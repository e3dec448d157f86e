"""Interceptor chains (reference: src/rdkafka_interceptor.c).

Hook points mirror rdkafka_interceptor.h:33-72: on_conf_set, on_new,
on_destroy, on_send, on_acknowledgement, on_consume, on_commit,
on_request_sent, on_thread_start/exit. Plugins (``plugin.library.paths``)
are Python entry points ``module:function`` whose conf_init() registers
interceptors — the same gating boundary the reference uses for codec
providers (src/rdkafka_plugin.c).
"""
from __future__ import annotations

import importlib
from typing import Callable


HOOKS = ("on_conf_set", "on_new", "on_destroy", "on_send",
         "on_acknowledgement", "on_consume", "on_commit",
         "on_request_sent", "on_thread_start", "on_thread_exit")


class InterceptorChain:
    def __init__(self):
        self._hooks: dict[str, list[tuple[str, Callable]]] = {h: [] for h in HOOKS}

    def add(self, name: str, hook: str, fn: Callable) -> None:
        if hook not in self._hooks:
            raise ValueError(f"unknown interceptor hook {hook!r}")
        self._hooks[hook].append((name, fn))

    def _call(self, hook: str, *args):
        for _name, fn in self._hooks[hook]:
            try:
                fn(*args)
            except Exception:
                pass  # interceptor failures must not break the client

    def __getattr__(self, hook):
        if hook in HOOKS:
            return lambda *a: self._call(hook, *a)
        raise AttributeError(hook)

    def __len__(self):
        return sum(len(v) for v in self._hooks.values())


def load_plugins(paths: str, conf) -> InterceptorChain:
    """Load plugin modules listed in plugin.library.paths; each entry is
    ``module`` or ``module:func``; the callable receives (conf, chain) and
    registers interceptors (the conf_init() contract)."""
    chain = conf.get("interceptors") or InterceptorChain()
    for entry in (paths or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        mod_name, _, fn_name = entry.partition(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name or "conf_init")
        fn(conf, chain)
    return chain
