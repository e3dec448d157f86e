"""Build the native codec library (g++ → ``_codec.so``), cached by mtime.

The port's copy of librdkafka_tpu/ops/native/build.py, reduced to the
one artifact this package uses: ``_codec.so``, a plain shared library
reached via ctypes (codec.cpp).  The fast-lane CPython extension
(``tk_enqlane.so``) belongs to the client slice of the port.
"""
from __future__ import annotations

import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "codec.cpp")
SO = os.path.join(_DIR, "_codec.so")
_lock = threading.Lock()


def _compile(src: str, so: str, extra: list[str]) -> str:
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    # per-process temp name: parallel test workers may build at once
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           *extra, "-o", tmp, src]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)
    return so


def _loadable(so: str) -> bool:
    """A shipped .so can be foreign (sdist built on another arch/libc);
    trust it only if ctypes can actually load it."""
    import ctypes
    try:
        ctypes.CDLL(so)
        return True
    except OSError:
        return False


def build(force: bool = False) -> str:
    """Compile codec.cpp to a shared library if stale; returns the .so path."""
    with _lock:
        if force and os.path.exists(SO):
            os.remove(SO)
        so = _compile(SRC, SO, ["-fvisibility=hidden"])
        if not _loadable(so):
            os.remove(so)               # wrong-platform prebuilt: rebuild
            so = _compile(SRC, SO, ["-fvisibility=hidden"])
        return so
