"""engine_thread_cpu_us: the CPU of the offload engine's threads
(``ops/engine.py``: its dispatch thread and its warm-up thread, whose
names hold ``engine``) over the window, per record acknowledged in it.
A provider without an engine (``compression.backend=cpu``) has none."""


def read(r):
    if r.thread_cpu_s is None or not r.delivered:
        return None
    names = [k for k in r.thread_cpu_s if "engine" in k]
    if not names:
        return None
    return 1e6 * sum(r.thread_cpu_s[k] for k in names) / r.delivered
