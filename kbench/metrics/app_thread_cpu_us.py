"""app_thread_cpu_us: CPU time of the application's own thread (the
loop that calls produce() or poll()) over the window, per record."""


def read(r):
    n = r.delivered
    if not n or r.app_thread_cpu_s is None:
        return None
    return r.app_thread_cpu_s / n * 1e6
