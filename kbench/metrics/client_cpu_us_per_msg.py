"""client_cpu_us_per_msg: the client process's user + system CPU over
the window (getrusage: every thread, not the broker's process), per
record delivered or consumed in it."""


def read(r):
    n = r.delivered
    if not n or r.client_cpu_s is None:
        return None
    return r.client_cpu_s / n * 1e6
