"""broker_thread_cpu_us: the CPU of the client's broker threads
(``client/broker.py``: one a broker and the bootstrap one, named
``rdk:broker/...``) over the window, per record acknowledged in it."""


def read(r):
    if r.thread_cpu_s is None or not r.delivered:
        return None
    s = sum(v for k, v in r.thread_cpu_s.items()
            if k.startswith("rdk:broker"))
    return 1e6 * s / r.delivered
