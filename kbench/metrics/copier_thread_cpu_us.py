"""copier_thread_cpu_us: the CPU of the exactly-once copy's member
threads (``eos-copier-N``: each member's poll, produce, offsets and
commit calls, the application's side of the copy) over the window, per
record whose transaction committed in it.  A run without such threads
has none."""


def read(r):
    if r.thread_cpu_s is None or not r.delivered:
        return None
    got = [v for k, v in r.thread_cpu_s.items()
           if k.startswith("eos-copier")]
    if not got:
        return None
    return 1e6 * sum(got) / r.delivered
