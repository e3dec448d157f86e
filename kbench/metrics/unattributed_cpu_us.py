"""unattributed_cpu_us: the client's CPU over the window that the
program cannot place, per record acknowledged in it: the process's
user + system CPU (getrusage) less the application thread's, the
broker threads' and the codec worker's (every phase of their
``pass_tally`` and ``codec_tally`` events), the engine's dispatch
turns (``turn_cpu_ns``) and the native codec pool's (the engine's
``native_pool_cpu_ns`` and the events' ``pool_cpu_ns``).  A program
without the events, or a trail that lost some, has none."""

TALLIES = ("pass_tally", "codec_tally")


def tallies(spans, names):
    """The args of the window's tallies of these names; None where one
    thread's tallies differ in ``dropped``, because its ring overwrote
    events between them and tallies may be missing."""
    out, dropped = [], {}
    for e in spans:
        if e["name"] in names:
            a = e["args"]
            first = dropped.setdefault(e["tid"], a.get("dropped"))
            if first != a.get("dropped"):
                return None
            out.append(a)
    return out


def read(r):
    if (r.spans is None or not r.delivered or r.client_cpu_s is None
            or r.app_thread_cpu_s is None):
        return None
    got = tallies(r.spans, TALLIES)
    if not got:
        return None
    e = r.engine or {}
    ns = sum(sum(a["cpu_ns"].values()) + a.get("pool_cpu_ns", 0)
             for a in got)
    ns += e.get("turn_cpu_ns", 0) + e.get("native_pool_cpu_ns", 0)
    left = r.client_cpu_s - r.app_thread_cpu_s - ns / 1e9
    return left * 1e6 / r.delivered
