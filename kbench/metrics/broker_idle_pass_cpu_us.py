"""broker_idle_pass_cpu_us: the CPU of the broker threads' serve passes
that did nothing (no op served, no batch formed, no byte written or
read, no retry or timeout acted on), per record acknowledged in the
window: the ``idle`` CPU of the program's ``pass_tally`` events
(``client/broker.py``, one a broker thread every 100 ms while tracing).
A program without the events, or a trail that lost some, has none."""


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
    if r.spans is None or not r.delivered:
        return None
    got = tallies(r.spans, ("pass_tally",))
    if not got:
        return None
    return sum(a["cpu_ns"].get("idle", 0) for a in got) / 1e3 / r.delivered
