"""native_pool_cpu_us: the CPU of the native codec's worker threads
(``ops/native/codec.cpp``: each ``*_many`` call starts its own and
joins them before it returns, so no per-thread reading sees them), per
record acknowledged in the window: what the engine's host work took
(its ``native_pool_cpu_ns`` counter) and what the broker threads and
the codec worker took (``pool_cpu_ns`` of their ``pass_tally`` and
``codec_tally`` events), all counted while tracing.  A program without
the counter and the events, or a trail that lost tallies, has none."""

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
    if r.spans is None or not r.delivered:
        return None
    got = tallies(r.spans, TALLIES)
    ns = (r.engine or {}).get("native_pool_cpu_ns")
    if got is None or (not got and ns is None):
        return None
    ns = (ns or 0) + sum(a.get("pool_cpu_ns", 0) for a in got)
    return ns / 1e3 / r.delivered
