"""broker_ack_cpu_us: the CPU the broker threads spend on responses,
from the socket read through each ProduceResponse's delivery reports
and retries (the ``recv`` phase of the program's ``pass_tally``
events), per record acknowledged in the window.  A program without the
events, or a trail that lost some, has none."""


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
    return sum(a["cpu_ns"].get("recv", 0) for a in got) / 1e3 / r.delivered
