"""consume_cpu_us: the CPU of the consumers' fetch path per record
whose transaction committed in the window: the broker threads' fetch
serve and fetch responses (the ``fetch`` and ``fetch_recv`` phases of
the program's ``pass_tally`` events: the fetch requests and deferred
partitions, and each response's parse, CRC tickets, decompress and
record parsing) and the application side of it (``fetch_cpu_ns``: the
thread CPU of the consumers' ``poll()`` and ``consume()`` calls), all
counted while tracing.  A program without the counter or the events, or a trail that
lost tallies, has none."""

PHASES = ("fetch", "fetch_recv")


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
    fetch = r.extra.get("fetch") or {}
    if r.spans is None or not r.delivered or "fetch_cpu_ns" not in fetch:
        return None
    got = tallies(r.spans, ("pass_tally",))
    if not got:
        return None
    ns = fetch["fetch_cpu_ns"] + sum(a["cpu_ns"].get(k, 0) for a in got
                                     for k in PHASES)
    return ns / 1e3 / r.delivered
