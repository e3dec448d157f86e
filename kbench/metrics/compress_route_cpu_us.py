"""compress_route_cpu_us: the dispatch thread's CPU on the compress
route's launched rounds over the window, per record acknowledged in it:
packing and launching each round (``compress_stats["fill_cpu_ns"]``),
its readback's wait for the card (``sync_cpu_ns``) and the assembly of
its frames (``frame_cpu_ns``), all counted while tracing.  The kernel's
own time reaches the client's CPU through the readback's wait.  A
program without the counters, or an untraced run, has none."""

FIELDS = ("compress_fill_cpu_ns", "compress_sync_cpu_ns",
          "compress_frame_cpu_ns")


def read(r):
    e = r.engine
    if r.spans is None or not r.delivered or not e or any(
            k not in e for k in FIELDS):
        return None
    return sum(e[k] for k in FIELDS) / 1e3 / r.delivered
