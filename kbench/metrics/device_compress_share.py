"""device_compress_share: the share of the compress route's input bytes
that the card compressed in the window (``gpu.compress.device``): the
input bytes of the rounds launched on ``lz4_rows`` (the engine's
``compress_stats["bytes_in"]``) over those and the input bytes that the
deterministic CPU encoder served inside the route (``cpu_bytes_in``:
below the launch quorum, routed there by the governor, before the
kernel was warm, shed).  A program without the ``cpu_bytes_in``
counter, or a window in which the route took no bytes, has none."""


def read(r):
    e = r.engine
    if not e or "compress_cpu_bytes_in" not in e:
        return None
    dev = e.get("compress_bytes_in", 0)
    total = dev + e["compress_cpu_bytes_in"]
    return 100.0 * dev / total if total else None
