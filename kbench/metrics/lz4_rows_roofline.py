"""lz4_rows_roofline: the ``lz4_rows`` kernel's share of its byte
roofline over the traced window: the least time the card's memory could
move the bytes of the window's compress rounds (:func:`round_bytes`) at
the H100 SXM's published 3.35 TB/s, over the summed device time of the
kernel (``r.dev["kernel_s"]``, every entry whose name holds
``lz4_rows``).  A window with no such kernel time, or a program without
the route's byte counters, has none."""

#: NVIDIA's data sheet, H100 SXM, HBM3
HBM_BYTES_PER_S = 3.35e12
KERNEL = "lz4_rows"


def round_bytes(e: dict) -> int:
    """The bytes a launch must move at least: each input byte of the
    launched rounds read once (``compress_bytes_in``) and each byte of
    their frames written once (``compress_bytes_out``)."""
    return e.get("compress_bytes_in", 0) + e.get("compress_bytes_out", 0)


def roofline(nbytes: float, kernel_s: float) -> float:
    """Percent of the byte roofline that ``nbytes`` in ``kernel_s``
    reach."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / kernel_s


def read(r):
    d, e = r.dev, r.engine
    if not d or not e:
        return None
    t = sum(v for k, v in d["kernel_s"].items() if KERNEL in k)
    nbytes = round_bytes(e)
    if t <= 0 or not nbytes:
        return None
    return roofline(nbytes, t)
