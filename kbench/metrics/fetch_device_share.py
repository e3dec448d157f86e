"""fetch_device_share: the share of the fetched v2 bytes whose CRC32C
the card checked (``crc_rows``) in the window, over those the card or
the host checked: the program's ``fetch_crc_bytes_device`` over it and
``fetch_crc_bytes_host``, summed over the consumers' broker threads
(always counted).  A program without the counters, or a window in which
the consumers verified nothing, has none."""


def read(r):
    fetch = r.extra.get("fetch") or {}
    dev = fetch.get("fetch_crc_bytes_device")
    host = fetch.get("fetch_crc_bytes_host")
    if dev is None or host is None or not dev + host:
        return None
    return 100.0 * dev / (dev + host)
