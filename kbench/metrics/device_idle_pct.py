"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the card (torch.profiler's CUDA activity)."""


def read(r):
    d = r.dev
    if not d or not d["window_s"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
