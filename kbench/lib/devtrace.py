"""The device trace of a ``--trace 1`` window: torch.profiler's CUDA
activity (kernels, copies, memsets), reduced to the busy time of the
card, the time of each kernel by name, and the longest gaps in which
the card was idle, each labelled by the program's span that was open on
the host at the gap's middle.

The profiler's clock is tied to ``time.monotonic_ns`` (the program's
trace clock) by a marker: a ``record_function`` range opened right
after a monotonic reading, whose profiler start gives the offset.
"""
from __future__ import annotations

import time

MARK = "kbench.window"


def start(device: str):
    """A running profiler, or None off the card."""
    if device != "cuda":
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    mono = time.monotonic_ns()
    with record_function(MARK):
        pass
    return prof, mono


def _union(iv: list) -> list:
    """Merged, sorted intervals."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _label(spans: list, t_us: float) -> str:
    """The latest-starting program span open at ``t_us`` (trace us)."""
    best = None
    for e in spans:
        if e["ts"] <= t_us <= e["ts"] + e["dur"] and (
                best is None or e["ts"] > best["ts"]):
            best = e
    return f"{best['cat']}:{best['name']}" if best else "no span open"


def finish(handle, t0_ns: int, t1_ns: int, spans: list) -> dict:
    """Stop the profiler and reduce its trace over [t0_ns, t1_ns]."""
    import torch
    from torch.autograd import DeviceType
    prof, mono = handle
    torch.cuda.synchronize()
    prof.stop()
    events = prof.profiler.kineto_results.events()
    mark = [e.start_ns() for e in events if e.name() == MARK]
    # profiler ns -> monotonic ns
    off = (mono - mark[0]) if mark else (time.monotonic_ns() - time.time_ns())
    iv = []
    kernel_s: dict[str, float] = {}
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        a = e.start_ns() + off
        b = a + e.duration_ns()
        a, b = max(a, t0_ns), min(b, t1_ns)
        if b <= a:
            continue
        iv.append((a, b))
        kernel_s[e.name()] = kernel_s.get(e.name(), 0.0) + (b - a) / 1e9
    busy = _union(iv)
    window_s = (t1_ns - t0_ns) / 1e9
    gaps = []
    prev = t0_ns
    for a, b in busy + [[t1_ns, t1_ns]]:
        if a > prev:
            gaps.append((a - prev, prev))
        prev = max(prev, b)
    gaps.sort(reverse=True)
    top_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    idle = [[_label(spans, (g0 + g / 2) / 1e3), g / 1e9]
            for g, g0 in gaps[:10]]
    return {"busy_s": sum(b - a for a, b in busy) / 1e9,
            "window_s": window_s,
            "kernel_s": kernel_s,
            "kind": torch.cuda.get_device_name(0),
            "marker": bool(mark),
            "events": len(events),
            "breakdown": {"device_ops": [[k, v] for k, v in top_ops],
                          "idle_gaps": idle}}
