"""Cross-process trace collection: merge per-process flight-recorder
dumps into ONE Perfetto-loadable timeline.

obs/trace.py stops at the process boundary — each fleet worker, the
rig supervisor and every broker relay runs its own rings stamped with
its own ``time.monotonic_ns()``.  This module is the other half:

  * **Clock alignment.**  Every collection channel (worker stdin/
    stdout, rig control socket, relay stdin) does a request/response
    offset exchange: the collector stamps ``t_send``, the peer replies
    with its own ``mono_ns``, the collector stamps ``t_recv``.  The
    peer's clock read happened somewhere inside the round trip, so

        offset = peer_mono - (t_send + t_recv) / 2
        err    = (t_recv - t_send) / 2

    maps peer timestamps into the collector's timebase with a bounded
    error of half the round trip (on Linux CLOCK_MONOTONIC is machine-
    wide, so offsets measure ~0 — the exchange is what PROVES it, and
    keeps the merge correct on any future multi-host topology).

  * **Merge.**  :func:`merge` shifts every event by its process's
    offset, injects ``process_name`` metadata per pid (Perfetto's
    process rail labels) and returns one ts-sorted event list.

  * **Flow stitching.**  Hot paths emit sampled ``flow_*`` instants
    keyed by ``(topic, partition, offset)`` (trace.flow_sample_every);
    :func:`stitch_flows` connects each key's produce -> ack -> fetch ->
    deliver points with Chrome flow events (ph "s"/"t"/"f"), so one
    record's cross-process journey renders as a linked arrow chain.

Temp dump directories handed out by :func:`make_dump_dir` are
registered so the conftest leak fixture can fail any test that loses
one (a fleet run releases its directory in ``stop()``).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Optional

#: stage order of the per-record flow points (trace instants emitted by
#: client/kafka.py + client/broker.py under trace.flow_sample_every)
FLOW_STAGES = ("flow_produce", "flow_ack", "flow_fetch", "flow_deliver")

_lock = threading.Lock()
_dump_dirs: set[str] = set()


# ------------------------------------------------------ dump dirs --
def make_dump_dir(prefix: str = "tk_obs_") -> str:
    """A registered temp directory for flight dumps / ring dumps; the
    owner must release it (conftest fails leaked ones)."""
    d = tempfile.mkdtemp(prefix=prefix)
    with _lock:
        _dump_dirs.add(d)
    return d


def release_dump_dir(path: str) -> None:
    with _lock:
        _dump_dirs.discard(path)
    shutil.rmtree(path, ignore_errors=True)


def active_dump_dir_count() -> int:
    with _lock:
        return len(_dump_dirs)


# -------------------------------------------------- clock alignment --
def align_offset(t_send_ns: int, peer_mono_ns: int,
                 t_recv_ns: int) -> tuple[int, int]:
    """(offset_ns, err_ns) mapping the peer's monotonic clock into the
    collector's: ``collector_ts = peer_ts + offset_ns``, accurate to
    +/- err_ns (half the observed round trip)."""
    mid = (t_send_ns + t_recv_ns) // 2
    return mid - peer_mono_ns, (t_recv_ns - t_send_ns) // 2


class ProcessDump:
    """One process's contribution: its Chrome events plus the clock
    mapping computed from the collection channel's offset exchange."""

    __slots__ = ("name", "pid", "events", "offset_ns", "err_ns")

    def __init__(self, name: str, pid: int, events: list,
                 offset_ns: int = 0, err_ns: int = 0):
        self.name = name
        self.pid = pid
        self.events = events
        self.offset_ns = offset_ns
        self.err_ns = err_ns


# ------------------------------------------------------------ merge --
def merge(dumps: list[ProcessDump]) -> list[dict]:
    """One ts-sorted Chrome event list across processes: every event
    shifted into the collector's timebase, one ``process_name``
    metadata record per pid, per-process ``clock_err_us`` recorded as
    an arg on the metadata so the bound survives into the artifact."""
    out: list[dict] = []
    for d in dumps:
        off_us = d.offset_ns / 1e3
        out.append({"name": "process_name", "ph": "M", "pid": d.pid,
                    "tid": 0,
                    "args": {"name": d.name,
                             "clock_offset_us": round(off_us, 3),
                             "clock_err_us": round(d.err_ns / 1e3, 3)}})
        for e in d.events:
            e = dict(e)
            e["pid"] = d.pid
            if "ts" in e:
                e["ts"] = e["ts"] + off_us
            out.append(e)
    out.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    return out


# ---------------------------------------------------- flow stitching --
def _flow_key(e: dict) -> Optional[tuple]:
    a = e.get("args") or {}
    if "topic" in a and "partition" in a and "offset" in a:
        return (a["topic"], a["partition"], a["offset"])
    return None


def stitch_flows(events: list[dict]) -> tuple[list[dict], int]:
    """Synthesize Chrome flow events linking each sampled record's
    ``flow_*`` instants in FLOW_STAGES order across processes.

    Returns ``(events + flow events, n_links)`` where a "link" is one
    arrow between two consecutive stitched points.  Points are matched
    purely by ``(topic, partition, offset)`` — the producer and the
    consumer never coordinated beyond the record itself."""
    stage_rank = {n: i for i, n in enumerate(FLOW_STAGES)}
    chains: dict[tuple, list[dict]] = {}
    for e in events:
        if e.get("ph") == "i" and e.get("name") in stage_rank:
            k = _flow_key(e)
            if k is not None:
                chains.setdefault(k, []).append(e)
    flows: list[dict] = []
    links = 0
    fid = 0
    for k in sorted(chains, key=lambda kk: (str(kk[0]), kk[1], kk[2])):
        pts = sorted(chains[k], key=lambda e: (stage_rank[e["name"]],
                                               e.get("ts", 0)))
        if len(pts) < 2:
            continue
        fid += 1
        links += len(pts) - 1
        for i, p in enumerate(pts):
            ph = "s" if i == 0 else ("f" if i == len(pts) - 1 else "t")
            f = {"name": "record_flow", "cat": "flow", "ph": ph,
                 "id": fid, "pid": p["pid"], "tid": p.get("tid", 0),
                 "ts": p.get("ts", 0),
                 "args": {"topic": k[0], "partition": k[1],
                          "offset": k[2], "stage": p["name"]}}
            if ph == "f":
                f["bp"] = "e"
            flows.append(f)
    return events + flows, links


def flow_link_count(events: list[dict]) -> int:
    """Arrows already stitched into ``events`` (ph s/t/f count minus
    one per flow id) — the acceptance probe for merged artifacts."""
    per_id: dict = {}
    for e in events:
        if e.get("ph") in ("s", "t", "f") and e.get("cat") == "flow":
            per_id[e["id"]] = per_id.get(e["id"], 0) + 1
    return sum(n - 1 for n in per_id.values() if n > 1)


# ------------------------------------------------------------ write --
def write(path: str, events: list[dict]) -> int:
    """Perfetto-loadable Chrome trace JSON; returns the non-metadata
    event count (same contract as trace.dump)."""
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return sum(1 for e in events if e.get("ph") != "M")
