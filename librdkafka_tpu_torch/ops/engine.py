"""Pipelined async device-offload engine: the CRC route.

The port of librdkafka_tpu/ops/engine.py's CRC route (tickets, fan-in,
the adaptive governor, per-device lanes, staging rings, bulk readback)
onto CUDA streams.  Every ``crc32c_many`` call of the synchronous route
blocks its caller through the join, the host-to-device copy, the launch
and the readback; this module gives the offload seam the overlap the
reference client gets by pipelining the msgset writer against broker IO:

  * ``submit()`` returns a :class:`Ticket` at once; a dispatch thread
    owns every device interaction and keeps up to ``depth`` launches in
    flight per lane, so the codec worker frames and CRC-patches batch k
    on the host while batch k+1 is checksummed on the card.
  * Staging is a ring of ``depth + 1`` PINNED host slots per bucket and
    lane (``crc32c_torch.Slot``): a launch's packed ``flat`` and its
    metadata are filled into one slot and cross in ONE non-blocking copy
    on the lane's stream, into device buffers the lane keeps; the CRCs
    come back with one non-blocking copy into the slot.  A slot is
    filled again only after the event recorded behind its last launch:
    a non-blocking copy from pinned memory reads the slot while the host
    runs on.
  * Cross-submitter fan-in: below-quorum jobs arriving within a bounded
    window (default 500 us) merge into ONE launch.
  * The adaptive governor: background warmup (until a lane is warm its
    launches are served by the CPU provider), cost-model routing between
    the device and the CPU provider with periodic exploration, an
    adaptive fan-in window sized from the submission inter-arrival EWMA,
    and fused launches: crc32c and legacy-crc32 jobs popped together go
    out as ONE launch with a per-segment polynomial.
  * One lane per device of the pool (``mesh_devices``: 0 every device,
    1 one lane, N the first min(N, pool)): its own stream, staging rings,
    device buffers and in-flight deque; a group goes whole to the
    least-loaded lane.
  * Sharded launches: with several lanes, a group of at least
    ``SHARD_MIN_ROWS`` 64 KB blocks a lane (the JAX engine's decision)
    splits its packed segments into one contiguous shard a lane, of about
    equal bytes, cut at segment bounds.  Each shard is filled into a
    pinned slot of its lane's rings and launched on that lane's stream
    (parallel/mesh.py, kernel G); the launch rides the whole-mesh
    pseudo-lane (id -1), every lane records it with its share of the
    blocks, and the readback waits for every shard before the tickets
    resolve.  Shards on one card run in series; on several cards they
    overlap.
  * Bulk readback: one event wait and one vectorized uint32 view per
    launch; the kernel returns whole-buffer CRCs, so there is no 64 KB
    block split and no host-side ``crc32c_combine``.

The engine never changes bytes: the kernel (csrc/crc_rows.cu) is exact
for any segment length, and every CPU route serves the caller's
bit-identical fallback.  A lane on a CPU device runs the kernel's plain
PyTorch version (``crc32c_torch.crc_segments`` on a CPU tensor): the
tests' route.  A lane on a card launches the kernel or fails the
tickets.

The device compress route makes lz4 a launch kind the way CRC is one:
``submit_compress`` packs a group's 64 KB blocks into a pinned slot of
the lane's rings, launches the LZ4 kernel with its CRC epilogue
(ops/lz4_torch.py, csrc/lz4_rows.cu) and reads back only the compressed
bytes, the lengths and both CRCs of every block; the readback assembles
one LZ4F frame per buffer as a :class:`packing.FrameBlob` carrying the
CRC of each part, so the writer folds the v2 batch CRC with no CRC
launch.  The governor keeps a parallel pair of compress cost models and
a per-topic QoS layer (``qos`` weights): weighted fan-in admission,
weight-ordered dispatch and, only while every lane is saturated, the
shedding of flood topics to the CPU encoder.  Every CPU route of a
compress job serves ``cpu_compress_fallback``, the deterministic native
encoder, whose bytes equal the kernel's.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..analysis import lockdep as _lockdep
from ..analysis.locks import new_cond, new_lock
from ..analysis.races import register_slots, shared, shared_dict
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from . import cpu as _cpu_ops
from . import crc32c_torch as _crc
from . import lz4_torch as _lz4
from ..parallel import mesh as _mesh
from .packing import LZ4F_BLOCKSIZE, lz4f_frame, next_pow2

class Ticket:
    """Handle for one submitted job; resolves to a uint32 ndarray of
    per-buffer checksums (or raises the launch's exception)."""

    __slots__ = ("_ev", "_result", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("offload ticket not resolved in time")
        if self._exc is not None:
            raise self._exc
        return self._result

    # dispatch-thread side -------------------------------------------------
    # (first resolution wins: the shutdown sweep failing stragglers must
    # not clobber a result the dispatch thread already delivered)
    def _complete(self, result) -> None:
        if not self._ev.is_set():
            self._result = result
            self._ev.set()

    def _fail(self, exc: BaseException) -> None:
        if not self._ev.is_set():
            self._exc = exc
            self._ev.set()


class _Job:
    __slots__ = ("kind", "data", "lens", "poly", "ticket", "window", "fn",
                 "args", "t_submit", "topics", "weight")

    def __init__(self, kind, ticket, window=False, data=b"", lens=None,
                 poly=None, fn=None, args=()):
        self.kind = kind            # "crc" | "lz4" | "compute" | "host"
        self.data = data            # crc: the buffers joined (a snapshot);
                                    # lz4: the list of buffers (bytes)
        self.lens = lens            # crc, lz4: (n,) int64 buffer lengths
        self.poly = poly
        self.ticket = ticket
        self.window = window        # may wait the fan-in window
        self.fn = fn
        self.args = args
        self.t_submit = 0.0         # submit() time (stage_latency)
        self.topics: tuple = ()     # QoS: topics riding this job
        self.weight = 1.0           # QoS: max weight of them

    def bufs(self) -> list:
        """The job's buffers, as views of its joined snapshot (an lz4
        job keeps them as a list)."""
        if isinstance(self.data, list):
            return self.data
        mv = memoryview(self.data)
        ends = np.cumsum(self.lens).tolist()
        return [mv[e - n:e] for e, n in zip(ends, self.lens.tolist())]


class _Staging:
    """Rings of ``copies`` host slots per bucket (crc32c_torch.slot_bucket
    of a launch's flat + metadata bytes), pinned on a card's lane.  A slot
    is taken for one launch and given back at its readback; the ring
    hands out its slots in turn, skipping taken ones, and grows past
    ``copies`` only when a launch of several chunks finds none free.  The
    next fill of a slot also waits for the event behind its last launch,
    so a fill never overwrites bytes an in-flight copy still reads."""

    def __init__(self, copies: int, pin: bool):
        self.copies = max(2, copies)
        self.pin = pin
        self._lock = new_lock("engine.staging")
        #: the rings and their cursors, by bucket: taken on the dispatch
        #: thread, preallocated by the warmup, cleared at close, every
        #: access under engine.staging
        self._rings: dict[int, list] = shared_dict("engine.staging.rings")
        self._next: dict[int, int] = shared_dict("engine.staging.next")

    def take(self, nbytes: int) -> "_crc.Slot":
        key = _crc.slot_bucket(nbytes)
        with self._lock:
            ring = self._rings.setdefault(key, [])
            start = self._next.get(key, 0)
            for k in range(len(ring)):
                i = (start + k) % len(ring)
                if not ring[i].busy:
                    break
            else:
                i = len(ring)
                ring.append(_crc.Slot(key, self.pin))
            self._next[key] = (i + 1) % max(self.copies, len(ring))
            slot = ring[i]
            slot.busy = True
            return slot

    def give_back(self, slots) -> None:
        """Return a launch's slots to their rings (its results are read)."""
        with self._lock:
            for s in slots:
                s.busy = False

    def prealloc(self, nbytes: int = _crc.SLOT_FLOOR) -> None:
        """Allocate the ring of the ``nbytes`` bucket up front (warmup)."""
        key = _crc.slot_bucket(nbytes)
        with self._lock:
            ring = self._rings.setdefault(key, [])
            while len(ring) < self.copies:
                ring.append(_crc.Slot(key, self.pin))

    def nbytes(self) -> int:
        """Host bytes the rings hold (pinned on a card's lane)."""
        with self._lock:
            return sum(s.nbytes() for ring in self._rings.values()
                       for s in ring)

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()
            self._next.clear()


class _Launch:
    """One in-flight launch awaiting readback."""

    __slots__ = ("kind", "jobs", "chunks", "ticket", "out_tree", "event",
                 "t0", "bucket", "lane", "raw", "sharded")

    def __init__(self, kind):
        self.kind = kind
        self.jobs: list[_Job] = []
        self.chunks: list = []                   # crc: (slot, plan, lane)
                                                 # per launch or shard;
                                                 # lz4: (slot, plan, handle)
        self.raw: list = []                      # lz4: the group's buffers
        self.ticket: Optional[Ticket] = None     # compute kind only
        self.out_tree = None
        self.event = None                        # compute: end of fn's work
        self.t0: Optional[float] = None          # launch wall-clock start
        self.bucket: Optional[int] = None        # slot bucket of chunk 0
        self.lane: Optional["_Lane"] = None
        self.sharded = False                     # split over every lane


class _Lane:
    """One per-device dispatch lane: the device and its stream with the
    device buffers the lane reuses (``crc32c_torch.LaneBuffers``), its
    private staging rings, its in-flight launch deque honoring the
    engine ``depth``, and per-device counters for devices_snapshot.  The
    whole-mesh sharded launches ride a pseudo-lane (``dev_id`` -1, no
    device) with the same depth discipline; their shards use the real
    lanes' rings and streams."""

    __slots__ = ("dev_id", "device", "bufs", "staging", "inflight",
                 "launches", "blocks", "jobs", "launch_avg", "rb_stream")

    def __init__(self, dev_id: int, device: torch.device, copies: int,
                 launch_avg):
        self.dev_id = dev_id
        self.device = device            # None: the whole-mesh pseudo-lane
        card = device is not None and device.type == "cuda"
        self.bufs = _crc.LaneBuffers(device) if device is not None else None
        self.staging = (_Staging(copies, pin=card) if device is not None
                        else None)
        self.inflight: deque = deque()  # _Launch records, oldest first
        self.launches = 0
        self.blocks = 0
        self.jobs = 0
        self.launch_avg = launch_avg    # per-device stage_latency window
        # a card's second stream, for an lz4 launch's bulk readback: the
        # lane's own stream may already hold the next launch
        self.rb_stream = torch.cuda.Stream(device) if card else None


class _Governor:
    """Online policy state for the adaptive offload governor.

    Three O(1) EWMAs: ``interarrival_s`` (CRC submission inter-arrival,
    fed by submitters; sizes the fan-in window), ``dev_launch_s[(device,
    bucket)]`` (launch latency, dispatch to readback, fed by the dispatch
    thread) and ``cpu_ns_per_byte`` (the CPU provider's observed rate).
    ``route`` compares the best device estimate against the CPU model for
    an at-quorum group and periodically explores the unpicked side, so a
    stale estimate cannot pin the router."""

    EWMA_ALPHA = 0.25
    EXPLORE_EVERY = 16
    #: per-topic byte-pressure decay applied at each submission of that
    #: topic (the QoS feedback signal)
    QOS_DECAY = 0.75
    #: a topic is shed-eligible while saturated once its decayed byte
    #: share exceeds this multiple of its weight share
    QOS_SHED_RATIO = 1.5

    __slots__ = ("enabled", "fanin_cap_s", "interarrival_s",
                 "_last_submit", "cpu_ns_per_byte", "dev_launch_s",
                 "_since_explore", "_glock", "cpu_comp_ns_per_byte",
                 "dev_comp_launch_s", "_since_explore_comp",
                 "qos_weights", "qos_bytes", "qos_routed", "qos_shed")

    def __init__(self, enabled: bool, fanin_cap_s: float):
        self.enabled = bool(enabled)
        self.fanin_cap_s = float(fanin_cap_s)
        # every EWMA below is mutated under _glock: submitters update the
        # arrival model, the dispatch thread the cost models and the
        # explore counter, and snapshot readers run on their own threads
        self._glock = new_lock("engine.governor")
        self.interarrival_s: Optional[float] = None
        self._last_submit: Optional[float] = None
        self.cpu_ns_per_byte: Optional[float] = None
        # (lane id, slot bucket) -> launch-time EWMA seconds
        self.dev_launch_s: dict[tuple[int, int], float] = {}
        self._since_explore = 0
        # compress cost models: the CRC models' shapes, never sharing an
        # estimate with them (an lz4 launch is far heavier than a CRC one)
        self.cpu_comp_ns_per_byte: Optional[float] = None
        self.dev_comp_launch_s: dict[tuple[int, int], float] = {}
        self._since_explore_comp = 0
        # per-topic QoS state: weights, decayed byte pressure (the
        # feedback signal), routed / shed counters
        self.qos_weights: dict[str, float] = {}
        self.qos_bytes: dict[str, float] = {}
        self.qos_routed: dict[str, int] = {}
        self.qos_shed: dict[str, int] = {}

    def _ewma(self, old: Optional[float], v: float) -> float:
        return v if old is None else old + self.EWMA_ALPHA * (v - old)

    # ---- submitter side ----
    def note_submit(self, now: float) -> None:
        with self._glock:
            last, self._last_submit = self._last_submit, now
            if last is not None:
                self.interarrival_s = self._ewma(self.interarrival_s,
                                                 now - last)

    # ---- dispatch-thread side ----
    def fanin_window(self, need: int) -> float:
        """Seconds a below-quorum group should wait for ``need`` more
        buffers.  Static cap until the arrival model has data; zero when
        the mean inter-arrival already exceeds the cap (nothing will
        merge — dispatch now, don't tax latency)."""
        cap = self.fanin_cap_s
        with self._glock:
            ia = self.interarrival_s
        if not self.enabled or ia is None:
            return cap
        if ia >= cap:
            return 0.0
        return min(cap, 2.0 * max(1, need) * ia)

    def note_device(self, bucket: Optional[int], dt: float,
                    dev: int = 0) -> None:
        if bucket is not None:
            key = (dev, bucket)
            with self._glock:
                self.dev_launch_s[key] = self._ewma(
                    self.dev_launch_s.get(key), dt)

    def lane_device_s(self, dev: int, bucket: int) -> Optional[float]:
        """The (lane, bucket) launch-time estimate — lane selection's
        tie-break (None: the lane hasn't run this bucket yet)."""
        with self._glock:
            return self.dev_launch_s.get((dev, bucket))

    def best_device_s(self, bucket: int) -> Optional[float]:
        """The fastest known device estimate for a bucket — what the
        CPU-vs-device route decision compares against."""
        with self._glock:
            best = None
            for (d, b), s in self.dev_launch_s.items():
                if b == bucket and (best is None or s < best):
                    best = s
            return best

    def note_cpu(self, nbytes: int, dt: float) -> None:
        if nbytes > 0:
            with self._glock:
                self.cpu_ns_per_byte = self._ewma(self.cpu_ns_per_byte,
                                                  dt * 1e9 / nbytes)

    def route(self, bucket: int, nbytes: int) -> tuple[str, bool]:
        """('device'|'cpu', explored) for an at-quorum group.  Unknown
        estimates prefer the device — exactly the static policy."""
        dev = self.best_device_s(bucket)
        with self._glock:
            cpu = self.cpu_ns_per_byte
            if dev is None or cpu is None:
                return "device", False
            pick = "device" if dev <= nbytes * cpu / 1e9 else "cpu"
            self._since_explore += 1
            if self._since_explore >= self.EXPLORE_EVERY:
                self._since_explore = 0
                return ("cpu" if pick == "device" else "device"), True
            return pick, False

    def snapshot(self) -> dict:
        """JSON-ready gauges: dev_launch_ms is the best (fastest) device
        estimate per bucket; the per-device split rides
        devices_snapshot()."""
        with self._glock:
            dev_launch = dict(self.dev_launch_s)
            ia = self.interarrival_s
            cpu = self.cpu_ns_per_byte
        best: dict[int, float] = {}
        for (d, b), s in dev_launch.items():
            if b not in best or s < best[b]:
                best[b] = s
        return {
            "enabled": self.enabled,
            "interarrival_us": (None if ia is None
                                else round(ia * 1e6, 1)),
            "cpu_ns_per_byte": (None if cpu is None
                                else round(cpu, 3)),
            "dev_launch_ms": {str(b): round(s * 1e3, 3)
                              for b, s in sorted(best.items())},
        }

    def device_launch_ms(self, dev: int) -> dict:
        """One lane's {bucket: ms} EWMAs (devices_snapshot)."""
        with self._glock:
            items = sorted(self.dev_launch_s.items())
        return {str(b): round(s * 1e3, 3)
                for (d, b), s in items if d == dev}

    # ---- compress route ----
    def note_topics(self, entries) -> None:
        """Submitter side: fold one compress submission into the QoS
        models; ``entries`` is (topic, weight, nbytes) per topic."""
        with self._glock:
            for topic, w, nbytes in entries:
                self.qos_weights[topic] = float(w)
                self.qos_bytes[topic] = (
                    self.qos_bytes.get(topic, 0.0) * self.QOS_DECAY
                    + float(nbytes))

    def note_device_compress(self, bucket: Optional[int], dt: float,
                             dev: int = 0) -> None:
        if bucket is not None:
            key = (dev, bucket)
            with self._glock:
                self.dev_comp_launch_s[key] = self._ewma(
                    self.dev_comp_launch_s.get(key), dt)

    def note_cpu_compress(self, nbytes: int, dt: float) -> None:
        if nbytes > 0:
            with self._glock:
                self.cpu_comp_ns_per_byte = self._ewma(
                    self.cpu_comp_ns_per_byte, dt * 1e9 / nbytes)

    def lane_compress_s(self, dev: int, bucket: int) -> Optional[float]:
        with self._glock:
            return self.dev_comp_launch_s.get((dev, bucket))

    def route_compress(self, bucket: int, nbytes: int) -> tuple[str, bool]:
        """('device'|'cpu', explored) for an at-quorum compress group: the
        :meth:`route` shape on the compress cost models."""
        with self._glock:
            best = None
            for (d, b), s in self.dev_comp_launch_s.items():
                if b == bucket and (best is None or s < best):
                    best = s
            cpu = self.cpu_comp_ns_per_byte
            if best is None or cpu is None:
                return "device", False
            pick = "device" if best <= nbytes * cpu / 1e9 else "cpu"
            self._since_explore_comp += 1
            if self._since_explore_comp >= self.EXPLORE_EVERY:
                self._since_explore_comp = 0
                return ("cpu" if pick == "device" else "device"), True
            return pick, False

    def shed_topics(self, saturated: bool) -> set:
        """Topics whose decayed byte share exceeds QOS_SHED_RATIO x the
        share their weight entitles them to — only while every lane is
        saturated, and never the whole topic set."""
        if not (self.enabled and saturated):
            return set()
        with self._glock:
            if len(self.qos_weights) < 2:
                return set()
            tot_w = sum(self.qos_weights.values()) or 1.0
            tot_b = sum(self.qos_bytes.values())
            if tot_b <= 0:
                return set()
            out = {t for t, w in self.qos_weights.items()
                   if (self.qos_bytes.get(t, 0.0) / tot_b
                       > self.QOS_SHED_RATIO * (w / tot_w))}
            return out if len(out) < len(self.qos_weights) else set()

    def note_qos(self, topics, *, shed: bool) -> None:
        """Dispatch-thread side: count a job's topics as device-routed or
        shed."""
        if topics:
            with self._glock:
                tgt = self.qos_shed if shed else self.qos_routed
                for t in topics:
                    tgt[t] = tgt.get(t, 0) + 1

    def compress_models(self) -> dict:
        """The compress cost models, in the :meth:`snapshot` shape."""
        with self._glock:
            dev = dict(self.dev_comp_launch_s)
            cpu = self.cpu_comp_ns_per_byte
        best: dict[int, float] = {}
        for (d, b), s in dev.items():
            if b not in best or s < best[b]:
                best[b] = s
        return {"cpu_ns_per_byte": (None if cpu is None
                                    else round(cpu, 3)),
                "dev_launch_ms": {str(b): round(s * 1e3, 3)
                                  for b, s in sorted(best.items())}}

    def qos_snapshot(self) -> dict:
        """Per-topic {weight, routed, shed}."""
        with self._glock:
            topics = (set(self.qos_weights) | set(self.qos_routed)
                      | set(self.qos_shed))
            return {t: {"weight": self.qos_weights.get(t, 1.0),
                        "routed": self.qos_routed.get(t, 0),
                        "shed": self.qos_shed.get(t, 0)}
                    for t in sorted(topics)}


# the governor's online models are cross-thread by design, all
# serialized under engine.governor
register_slots(_Governor, "interarrival_s", "_last_submit",
               "cpu_ns_per_byte", "dev_launch_s", "_since_explore",
               "cpu_comp_ns_per_byte", "dev_comp_launch_s",
               "_since_explore_comp", "qos_weights", "qos_bytes",
               "qos_routed", "qos_shed",
               prefix="engine.governor")


def _to_host(tree):
    """A compute job's result with every tensor copied to a numpy array
    (tuples, lists and dicts walked)."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _resolve_devices(devices) -> list:
    """The lanes' devices: every visible card for None (raising on a
    host without one), else the caller's list, indices resolved."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=['cpu'] to run the engine's "
                "lanes on the kernel's plain PyTorch version")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("the engine needs at least one device")
    return out


class AsyncOffloadEngine:
    """Double-buffered producer/consumer pipeline around the CRC kernel
    (and, generically, any function via :meth:`submit_compute`)."""

    # lockset-checked shared state (analysis/races.py): the submit
    # queue, warm-request queue and closed flag cross submitter /
    # dispatch / warmup threads under engine.queue.  The lane list and
    # gauges are relaxed: lanes are written ONCE under engine.lanes (the
    # pre-ready read outside the lock only ever sees the final value or
    # triggers the locked double-check), and the gauges are single-writer
    # dispatch-thread ints read as snapshots — atomic under the GIL.
    _queue = shared("engine.queue.jobs")
    _warm_requests = shared("engine.warm_requests")
    _closed = shared("engine.closed")
    _lanes = shared("engine.lanes_list", relaxed=True)
    _shard_lane = shared("engine.shard_lane", relaxed=True)
    _lanes_ready = shared("engine.lanes_ready", relaxed=True)
    _inflight_cnt = shared("engine.gauge.inflight", relaxed=True)
    _fanin_last = shared("engine.gauge.fanin", relaxed=True)

    #: minimum 64 KB blocks PER LANE before a group splits across the
    #: lanes (the JAX engine's threshold: below it, whole-to-one-lane
    #: beats the scatter and gather)
    SHARD_MIN_ROWS = 8
    #: the sharded steps the warmup sweep builds (per-shard rows x kind),
    #: the JAX engine's standard buckets; other shapes warm on demand
    SHARD_WARM_BUCKETS = (64, 128, 256)
    WARM_KINDS = ("crc32c", "crc32", "fused")

    def __init__(self, *, depth: int = 2, fanin_window_s: float = 0.0005,
                 min_batches: int = 4,
                 cpu_fallback: Optional[Callable] = None,
                 name: str = "gpu-engine",
                 governor: bool = True, warmup: bool = False,
                 devices=None, mesh_devices: int = 0,
                 cpu_compress_fallback: Optional[Callable] = None):
        # depth: launches kept in flight PER LANE before that lane's
        # oldest is read back
        self.depth = max(1, int(depth))
        self.fanin_window_s = max(0.0, float(fanin_window_s))
        self.min_batches = max(1, int(min_batches))
        # cpu_fallback(bufs, poly) -> list[int]; serves below-quorum jobs
        self.cpu_fallback = cpu_fallback
        # cpu_compress_fallback(bufs) -> list[bytes]: the deterministic lz4
        # frame encoder (bytes equal to the kernel's) serving below-quorum,
        # unwarmed, CPU-routed and shed compress jobs
        self.cpu_compress_fallback = cpu_compress_fallback
        self._name = name
        # the adaptive policy layer; fanin_window_s is its CAP
        self.governor = _Governor(governor, self.fanin_window_s)
        # warmup=True: lanes warm on the background thread and jobs for
        # a lane not warm yet go to the CPU provider; warmup=False: the
        # dispatch thread builds and loads the kernel inline
        self.warmup_enabled = bool(warmup) and cpu_fallback is not None
        # the device pool: every visible card by default; the tests pass
        # CPU devices.  gpu.mesh.devices picks the lanes from it: 0 every
        # device, 1 the single lane, N the first min(N, pool).  Lanes
        # (streams, buffers) are created lazily on the dispatch or warmup
        # thread.
        self._devices = _resolve_devices(devices)
        self.mesh_devices = int(mesh_devices)
        self._lanes: list[_Lane] = []
        self._shard_lane: Optional[_Lane] = None
        self._lanes_ready = False
        self._lanes_lock = new_lock("engine.lanes")
        self._lock = new_lock("engine.queue")
        self._cond = new_cond("engine.queue", self._lock)
        self._queue: deque[_Job] = deque()
        self._closed = False
        # lanes the dispatch thread missed on: the warmup thread warms
        # these first; an item is a lane id (the CRC kernel) or
        # ("lz4", lane id) (the compress kernel, warmed on demand only)
        self._warm_requests: deque = deque()
        # lane id -> the exception its warmup raised (a card that cannot
        # build or launch the kernel fails its tickets, never hides); the
        # compress kernel's failures apart
        self._warm_failed: dict[int, BaseException] = {}
        self._lz4_failed: dict[int, BaseException] = {}
        # single-writer (the dispatch thread; the warmup thread's bump
        # rides the engine lock) with snapshot readers
        self.stats = shared_dict("engine.stats", relaxed=True)
        self.stats.update(
            {"launches": 0, "blocks": 0, "jobs": 0,
             "aggregated": 0, "cpu_fallback_jobs": 0,
             "fanin_waits": 0, "host_jobs": 0,
             "fanin_skips": 0, "warmup_miss_jobs": 0,
             "warmup_compiled": 0, "routed_cpu_jobs": 0,
             "explore_routes": 0, "fused_launches": 0,
             # launches split over every lane (the whole-mesh route)
             "sharded_launches": 0,
             # the dispatch loop's turns
             "turns": 0,
             # thread CPU, counted only while tracing: every turn, the
             # readbacks' device waits, the host work (host jobs,
             # CPU-served groups), and the native pool threads that
             # host work started
             "turn_cpu_ns": 0, "sync_cpu_ns": 0, "host_cpu_ns": 0,
             "native_pool_cpu_ns": 0})
        # the device compress route's counters, kept apart from the CRC
        # stats (same discipline: dispatch-thread writes, snapshot reads)
        self.compress_stats = shared_dict("engine.compress_stats",
                                          relaxed=True)
        self.compress_stats.update(
            {"launches": 0, "blocks": 0, "jobs": 0, "cpu_jobs": 0,
             "warmup_miss_jobs": 0, "routed_cpu_jobs": 0,
             "explore_routes": 0, "fused_crc": 0, "shed_jobs": 0,
             "bytes_in": 0, "bytes_out": 0})
        # per-bucket route split {str(bucket): {"device": n, "cpu": n}}
        self._comp_routed = shared_dict("engine.compress_routed",
                                        relaxed=True)
        # per-stage latency windows (codec_engine.stage_latency):
        # submit->launch wait, launch->readback, the host-side reap
        from ..client.stats import Avg
        self._Avg = Avg
        self.stage_submit_wait = Avg()
        self.stage_launch = Avg()
        self.stage_reap = Avg()
        # instantaneous gauges: in-flight launch depth and the last
        # fan-in occupancy
        self._inflight_cnt = 0
        self._fanin_last = 0
        # this engine holds the compress kernel's warm registry until
        # its close() (lz4_torch.drop_device_kernels)
        _lz4.hold_device_kernels()
        self._lz4_held = True
        self._thread = threading.Thread(target=self._main, daemon=True,
                                        name=name)
        self._thread.start()
        self._warmup_thread = None
        if self.warmup_enabled:
            # name contains "engine" so the conftest thread-leak fixture
            # covers it like the dispatch thread
            self._warmup_thread = threading.Thread(
                target=self._warmup_main, daemon=True,
                name=name + "-warmup")
            self._warmup_thread.start()

    # ------------------------------------------------------------ public --
    def submit(self, bufs: list, poly: str = "crc32c",
               window: bool = True) -> Ticket:
        """Queue a CRC job; returns immediately.  The buffers are joined
        here (one copy, which is also the job's snapshot of them).
        ``window=False`` skips the fan-in wait (synchronous callers that
        already meet the quorum shouldn't pay the aggregation latency —
        whatever is queued at dispatch time still merges in)."""
        if poly not in _crc.POLYS:
            raise ValueError(poly)
        t = Ticket()
        lens = np.fromiter((len(b) for b in bufs), dtype=np.int64,
                           count=len(bufs))
        job = _Job("crc", t, window, b"".join(bufs), lens, poly)
        job.t_submit = time.perf_counter()
        with self._cond:
            if self._closed:
                raise RuntimeError("engine closed")
            self.governor.note_submit(time.monotonic())
            self._queue.append(job)
            self._cond.notify()
        return t

    def submit_compress(self, bufs: list, *, qos=None,
                        window: bool = True) -> Ticket:
        """Queue a device lz4 compress job; resolves to one LZ4F frame per
        buffer: a :class:`packing.FrameBlob` (bytes plus the crc32c of
        each frame part, from the kernel's CRC epilogue) on the device
        route, plain ``bytes`` when the deterministic CPU encoder served
        it; the same bytes either way.  ``qos`` is an optional (topic,
        weight) pair per buffer: the max weight shortens the job's fan-in
        wait and orders it ahead of lighter work, and the topics' byte
        pressure feeds the governor's shed decision."""
        t = Ticket()
        data = [bytes(b) for b in bufs]
        lens = np.fromiter((len(b) for b in data), dtype=np.int64,
                           count=len(data))
        job = _Job("lz4", t, window, data, lens)
        job.t_submit = time.perf_counter()
        if qos:
            per: dict[str, list] = {}
            wmax = 1.0
            for (topic, w), b in zip(qos, data):
                e = per.get(topic)
                if e is None:
                    per[topic] = [float(w), len(b)]
                else:
                    e[1] += len(b)
                wmax = max(wmax, float(w))
            job.topics = tuple(sorted(per))
            job.weight = wmax
            self.governor.note_topics(
                [(topic, w, nb) for topic, (w, nb) in per.items()])
        with self._cond:
            if self._closed:
                raise RuntimeError("engine closed")
            self.governor.note_submit(time.monotonic())
            self._queue.append(job)
            self._cond.notify()
        return t

    def submit_compute(self, fn, *args, host: bool = False,
                       weight: float = 1.0) -> Ticket:
        """Generic pipelined dispatch: run ``fn(*args)`` on the dispatch
        thread.  ``host=False`` runs it on lane 0's stream and treats its
        return value as a tree of tensors, with the same in-flight depth
        and bulk-readback discipline (numpy arrays come back);
        ``host=True`` runs a plain host function (the native decompress
        and compress paths) to completion on the dispatch thread and
        resolves the ticket with its raw return value.  A host job
        overlaps any device launch already in flight: the card executes
        while the dispatch thread runs the (GIL-releasing) native
        call.  ``weight`` is the QoS priority (the max topic weight
        riding the job): the dispatch loop stable-sorts popped jobs by
        descending weight, so a latency topic's host compress never
        queues behind a bulk flood's."""
        t = Ticket()
        job = _Job("host" if host else "compute", t, fn=fn, args=args)
        job.weight = float(weight)
        job.t_submit = time.perf_counter()
        with self._cond:
            if self._closed:
                raise RuntimeError("engine closed")
            self._queue.append(job)
            self._cond.notify()
        return t

    def close(self, timeout: float = 30.0) -> None:
        """Stop the dispatch thread.  Outstanding work drains
        deterministically, per lane: every lane's queued and in-flight
        launches are completed by the exiting thread, and anything it
        could not reach (a wedged or crashed dispatch thread, or a join
        timeout) is FAILED rather than left to hang its waiter in
        Ticket.result().  The staging rings are released once the
        dispatch thread has exited, and this engine's hold on the
        compress kernel's warm registry with them
        (lz4_torch.drop_device_kernels: no warm state outlives the last
        engine, and none is taken from a live one); an engine of several
        lanes also releases the sharded steps (parallel/mesh.py
        release_step_cache)."""
        with self._cond:
            self._closed = True
            held, self._lz4_held = self._lz4_held, False
            self._cond.notify()
        self._thread.join(timeout)
        if self._warmup_thread is not None:
            # the warmup thread checks _closed between lanes; a build in
            # progress finishes (it cannot be cancelled) and the thread
            # exits — deterministic drain, no leak
            self._warmup_thread.join(timeout)
        if held:
            _lz4.drop_device_kernels()
        if self._shard_lane is not None:
            _mesh.release_step_cache()
        if self._thread.is_alive():
            # join timed out: the dispatch thread is wedged.  Fail every
            # job still visible so waiters unblock; first-resolution-wins
            # keeps this safe against the thread completing them
            with self._cond:
                stranded = self._pop_jobs_locked()
            exc = RuntimeError("offload engine closed (dispatch thread "
                               "did not exit in time)")
            for j in stranded:
                j.ticket._fail(exc)
            return
        if self._warmup_thread is None or not self._warmup_thread.is_alive():
            for ln in self._lanes:
                ln.staging.clear()

    def warm_wait(self, timeout: float = 120.0, device: int = 0) -> bool:
        """Block until lane ``device``'s kernel is warm (one kernel
        serves every shape, so there is no bucket to name); returns
        False on timeout, or at once if the lane's warmup failed."""
        dev = self._devices[device]
        deadline = time.monotonic() + timeout
        while not _crc.kernel_ready(dev):
            if (time.monotonic() >= deadline or self._is_closed()
                    or device in self._warm_failed):
                return _crc.kernel_ready(dev)
            time.sleep(0.02)
        return True

    def lz4_warm_wait(self, timeout: float = 120.0, device: int = 0) -> bool:
        """Block until lane ``device``'s compress kernel is warm, asking
        the warmup thread for it (warmed here when the engine has no
        warmup); False on timeout, or at once if its warmup failed."""
        dev = self._devices[device]
        if not _lz4.kernel_ready(dev):
            if not self.warmup_enabled:
                _lz4.warm_kernel(dev)
                return True
            self._request_warm(("lz4", device))
        deadline = time.monotonic() + timeout
        while not _lz4.kernel_ready(dev):
            if (time.monotonic() >= deadline or self._is_closed()
                    or device in self._lz4_failed):
                return _lz4.kernel_ready(dev)
            time.sleep(0.02)
        return True

    def compress_snapshot(self) -> dict:
        """The device compress route's gauges: route counters, bytes in
        and out, the per-bucket device/cpu split, the compress cost
        models and the per-topic QoS table."""
        snap = dict(self.compress_stats)
        snap["routed"] = {b: dict(v)
                          for b, v in sorted(self._comp_routed.items())}
        snap["model"] = self.governor.compress_models()
        snap["qos"] = self.governor.qos_snapshot()
        return snap

    def _is_closed(self) -> bool:
        """Locked read of the closed flag for the warmup thread and test
        hooks (the dispatch loop reads it under the condvar it already
        holds)."""
        with self._lock:
            return self._closed

    def governor_snapshot(self) -> dict:
        """Governor gauges for the statistics JSON."""
        snap = self.governor.snapshot()
        snap["warmup"] = self.warmup_enabled
        return snap

    def stage_latency_snapshot(self) -> dict:
        """Per-stage windowed latency decomposition, in us: submit->launch
        wait, launch->readback (device round trip), the host-side reap,
        and the per-lane launch split (``launch_dev``).  Rolls the
        windows over, like every rd_avg_t emit."""
        return {"submit_wait": self.stage_submit_wait.rollover(),
                "launch": self.stage_launch.rollover(),
                "reap": self.stage_reap.rollover(),
                "launch_dev": {str(ln.dev_id): ln.launch_avg.rollover()
                               for ln in self._lanes}}

    def gauges_snapshot(self) -> dict:
        """Instantaneous pipeline-occupancy gauges: queued jobs not yet
        popped by the dispatch thread, launches in flight awaiting
        readback, and the buffer count the last fan-in window closed
        with."""
        return {"queue_depth": len(self._queue),
                "inflight_launches": self._inflight_cnt,
                "fanin_occupancy": self._fanin_last}

    def devices_snapshot(self) -> list:
        """Per-lane gauges for the statistics JSON (codec_engine.devices[],
        the reference's keys): launch/block/job counts, in-flight depth,
        the governor's per-bucket launch-time EWMAs and the warm-kernel
        count of each device.  Empty until the lanes resolve."""
        return [{"id": ln.dev_id,
                 "launches": ln.launches, "blocks": ln.blocks,
                 "jobs": ln.jobs, "inflight": len(ln.inflight),
                 "dev_launch_ms": self.governor.device_launch_ms(ln.dev_id),
                 "warm_buckets": _crc.warm_bucket_count(ln.device)}
                for ln in self._lanes]

    # ------------------------------------------------------------- lanes --
    def _get_lanes(self) -> list:
        """Resolve the per-device dispatch lanes (dispatch/warmup thread:
        creates the lanes' streams).  ``mesh_devices`` 0 takes every
        device of the pool; more than one lane also creates the
        whole-mesh pseudo-lane that tracks sharded launches."""
        if self._lanes_ready:
            return self._lanes
        with self._lanes_lock:
            if self._lanes_ready:
                return self._lanes
            pool = self._devices
            n = (len(pool) if self.mesh_devices <= 0
                 else min(self.mesh_devices, len(pool)))
            self._lanes = [_Lane(i, d, self.depth + 1, self._Avg())
                           for i, d in enumerate(pool[:n])]
            if n > 1:
                self._shard_lane = _Lane(-1, None, self.depth + 1,
                                         self._Avg())
            self._lanes_ready = True
        return self._lanes

    def _all_lanes(self) -> list:
        return (self._lanes + [self._shard_lane]
                if self._shard_lane is not None else self._lanes)

    def _inflight_total(self) -> int:
        return sum(len(ln.inflight) for ln in self._all_lanes())

    def _oldest_lane(self) -> Optional[_Lane]:
        """The lane holding the oldest in-flight launch (drain order: by
        dispatch time across lanes, so no lane's results are held hostage
        behind a busier one)."""
        best = None
        for ln in self._all_lanes():
            if not ln.inflight:
                continue
            if best is None or ((ln.inflight[0].t0 or 0.0)
                                < (best.inflight[0].t0 or 0.0)):
                best = ln
        return best

    # ----------------------------------------------------- warmup thread --
    def _request_warm(self, item) -> None:
        """A launch missed this lane (``item``: a lane id, or ("lz4", lane
        id)) — move it to the front of the warmup queue, starting the
        warmup thread again if its sweep has ended (compress kernels warm
        on demand only)."""
        with self._lock:
            if self._closed:
                return
            if item not in self._warm_requests:
                self._warm_requests.append(item)
            if self.warmup_enabled and not self._warmup_thread.is_alive():
                self._warmup_thread = threading.Thread(
                    target=self._warmup_main, daemon=True,
                    name=self._name + "-warmup")
                self._warmup_thread.start()

    def _warmup_main(self):
        """Low-priority sweep warming every lane in order (lane 0 first):
        its first pinned slots, then the kernel (crc32c_torch.warm_kernel:
        build, constants, one launch on zeros); then, with several lanes,
        the sharded steps of the standard buckets.  Items the dispatch
        thread missed on jump the queue.  Exits when the sweep is complete
        or the engine closes."""
        lanes = self._get_lanes()
        sweep: list = list(range(len(lanes)))
        if len(lanes) > 1:
            sweep += [("shard", Bs, kind) for Bs in self.SHARD_WARM_BUCKETS
                      for kind in self.WARM_KINDS]
        i = 0
        while True:
            with self._lock:
                if self._closed:
                    return
                item = (self._warm_requests.popleft()
                        if self._warm_requests else None)
            if item is None:
                if i >= len(sweep):
                    return
                item = sweep[i]
                i += 1
            if isinstance(item, tuple):
                if item[0] == "lz4":
                    self._warm_lz4(lanes[item[1]])
                else:
                    self._warm_shard(lanes, item[1], item[2])
                continue
            lane = lanes[item]
            if _crc.kernel_ready(lane.device) or item in self._warm_failed:
                continue
            try:
                lane.staging.prealloc()
                _crc.warm_kernel(lane.device)
            except Exception as e:
                # the lane stays closed; its jobs fail with this error
                self._warm_failed[item] = e
                continue
            # counted under the engine lock: the one stats write NOT on
            # the dispatch thread
            with self._lock:
                self.stats["warmup_compiled"] += 1

    def _warm_shard(self, lanes: list, Bs: int, kind: str) -> None:
        """The warmup thread's ("shard", Bs, kind) item: build the sharded
        CRC step over every lane (parallel/mesh.py warm_sharded_crc).  A
        lane whose warmup failed keeps the split closed; a failing build
        leaves the shape on the whole-lane route."""
        devices = [ln.device for ln in lanes]
        if (_mesh.sharded_crc_ready(devices, Bs, _crc.BLOCK, kind)
                or any(ln.dev_id in self._warm_failed for ln in lanes)):
            return
        try:
            _mesh.warm_sharded_crc(devices, Bs, _crc.BLOCK, kind)
        except Exception:
            # the warmup thread must keep running; a card that cannot
            # build or launch has failed its lane's warmup already, and
            # the groups of this shape stay whole
            return
        with self._lock:
            self.stats["warmup_compiled"] += 1

    def _warm_lz4(self, lane: _Lane) -> None:
        """The warmup thread's compress item: build, constants and one
        checked launch (lz4_torch.warm_kernel); a failure closes the
        lane's compress route with that error."""
        if _lz4.kernel_ready(lane.device) or lane.dev_id in self._lz4_failed:
            return
        try:
            _lz4.warm_kernel(lane.device)
        except Exception as e:
            self._lz4_failed[lane.dev_id] = e
            return
        with self._lock:
            self.stats["warmup_compiled"] += 1

    # ---------------------------------------------------- dispatch thread --
    def _main(self):
        try:
            self._main_loop()
        finally:
            # deterministic shutdown: whether the loop exited cleanly
            # (drained) or died on an unexpected error, no ticket may be
            # left unresolved; every lane fail-or-drains
            with self._cond:
                stranded = self._pop_jobs_locked()
            exc = RuntimeError("offload engine dispatch thread exited")
            for j in stranded:
                j.ticket._fail(exc)
            for lane in self._all_lanes():
                for rec in lane.inflight:
                    if rec.kind in ("crc", "lz4"):
                        for j in rec.jobs:
                            j.ticket._fail(exc)
                    elif rec.ticket is not None:
                        rec.ticket._fail(exc)
                lane.inflight.clear()

    def _main_loop(self):
        traced = False              # the previous turn ran traced
        while True:
            tr = _trace.enabled
            if tr:
                if not traced:
                    # pool CPU from before tracing is nobody's to count
                    _cpu_ops.pool_cpu_take()
                c0 = time.thread_time_ns()
            traced = tr
            stats = self.stats
            stats["turns"] += 1
            with self._cond:
                if not self._queue and not self._closed:
                    # with launches in flight, linger only briefly: a
                    # pipelining submitter's NEXT job should launch
                    # before the oldest readback blocks this thread
                    self._cond.wait(
                        timeout=0.0002 if self._inflight_total() else None)
                if (self._closed and not self._queue
                        and not self._inflight_total()):
                    return
                jobs = self._pop_jobs_locked()
            if jobs:
                jobs = self._fanin(jobs)
                # QoS priority: heavier (latency) jobs launch first; the
                # sort is stable, so weight 1.0 keeps submission order
                jobs.sort(key=lambda j: -j.weight)
                for group in self._group(jobs):
                    rec = self._launch(group)
                    if rec is not None:
                        lane = rec.lane
                        lane.inflight.append(rec)
                        # lane pipeline full: sync that lane's oldest —
                        # every other lane's launches keep executing
                        while len(lane.inflight) > self.depth:
                            self._inflight_cnt = self._inflight_total()
                            self._readback(lane.inflight.popleft())
                    self._inflight_cnt = self._inflight_total()
            else:
                lane = self._oldest_lane()
                if lane is not None:
                    # nothing new queued: drain completed work rather
                    # than hold results hostage waiting for more
                    # submissions
                    self._readback(lane.inflight.popleft())
                    self._inflight_cnt = self._inflight_total()
            if tr:
                stats["turn_cpu_ns"] += time.thread_time_ns() - c0

    def _pop_jobs_locked(self) -> list[_Job]:
        jobs = list(self._queue)
        self._queue.clear()
        return jobs

    def _fanin(self, jobs: list[_Job]) -> list[_Job]:
        """Bounded fan-in: when the windowed CRC jobs are below the
        launch quorum, wait for more submitters before dispatching.  The
        wait is sized by the governor from the submission inter-arrival
        EWMA — ``fanin_window_s`` is the cap; a zero adaptive window
        dispatches immediately, so low-rate traffic stops paying the
        latency tax."""
        if self.fanin_window_s <= 0:
            return jobs
        nbufs = sum(len(j.lens) for j in jobs
                    if j.kind in ("crc", "lz4") and j.window)
        if nbufs == 0 or nbufs >= self.min_batches:
            return jobs
        # weighted admission: the heaviest topic riding this window
        # divides the wait
        wmax = max((j.weight for j in jobs
                    if j.kind in ("crc", "lz4") and j.window), default=1.0)
        window = (self.governor.fanin_window(self.min_batches - nbufs)
                  / max(1.0, wmax))
        if window <= 0:
            self.stats["fanin_skips"] += 1
            self._fanin_last = nbufs
            if _trace.enabled:
                _trace.instant("engine", "fanin_skip",
                               {"bufs": nbufs, "need": self.min_batches})
            return jobs
        self.stats["fanin_waits"] += 1
        t0 = _trace.now() if _trace.enabled else 0
        deadline = time.monotonic() + window
        with self._cond:
            while nbufs < self.min_batches:
                left = deadline - time.monotonic()
                if left <= 0 or self._closed:
                    break
                self._cond.wait(left)
                more = self._pop_jobs_locked()
                jobs.extend(more)
                nbufs += sum(len(j.lens) for j in more
                             if j.kind in ("crc", "lz4") and j.window)
        self._fanin_last = nbufs
        if t0:
            _trace.complete("engine", "fanin_wait", t0,
                            {"bufs": nbufs, "need": self.min_batches,
                             "window_us": round(window * 1e6, 1)})
        return jobs

    def _group(self, jobs: list[_Job]):
        """Launch groups: CRC jobs merge per polynomial — or across BOTH
        polynomials into one fused launch when the governor is on
        (per-segment ``sel``), so a mixed v2/legacy fetch response pays
        one launch instead of two.  lz4 compress jobs merge into one group
        the same way.  Compute/host jobs launch individually."""
        by_poly: dict[str, list[_Job]] = {}
        lz4_group: list[_Job] = []
        order = []
        for j in jobs:
            if j.kind == "lz4":
                if not lz4_group:
                    order.append(lz4_group)
                lz4_group.append(j)
            elif j.kind != "crc":
                order.append([j])
            else:
                if j.poly not in by_poly:
                    by_poly[j.poly] = []
                    order.append(by_poly[j.poly])
                by_poly[j.poly].append(j)
        if self.governor.enabled and len(by_poly) > 1:
            # fuse: one merged group replaces the per-poly groups, at the
            # position of the first CRC group (submission order of
            # non-CRC jobs preserved)
            merged = [j for j in jobs if j.kind == "crc"]
            fused_order = []
            placed = False
            for g in order:
                if g and g[0].kind == "crc":
                    if not placed:
                        fused_order.append(merged)
                        placed = True
                else:
                    fused_order.append(g)
            return fused_order
        return order

    # -------------------------------------------------------------- launch --
    def _launch(self, group: list[_Job]) -> Optional[_Launch]:
        try:
            if group[0].kind == "host":
                # host compute (native decompress/compress): runs to
                # completion here, overlapping whatever device launches
                # are already in flight
                job = group[0]
                self.stats["host_jobs"] += 1
                t0 = _trace.now() if _trace.enabled else 0
                c0 = time.thread_time_ns() if t0 else 0
                job.ticket._complete(job.fn(*job.args))
                if t0:
                    self._note_host_cpu(c0)
                    _trace.complete(
                        "engine", "host_job", t0,
                        {"fn": getattr(job.fn, "__name__", "host")})
                return None
            if group[0].kind == "compute":
                return self._launch_compute(group[0])
            if group[0].kind == "lz4":
                return self._launch_lz4(group)
            return self._launch_crc(group)
        except Exception as e:
            for j in group:
                j.ticket._fail(e)
            return None

    def _launch_compute(self, job: _Job) -> _Launch:
        rec = _Launch("compute")
        rec.ticket = job.ticket
        # compute fns place their own tensors; track the launch on lane 0
        # for depth accounting and drain order
        rec.lane = lane = self._get_lanes()[0]
        rec.t0 = time.perf_counter()
        stream = lane.bufs.stream
        if stream is None:
            rec.out_tree = job.fn(*job.args)
            return rec
        with torch.cuda.stream(stream):
            rec.out_tree = job.fn(*job.args)     # async on the lane
            rec.event = torch.cuda.Event()
            rec.event.record(stream)
        return rec

    def _note_host_cpu(self, c0: int) -> None:
        """Tracing: the thread CPU of host work begun at thread clock
        ``c0``, and what the native pool's threads spent for it."""
        self.stats["host_cpu_ns"] += time.thread_time_ns() - c0
        self.stats["native_pool_cpu_ns"] += _cpu_ops.pool_cpu_take()

    def _serve_cpu(self, group: list[_Job], counter: str) -> None:
        """Serve a group on the CPU provider (bit-identical), timing it
        into the governor's CPU cost estimate."""
        self.stats[counter] += len(group)
        t0 = time.perf_counter()
        tr0 = _trace.now() if _trace.enabled else 0
        c0 = time.thread_time_ns() if tr0 else 0
        nbytes = 0
        for j in group:
            try:
                vals = self.cpu_fallback(j.bufs(), j.poly)
                j.ticket._complete(np.asarray(vals, dtype=np.uint32))
                nbytes += len(j.data)
            except Exception as e:
                j.ticket._fail(e)
        self.governor.note_cpu(nbytes, time.perf_counter() - t0)
        if tr0:
            self._note_host_cpu(c0)
            _trace.complete("engine", "cpu_serve", tr0,
                            {"route": "cpu", "reason": counter,
                             "jobs": len(group), "bytes": nbytes})

    def _serve_cpu_compress(self, group: list[_Job], counter: str, *,
                            shed: bool = False) -> None:
        """Serve a compress group on the deterministic CPU encoder (the
        kernel's bytes by construction), timing it into the governor's
        compress cost model."""
        self.compress_stats[counter] += len(group)
        t0 = time.perf_counter()
        tr0 = _trace.now() if _trace.enabled else 0
        c0 = time.thread_time_ns() if tr0 else 0
        nbytes = 0
        for j in group:
            try:
                j.ticket._complete(self.cpu_compress_fallback(j.bufs()))
                nbytes += int(j.lens.sum())
            except Exception as e:
                j.ticket._fail(e)
            self.governor.note_qos(j.topics, shed=shed)
        self.governor.note_cpu_compress(nbytes, time.perf_counter() - t0)
        if tr0:
            self._note_host_cpu(c0)
            _trace.complete("engine", "cpu_serve", tr0,
                            {"route": "cpu", "reason": counter,
                             "kind": "compress", "jobs": len(group),
                             "bytes": nbytes})

    def _note_comp_route(self, bucket: int, side: str) -> None:
        """Per-bucket device/cpu route split (dispatch-thread writes)."""
        d = self._comp_routed.get(str(bucket))
        if d is None:
            d = {"device": 0, "cpu": 0}
            self._comp_routed[str(bucket)] = d
        d[side] += 1

    def _pick_lane(self, lanes: list, bucket: Optional[int]) -> _Lane:
        """Least-loaded whole-group lane pick: fewest in-flight launches
        first, then the governor's per-lane launch-time EWMA for this
        bucket (unknown sorts first — cold lanes get measured), then
        total launches (round-robin among equals)."""
        return min(lanes, key=lambda ln: (
            len(ln.inflight),
            self.governor.lane_device_s(ln.dev_id, bucket) or 0.0
            if bucket is not None else 0.0,
            ln.launches))

    @staticmethod
    def _chunks(lens: np.ndarray) -> list[tuple[int, int]]:
        """Buffer ranges [start, stop) of a group's launches: at most
        LAUNCH_BYTES of buffers each, a larger buffer alone (the
        synchronous route's split, crc32c_torch._crc_many).  The compress
        route cuts the same way, so a buffer's blocks never split."""
        ends = np.cumsum(lens)
        out, start = [], 0
        while start < len(lens):
            base = int(ends[start] - lens[start])
            stop = max(start + 1, int(np.searchsorted(
                ends, base + _crc.LAUNCH_BYTES, side="right")))
            out.append((start, stop))
            start = stop
        return out

    @staticmethod
    def _shard_bucket(nrows: int, ndev: int) -> int:
        """Per-shard rows of a sharded chunk of ``nrows`` 64 KB blocks over
        ``ndev`` lanes, the JAX engine's bucket (its step-cache key): the
        next power of two from SHARD_MIN_ROWS, at least 128 once a shard
        holds 64 rows."""
        rows = -(-nrows // ndev)
        Bs = next_pow2(rows, lo=AsyncOffloadEngine.SHARD_MIN_ROWS)
        if rows >= 64:
            Bs = max(Bs, 128)
        return Bs

    @staticmethod
    def _shard_chunks(lens: np.ndarray, ndev: int) -> list:
        """A sharded group's launches: at most ``ndev`` x LAUNCH_BYTES of
        buffers each (a larger buffer alone), each cut into ``ndev``
        contiguous shards of about equal bytes at buffer bounds.  Returns
        (cuts, Bs) per launch: shard j holds buffers [cuts[j],
        cuts[j + 1]); Bs is :meth:`_shard_bucket` of its blocks."""
        ends = np.cumsum(lens)
        blocks = (lens + _crc.BLOCK - 1) // _crc.BLOCK
        out, start = [], 0
        while start < len(lens):
            base = int(ends[start] - lens[start])
            stop = max(start + 1, int(np.searchsorted(
                ends, base + _crc.LAUNCH_BYTES * ndev, side="right")))
            # rel[i]: the bytes of the launch's first i buffers
            rel = np.concatenate([[0], ends[start:stop] - base])
            cuts = [start]
            for j in range(1, ndev):
                target = rel[-1] * j / ndev
                k = min(int(np.searchsorted(rel, target)), len(rel) - 1)
                if k > 0 and target - rel[k - 1] <= rel[k] - target:
                    k -= 1          # the nearer buffer bound
                cuts.append(max(cuts[-1], start + k))
            cuts.append(stop)
            out.append((cuts, AsyncOffloadEngine._shard_bucket(
                int(blocks[start:stop].sum()), ndev)))
            start = stop
        return out

    def _launch_crc(self, group: list[_Job]) -> Optional[_Launch]:
        self.stats["jobs"] += len(group)
        if len(group) > 1:
            self.stats["aggregated"] += len(group)
        lens = (np.concatenate([j.lens for j in group]) if group
                else np.zeros(0, np.int64))
        # quorum and ``blocks`` count the 64 KB blocks of each buffer, as
        # the JAX engine does, so both route the same submissions alike
        nblocks = int(((lens + _crc.BLOCK - 1) // _crc.BLOCK).sum())
        if nblocks < self.min_batches and self.cpu_fallback is not None:
            # below the launch quorum even after fan-in (the governor's
            # hard floor): the CPU provider serves these (bit-identical),
            # still off the submitter's thread
            self._serve_cpu(group, "cpu_fallback_jobs")
            return None

        polys = ({j.poly for j in group if int(j.lens.sum())}
                 or {group[0].poly})
        mixed = len(polys) > 1
        kind = "fused" if mixed else next(iter(polys))

        lanes = self._get_lanes()
        ndev = len(lanes)
        # the sharded route, the JAX engine's decision: a group of at
        # least SHARD_MIN_ROWS blocks a lane splits over every lane
        shard = ndev > 1 and nblocks >= ndev * self.SHARD_MIN_ROWS
        if shard:
            schunks = self._shard_chunks(lens, ndev)
            devices = [ln.device for ln in lanes]
            if self.warmup_enabled:
                missing = sorted({Bs for _, Bs in schunks
                                  if not _mesh.sharded_crc_ready(
                                      devices, Bs, _crc.BLOCK, kind)})
                if missing:
                    # the step is not built yet: whole to one lane (never
                    # stall), and ask for it
                    for Bs in missing:
                        self._request_warm(("shard", Bs, kind))
                    shard = False
        if shard:
            lane = self._shard_lane
            # the slot bucket of the first launch's largest shard
            cuts = schunks[0][0]
            ends = np.concatenate([[0], np.cumsum(lens)])
            bucket = _crc.slot_bucket(int(max(
                ends[b] - ends[a] for a, b in zip(cuts, cuts[1:]))))
        else:
            chunks = self._chunks(lens)
            bucket = (_crc.slot_bucket(int(lens[slice(*chunks[0])].sum()))
                      if chunks else None)
            if self.warmup_enabled:
                # warmup gate, per lane: route to any warm lane; with none
                # warm, CPU serves and the picked lane jumps the warmup
                # queue.  A lane whose warmup failed never opens: when
                # every lane failed, the group fails with that error.
                ok = [ln for ln in lanes if _crc.kernel_ready(ln.device)]
                if not ok:
                    failed = [self._warm_failed.get(ln.dev_id)
                              for ln in lanes]
                    if all(failed):
                        raise failed[0]
                    want = self._pick_lane(
                        [ln for ln, f in zip(lanes, failed) if f is None],
                        bucket)
                    self._request_warm(want.dev_id)
                    self._serve_cpu(group, "warmup_miss_jobs")
                    return None
            else:
                ok = lanes
            lane = self._pick_lane(ok, bucket)
        explored = False
        if self.governor.enabled and self.cpu_fallback is not None:
            route, explored = self.governor.route(bucket, int(lens.sum()))
            if explored:
                self.stats["explore_routes"] += 1
            if route == "cpu":
                self._serve_cpu(group, "routed_cpu_jobs")
                return None

        rec = _Launch("crc")
        rec.jobs = group
        rec.lane = lane
        rec.bucket = bucket
        rec.sharded = shard
        # submit->launch wait: the queue + fan-in share of each job's
        # pipeline latency (stage_latency.submit_wait)
        t_launch = time.perf_counter()
        for j in group:
            if j.t_submit:
                self.stage_submit_wait.add((t_launch - j.t_submit) * 1e6)
        rec.t0 = t_launch
        tr0 = _trace.now() if _trace.enabled else 0
        if _metrics.enabled:
            _metrics.counter("engine.launches").inc()
        self.stats["launches"] += 1
        if mixed:
            self.stats["fused_launches"] += 1
        self.stats["blocks"] += nblocks
        if shard:
            self.stats["sharded_launches"] += 1
            self._launch_crc_sharded(rec, lanes, group, lens, schunks, kind)
        else:
            lane.launches += 1
            lane.blocks += nblocks
            lane.jobs += len(group)
            self._launch_crc_lane(rec, lane, group, lens, chunks)
        if tr0:
            # the async dispatch span; governor + lane decisions ride the
            # args (device: the lane id, or -1 for a sharded launch)
            _trace.complete("engine", "device_launch", tr0,
                            {"route": "device", "explored": explored,
                             "fused": mixed, "bucket": bucket,
                             "blocks": nblocks, "jobs": len(group),
                             "device": lane.dev_id, "sharded": shard})
        return rec

    @staticmethod
    def _slicer(group: list[_Job], lens: np.ndarray):
        """(sel per buffer, pieces(a, b)): the polynomial of each of the
        group's buffers, and the bytes of buffers [a, b) as views of the
        jobs' joined snapshots, with no copy."""
        sel = np.repeat(np.array([_crc.POLYS.index(j.poly) for j in group],
                                 dtype=np.int32),
                        [len(j.lens) for j in group])
        # each job's joined bytes start at its buffers' first offset
        datas = [j.data for j in group]
        starts = np.cumsum([0] + [len(d) for d in datas])[:-1].tolist()
        ends = np.cumsum(lens)

        def pieces(a: int, b: int) -> list:
            lo, hi = int(ends[a] - lens[a]), int(ends[b - 1])
            return [memoryview(d)[max(lo, s) - s:min(hi, s + len(d)) - s]
                    for d, s in zip(datas, starts)
                    if s + len(d) > lo and s < hi]

        return sel, pieces

    def _launch_crc_lane(self, rec: _Launch, lane: _Lane,
                         group: list[_Job], lens: np.ndarray,
                         chunks: list) -> None:
        """Whole-to-one-lane dispatch: each chunk planned, filled into a
        slot of the lane's rings, copied in one non-blocking H2D on the
        lane's stream and launched there; nothing here waits on the card
        (but a slot still read by an earlier launch)."""
        sel, pieces = self._slicer(group, lens)
        for a, b in chunks:
            plan = _crc.plan_slot(lens[a:b], sel[a:b])
            slot = lane.staging.take(plan.nbytes)
            rec.chunks.append((slot, plan, lane))
            try:
                _crc.fill_slot(slot, plan, pieces(a, b))
                _crc.send_slot(slot, plan, lane.bufs)
                _crc.launch_slot(slot, plan, lane.bufs)
            except BaseException:
                self._give_back(rec)
                raise

    def _launch_crc_sharded(self, rec: _Launch, lanes: list,
                            group: list[_Job], lens: np.ndarray,
                            schunks: list, kind: str) -> None:
        """Whole-mesh dispatch (kernel G): each launch's shard j is filled
        into a slot of lane j's rings, copied on lane j's stream and
        launched there through the sharded step (parallel/mesh.py), so
        shards on several cards overlap.  Every lane records the shared
        launch and its share of the blocks.  A shard that cannot build or
        launch fails the whole group: no shard goes to the CPU."""
        sel, pieces = self._slicer(group, lens)
        blocks = (lens + _crc.BLOCK - 1) // _crc.BLOCK
        devices = [ln.device for ln in lanes]
        for cuts, Bs in schunks:
            _, step = _mesh.sharded_crc_step(devices, Bs, _crc.BLOCK, kind)
            for j, ln in enumerate(lanes):
                a, b = cuts[j], cuts[j + 1]
                ln.launches += 1
                ln.blocks += int(blocks[a:b].sum())
                if a == b:
                    continue
                plan = _crc.plan_slot(lens[a:b], sel[a:b])
                slot = ln.staging.take(plan.nbytes)
                rec.chunks.append((slot, plan, ln))
                try:
                    _crc.fill_slot(slot, plan, pieces(a, b))
                    _crc.send_slot(slot, plan, ln.bufs)
                    step.launch_slot(slot, plan, ln.bufs)
                except BaseException:
                    self._give_back(rec)
                    raise

    @staticmethod
    def _give_back(rec: _Launch) -> None:
        """Return a CRC launch's slots to their lanes' rings."""
        for slot, _, ln in rec.chunks:
            ln.staging.give_back([slot])

    def _launch_lz4(self, group: list[_Job]) -> Optional[_Launch]:
        """The device compress route: a group's buffers cut into 64 KB
        blocks, packed into pinned slots of a lane's rings, one launch of
        the LZ4 kernel with its CRC epilogue per chunk, governed by the
        compress cost models.  Every CPU route (below quorum, lane not
        warm, CPU-routed, QoS-shed) serves the deterministic CPU encoder:
        the same frames on every route."""
        self.compress_stats["jobs"] += len(group)
        can_cpu = self.cpu_compress_fallback is not None

        # QoS shed: while every lane is saturated, flood topics (a byte
        # share beyond what their weight entitles them to) divert to the
        # CPU encoder so the card stays free for the rest — never the
        # whole group
        if can_cpu and len(group) > 1 and self._lanes_ready:
            saturated = (self._inflight_total()
                         >= self.depth * len(self._all_lanes()))
            shed = self.governor.shed_topics(saturated)
            if shed:
                shed_jobs = [j for j in group
                             if j.topics and set(j.topics) <= shed]
                if shed_jobs and len(shed_jobs) < len(group):
                    keep = set(map(id, shed_jobs))
                    group = [j for j in group if id(j) not in keep]
                    self._serve_cpu_compress(shed_jobs, "shed_jobs",
                                             shed=True)

        lens = np.concatenate([j.lens for j in group])
        nblocks = int((-(-lens // LZ4F_BLOCKSIZE)).sum())
        if nblocks < self.min_batches and can_cpu:
            # below the launch quorum even after fan-in: the hard floor
            self._serve_cpu_compress(group, "cpu_jobs")
            return None
        if nblocks == 0:
            # every buffer empty (and no CPU encoder): header + EndMark
            # frames need no device
            for j in group:
                j.ticket._complete([lz4f_frame([]) for _ in j.lens])
            return None
        # 64 MiB of blocks a launch (crc32c_torch.LAUNCH_BYTES).  The JAX
        # engine caps a launch at 64 rows (LZ4_MAX_B) so that it never
        # holds a TPU lane long; on an H100, 64 rows would be 64 CTAs on
        # 132 SMs.  64 MiB is one produce round of the main path (64
        # partitions x ~1 MB, 1,024 blocks): one launch, about eight CTA
        # waves, staged in one 64 MiB pinned slot.
        chunks = self._chunks(lens)
        bucket = _crc.slot_bucket(int(lens[slice(*chunks[0])].sum()))

        lanes = self._get_lanes()
        ok = lanes
        if self.warmup_enabled:
            # warmup gate, per lane (the CRC gate's shape): with no lane's
            # compress kernel warm, the CPU encoder serves and the picked
            # lane's warm request jumps the queue; a lane whose warmup
            # failed never opens, and with every lane failed the group
            # fails with that error
            ok = [ln for ln in lanes if _lz4.kernel_ready(ln.device)]
            if not ok:
                failed = [self._lz4_failed.get(ln.dev_id) for ln in lanes]
                if all(failed):
                    raise failed[0]
                want = self._pick_lane(
                    [ln for ln, f in zip(lanes, failed) if f is None], None)
                self._request_warm(("lz4", want.dev_id))
                if can_cpu:
                    self._serve_cpu_compress(group, "warmup_miss_jobs")
                    return None
                ok = [want]

        explored = False
        if self.governor.enabled and can_cpu:
            route, explored = self.governor.route_compress(
                bucket, int(lens.sum()))
            if explored:
                self.compress_stats["explore_routes"] += 1
            if route == "cpu":
                self._note_comp_route(bucket, "cpu")
                self._serve_cpu_compress(group, "routed_cpu_jobs")
                return None

        lane = min(ok, key=lambda ln: (
            len(ln.inflight),
            self.governor.lane_compress_s(ln.dev_id, bucket) or 0.0,
            ln.launches))
        # with no warmup thread the kernel is built and checked here, on
        # its first use (a failure fails the group)
        _lz4.warm_kernel(lane.device)
        rec = _Launch("lz4")
        rec.jobs = group
        rec.lane = lane
        rec.bucket = bucket
        rec.raw = [b for j in group for b in j.bufs()]
        t_launch = time.perf_counter()
        for j in group:
            if j.t_submit:
                self.stage_submit_wait.add((t_launch - j.t_submit) * 1e6)
        rec.t0 = t_launch
        tr0 = _trace.now() if _trace.enabled else 0
        if _metrics.enabled:
            _metrics.counter("engine.launches").inc()
        self.compress_stats["launches"] += 1
        self.compress_stats["blocks"] += nblocks
        self.compress_stats["bytes_in"] += int(lens.sum())
        self._note_comp_route(bucket, "device")
        lane.launches += 1
        lane.blocks += nblocks
        lane.jobs += len(group)
        for a, b in chunks:
            plan = _lz4.plan_lz4(lens[a:b])
            slot = lane.staging.take(plan.nbytes)
            try:
                _lz4.fill_lz4(slot, plan, rec.raw[a:b])
                handle = _lz4.launch_lz4(slot, plan, lane.bufs)
            except BaseException:
                lane.staging.give_back([slot] + [c[0] for c in rec.chunks])
                raise
            rec.chunks.append((slot, plan, handle))
        for j in group:
            self.governor.note_qos(j.topics, shed=False)
        if tr0:
            _trace.complete("engine", "compress_launch", tr0,
                            {"route": "device", "explored": explored,
                             "bucket": bucket, "blocks": nblocks,
                             "jobs": len(group), "device": lane.dev_id})
        return rec

    # ------------------------------------------------------------ readback --
    def _readback(self, rec: _Launch) -> None:
        if _lockdep.enabled:
            # the device sync below can stall for a full launch round
            # trip — holding any lock here would freeze submitters
            _lockdep.note_blocking("engine.readback")
        try:
            if rec.kind == "compute":
                t0 = _trace.now() if _trace.enabled else 0
                c0 = time.thread_time_ns() if t0 else 0
                if rec.event is not None:
                    rec.event.synchronize()
                if t0:
                    self.stats["sync_cpu_ns"] += time.thread_time_ns() - c0
                rec.ticket._complete(_to_host(rec.out_tree))
                if t0:
                    _trace.complete("engine", "readback", t0,
                                    {"kind": "compute"})
                return
            if rec.kind == "lz4":
                self._readback_lz4(rec)
                return
            self._readback_crc(rec)
        except Exception as e:
            if rec.kind == "compute":
                rec.ticket._fail(e)
            else:
                for j in rec.jobs:
                    j.ticket._fail(e)

    def _readback_lz4(self, rec: _Launch) -> None:
        """Read a compress launch back and assemble the LZ4F frames: one
        launch gave the compressed blocks AND the CRCs of both candidate
        bodies of each block, so the store-raw choice (compressed iff
        strictly smaller) picks its CRC for free and the v2 batch CRC is
        a host-side combine away (FrameBlob.region_crc)."""
        tr0 = _trace.now() if _trace.enabled else 0
        c0 = time.thread_time_ns() if tr0 else 0
        try:
            parts = [_lz4.read_lz4(slot, plan, handle, rec.lane.rb_stream)
                     for slot, plan, handle in rec.chunks]
        finally:
            rec.lane.staging.give_back([c[0] for c in rec.chunks])
        if tr0:
            self.stats["sync_cpu_ns"] += time.thread_time_ns() - c0
        if rec.t0 is not None:
            dt = time.perf_counter() - rec.t0
            self.governor.note_device_compress(rec.bucket, dt,
                                               rec.lane.dev_id)
            rec.lane.launch_avg.add(dt * 1e6)
            self.stage_launch.add(dt * 1e6)
        t_reap = time.perf_counter()
        self.compress_stats["fused_crc"] += 1
        frames, nblocks = [], 0
        for (_, plan, _), (packed, offs, olen, cc, cr) in zip(rec.chunks,
                                                            parts):
            mv = memoryview(packed)
            for first, nb in plan.spans:
                buf = memoryview(rec.raw[len(frames)])
                bodies = []
                for k in range(nb):
                    i = first + k
                    o = int(offs[i])
                    raw = buf[k * LZ4F_BLOCKSIZE:(k + 1) * LZ4F_BLOCKSIZE]
                    bodies.append((mv[o:o + int(olen[i])].tobytes(),
                                   int(cc[i]), raw, int(cr[i])))
                frames.append(lz4f_frame(bodies))
            nblocks += plan.B
        self.compress_stats["bytes_out"] += sum(len(f) for f in frames)
        pos = 0
        for j in rec.jobs:
            j.ticket._complete(frames[pos:pos + len(j.lens)])
            pos += len(j.lens)
        if tr0:
            _trace.complete("engine", "fused_crc", tr0,
                            {"bucket": rec.bucket, "frames": len(frames),
                             "blocks": nblocks, "device": rec.lane.dev_id})
        self.stage_reap.add((time.perf_counter() - t_reap) * 1e6)

    def _readback_crc(self, rec: _Launch) -> None:
        tr0 = _trace.now() if _trace.enabled else 0
        c0 = time.thread_time_ns() if tr0 else 0
        # ONE event wait + vectorized uint32 view per launch (per shard
        # of a sharded one, every shard waited before any ticket
        # resolves) — no per-item int(x) loop
        try:
            parts = [_crc.read_slot(slot, plan)
                     for slot, plan, _ in rec.chunks]
        finally:
            self._give_back(rec)
        if tr0:
            self.stats["sync_cpu_ns"] += time.thread_time_ns() - c0
        crcs = (parts[0] if len(parts) == 1 else
                np.concatenate(parts) if parts else
                np.zeros(0, dtype=np.uint32))
        # launch latency feeds the governor's per-(lane, bucket) model
        # AND the stage_latency.launch window (dispatch -> bulk sync); a
        # sharded launch records under every lane (the whole mesh was
        # busy for that window)
        if rec.t0 is not None:
            dt = time.perf_counter() - rec.t0
            for ln in (self._lanes if rec.sharded else [rec.lane]):
                self.governor.note_device(rec.bucket, dt, ln.dev_id)
                ln.launch_avg.add(dt * 1e6)
            self.stage_launch.add(dt * 1e6)
        t_reap = time.perf_counter()
        if tr0:
            _trace.complete("engine", "readback", tr0,
                            {"kind": "crc", "bucket": rec.bucket,
                             "jobs": len(rec.jobs),
                             "device": rec.lane.dev_id})
        # slice the results back out per job in submission order
        pos = 0
        for j in rec.jobs:
            n = len(j.lens)
            j.ticket._complete(crcs[pos:pos + n])
            pos += n
        self.stage_reap.add((time.perf_counter() - t_reap) * 1e6)
