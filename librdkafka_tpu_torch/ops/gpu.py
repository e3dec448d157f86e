"""GPU codec provider — the port of librdkafka_tpu/ops/tpu.py.

The same MsgsetCodecProvider interface as the CPU provider; the batched
checksums and, when asked for, the lz4 compression leave the host:

  * ``crc32c_many`` / ``crc32_many``: at and above ``min_batches``
    buffers and with the transport gate open, through the async offload
    engine (ops/engine.py: pinned staging rings, a stream per lane, the
    governor) as one ticket resolved at once; with ``pipeline_depth=0``
    one synchronous launch of the hand-written segment kernel per 64 MB
    of buffers (ops/crc32c_torch.py, csrc/crc_rows.cu), as tpu.py:453-467
    and :480-500 route them; below the quorum, the CPU provider.
  * ``crc32c_submit`` / ``crc32_submit``: the engine's tickets, so the
    caller frames round k+1 while round k is checksummed; None when the
    engine is off or the gate closed (the caller then computes
    synchronously).
  * ``compress_submit``: with ``compress_device`` (``tpu.compress.device``)
    and lz4, the engine's device compress route (``submit_compress``):
    one launch of the LZ4 kernel with its CRC epilogue
    (ops/lz4_torch.py, csrc/lz4_rows.cu) per round, resolving to LZ4F
    frames that carry the CRC of each part, so the writer folds the v2
    batch CRC with no CRC launch.  Its bytes are the deterministic native
    encoder's (``cpu.lz4f_compress_many(deterministic=True)``), not the
    default fast parse's.  Otherwise an engine host job running the
    native codec on the dispatch thread, in QoS weight order.
  * ``compress_many`` with ``lz4_force`` (``tpu.lz4.force``): the
    synchronous device route, every 64 KB block of every buffer in one
    launch (``lz4_torch.lz4_block_compress_many``), or with
    ``mesh_devices`` > 1 one launch a device of the mesh
    (parallel/mesh.py ``shard_compress``), frames assembled on the host;
    same bytes as the deterministic native encoder.
  * ``decompress_submit``: engine host jobs running the native CPU
    decoders on the dispatch thread, overlapping the in-flight launches.

The transport gate (``min_transport_mb_s``) measures a pinned
host-to-device round trip in a SUBPROCESS, so a client the gate routes
to the CPU never initializes CUDA in its own process.  A CPU device has
no transport: its gate is always open.  Wire bytes are identical to the
CPU provider's by construction.
"""
from __future__ import annotations

import threading

import torch

from . import cpu as _cpu
from . import crc32c_torch
from . import lz4_torch
from ..analysis.locks import new_lock
from ..analysis.races import shared
from ..parallel import mesh as _par_mesh
from .packing import LZ4F_BLOCKSIZE, lz4f_frame

#: the device pool of ``device="cpu"``: eight lanes of the plain version,
#: the device count the JAX package's tests give its CPU backend
#: (tests/conftest.py, --xla_force_host_platform_device_count=8)
CPU_POOL = 8

#: the probe body, run OUT OF PROCESS (see _probe_transport): a pinned
#: host-to-device copy and its way back, timed after one warm round trip;
#: the rate counts the bytes moved in BOTH directions
_PROBE_SRC = (
    "import sys, time\n"
    "import torch\n"
    "if not torch.cuda.is_available():\n"
    "    sys.exit(3)\n"
    "dev = torch.device(sys.argv[1])\n"
    "h = torch.zeros(4 << 16, dtype=torch.uint8).pin_memory()\n"
    "back = torch.empty_like(h).pin_memory()\n"
    "back.copy_(h.to(dev, non_blocking=True), non_blocking=True)\n"
    "torch.cuda.synchronize(dev)\n"
    "t0 = time.perf_counter()\n"
    "back.copy_(h.to(dev, non_blocking=True), non_blocking=True)\n"
    "torch.cuda.synchronize(dev)\n"
    "dt = max(time.perf_counter() - t0, 1e-9)\n"
    "print((2 * h.numel() / (1 << 20)) / dt)\n")


def probe_cache_path(device) -> str:
    """Where the transport probe's reading is cached: per user, per
    package (the JAX provider's file is ``tk_transport_*``), per visible
    card set (``CUDA_VISIBLE_DEVICES``) and per device."""
    import os
    import tempfile
    vis = os.environ.get("CUDA_VISIBLE_DEVICES", "all") or "none"
    key = f"{vis}_{device}".replace(",", "-").replace(":", "-")
    return os.path.join(tempfile.gettempdir(),
                        f"tk_torch_transport_{os.getuid()}_{key}.json")


class GpuCodecProvider:
    """MsgsetCodecProvider with the CRC batches on the GPU.

    ``device=None`` is the card (``cuda``, one engine lane per visible
    card); a host without CUDA raises rather than serving from the CPU.
    ``device="cpu"`` runs the kernel's plain PyTorch version on the host
    (the tests' route).  The defaults are the JAX provider's:
    ``pipeline_depth=2`` (the engine; 0 = the synchronous route),
    ``fanin_us=500``, ``governor=True``, ``warmup=True``,
    ``min_transport_mb_s=100`` (0 disables the gate), and the device lz4
    routes off: ``compress_device=False`` (the engine's compress route)
    and ``lz4_force=False`` (the synchronous one).

    ``mesh_devices`` (``gpu.mesh.devices``) picks the engine's lanes from
    the device pool: 0 every device, 1 one lane, N the first min(N,
    pool).  The pool of ``cuda`` is the visible cards, of ``cuda:N`` that
    card, of ``cpu`` :data:`CPU_POOL` lanes; the knob never repeats a
    card.  Above 1 it also shards the ``lz4_force`` route over a mesh of
    as many devices."""

    name = "gpu"
    #: the writer phase may pass per-buffer (topic, weight) QoS pairs to
    #: compress_submit
    accepts_qos = True

    # relaxed lockset declarations (analysis/races.py): the engine handle
    # is created once under gpu.engine_init and only READ lock-free
    # afterwards (object-reference loads are atomic)
    _engine = shared("gpu.engine", relaxed=True)
    _mesh = shared("gpu.mesh", relaxed=True)

    def __init__(self, min_batches: int = 4, device=None,
                 warmup: bool = True, min_transport_mb_s: float = 100.0,
                 pipeline_depth: int = 2, fanin_us: int = 500,
                 governor: bool = True, compress_device: bool = False,
                 lz4_force: bool = False, mesh_devices: int = 0):
        # below this many independent buffers a launch isn't worth it;
        # fall back to the CPU provider (identical bytes either way).
        self.min_batches = max(1, int(min_batches))
        self.device = crc32c_torch.resolve_device(device)
        self.min_transport_mb_s = float(min_transport_mb_s)
        self.transport_mb_s: float | None = None      # measured by probe
        self._probe_lock = new_lock("gpu.probe")
        self.pipeline_depth = int(pipeline_depth)
        self.fanin_us = int(fanin_us)
        self.governor = bool(governor)
        self.warmup = bool(warmup)       # the engine's warmup too
        # tpu.compress.device: producer lz4 through the engine's device
        # compress route; tpu.lz4.force: compress_many's lz4 on the card
        self.compress_device = bool(compress_device)
        self.lz4_force = bool(lz4_force)
        self.mesh_devices = int(mesh_devices or 0)
        self._mesh = None
        self._engine = None
        self._engine_closed = False
        self._engine_lock = new_lock("gpu.engine_init")
        self._cpu = _cpu.CpuCodecProvider()
        self._warmup_thread = None
        if warmup:
            # probe transport FIRST: when the gate is closed every launch
            # self-routes to CPU, so the build would never be used
            def _warm():
                try:
                    if self._offload_pays():
                        crc32c_torch.warm_kernel(self.device)
                    if self.lz4_force:
                        # the synchronous E route's build and first launch
                        lz4_torch.lz4_block_compress_many(
                            [bytes(LZ4F_BLOCKSIZE)], self.device)
                except Exception:
                    pass        # the route raises at its first launch

            self._warmup_thread = threading.Thread(
                target=_warm, daemon=True, name="gpu-codec-warmup")
            self._warmup_thread.start()

    # ---------------------------------------------------- transport gate --
    def _probe_transport(self) -> float:
        """Measure host<->device bandwidth once, in a SUBPROCESS, with a
        disk cache (only a positive reading is cached).  A probe failure
        is held in memory as 0.0: a broken card must not receive
        traffic."""
        with self._probe_lock:
            if self.transport_mb_s is not None:
                return self.transport_mb_s
            if self.device.type == "cpu":
                # no transport to gate: the "device" is host memory
                self.transport_mb_s = float("inf")
                return self.transport_mb_s
            self.transport_mb_s = _probe_cached(str(self.device))
            return self.transport_mb_s

    def _offload_pays(self) -> bool:
        """True when the measured transport clears the gate (or the gate
        is disabled).  Probes lazily if the warmup thread hasn't yet."""
        if self.min_transport_mb_s <= 0:
            return True
        return self._probe_transport() >= self.min_transport_mb_s

    def wait_warm(self, timeout: float = 120.0) -> bool:
        """Block until the route is open: the warmup thread (probe and
        kernel) has ended and, with the engine on, its lane 0 is warm —
        its compress kernel too with ``compress_device``.  True when the
        device route is open."""
        if self._warmup_thread is not None:
            self._warmup_thread.join(timeout)
        if not self._offload_pays():
            return False
        eng = self._get_engine()
        if eng is None or not eng.warmup_enabled:
            crc32c_torch.warm_kernel(self.device)
            if eng is not None and self.compress_device:
                return eng.lz4_warm_wait(timeout)
            return True
        if not eng.warm_wait(timeout):
            return False
        return not self.compress_device or eng.lz4_warm_wait(timeout)

    # -------------------------------------------------------------- lz4 --
    def _lz4f_compress_many(self, bufs: list[bytes]) -> list[bytes]:
        """The synchronous device lz4 route: every 64 KB block of every
        buffer in one launch of the LZ4 kernel, frames assembled on the
        host with the native encoders' store-raw rule."""
        blocks: list = []
        spans: list[tuple[int, int]] = []      # (first block, count) a buf
        for b in bufs:
            mv = memoryview(bytes(b))
            first = len(blocks)
            for pos in range(0, len(mv), LZ4F_BLOCKSIZE):
                blocks.append(mv[pos:pos + LZ4F_BLOCKSIZE])
            spans.append((first, len(blocks) - first))
        mesh = self._get_mesh()
        if mesh is not None:
            cblocks, _, _ = _par_mesh.shard_compress(mesh, blocks,
                                                     with_crc=False)
        else:
            cblocks = lz4_torch.lz4_block_compress_many(blocks, self.device)
        # the frame's part CRCs are not needed here: 0 stands in for them
        return [bytes(lz4f_frame([(cblocks[i], 0, blocks[i], 0)
                                  for i in range(first, first + nb)]))
                for first, nb in spans]

    # -------------------------------------------------------- interface --
    def compress_many(self, codec: str, bufs: list[bytes], level: int = -1
                      ) -> list[bytes]:
        """lz4 on the card with ``lz4_force`` (at quorum): the
        deterministic encoder's bytes; everything else on the native CPU
        path (lz4 there is the default fast parse)."""
        if (codec == "lz4" and self.lz4_force
                and len(bufs) >= self.min_batches):
            return self._lz4f_compress_many(bufs)
        return self._cpu.compress_many(codec, bufs, level)

    def decompress_many(self, codec: str, bufs: list[bytes],
                        size_hints: list[int] | None = None) -> list[bytes]:
        return self._cpu.decompress_many(codec, bufs, size_hints)

    def decompress_submit(self, codec: str, bufs: list[bytes],
                          size_hints: list[int] | None = None):
        """Pipelined fetch decompress: the native ``*_decompress_many``
        on the engine's dispatch thread as a host job, so the caller
        frames the NEXT partition while this one inflates — overlapping
        any in-flight CRC launch too.  None when the pipeline is off."""
        eng = self._get_engine()
        if eng is None:
            return None
        return eng.submit_compute(self._cpu.decompress_many, codec, bufs,
                                  size_hints, host=True)

    def compress_submit(self, codec: str, bufs: list[bytes],
                        level: int = -1, qos=None):
        """Pipelined producer compress, two routes:

        * **device** — lz4 with ``compress_device`` on and the transport
          gate open (or ``lz4_force``): the engine's compress route, one
          launch of the LZ4 kernel with its CRC epilogue per chunk,
          resolving to LZ4F frames (:class:`packing.FrameBlob`) that
          carry per-part CRCs.  Bytes of
          ``cpu.lz4f_compress_many(deterministic=True)``; the governor
          may route a group to that CPU encoder.
        * **host job** — everything else: compress_many on the engine's
          dispatch thread, so compression of round k+1 overlaps the
          in-flight launch of round k, dispatched in ``qos`` weight
          order.

        ``qos`` is an optional per-buffer ``(topic, weight)`` list.  None
        when the pipeline is off."""
        eng = self._get_engine()
        if eng is None:
            return None
        if (codec == "lz4" and self.compress_device
                and (self.lz4_force or self._offload_pays())):
            return eng.submit_compress(
                bufs, qos=qos, window=len(bufs) < self.min_batches)
        weight = (max((w for _, w in qos), default=1.0) if qos else 1.0)
        return eng.submit_compute(self.compress_many, codec, bufs, level,
                                  host=True, weight=weight)

    def crc32c_submit(self, bufs: list[bytes]):
        """Async pipelined CRC32C: a Ticket resolving to a uint32 ndarray
        (one checksum per buffer, bit-identical to the CPU provider), or
        None when the CPU path is the right route (gate closed, pipeline
        off).  Below-quorum submissions ride the engine's fan-in window,
        merging with other submitters' batches into one launch."""
        if not self._offload_pays():
            return None
        eng = self._get_engine()
        if eng is None:
            return None
        return eng.submit(bufs, poly="crc32c",
                          window=len(bufs) < self.min_batches)

    def crc32_submit(self, bufs: list[bytes]):
        """The legacy (zlib-poly) mirror of :meth:`crc32c_submit`, for
        the MsgVer0/1 fetch verify.  The engine's warmup gate serves from
        the CPU provider until its lane is warm."""
        if not self._offload_pays():
            return None
        eng = self._get_engine()
        if eng is None:
            return None
        return eng.submit(bufs, poly="crc32",
                          window=len(bufs) < self.min_batches)

    def crc32c_many(self, bufs: list[bytes]) -> list[int]:
        return self._crc_many(bufs, "crc32c")

    def crc32_many(self, bufs: list[bytes]) -> list[int]:
        """Legacy MsgVer0/1 zlib-poly CRC on the same kernel."""
        return self._crc_many(bufs, "crc32")

    def _crc_many(self, bufs: list[bytes], poly: str) -> list[int]:
        if len(bufs) >= self.min_batches and self._offload_pays():
            eng = self._get_engine()
            if eng is not None:
                # engine route: pinned staging + bulk readback;
                # window=False — a synchronous caller already at quorum
                # must not pay the fan-in latency
                return eng.submit(bufs, poly,
                                  window=False).result().tolist()
            return crc32c_torch._crc_many(bufs, poly, self.device).tolist()
        return self._cpu_crc_fallback(bufs, poly)

    def fused_codec_id(self, codec: str) -> int | None:
        """The fused native batch build (tk_torch_enqlane.build_batch) is
        allowed only when this provider would route BOTH the compress and
        the CRC to the CPU anyway (lz4 not forced onto the card, transport
        gate closed): then it is exactly the CPU provider's fused path.
        With the device route open (None) the 3-phase pipeline keeps the
        batched CRC, and with ``compress_device`` the lz4, on the card."""
        if self.lz4_force or self._offload_pays():
            return None
        return self._cpu.fused_codec_id(codec)

    # ------------------------------------------------- pipelined offload --
    def _pool(self) -> list:
        """The devices the lanes are taken from (see the class doc)."""
        if self.device.type == "cpu":
            return [self.device] * CPU_POOL
        if self.device.index is None:
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [self.device]

    def _get_mesh(self):
        """The lz4_force route's mesh: the first min(mesh_devices, pool)
        devices, when that is more than one."""
        if self._mesh is None and self.mesh_devices > 1:
            pool = self._pool()
            n = min(self.mesh_devices, len(pool))
            if n > 1:
                self._mesh = _par_mesh.make_mesh(n, pool)
        return self._mesh

    def _get_engine(self):
        """The async offload engine (ops/engine.py), created on first
        use.  None when ``pipeline_depth=0`` or after close()."""
        if self.pipeline_depth <= 0 or self._engine_closed:
            return None
        if self._engine is None:
            with self._engine_lock:
                if self._engine is None and not self._engine_closed:
                    from .engine import AsyncOffloadEngine
                    self._engine = AsyncOffloadEngine(
                        depth=self.pipeline_depth,
                        fanin_window_s=self.fanin_us / 1e6,
                        min_batches=self.min_batches,
                        cpu_fallback=self._cpu_crc_fallback,
                        cpu_compress_fallback=self._cpu_lz4_fallback,
                        name="gpu-codec-engine",
                        governor=self.governor,
                        warmup=self.warmup,
                        devices=self._pool(),
                        mesh_devices=self.mesh_devices)
        return self._engine

    def _cpu_crc_fallback(self, bufs, poly: str) -> list[int]:
        return (self._cpu.crc32c_many(bufs) if poly == "crc32c"
                else self._cpu.crc32_many(bufs))

    def _cpu_lz4_fallback(self, bufs) -> list[bytes]:
        """The deterministic (insert-all) native encoder: the kernel's
        bytes, so governor re-routes, warmup misses and shed jobs give the
        same frames.  Not the CPU provider's fast parse, which emits a
        different (equally valid) LZ4F stream."""
        return _cpu.lz4f_compress_many([bytes(b) for b in bufs],
                                       deterministic=True)

    def close(self) -> None:
        """Tear down the async engine (drains in-flight launches) and
        join the warmup thread; the provider keeps serving synchronously
        afterwards — a straggling codec job must not respawn a dispatch
        thread post-close.  A provider that built an lz4 mesh also
        releases the sharded steps (parallel/mesh.py
        release_step_cache)."""
        with self._engine_lock:
            self._engine_closed = True
            eng, self._engine = self._engine, None
        if eng is not None:
            eng.close()
        if self._warmup_thread is not None:
            self._warmup_thread.join(30.0)
            self._warmup_thread = None
        if self._mesh is not None:
            self._mesh = None
            _par_mesh.release_step_cache()


def _probe_cached(device: str, ttl: float = 900.0) -> float:
    """The transport probe's reading for ``device`` in MB/s: from the
    disk cache when it is ours and fresh, else from a subprocess running
    _PROBE_SRC; 0.0 when the probe fails."""
    import json
    import os
    import subprocess
    import sys
    import time
    cache = probe_cache_path(device)
    try:
        st = os.stat(cache)
        # the temp dir is world-writable: only trust a file we own
        if st.st_uid == os.getuid() and time.time() - st.st_mtime < ttl:
            with open(cache) as f:
                return float(json.load(f)["mb_s"])
    except (OSError, ValueError, KeyError):
        pass
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE_SRC, device],
                             capture_output=True, timeout=300)
        v = float(out.stdout.split()[-1]) if out.returncode == 0 else 0.0
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        v = 0.0
    if v > 0:
        try:
            tmp = cache + f".{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"mb_s": v}, f)
            os.replace(tmp, cache)
        except OSError:
            pass
    return v

