"""The codec kernels over several devices: the port of
librdkafka_tpu/parallel/mesh.py.

The JAX package lays independent per-partition blocks along the 1-D
``batch`` axis of a ``jax.sharding.Mesh`` and shard_maps the
single-device body over it, so each chip works on its contiguous row
shard and only a byte counter crosses chips (a ``psum``).  The port keeps
that layout with plain torch devices:

  * :class:`Mesh` is the device list along ``"batch"``.  A device may
    repeat (``["cuda:0"] * 4``, ``["cpu"] * 8``): launches on one card run
    one after another (crc32c_torch.serialized_launch), so the shards of
    a repeated card are a series, not a scale-out.
  * Kernel G, the sharded CRC step (:func:`sharded_crc_step`), launches
    the CRC kernel (csrc/crc_rows.cu, through ``crc32c_torch.crc_rows``)
    once per shard, on that shard's device and stream.  The async offload
    engine's sharded launches (ops/engine.py) go through the same step,
    one shard a lane from that lane's pinned staging
    (:meth:`_CrcStep.launch_slot`).
  * Kernel H, the sharded codec step (:func:`sharded_codec_step`,
    :func:`shard_compress`), launches the LZ4 kernel (csrc/lz4_rows.cu,
    ``lz4_torch.lz4_rows``) once per shard, with the raw rows' CRC32C
    epilogue when ``with_crc``; each device sums its valid rows'
    compressed lengths and the sums meet on the first device (the
    reference's ``psum``).

Neither step has a kernel body of its own: the reference's local body is
the single-device body, and so is the port's.  On a CPU device a shard
runs the kernel's plain PyTorch version; on a card it launches the kernel
or raises.  ``crc_launches`` and ``codec_launches`` count the shard
launches G and H made on a card.

Steps live in a bounded LRU (``_STEP_CACHE``, 16 entries) keyed by kind,
devices and shape, holding each step's per-device state (streams, and
through the kernels' warm registries the device constants);
:func:`release_step_cache` is the close-time hook of the engine and the
provider, and the tests assert ``step_cache_count() == 0`` after each.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..ops import crc32c_torch as _crc
from ..ops import lz4_torch as _lz4
from ..ops.packing import next_pow2, pad_right

#: shard kernel launches made on a card by G (the sharded CRC step and
#: the engine's sharded launches) and by H (the sharded codec step)
crc_launches = 0
codec_launches = 0
_count_lock = threading.Lock()


def _count(crc: int = 0, codec: int = 0) -> None:
    global crc_launches, codec_launches
    with _count_lock:
        crc_launches += crc
        codec_launches += codec


def _resolve(device) -> torch.device:
    """A mesh device, its card index resolved; a card that is not
    visible raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] * n to "
                               "run the steps on the kernels' plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} is not visible: "
                               f"{torch.cuda.device_count()} card(s)")
    return dev


class Mesh:
    """A 1-D mesh of torch devices along the axis ``"batch"``."""

    axis_names = ("batch",)

    def __init__(self, devices):
        self.devices = tuple(_resolve(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """The first ``n_devices`` of ``devices`` (default: the visible
    cards, raising on a host without CUDA) as a :class:`Mesh`; asking
    for more devices than there are raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] * n to "
                               "run the steps on the kernels' plain versions")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise RuntimeError(f"need {n_devices} devices, have "
                               f"{len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices)


def _keys(devices) -> tuple:
    return tuple(str(_resolve(d)) for d in devices)


# Bounded LRU of built steps, keyed by (kind, devices, shape...).
_STEP_CACHE: OrderedDict = OrderedDict()
_STEP_CACHE_MAX = 16
_STEP_LOCK = threading.Lock()


def _step_cache_get(key):
    with _STEP_LOCK:
        v = _STEP_CACHE.get(key)
        if v is not None:
            _STEP_CACHE.move_to_end(key)
        return v


def _step_cache_put(key, val):
    with _STEP_LOCK:
        _STEP_CACHE[key] = val
        _STEP_CACHE.move_to_end(key)
        while len(_STEP_CACHE) > _STEP_CACHE_MAX:
            _STEP_CACHE.popitem(last=False)


def step_cache_count() -> int:
    """Live cached steps (the tests' leak gauge)."""
    with _STEP_LOCK:
        return len(_STEP_CACHE)


def release_step_cache() -> None:
    """Close-time hook: drop every cached step (engine close, provider
    close, test teardown).  Steps are rebuilt on next use."""
    with _STEP_LOCK:
        _STEP_CACHE.clear()


def _streams(mesh: Mesh) -> list:
    """One stream per shard on a card (None on the CPU)."""
    return [torch.cuda.Stream(d) if d.type == "cuda" else None
            for d in mesh.devices]


def _rows(x: np.ndarray, j: int, Bs: int) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x[j * Bs:(j + 1) * Bs]))


# ------------------------------------------------------------ kernel G --

class _CrcStep:
    """Kernel G's state for (devices, Bs, N, kind): the mesh and a stream
    per shard.  Built only once every device's CRC kernel is warm
    (crc32c_torch.warm_kernel: the build, the device constants and one
    checked launch), so a device that cannot build or launch raises
    here."""

    def __init__(self, devices, Bs: int, N: int, kind: str):
        if kind not in _crc.POLYS + ("fused",):
            raise ValueError(kind)
        self.mesh = Mesh(devices)
        self.Bs, self.N, self.kind = int(Bs), int(N), kind
        for dev in dict.fromkeys(self.mesh.devices):
            _crc.warm_kernel(dev)
        self.streams = _streams(self.mesh)

    def __call__(self, data, terms, sel=None) -> np.ndarray:
        """data (Bs*ndev, N) uint8 left-padded rows, terms (Bs*ndev,)
        uint32 (the term f(~0, 0^n) of each row's length), sel
        (Bs*ndev,) uint32 (0 crc32c, 1 crc32) when kind is "fused":
        (Bs*ndev,) uint32 CRCs, each shard checksummed on its device."""
        data = np.asarray(data, dtype=np.uint8)
        terms = np.asarray(terms).astype(np.int64)
        B = self.Bs * self.mesh.size
        if data.shape != (B, self.N) or terms.shape != (B,):
            raise ValueError(f"data must be ({B}, {self.N}) and terms "
                             f"({B},), not {data.shape} and {terms.shape}")
        if self.kind == "fused":
            if sel is None:
                raise ValueError("a fused step takes sel")
            sel = np.asarray(sel).astype(np.int32)
        else:
            sel = np.full((B,), _crc.POLYS.index(self.kind), np.int32)
        outs = []
        for j, (dev, stream) in enumerate(zip(self.mesh.devices,
                                              self.streams)):
            d, t, s = (_rows(x, j, self.Bs) for x in (data, terms, sel))
            if stream is None:
                outs.append((_crc.crc_rows(d, t, s), None))
                continue
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                out = _crc.crc_rows(d.to(dev, non_blocking=True),
                                    t.to(dev, non_blocking=True),
                                    s.to(dev, non_blocking=True))
                host = torch.empty(out.shape, dtype=torch.int64,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            _count(crc=1)
            outs.append((host, done))
        for _, done in outs:            # every shard in flight, then wait
            if done is not None:
                done.synchronize()
        return np.concatenate([o.numpy() for o, _ in outs]).astype(np.uint32)

    def launch_slot(self, slot, plan, bufs) -> None:
        """One shard of the engine's sharded launch: the CRC kernel on the
        shard's packed segments, from its lane's pinned ``slot`` into the
        lane's device buffers on the lane's stream
        (crc32c_torch.launch_slot; the plain version on a CPU lane)."""
        _crc.launch_slot(slot, plan, bufs)
        if bufs.stream is not None and plan.S:
            _count(crc=1)


def _crc_step_key(devices, Bs: int, N: int, kind: str) -> tuple:
    return ("crc", _keys(devices), int(Bs), int(N), kind)


def sharded_crc_ready(devices, Bs: int, N: int, kind: str) -> bool:
    """True once the sharded CRC step for (devices, per-shard rows Bs,
    row width N, kind) is built: the engine's warm gate for the split
    route (kind: 'crc32c' | 'crc32' | 'fused')."""
    return _step_cache_get(_crc_step_key(devices, Bs, N, kind)) is not None


def sharded_crc_step(devices, Bs: int, N: int, kind: str):
    """(mesh, step) for the sharded CRC launch; ``step(data, terms[,
    sel])`` checksums (Bs*ndev, N) left-padded rows, each device its
    contiguous Bs-row shard (see :class:`_CrcStep`).  Cached in the
    bounded LRU."""
    key = _crc_step_key(devices, Bs, N, kind)
    cached = _step_cache_get(key)
    if cached is not None:
        return cached
    step = _CrcStep(devices, Bs, N, kind)
    val = (step.mesh, step)
    _step_cache_put(key, val)
    return val


def warm_sharded_crc(devices, Bs: int, N: int, kind: str) -> None:
    """Build the sharded CRC step off the hot path (the engine's warmup
    thread).  One kernel serves every shape, so the step is warm once
    each of its devices is and its streams exist: no launch at the
    step's shape.  Idempotent."""
    if not sharded_crc_ready(devices, Bs, N, kind):
        sharded_crc_step(devices, Bs, N, kind)


def sharded_crc_reference(mesh: Mesh, data, terms, sel) -> np.ndarray:
    """Kernel G's function in plain PyTorch: each contiguous row shard
    through crc32c_torch.crc_segments_reference (as rows: offsets b·N,
    lengths N, with ``terms``) on its mesh device, concatenated.  ``sel``
    (B,) picks each row's polynomial."""
    data = np.asarray(data, dtype=np.uint8)
    B, N = data.shape
    Bs = B // mesh.size
    outs = []
    for j, dev in enumerate(mesh.devices):
        d = _rows(data, j, Bs).reshape(-1).to(dev)
        n = len(d) // N
        outs.append(_crc.crc_segments_reference(
            d, torch.arange(n, dtype=torch.int64) * N,
            torch.full((n,), N, dtype=torch.int64),
            _rows(np.asarray(sel).astype(np.int32), j, Bs),
            _rows(np.asarray(terms).astype(np.int64), j, Bs)).cpu())
    return torch.cat(outs).numpy().astype(np.uint32)


# ------------------------------------------------------------ kernel H --

class _CodecStep:
    """Kernel H's state for (devices, N, with_crc): the mesh and a stream
    per shard, built once every device's LZ4 kernel is warm
    (lz4_torch.warm_kernel: the build and one launch checked against the
    plain version)."""

    def __init__(self, mesh: Mesh, N: int, with_crc: bool):
        self.mesh = mesh
        self.N, self.with_crc = int(N), bool(with_crc)
        for dev in dict.fromkeys(mesh.devices):
            _lz4.warm_kernel(dev)
        self.streams = _streams(mesh)

    def __call__(self, data, lens, valid):
        """data (B, N) uint8 right-padded, lens (B,) int32, valid (B,)
        int32 row mask, B a multiple of the mesh size →
        (compressed (B, W) uint8 zeroed past olen, W the widest row, olen
        (B,) int32[, crc32c of the raw rows (B,) uint32, total compressed
        bytes of the valid rows]); the last two only with ``with_crc``."""
        data = np.asarray(data, dtype=np.uint8)
        lens = np.asarray(lens).astype(np.int32)
        valid = np.asarray(valid).astype(np.int64)
        B = len(data)
        ndev = self.mesh.size
        if data.shape != (B, self.N) or B % ndev:
            raise ValueError(f"data must be (B, {self.N}) with B a multiple "
                             f"of {ndev}, not {data.shape}")
        Bs = B // ndev
        mode = "raw" if self.with_crc else "none"
        shards = []
        for j, (dev, stream) in enumerate(zip(self.mesh.devices,
                                              self.streams)):
            d, ln, v = (_rows(x, j, Bs) for x in (data, lens, valid))
            if stream is None:
                comp, olen, _, cr = _lz4.lz4_rows(d, ln, mode)
                part = (olen.to(torch.int64) * v).sum()
                shards.append((comp, olen, cr, part))
                continue
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                comp, olen, _, cr = _lz4.lz4_rows(
                    d.to(dev, non_blocking=True),
                    ln.to(dev, non_blocking=True), mode)
                part = (olen.to(torch.int64)
                        * v.to(dev, non_blocking=True)).sum()
            _count(codec=1)
            shards.append((comp, olen, cr, part))
        return self._gather(shards)

    def _gather(self, shards):
        """Every shard is queued: read the lengths, then only the bytes
        up to the widest row, and sum the shards' totals on the first
        device (the psum)."""
        olens = []
        for (comp, olen, _, _), stream in zip(shards, self.streams):
            if stream is not None:
                with torch.cuda.device(comp.device), \
                        torch.cuda.stream(stream):
                    olen = olen.cpu()
            olens.append(olen.numpy())
        olen = np.concatenate(olens)
        width = int(olen.max()) if len(olen) else 0
        outs = []
        for (comp, _, _, _), stream in zip(shards, self.streams):
            if stream is None:
                outs.append(comp[:, :width].numpy())
                continue
            with torch.cuda.device(comp.device), torch.cuda.stream(stream):
                outs.append(comp[:, :width].cpu().numpy())
        out = np.concatenate(outs)
        if not self.with_crc:
            return out, olen
        # each stream has run past its sum (the lengths' copy above
        # waited for it): peer copies to the first device, summed there
        first = self.mesh.devices[0]
        total = int(torch.stack([s[3].to(first) for s in shards]).sum())
        crc = np.concatenate([cr.cpu().numpy() for _, _, cr, _ in shards])
        return out, olen, crc.astype(np.uint32), total


def sharded_codec_step(mesh: Mesh, N: int, with_crc: bool = True):
    """The multi-device codec step for (B, N) blocks, B a multiple of the
    mesh size: ``fn(data, lens, valid)`` (see :class:`_CodecStep`).
    ``with_crc=False`` builds a compress-only step (no CRC, no sum) for
    callers that checksum elsewhere, e.g. the codec provider, whose batch
    CRC covers the assembled record batch.  Cached in the bounded LRU."""
    key = ("codec", _keys(mesh.devices), int(N), bool(with_crc))
    cached = _step_cache_get(key)
    if cached is not None:
        return cached
    fn = _CodecStep(mesh, N, with_crc)
    _step_cache_put(key, fn)
    return fn


def sharded_codec_reference(mesh: Mesh, data, lens, valid,
                            with_crc: bool = True):
    """Kernel H's function in plain PyTorch: each contiguous row shard
    through lz4_torch.lz4_rows_reference on its mesh device, the valid
    rows' compressed lengths summed in Python.  Returns (compressed (B,
    C), olen, crc or None, total or None) as numpy arrays and an int."""
    data = np.asarray(data, dtype=np.uint8)
    Bs = len(data) // mesh.size
    mode = "raw" if with_crc else "none"
    comp, olen, crc = [], [], []
    for j, dev in enumerate(mesh.devices):
        c, o, _, r = _lz4.lz4_rows_reference(
            _rows(data, j, Bs).to(dev),
            _rows(np.asarray(lens).astype(np.int32), j, Bs).to(dev), mode)
        comp.append(c.cpu().numpy())
        olen.append(o.cpu().numpy())
        if r is not None:
            crc.append(r.cpu().numpy())
    olen = np.concatenate(olen)
    total = (sum(int(n) for n, v in zip(olen, np.asarray(valid)) if v)
             if with_crc else None)
    return (np.concatenate(comp), olen,
            np.concatenate(crc).astype(np.uint32) if with_crc else None,
            total)


def shard_compress(mesh: Mesh, blocks: list, with_crc: bool = True):
    """Compress blocks across the mesh (B padded up to a mesh multiple
    with empty rows that count in nothing).  Returns (compressed blocks,
    crc32c of the raw blocks, total compressed bytes), with crcs None and
    total 0 when ``with_crc=False``.  An empty block list short-circuits
    without building a step."""
    if not blocks:
        return [], (np.zeros((0,), np.uint32) if with_crc else None), 0
    ndev = mesh.size
    N = next_pow2(max(len(b) for b in blocks))
    data, lens = pad_right(blocks, N)
    B = len(blocks)
    Bp = -(-B // ndev) * ndev
    valid = np.ones((B,), np.int32)
    if Bp != B:
        data = np.concatenate([data, np.zeros((Bp - B, N), np.uint8)])
        lens = np.concatenate([lens, np.zeros((Bp - B,), np.int32)])
        valid = np.concatenate([valid, np.zeros((Bp - B,), np.int32)])
    res = sharded_codec_step(mesh, N, with_crc)(data, lens, valid)
    if with_crc:
        out, olen, crc, total = res
    else:
        (out, olen), crc, total = res, None, 0
    return ([out[i, :olen[i]].tobytes() for i in range(B)],
            None if crc is None else crc[:B], int(total))
