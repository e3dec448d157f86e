"""Batched CRC32C / CRC32 on an NVIDIA GPU — bit-exact with src/crc32c.c
and src/rdcrc32.c.

The port of librdkafka_tpu/ops/crc32c_jax.py's main-path route (the
``_crc_many_mxu`` driver and its row kernels).  The checksum of MANY
buffers is computed in one device launch over packed ragged segments:

  - The buffers are joined, with no padding, into one uint8 array
    ``flat``; segment s is ``flat[offsets[s]:offsets[s] + lengths[s]]``
    and ``sel[s]`` picks its polynomial (0 crc32c, 1 crc32).  One copy of
    ``flat`` and one of the metadata cross to the card.
  - The kernel (``csrc/crc_rows.cu``) cuts each segment into tiles
    counted back from its end and returns the standard CRC of every
    segment, whatever its length: no host term, no 64 KB split, no
    ``crc32c_combine`` on the host.
  - With ``terms`` it keeps the TPU's row contract instead: it folds from
    a ZERO register and returns ``~(raw ^ terms)``.  CRC folding is
    GF(2)-linear, f(~0, data) = f(~0, 0^n) XOR f(0, data), and leading
    zeros are a no-op under a zero register, so a left-padded row with
    the host term f(~0, 0^n) (:func:`_term_host`) gives the CRC.
    :func:`crc_rows` is that contract on (B, N) rows, through the same
    kernel.

:func:`crc_segments` is the kernel's wrapper.  On a CUDA tensor it
launches the hand-written kernel (built with nvcc at first use, loaded
with ctypes) or raises; on a CPU tensor it runs
:func:`crc_segments_reference`, the plain PyTorch version of the same
function.  ``launches`` counts kernel launches and ``h2d_bytes`` the
bytes the route copies to the card.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from functools import lru_cache

import numpy as np
import torch

from ..utils.crc import (TABLE8_CRC32, TABLE_CRC32C, ZERO_OP_CRC32,
                         ZERO_OP_CRC32C, crc32c)

BLOCK = 65536        # the TPU row width of the row contract (crc_rows)
POLYS = ("crc32c", "crc32")   # sel value = index: 0 crc32c, 1 crc32
# The kernel's geometry (csrc/crc_rows.cu: kPiece, kTile, kShifts): a
# thread folds PIECE bytes, a block one TILE, combined by SHIFTS shift
# tables over PIECE << k bytes.
PIECE = 64
TILE = 256 * PIECE
SHIFTS = 9
LAUNCH_BYTES = 64 << 20      # bytes of ``flat`` per launch in _crc_many

#: kernel launches made by :func:`crc_segments` (not by the plain version)
launches = 0
#: bytes the CRC route copied host → device (``flat`` and metadata)
h2d_bytes = 0

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU_SRC = os.path.join(_PKG, "csrc", "crc_rows.cu")
CU_HEADER = os.path.join(_PKG, "csrc", "crc_fold.cuh")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "librdkafka_tpu_torch")
SO = os.path.join(BUILD_DIR, "libcrc_rows.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lib_lock = threading.Lock()
#: nvcc's output of the last build (ptxas register / spill report)
build_log = ""


# ------------------------------------------------------------ host math --

def _poly_tables(poly: str):
    """(slice-by-8 tables, ZERO_OP matrices) for a poly tag.  Both
    reflected init=~0 xorout=~0 CRCs share the whole affine machinery;
    only these two constants differ (reference: crc32c.c vs rdcrc32.c)."""
    if poly == "crc32c":
        return TABLE_CRC32C, ZERO_OP_CRC32C
    if poly == "crc32":
        return TABLE8_CRC32, ZERO_OP_CRC32
    raise ValueError(poly)


def _apply_host(cols: np.ndarray, v: int) -> int:
    """Apply a GF(2) 32x32 matrix (column form) to the register v."""
    acc = 0
    i = 0
    v = int(v)
    while v:
        if v & 1:
            acc ^= int(cols[i])
        v >>= 1
        i += 1
    return acc


@lru_cache(maxsize=1024)
def _term_host(n: int, poly: str = "crc32c") -> int:
    """f(~0, 0^n): the length-dependent affine term, host-side."""
    _, zop = _poly_tables(poly)
    v = 0xFFFFFFFF
    k = 0
    while n:
        if n & 1:
            v = _apply_host(zop[k], v)
        n >>= 1
        k += 1
    return v


def _mat_pow_cols(nbytes: int, poly: str) -> list[int]:
    """Columns of M^nbytes: advance a register through nbytes zeros."""
    _, zop = _poly_tables(poly)
    cols = [1 << i for i in range(32)]
    k = 0
    while nbytes:
        if nbytes & 1:
            cols = [_apply_host(zop[k], c) for c in cols]
        nbytes >>= 1
        k += 1
    return cols


@lru_cache(maxsize=16)
def _shift_tables(nbytes: int, poly: str) -> np.ndarray:
    """(4, 256) tables: SHIFT[k][b] = M^nbytes applied to (b << 8k)."""
    cols = _mat_pow_cols(nbytes, poly)
    out = np.zeros((4, 256), dtype=np.int64)
    for k in range(4):
        for b in range(256):
            out[k][b] = _apply_host(cols, b << (8 * k))
    return out


def _gf2_inverse(cols) -> list[int]:
    """Columns of the inverse of a GF(2) 32x32 matrix (column form), by
    Gauss-Jordan elimination on rows [A | I]."""
    rows = [sum(((int(cols[c]) >> r) & 1) << c for c in range(32))
            | (1 << (32 + r)) for r in range(32)]
    for c in range(32):
        p = next(r for r in range(c, 32) if (rows[r] >> c) & 1)
        rows[c], rows[p] = rows[p], rows[c]
        for r in range(32):
            if r != c and (rows[r] >> c) & 1:
                rows[r] ^= rows[c]
    inv_rows = [r >> 32 for r in rows]
    return [sum(((inv_rows[r] >> c) & 1) << r for r in range(32))
            for c in range(32)]


def _nibble_tables(nbytes: int, poly: str) -> np.ndarray:
    """(8, 16) tables: N[k][v] = M^nbytes applied to (v << 4k)."""
    cols = _mat_pow_cols(nbytes, poly)
    return np.array([[_apply_host(cols, v << (4 * k)) for v in range(16)]
                     for k in range(8)], dtype=np.uint32)


@lru_cache(maxsize=2)
def _kernel_consts(poly: str) -> np.ndarray:
    """The kernel's constants for one polynomial, uint32: its slice-by-8
    step as 16 nibble tables (16, 16), table j holding the byte table of
    byte j // 2 of the 8 folded at the nibble's place; zero-shift nibble
    tables (8, 16) over PIECE << k bytes for k < SHIFTS; then M^-m for
    m = 0..15 as 32 columns, which undoes the m trailing zeros up to a
    segment's 16-byte-aligned end."""
    t8, zop = _poly_tables(poly)
    t8 = np.asarray(t8, np.uint32)
    fold = t8[7 - np.arange(16)[:, None] // 2,
              np.arange(16)[None, :] << (4 * (np.arange(16)[:, None] % 2))]
    inv1 = _gf2_inverse(zop[0])
    inv = [[1 << i for i in range(32)]]
    for _ in range(15):
        inv.append([_apply_host(inv1, c) for c in inv[-1]])
    return np.concatenate(
        [fold.ravel()]
        + [_nibble_tables(PIECE << k, poly).ravel() for k in range(SHIFTS)]
        + [np.asarray(inv, np.uint32).ravel()])


def plan_tiles(offsets: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The kernel's tile list: each segment is cut into TILE-byte tiles
    counted back from its 16-byte-aligned end; tiles of one segment are
    adjacent.  Returns (T, 4) int32 rows of {window start, segment start,
    segment end, segment}."""
    start = offsets.astype(np.int64)
    end = start + lengths.astype(np.int64)
    aligned_end = (end + 15) & ~15
    n = np.maximum(1, -(-(aligned_end - (start & ~15)) // TILE))
    seg = np.repeat(np.arange(len(n)), n)
    first = np.cumsum(n) - n
    k = np.arange(len(seg)) - first[seg]
    vs = aligned_end[seg] - (n[seg] - k) * TILE
    return np.stack([vs, start[seg], end[seg], seg], axis=1).astype(np.int32)


# ------------------------------------------------------- plain version --

def _pick_kl(N: int) -> tuple[int, int]:
    """Chunk layout: K parallel lanes of L bytes, L % 8 == 0, K*L == N."""
    K = max(1, min(128, N // 64))
    while N % (K * 8) != 0:
        K //= 2
    return K, N // K


def crc_rows_reference(data: torch.Tensor, terms: torch.Tensor,
                       sel: torch.Tensor) -> torch.Tensor:
    """The row kernel's function in plain PyTorch, on CPU or CUDA tensors.

    data (B, N) uint8, rows left-padded; terms (B,) int64 holding the
    uint32 term f(~0, 0^n); sel (B,) int32 (0 = crc32c, 1 = crc32).
    Returns (B,) int64 holding ``~(raw ^ terms) & 0xFFFFFFFF``.

    Form: the chunk scan + shift-table fold of the JAX package's
    ``_crc_kernel`` (crc32c_jax.py:99-127) for both polynomials at once,
    each row looking up its own polynomial's tables.  Registers are
    carried in int64 masked to 32 bits: CPU torch has no uint32 shifts,
    and int32 ``>>`` is arithmetic.
    """
    B, N = data.shape
    dev = data.device
    K, L = _pick_kl(N)
    t8 = torch.from_numpy(np.stack([_poly_tables(p)[0] for p in POLYS])
                          .astype(np.int64)).reshape(-1).to(dev)
    poly = (sel != 0).to(torch.int64)      # as the kernel: nonzero = crc32
    base = (poly * 2048).view(B, 1)
    d = data.reshape(B, K, L).to(torch.int64)

    def tab(k: int, idx: torch.Tensor) -> torch.Tensor:
        return t8[base + (k * 256) + idx]

    # 1. raw register fold of each chunk from zero, 8 bytes per step
    crc = torch.zeros((B, K), dtype=torch.int64, device=dev)
    for s in range(0, L, 8):
        b = d[:, :, s:s + 8]
        lo = (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
              | (b[..., 3] << 24)) ^ crc
        crc = (tab(7, lo & 0xFF) ^ tab(6, (lo >> 8) & 0xFF)
               ^ tab(5, (lo >> 16) & 0xFF) ^ tab(4, (lo >> 24) & 0xFF)
               ^ tab(3, b[..., 4]) ^ tab(2, b[..., 5])
               ^ tab(1, b[..., 6]) ^ tab(0, b[..., 7]))

    # 2. fold chunks left to right: raw = shift_L(raw) ^ chunk_k
    st = torch.from_numpy(np.stack([_shift_tables(L, p) for p in POLYS])
                          ).reshape(-1).to(dev)
    sbase = poly * 1024
    raw = torch.zeros((B,), dtype=torch.int64, device=dev)
    for k in range(K):
        raw = (st[sbase + (raw & 0xFF)]
               ^ st[sbase + 256 + ((raw >> 8) & 0xFF)]
               ^ st[sbase + 512 + ((raw >> 16) & 0xFF)]
               ^ st[sbase + 768 + ((raw >> 24) & 0xFF)]) ^ crc[:, k]

    # 3. the host-computed affine term, then the final inversion
    return (raw ^ terms.to(torch.int64)) ^ 0xFFFFFFFF


def _term_torch(lengths: torch.Tensor, poly: torch.Tensor) -> torch.Tensor:
    """f(~0, 0^n) per segment in torch: binary exponentiation over the
    ZERO_OP matrices of each segment's polynomial (int64 holding uint32)."""
    dev = lengths.device
    zop = torch.from_numpy(np.stack([_poly_tables(p)[1] for p in POLYS])
                           .astype(np.int64)).to(dev)
    v = torch.full(lengths.shape, 0xFFFFFFFF, dtype=torch.int64, device=dev)
    top = int(lengths.max()) if lengths.numel() else 0
    for k in range(top.bit_length()):
        cols = zop[poly, k]                               # (S, 32)
        acc = torch.zeros_like(v)
        for i in range(32):
            acc ^= ((v >> i) & 1) * cols[:, i]
        v = torch.where(((lengths >> k) & 1) == 1, acc, v)
    return v


def crc_segments_reference(flat: torch.Tensor, offsets: torch.Tensor,
                           lengths: torch.Tensor, sel: torch.Tensor,
                           terms: torch.Tensor | None = None) -> torch.Tensor:
    """The segment kernel's function in plain PyTorch, on flat's device.

    Each segment is rebuilt as a left-padded row of width
    max(4096, next_pow2(length)) and folded by :func:`crc_rows_reference`;
    without ``terms`` the term f(~0, 0^n) comes from :func:`_term_torch`.
    Segments are taken in groups of about 4 MB of rows."""
    dev = flat.device
    offsets, lengths, sel = (x.to(dev) for x in (offsets, lengths, sel))
    poly = (sel != 0).to(torch.int64)
    if terms is None:
        terms = _term_torch(lengths, poly)
    terms = terms.to(dev)
    out = torch.zeros(offsets.shape, dtype=torch.int64, device=dev)
    ext = torch.cat([flat, flat.new_zeros(1)])     # index M reads a zero
    widths = [max(4096, 1 << max(0, int(n) - 1).bit_length())
              for n in lengths.tolist()]
    by_width: dict[int, list[int]] = {}
    for s, w in enumerate(widths):
        by_width.setdefault(w, []).append(s)
    for N, segs in by_width.items():
        step = max(1, (4 << 20) // N)
        for i in range(0, len(segs), step):
            idx = torch.tensor(segs[i:i + step], dtype=torch.int64,
                               device=dev)
            col = torch.arange(N, dtype=torch.int64, device=dev)
            lead = (N - lengths[idx]).view(-1, 1)
            pos = offsets[idx].view(-1, 1) - lead + col
            pos = torch.where(col >= lead, pos, flat.numel())
            out[idx] = crc_rows_reference(ext[pos], terms[idx],
                                          poly[idx].to(torch.int32))
    return out


# -------------------------------------------------------- CUDA kernel --

def build_kernel(src: str, so: str, flags=()) -> tuple[str, str]:
    """nvcc one ``csrc/*.cu`` (with the shared ``crc_fold.cuh``) into
    ``so`` under build/librdkafka_tpu_torch/ when it is missing or older
    than its sources, with ``flags`` added to NVCC_FLAGS; returns (so,
    nvcc's output, "" when up to date)."""
    newest = max(os.path.getmtime(src), os.path.getmtime(CU_HEADER))
    if os.path.exists(so) and os.path.getmtime(so) >= newest:
        return so, ""
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    res = subprocess.run([nvcc, *NVCC_FLAGS, *flags, "-o", tmp, src],
                         capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    os.replace(tmp, so)
    return so, log


def _build() -> str:
    """nvcc csrc/crc_rows.cu into build/librdkafka_tpu_torch/ if stale."""
    global build_log
    so, log = build_kernel(CU_SRC, SO)
    build_log = log or build_log
    return so


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            L = ctypes.CDLL(_build())
            vp = ctypes.c_void_p
            L.crc_segments_launch.argtypes = [vp] * 7 + [
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, vp]
            L.crc_segments_launch.restype = ctypes.c_int
            _lib = L
    return _lib


_DEV_CONSTS: dict = {}
_consts_lock = threading.Lock()


def _device_consts(dev: torch.device) -> torch.Tensor:
    """Both polynomials' :func:`_kernel_consts` as one int32 tensor of
    uint32 bit patterns on ``dev``, uploaded once per device."""
    key = str(dev)
    with _consts_lock:
        if key not in _DEV_CONSTS:
            c = np.concatenate([_kernel_consts(p) for p in POLYS])
            t = torch.from_numpy(c.view(np.int32)).to(dev)
            # landed before any stream reads it, not only this one's
            torch.cuda.current_stream(dev).synchronize()
            _DEV_CONSTS[key] = t
        return _DEV_CONSTS[key]


def _check_rows(data, terms, sel) -> tuple[int, int]:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("data must be a (B, N) uint8 tensor")
    B, N = data.shape
    if N < 4096 or N & (N - 1):
        raise ValueError(f"row width {N} must be a power of two >= 4096")
    if terms.shape != (B,) or terms.dtype != torch.int64:
        raise ValueError("terms must be a (B,) int64 tensor")
    if sel.shape != (B,) or sel.dtype != torch.int32:
        raise ValueError("sel must be a (B,) int32 tensor")
    if not (terms.device == sel.device == data.device):
        raise ValueError("data, terms and sel must share a device")
    return B, N


def crc_rows(data: torch.Tensor, terms: torch.Tensor,
             sel: torch.Tensor) -> torch.Tensor:
    """``~(fold(row) ^ terms) & 0xFFFFFFFF`` per left-padded row, (B,)
    int64: the TPU row contract.  CUDA tensors launch the segment kernel
    with offsets b·N and lengths N; CPU tensors run
    :func:`crc_rows_reference`."""
    B, N = _check_rows(data, terms, sel)
    if data.device.type == "cpu":
        return crc_rows_reference(data, terms, sel)
    if data.device.type != "cuda":
        raise ValueError(f"crc_rows: unsupported device {data.device}")
    return crc_segments(data.reshape(-1),
                        torch.arange(B, dtype=torch.int64) * N,
                        torch.full((B,), N, dtype=torch.int64), sel, terms)


def _check_segments(flat, offsets, lengths, sel, terms):
    """Validate the segment inputs; returns host (offsets, lengths)."""
    if flat.dtype != torch.uint8 or flat.dim() != 1:
        raise ValueError("flat must be a (M,) uint8 tensor")
    S = offsets.shape[0] if offsets.dim() == 1 else -1
    for name, t, dt in (("offsets", offsets, torch.int64),
                        ("lengths", lengths, torch.int64),
                        ("sel", sel, torch.int32),
                        ("terms", terms, torch.int64)):
        if t is None:
            continue
        if t.shape != (S,) or t.dtype != dt:
            raise ValueError(f"{name} must be a (S,) {dt} tensor")
        if t.device.type != "cpu" and t.device != flat.device:
            raise ValueError(f"{name} must lie on the CPU or on flat's "
                             f"device")
    off = offsets.cpu().numpy()
    ln = lengths.cpu().numpy()
    if S and ((off < 0).any() or (ln < 0).any()
              or (off + ln > flat.numel()).any()):
        raise ValueError("a segment lies outside flat")
    return off, ln


def crc_segments(flat: torch.Tensor, offsets: torch.Tensor,
                 lengths: torch.Tensor, sel: torch.Tensor,
                 terms: torch.Tensor | None = None) -> torch.Tensor:
    """CRC of each segment ``flat[offsets[s]:offsets[s] + lengths[s]]``
    with the polynomial ``sel[s]`` (0 crc32c, 1 crc32), (S,) int64.
    Without ``terms`` the standard CRC; with ``terms`` the row contract
    ``~(fold from zero ^ terms)``.

    flat (M,) uint8; offsets, lengths (S,) int64 and sel (S,) int32 and
    terms (S,) int64 on the CPU or on flat's device (they are read on
    the host, which plans the tiles).  A CUDA ``flat`` launches
    ``csrc/crc_rows.cu``; a CPU ``flat`` runs
    :func:`crc_segments_reference`."""
    if flat.device.type == "cpu":
        _check_segments(flat, offsets, lengths, sel, terms)
        return crc_segments_reference(flat, offsets, lengths, sel, terms)
    return launch(stage(flat, offsets, lengths, sel, terms))


def stage(flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor,
          sel: torch.Tensor, terms: torch.Tensor | None = None) -> tuple:
    """Check the inputs of :func:`crc_segments` on a CUDA ``flat``, plan
    the tiles and put the launch's inputs on the card: the metadata
    (tiles, sel, terms) crosses in ONE int64 tensor.  Returns what
    :func:`launch` takes; a staged launch may be fired again, which is
    how it is timed alone."""
    global h2d_bytes
    off, ln = _check_segments(flat, offsets, lengths, sel, terms)
    if flat.device.type != "cuda":
        raise ValueError(f"crc_segments: unsupported device {flat.device}")
    if flat.numel() > (1 << 31) - 16:
        raise ValueError("flat must hold under 2 GiB: the kernel's tile "
                         "positions are int32")
    if flat.numel() % 16 or flat.data_ptr() % 16:   # the kernel's copies
        flat = torch.cat([flat, flat.new_zeros(-flat.numel() % 16)])
    dev = flat.device
    tiles = plan_tiles(off, ln)
    sel_h = sel.cpu().numpy()
    # tiles first (16 B each, so aligned), then sel padded to 8 B, terms
    parts = [tiles.reshape(-1).view(np.int64),
             np.concatenate([sel_h, np.zeros(len(sel_h) % 2, np.int32)])
             .view(np.int64)]
    if terms is not None:
        parts.append(terms.cpu().numpy())
    meta = torch.from_numpy(np.concatenate(parts)).to(dev)
    h2d_bytes += meta.numel() * 8
    sel_at = meta.data_ptr() + tiles.nbytes
    terms_at = None if terms is None else sel_at + parts[1].nbytes
    # one polynomial's constants in shared memory when sel is uniform
    crc32 = sel_h != 0
    uniform = len(crc32) == 0 or crc32.all() or not crc32.any()
    poly_first = int(crc32[0]) if uniform and len(crc32) else 0

    scratch = torch.zeros((len(tiles),), dtype=torch.int64, device=dev)
    out = torch.empty((len(off),), dtype=torch.int64, device=dev)
    args = (flat.data_ptr(), meta.data_ptr(), sel_at, terms_at,
            _device_consts(dev).data_ptr(), scratch.data_ptr(),
            out.data_ptr(), len(tiles), poly_first, 1 if uniform else 2)
    return out, args, (flat, meta, scratch)


#: per device index, (stream, event) of the last kernel launch: launches
#: on one card run one after another whatever their stream (see launch)
_CHAIN: dict = {}
_chain_lock = threading.Lock()


def chained_launch(stream, fire, done, what: str) -> None:
    """Enqueue one kernel on ``stream`` after the card's last launch of
    this package.

    The CRC grid is cooperative and its blocks wait on each other's
    tiles, so no other launch of the port may share the card with it: a
    launch on another stream than the card's last one first waits, on
    the device, for that one's end.  ``fire(wait)`` queues the launch and
    returns a cudaError_t; ``wait`` is the torch Event of the card's last
    launch when ``stream`` must wait for it, else None.  ``done`` is the
    Event that ``fire`` records behind the launch.  Launches go out one at
    a time under a lock, which also makes each device's first launch (a
    kernel's one-time attribute and occupancy setup) happen once."""
    idx = stream.device_index
    with _chain_lock:
        last = _CHAIN.get(idx)
        err = fire(last[1] if last is not None and last[0] != stream
                   else None)
        if err != 0:
            raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
        _CHAIN[idx] = (stream, done)


def serialized_launch(stream, fire, what: str) -> None:
    """:func:`chained_launch` of a kernel that ``fire()`` enqueues on
    ``stream`` (returning a cudaError_t), with torch's wait and event
    around it."""
    done = torch.cuda.Event()

    def queue(wait) -> int:
        if wait is not None:
            stream.wait_event(wait)
        err = fire()
        if err == 0:
            done.record(stream)
        return err

    with torch.cuda.device(stream.device):
        chained_launch(stream, queue, done, what)


def launch(staged: tuple, stream=None) -> torch.Tensor:
    """Launch the kernel on ``stream`` (default: torch's current stream),
    serialized with the card's other launches (:func:`serialized_launch`);
    returns ``out``."""
    global launches
    out, args, _alive = staged
    if len(out) == 0:
        return out
    if stream is None:
        stream = torch.cuda.current_stream(out.device)
    lib = _kernel_lib()
    serialized_launch(
        stream, lambda: lib.crc_segments_launch(*args, stream.cuda_stream),
        "crc_segments")
    with _chain_lock:
        launches += 1
    return out


# -------------------------------------------------------------- driver --

def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device; never a
    silent CPU fallback: ``None``, ``"cuda"`` or ``"cuda:N"`` on a host
    without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' (gpu.device=cpu) to run "
            "the plain PyTorch version of the kernels")
    return dev


def crc32c_many(bufs, device=None) -> np.ndarray:
    """CRC32C of each buffer (uint32 array): one segment-kernel launch
    per LAUNCH_BYTES of buffers, each buffer taken whole."""
    return _crc_many(bufs, "crc32c", resolve_device(device))


def crc32_many(bufs, device=None) -> np.ndarray:
    """Legacy zlib-polynomial CRC32 (MsgVer0/1 per-message checksum,
    reference src/rdcrc32.c) on the same kernel — the GF(2)-linear
    decomposition is polynomial-agnostic."""
    return _crc_many(bufs, "crc32", resolve_device(device))


def _crc_many(bufs, poly: str, device: torch.device) -> np.ndarray:
    """Port of ``_crc_many_mxu`` (crc32c_jax.py:508-571) on packed
    segments: the buffers of a launch are joined into one ``flat`` (zeros
    only to round its end up to 16 bytes), copied to the card once, and
    every CRC comes back in one readback."""
    global h2d_bytes
    res = np.zeros((len(bufs),), dtype=np.uint32)
    lens = np.fromiter((len(b) for b in bufs), dtype=np.int64,
                       count=len(bufs))
    ends = np.cumsum(lens)
    sel_v = POLYS.index(poly)
    start = 0
    while start < len(bufs):
        base = int(ends[start] - lens[start])
        stop = max(start + 1, int(np.searchsorted(
            ends, base + LAUNCH_BYTES, side="right")))
        total = int(ends[stop - 1]) - base
        if total:                            # else every buffer empty: 0
            host = bytearray().join([*bufs[start:stop], bytes(-total % 16)])
            flat = torch.frombuffer(host, dtype=torch.uint8)
            if device.type != "cpu":
                flat = flat.to(device)
                h2d_bytes += flat.numel()
            out = crc_segments(
                flat, torch.from_numpy(ends[start:stop] - lens[start:stop]
                                       - base),
                torch.from_numpy(lens[start:stop]),
                torch.full((stop - start,), sel_v, dtype=torch.int32))
            res[start:stop] = out.cpu().numpy()
        start = stop
    return res


# ------------------------------------------------------ engine staging --
# The offload engine's form of the route (ops/engine.py): a launch is
# filled into a pinned host slot, copied to the card with ONE
# non-blocking copy on the lane's stream, launched on that stream into
# device buffers the lane keeps, and its CRCs come back with one
# non-blocking copy into the slot, so the host never waits on a launch
# it does not read yet.

SLOT_FLOOR = 1 << 20         # bytes of the smallest staging slot


def _pow2(n: int, lo: int) -> int:
    return max(lo, 1 << max(0, int(n) - 1).bit_length())


def slot_bucket(nbytes: int) -> int:
    """The staging ring a launch of ``nbytes`` (flat + metadata) takes
    its slot from: the next power of two, at least SLOT_FLOOR."""
    return _pow2(nbytes, SLOT_FLOOR)


class Slot:
    """One host staging slot of an engine lane, pinned when the lane is a
    card.  ``host`` holds a launch's joined ``flat`` (rounded up to 16
    bytes) and then its int64 metadata block (tiles, then sel); the CRCs
    come back into ``out``.  ``event`` marks the end of the last launch
    that used the slot (its copies included): the slot is filled again
    only after it."""

    __slots__ = ("cap", "pin", "host", "out", "event", "busy")

    def __init__(self, cap: int, pin: bool):
        self.cap = cap
        self.pin = pin
        self.busy = False       # taken by a launch not read back yet
        self.host = torch.empty((cap,), dtype=torch.uint8, pin_memory=pin)
        self.out = torch.empty((1024,), dtype=torch.int64, pin_memory=pin)
        self.event = None

    def wait(self) -> None:
        """Block until the slot's last launch no longer reads it."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None

    def nbytes(self) -> int:
        return self.host.numel() + self.out.numel() * 8


class LaneBuffers:
    """The device buffers an engine lane reuses from launch to launch:
    ``flat`` (flat + metadata, as the slot holds them), ``scratch`` (the
    kernel's tile registers, zero between launches: the kernel leaves it
    as it found it) and ``out``.  One lane's copies and launches go in
    order on its one stream, so launch k+1's copy into ``flat`` starts
    after launch k's kernel has read it.  ``stream`` is None on a CPU
    lane."""

    __slots__ = ("device", "stream", "flat", "scratch", "out")

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.flat = self.scratch = self.out = None

    def reserve(self, nbytes: int, ntiles: int, S: int) -> None:
        """Grow the buffers to hold a launch (on the lane's stream, so a
        freed buffer is reused only after the launches queued on it)."""
        dev = self.device
        if self.flat is None or self.flat.numel() < nbytes:
            self.flat = torch.empty((slot_bucket(nbytes),),
                                    dtype=torch.uint8, device=dev)
        if self.scratch is None or self.scratch.numel() < ntiles:
            self.scratch = torch.zeros((_pow2(ntiles, 1024),),
                                       dtype=torch.int64, device=dev)
        if self.out is None or self.out.numel() < S:
            self.out = torch.empty((_pow2(S, 1024),), dtype=torch.int64,
                                   device=dev)


class SlotPlan:
    """One launch of the engine's route, planned by :func:`plan_slot`:
    ``S`` segments in ``flat_bytes`` (a multiple of 16), then their tile
    list and sel, ``nbytes`` in all."""

    __slots__ = ("S", "flat_bytes", "nbytes", "ntiles", "sel_at",
                 "poly_first", "npolys", "offsets", "lengths", "sel",
                 "meta")


def plan_slot(lengths: np.ndarray, sel: np.ndarray) -> SlotPlan:
    """Plan a launch of segments laid back to back: ``lengths`` (S,)
    and ``sel`` (S,) their polynomials.  Host work only; the slot's
    size is ``nbytes``."""
    lengths = np.asarray(lengths, dtype=np.int64)
    sel = np.asarray(sel, dtype=np.int32)
    S = len(lengths)
    offsets = np.cumsum(lengths) - lengths
    total = int(lengths.sum())
    if total > (1 << 31) - 16:
        raise ValueError("a launch must hold under 2 GiB: the kernel's tile "
                         "positions are int32")
    tiles = plan_tiles(offsets, lengths)
    sel_raw = np.concatenate([sel, np.zeros(S % 2, np.int32)])
    crc32 = sel != 0
    uniform = S == 0 or crc32.all() or not crc32.any()
    plan = SlotPlan()
    plan.S, plan.flat_bytes = S, total + (-total % 16)
    plan.ntiles, plan.sel_at = len(tiles), plan.flat_bytes + tiles.nbytes
    plan.nbytes = plan.sel_at + sel_raw.nbytes
    plan.poly_first = int(crc32[0]) if uniform and S else 0
    plan.npolys = 1 if uniform else 2
    plan.offsets, plan.lengths, plan.sel = offsets, lengths, sel
    plan.meta = np.concatenate([tiles.reshape(-1).view(np.uint8),
                                sel_raw.view(np.uint8)])
    return plan


def fill_slot(slot: Slot, plan: SlotPlan, pieces) -> None:
    """Write a planned launch into ``slot``: ``pieces`` (bytes-like)
    joined are its segments back to back; the metadata follows.  Waits
    for the slot's last launch first."""
    if plan.nbytes > slot.cap:
        raise ValueError(f"launch of {plan.nbytes} B over its slot's "
                         f"{slot.cap}")
    slot.wait()
    host = slot.host.numpy()
    pos = 0
    for p in pieces:
        n = len(p)
        host[pos:pos + n] = np.frombuffer(p, dtype=np.uint8)
        pos += n
    if pos != int(plan.lengths.sum()):
        raise ValueError(f"pieces hold {pos} B, the plan "
                         f"{int(plan.lengths.sum())}")
    host[pos:plan.flat_bytes] = 0
    host[plan.flat_bytes:plan.nbytes] = plan.meta
    if slot.out.numel() < plan.S:
        slot.out = torch.empty((_pow2(plan.S, 1024),), dtype=torch.int64,
                               pin_memory=slot.pin)


def send_slot(slot: Slot, plan: SlotPlan, lane: LaneBuffers) -> None:
    """Queue the slot's H2D copy on the lane's stream (a no-op on a CPU
    lane, whose launch reads the slot in place)."""
    global h2d_bytes
    if lane.stream is None:
        return
    with torch.cuda.stream(lane.stream):
        lane.reserve(plan.nbytes, plan.ntiles, plan.S)
        lane.flat[:plan.nbytes].copy_(slot.host[:plan.nbytes],
                                      non_blocking=True)
    with _chain_lock:
        h2d_bytes += plan.nbytes


def launch_slot(slot: Slot, plan: SlotPlan, lane: LaneBuffers) -> None:
    """Queue the kernel on the slot's bytes and the D2H copy of its CRCs
    into ``slot.out``, then mark the slot's event.  A CPU lane runs
    :func:`crc_segments` on the slot in place (the plain version)."""
    if plan.S == 0:
        return
    if lane.stream is None:
        flat = slot.host[:plan.flat_bytes]
        slot.out[:plan.S] = crc_segments(
            flat, torch.from_numpy(plan.offsets),
            torch.from_numpy(plan.lengths), torch.from_numpy(plan.sel))
        return
    base = lane.flat.data_ptr()
    out = lane.out[:plan.S]
    args = (base, base + plan.flat_bytes, base + plan.sel_at, None,
            _device_consts(lane.device).data_ptr(), lane.scratch.data_ptr(),
            out.data_ptr(), plan.ntiles, plan.poly_first, plan.npolys)
    launch((out, args, None), lane.stream)
    with torch.cuda.stream(lane.stream):
        slot.out[:plan.S].copy_(out, non_blocking=True)
        slot.event = torch.cuda.Event()
        slot.event.record(lane.stream)


def read_slot(slot: Slot, plan: SlotPlan) -> np.ndarray:
    """The launch's CRCs, (S,) uint32, once its copy back has landed."""
    slot.wait()
    return slot.out[:plan.S].numpy().astype(np.uint32)


# ------------------------------------------------------ warm registry --
# The port of crc32c_jax.py's warm registry (kernel_ready, ready_kernel,
# warm_kernel, warm_bucket_count), keyed by device.  One compiled kernel
# serves every shape, so the JAX package's per-(B, 64 KB) bucket sweep
# has no counterpart: a device is warm or it is not.  On a card, warm
# means the nvcc build, the constants uploaded to that device, and one
# launch on zeros (under CUDA's lazy module loading the first launch
# pays the module load).  On the CPU it means the host tables the plain
# version reads (_kernel_consts, and _shift_tables at the chunk lengths
# of rows up to 256 KB).

_READY: dict[str, bool] = {}
_warm_lock = threading.Lock()


def _dev_key(device) -> str:
    """Registry key of a device ("cuda:N" with the index resolved, or
    "cpu"); None is the card torch would pick."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def kernel_ready(device=None) -> bool:
    """True once :func:`warm_kernel` has run for ``device``."""
    return _dev_key(device) in _READY


def ready_kernel(device=None):
    """The warmed kernel wrapper for ``device`` (:func:`crc_segments`,
    every shape), or None before :func:`warm_kernel`."""
    return crc_segments if kernel_ready(device) else None


def warm_bucket_count(device=None) -> int:
    """Warm kernels on ``device``: 1 or 0 (devices_snapshot's
    ``warm_buckets``)."""
    return int(kernel_ready(device))


def warm_kernel(device=None) -> None:
    """Make ``device`` warm (see above).  Idempotent and safe from any
    thread: the first caller does the work under a lock, later ones
    wait for it, so a device's first launch happens once."""
    key = _dev_key(device)
    if key in _READY:
        return
    with _warm_lock:
        if key in _READY:
            return
        dev = torch.device(key)
        if dev.type == "cuda":
            _kernel_lib()
            zeros = torch.zeros((16,), dtype=torch.uint8, device=dev)
            got = crc_segments(zeros, torch.zeros(1, dtype=torch.int64),
                               torch.full((1,), 16, dtype=torch.int64),
                               torch.zeros(1, dtype=torch.int32))
            if int(got.cpu()[0]) != crc32c(bytes(16)):
                raise RuntimeError(f"warm launch on {key} returned a wrong "
                                   f"CRC")
        else:
            for p in POLYS:
                _kernel_consts(p)
                for w in range(12, 19):      # rows of 4 KB to 256 KB
                    _shift_tables(_pick_kl(1 << w)[1], p)
        _READY[key] = True

