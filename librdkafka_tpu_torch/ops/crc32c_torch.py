"""Batched CRC32C / CRC32 on an NVIDIA GPU — bit-exact with src/crc32c.c
and src/rdcrc32.c.

The port of librdkafka_tpu/ops/crc32c_jax.py's main-path route (the
``_crc_many_mxu`` driver and its row kernels).  The checksum of MANY
buffers is computed in one device launch over fixed 64 KB rows:

  - CRC register folding is GF(2)-linear in (register, data):
        f(~0, data) = f(~0, 0^n) XOR f(0, data)
    and leading zero bytes are a no-op under a zero initial register:
        f(0, 0^m || data) = f(0, data).
    So each 64 KB block is LEFT-padded with zeros into a (B, 65536) row,
    the device folds every row from a zero register, and the
    length-dependent term f(~0, 0^n) is computed on the host
    (:func:`_term_host`) and applied by the kernel:
        out[b] = ~(raw_b ^ terms[b]).
  - Buffers longer than one block are folded block by block on the host
    with ``crc32c_combine`` / ``crc32_combine`` (µs each).

:func:`crc_rows` is the row kernel's wrapper.  On a CUDA tensor it
launches the hand-written kernel ``csrc/crc_rows.cu`` (built with nvcc
at first use, loaded with ctypes) or raises; on a CPU tensor it runs
:func:`crc_rows_reference`, the plain PyTorch version of the same
function.  ``launches`` counts kernel launches.
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
                         ZERO_OP_CRC32C, crc32_combine, crc32c_combine)
from .packing import pad_left

BLOCK = 65536        # fixed device row; ≥ any msgset batch chunk
MAX_ROWS = 256       # rows per launch (bounds the staging copy)
POLYS = ("crc32c", "crc32")   # sel value = index: 0 crc32c, 1 crc32

#: kernel launches made by :func:`crc_rows` (not by the plain version)
launches = 0

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU_SRC = os.path.join(_PKG, "csrc", "crc_rows.cu")
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


# -------------------------------------------------------- CUDA kernel --

def _build() -> str:
    """nvcc csrc/crc_rows.cu into build/librdkafka_tpu_torch/ if stale."""
    global build_log
    if (os.path.exists(SO)
            and os.path.getmtime(SO) >= os.path.getmtime(CU_SRC)):
        return SO
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.tmp"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, CU_SRC],
                         capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {CU_SRC}:\n{build_log}")
    os.replace(tmp, SO)
    return SO


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            L = ctypes.CDLL(_build())
            vp = ctypes.c_void_p
            L.crc_rows_launch.argtypes = [vp, vp, vp, vp, vp, vp,
                                          ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int, vp]
            L.crc_rows_launch.restype = ctypes.c_int
            _lib = L
    return _lib


_DEV_CONSTS: dict = {}


def _device_consts(dev: torch.device):
    """(tables (2, 8, 256) uint32, zop (2, 64, 32) uint32) as int32
    bit patterns on ``dev``, uploaded once per device."""
    key = str(dev)
    if key not in _DEV_CONSTS:
        t = np.stack([_poly_tables(p)[0] for p in POLYS]).astype(np.uint32)
        z = np.stack([_poly_tables(p)[1] for p in POLYS]).astype(np.uint32)
        _DEV_CONSTS[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)
            for a in (t, z))
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
    int64.  CUDA tensors launch ``csrc/crc_rows.cu``; CPU tensors run
    :func:`crc_rows_reference`."""
    global launches
    B, N = _check_rows(data, terms, sel)
    if data.device.type == "cpu":
        return crc_rows_reference(data, terms, sel)
    if data.device.type != "cuda":
        raise ValueError(f"crc_rows: unsupported device {data.device}")
    data, terms, sel = (t.contiguous() for t in (data, terms, sel))
    out = torch.empty((B,), dtype=torch.int64, device=data.device)
    if B == 0:
        return out
    tables, zop = _device_consts(data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = _kernel_lib().crc_rows_launch(
        data.data_ptr(), terms.data_ptr(), sel.data_ptr(),
        tables.data_ptr(), zop.data_ptr(), out.data_ptr(),
        B, N, (N // 256).bit_length() - 1, stream)
    if err != 0:
        raise RuntimeError(f"crc_rows kernel launch failed: cudaError {err}")
    launches += 1
    return out


# -------------------------------------------------------------- driver --

def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device; never a
    silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch version of the kernels")
        return torch.device("cuda")
    return torch.device(device)


def crc32c_many(bufs, device=None) -> np.ndarray:
    """CRC32C of each buffer (uint32 array) via one row-kernel launch
    per 256 64 KB blocks, folded per buffer with crc32c_combine."""
    return _crc_many(bufs, "crc32c", resolve_device(device))


def crc32_many(bufs, device=None) -> np.ndarray:
    """Legacy zlib-polynomial CRC32 (MsgVer0/1 per-message checksum,
    reference src/rdcrc32.c) on the same row kernel — the GF(2)-linear
    decomposition is polynomial-agnostic."""
    return _crc_many(bufs, "crc32", resolve_device(device))


def _crc_many(bufs, poly: str, device: torch.device) -> np.ndarray:
    """Port of ``_crc_many_mxu`` (crc32c_jax.py:508-571), launching
    exactly the rows it has (no pow2 / 128-row bucket padding)."""
    res = np.zeros((len(bufs),), dtype=np.uint32)
    if not bufs:
        return res
    combine = crc32c_combine if poly == "crc32c" else crc32_combine
    blocks: list[bytes] = []
    spans: list[tuple[int, int]] = []
    for b in bufs:
        b = bytes(b)
        first = len(blocks)
        for pos in range(0, len(b), BLOCK):
            blocks.append(b[pos:pos + BLOCK])
        spans.append((first, len(blocks) - first))
    if not blocks:
        return res                         # every buffer empty: crc 0

    crcs = np.zeros((len(blocks),), dtype=np.uint32)
    sel_v = POLYS.index(poly)
    for start in range(0, len(blocks), MAX_ROWS):
        chunk = blocks[start:start + MAX_ROWS]
        data, lens = pad_left(chunk, BLOCK)
        terms = np.array([_term_host(int(n), poly) for n in lens],
                         dtype=np.int64)
        out = crc_rows(torch.from_numpy(data).to(device),
                       torch.from_numpy(terms).to(device),
                       torch.full((len(chunk),), sel_v, dtype=torch.int32,
                                  device=device))
        crcs[start:start + len(chunk)] = out.cpu().numpy()

    for i, ((first, nb), b) in enumerate(zip(spans, bufs)):
        if nb == 0:
            continue                       # empty buffer: crc 0
        acc = int(crcs[first])
        off = BLOCK
        for k in range(1, nb):
            ln = min(BLOCK, len(b) - off)
            acc = combine(acc, int(crcs[first + k]), ln)
            off += BLOCK
        res[i] = acc
    return res
