"""Batched LZ4 block compression on an NVIDIA GPU, with the CRC32C of the
compressed and the raw rows in the same launch — bit-exact with the
deterministic insert-all encoder of ops/native/codec.cpp
(``tk_lz4_block_compress``).

The port of librdkafka_tpu/ops/lz4_jax.py: its device functions E (the
vmapped encoder, ``lz4_block_compress_many``), F (the fused compress→CRC
launch of the engine's compress route) and the CRC D inside F become one
hand-written kernel, ``csrc/lz4_rows.cu``, whose ``with_crc`` flag picks
the CRCs computed:

  - ``"none"``: the compressed rows and their lengths (E);
  - ``"both"``: also the CRC32C of each compressed row and of each raw
    row (F), so the MessageSet v2 batch CRC folds on the host
    (packing.FrameBlob);
  - ``"raw"``: the raw rows' CRC32C only (models/codec_step.py, I).

:func:`lz4_rows` is the kernel's wrapper on the TPU's row contract:
``data`` (B, N) uint8 right-padded, ``lens`` (B,) int32 → ``comp`` (B, C)
uint8 zeroed past ``olen``, C = N + N // 255 + 16.  On a CUDA tensor it
launches the kernel (built with nvcc at first use, loaded with ctypes) or
raises; on a CPU tensor it runs :func:`lz4_rows_reference`, the plain
PyTorch version (a transcription of the JAX formulation: sort for the
equal-hash predecessor, blocked match extension, pointer-doubling parse,
searchsorted emission).  The engine's form (``plan_lz4`` … ``read_lz4``)
packs the blocks with no padding into a pinned slot and reads back only
the compressed bytes the kernel made, in native calls (one to pack, one
to launch, one to read back).

``launches`` counts kernel launches, ``h2d_bytes`` / ``d2h_bytes`` the
bytes the routes copied to and from the card.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from . import crc32c_torch as _crc
from .packing import LZ4F_BLOCKSIZE, next_pow2, pad_right

HASH_BITS = 12
MAXMATCH = 273
MINMATCH = 4
MODES = ("none", "both", "raw")

#: kernel launches made by :func:`lz4_rows` and :func:`launch_lz4` (not by
#: the plain version)
launches = 0
#: bytes the compress routes copied host → device and device → host
h2d_bytes = 0
d2h_bytes = 0

CU_SRC = os.path.join(os.path.dirname(_crc.CU_SRC), "lz4_rows.cu")
SO = os.path.join(_crc.BUILD_DIR, "liblz4_rows.so")

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
#: nvcc's output of the last build (ptxas register / spill report)
build_log = ""


def _bound(n: int) -> int:
    return n + n // 255 + 16


def _count(launched: int = 0, h2d: int = 0, d2h: int = 0) -> None:
    global launches, h2d_bytes, d2h_bytes
    with _count_lock:
        launches += launched
        h2d_bytes += h2d
        d2h_bytes += d2h


# ------------------------------------------------------- plain version --

def _extlen(L: torch.Tensor) -> torch.Tensor:
    """Number of length-extension bytes of a literal / match run field."""
    return torch.where(L >= 15, (L - 15) // 255 + 1, torch.zeros_like(L))


def _hash(val: torch.Tensor) -> torch.Tensor:
    """(val * 2654435761) mod 2^32 >> 20 in int64 without overflow: CPU
    torch has no uint32 arithmetic, so the product is taken in 16-bit
    halves."""
    k = 2654435761
    lo = (val & 0xFFFF) * k
    hi = (((val >> 16) * k) & 0xFFFF) << 16
    return ((lo + hi) & 0xFFFFFFFF) >> (32 - HASH_BITS)


def sort_candidates(h: torch.Tensor) -> torch.Tensor:
    """candidate[p] = the previous position of each row of ``h`` (B, L)
    int64, L <= 2^17, with an equal value, else -1: one sort of the unique
    composite keys (h << 17 | pos), as lz4_jax.py:83-90 takes it."""
    B, L = h.shape
    i64 = torch.int64
    pos = torch.arange(L, dtype=i64, device=h.device).expand(B, L)
    skey = torch.sort((h << 17) | pos, dim=1).values
    order = skey & ((1 << 17) - 1)
    h_sorted = skey >> 17
    prev = torch.cat([torch.full((B, 1), -1, dtype=i64, device=h.device),
                      order[:, :-1]], 1)
    same = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=h.device),
                      h_sorted[:, 1:] == h_sorted[:, :-1]], 1)
    return torch.zeros((B, L), dtype=i64, device=h.device).scatter_(
        1, order, torch.where(same, prev, -1))


def _compress_rows(data: torch.Tensor, lens: torch.Tensor):
    """``_lz4_block_one`` (lz4_jax.py:63-196) over rows at once: (B, N)
    uint8 right-padded, lens (B,) → ((B, C) uint8, (B,) int64).  Every
    clip of the JAX version is explicit here: torch's gathers raise where
    jax clamps."""
    B, N = data.shape
    dev = data.device
    C = _bound(N)
    D = N + 2
    i64 = torch.int64
    pos = torch.arange(N, dtype=i64, device=dev).expand(B, N)
    n = lens.to(i64).view(B, 1)
    d = data.to(i64)

    def at(idx):
        return torch.gather(d, 1, idx.clamp(0, N - 1))

    val = at(pos) | (at(pos + 1) << 8) | (at(pos + 2) << 16) \
        | (at(pos + 3) << 24)
    cand = sort_candidates(_hash(val))
    valid = ((cand >= 0) & (pos - cand <= 65535)
             & (torch.gather(val, 1, cand.clamp(0, N - 1)) == val)
             & (pos + 12 <= n))

    # match lengths: blocked longest common extension, 16 bytes a round
    mmax = torch.clamp(n - 5 - pos, max=MAXMATCH)
    k16 = torch.arange(16, dtype=i64, device=dev)

    def g16(base):
        idx = (base.unsqueeze(-1) + k16).clamp(0, N - 1)
        return torch.gather(data, 1, idx.view(B, -1)).view(B, N, 16)

    mlen = torch.where(valid, MINMATCH, 0).to(i64)
    active = valid & (mlen < mmax)
    while bool(active.any()):
        neq = g16(cand + mlen) != g16(pos + mlen)
        run = torch.where(neq.any(-1), neq.to(torch.uint8).argmax(-1), 16)
        mlen = mlen + torch.where(active, torch.minimum(run, mmax - mlen), 0)
        active = active & (run == 16) & (mlen < mmax)

    # the greedy parse by pointer doubling over the successor graph
    sink = N + 1
    nxt = torch.where(valid, pos + mlen, pos + 1)
    jump = torch.where(pos + 12 <= n, torch.clamp(nxt, max=sink), sink)
    J = torch.cat([jump, torch.full((B, 2), sink, dtype=i64, device=dev)], 1)
    on = torch.zeros((B, D), dtype=torch.bool, device=dev)
    on[:, 0] = True
    for _ in range(int(np.ceil(np.log2(N + 2))) + 1):
        on = on.scatter(1, torch.where(on, J, sink), True)
        J = torch.gather(J, 1, J)
    match_here = on[:, :N] & valid

    # anchors, literal runs, per-sequence sizes and offsets
    mend = torch.where(match_here, pos + mlen, 0)
    cm = torch.cummax(mend, dim=1).values
    anchor = torch.cat([torch.zeros((B, 1), dtype=i64, device=dev),
                        cm[:, :-1]], 1)
    lit = pos - anchor
    final_anchor = cm[:, -1]
    final_lit = lens.to(i64) - final_anchor
    sz = torch.where(match_here,
                     1 + _extlen(lit) + lit + 2 + _extlen(mlen - MINMATCH), 0)
    csum = torch.cumsum(sz, 1)
    total_seq = csum[:, -1]
    S = match_here.sum(1)
    total_out = total_seq + 1 + _extlen(final_lit) + final_lit

    # dense sequence tables (+ a pseudo sequence for the final run)
    di = torch.where(match_here, torch.cumsum(match_here.to(i64), 1) - 1,
                     D - 1)
    junk = torch.tensor([C + 1, 0, 0, MINMATCH, 0], dtype=i64, device=dev)
    tbl = junk.view(5, 1, 1).expand(5, B, D).clone()
    vals = torch.stack([csum - sz, lit, anchor, mlen, pos - cand])
    tbl.scatter_(2, di.unsqueeze(0).expand(5, B, N), vals)
    tbl[:, :, D - 1] = junk.view(5, 1)
    tbl[:3].scatter_(2, S.view(1, B, 1).expand(3, B, 1),
                     torch.stack([total_seq, final_lit, final_anchor])
                     .unsqueeze(-1))

    # every output byte from its sequence (searchsorted needs the table's
    # offsets non-decreasing: real entries increase, pseudo = total_seq,
    # junk = C + 1)
    j = torch.arange(C, dtype=i64, device=dev).expand(B, C).contiguous()
    i = torch.searchsorted(tbl[0].contiguous(), j, right=True) - 1
    i = i.clamp(0, D - 1)
    G = torch.gather(tbl, 2, i.unsqueeze(0).expand(5, B, C))
    r = j - G[0]
    L = G[1]
    elq = _extlen(L)
    A = G[2]
    M = G[3] - MINMATCH
    emq = _extlen(M)
    hasm = i < S.view(B, 1)
    token = (torch.clamp(L, max=15) << 4) | torch.where(
        hasm, torch.clamp(M, max=15), 0)
    off = G[4]
    lit_start = 1 + elq
    lit_end = lit_start + L
    litb = at(A + r - lit_start)
    mk = r - lit_end - 1
    byte = torch.where(mk < emq, 255, (M - 15) % 255)
    byte = torch.where(r == lit_end + 1, off >> 8, byte)
    byte = torch.where(r == lit_end, off & 0xFF, byte)
    byte = torch.where((r >= lit_start) & (r < lit_end), litb, byte)
    byte = torch.where((r >= 1) & (r <= elq),
                       torch.where(r < elq, 255, (L - 15) % 255), byte)
    byte = torch.where(r == 0, token, byte)
    byte = torch.where(j < total_out.view(B, 1), byte, 0)
    return byte.to(torch.uint8), total_out


def _crc_of_rows(rows: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The standard CRC32C of ``rows[b, :lens[b]]`` (D's function), by the
    CRC kernel's plain version; (B,) int64."""
    B, W = rows.shape
    return _crc.crc_segments_reference(
        rows.reshape(-1), torch.arange(B, dtype=torch.int64) * W,
        lens.to(torch.int64).cpu(), torch.zeros(B, dtype=torch.int32))


def _check(data: torch.Tensor, lens: torch.Tensor, with_crc: str):
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("data must be a (B, N) uint8 tensor")
    B, N = data.shape
    if N < 16 or N > LZ4F_BLOCKSIZE or N % 16:
        raise ValueError(f"row width {N} must be a multiple of 16 in "
                         f"[16, {LZ4F_BLOCKSIZE}]")
    if lens.shape != (B,) or lens.dtype != torch.int32:
        raise ValueError("lens must be a (B,) int32 tensor")
    if lens.device != data.device:
        raise ValueError("data and lens must share a device")
    if with_crc not in MODES:
        raise ValueError(f"with_crc must be one of {MODES}")
    return B, N


def lz4_rows_reference(data: torch.Tensor, lens: torch.Tensor,
                       with_crc: str = "none"):
    """The kernel's function in plain PyTorch, on data's device.

    data (B, N) uint8 right-padded, lens (B,) int32 in [0, N].  Returns
    (comp (B, C) uint8 zeroed past olen, olen (B,) int32, crc_comp,
    crc_raw), each CRC a (B,) int64 holding the uint32, or None where
    ``with_crc`` does not ask for it.  Rows are taken in groups of about
    1 MB (the match extension gathers 16 bytes per position)."""
    B, N = _check(data, lens, with_crc)
    if B and (int(lens.min()) < 0 or int(lens.max()) > N):
        raise ValueError("lens must lie in [0, N]")
    C = _bound(N)
    comp = torch.zeros((B, C), dtype=torch.uint8, device=data.device)
    olen = torch.zeros((B,), dtype=torch.int64, device=data.device)
    step = max(1, (1 << 20) // N)
    for s in range(0, B, step):
        comp[s:s + step], olen[s:s + step] = _compress_rows(
            data[s:s + step], lens[s:s + step])
    crc_comp = _crc_of_rows(comp, olen) if with_crc == "both" else None
    crc_raw = _crc_of_rows(data, lens) if with_crc != "none" else None
    if crc_comp is not None:
        crc_comp = crc_comp.to(data.device)
    if crc_raw is not None:
        crc_raw = crc_raw.to(data.device)
    return comp, olen.to(torch.int32), crc_comp, crc_raw


# ------------------------------------- the kernel's decomposition, plain --
# csrc/lz4_rows.cu computes the candidates off the serial parse (stage 2)
# and walks the chain read-only (stage 3).  These two functions are that
# decomposition in plain torch / numpy, for the tests only: the kernel's
# path never calls them.

def _segment_len(P: int, segments: int) -> int:
    """The kernel's segment length: ceil(P / S) rounded up to 32."""
    return (-(-P // segments) + 31) & ~31


def segment_candidates(data: torch.Tensor, lens: torch.Tensor,
                       segments: int):
    """Stage 2 of the kernel: every position's candidate through S segment
    tables and the prefix-max fix-up.

    data (B, N) uint8, lens (B,).  The positions P = [0, n - 11) that can
    start a match are cut into ``segments`` contiguous segments of
    :func:`_segment_len`.  A position's candidate is its last earlier
    position of the same hash in its own segment (the warp's walk; taken
    here with one sort per row), else the last position of the hash in the
    nearest earlier segment that has one: the exclusive prefix max over
    the segment tables T[s, h] = 1 + the last position of hash h in
    segment s (0 empty).  Returns (cand (B, N) int64, -1 where none or
    outside P; valid (B, N) bool: a candidate with an equal 4-byte prefix
    at distance <= 65535)."""
    B, N = data.shape
    i64 = torch.int64
    cand = torch.full((B, N), -1, dtype=i64)
    valid = torch.zeros((B, N), dtype=torch.bool)
    for b in range(B):
        P = max(0, int(lens[b]) - 11)
        if P == 0:
            continue
        seg = _segment_len(P, segments)
        d = data[b, :P + 3].to(i64)
        val = d[:P] | (d[1:P + 1] << 8) | (d[2:P + 2] << 16) \
            | (d[3:P + 3] << 24)
        h = _hash(val)
        pos = torch.arange(P, dtype=i64)
        sid = pos // seg
        inseg = sort_candidates(((sid << 12) | h).view(1, P)).view(P)
        tables = torch.zeros(segments * (1 << HASH_BITS), dtype=i64)
        tables.scatter_reduce_(0, (sid << 12) | h, pos + 1, "amax")
        tables = tables.view(segments, 1 << HASH_BITS)
        prefix = torch.cat([torch.zeros((1, 1 << HASH_BITS), dtype=i64),
                            torch.cummax(tables, 0).values[:-1]])
        c = torch.where(inseg >= 0, inseg, prefix[sid, h] - 1)
        cand[b, :P] = c
        valid[b, :P] = ((c >= 0) & (pos - c <= 65535)
                        & (val[c.clamp(min=0)] == val))
    return cand, valid


def _walk(row, n: int, vpos, cands, p: int, end: int, links=None):
    """The chain from state p while p < end (for at most ``links``
    sequences): its sequences (v, distance, mlen), the states it passes
    below end (p, then each match's end) and the state it stops in (>= end
    at the end: a state with no valid position before end is the state
    end)."""
    seqs, states = [], []
    while p < end and (links is None or len(seqs) < links):
        states.append(p)
        i = int(np.searchsorted(vpos, p))
        if i == len(vpos) or vpos[i] >= end:
            return seqs, states, end
        v = int(vpos[i])
        c = int(cands[v])
        mmax = min(MAXMATCH, n - 5 - v)
        neq = np.flatnonzero(row[c + MINMATCH:c + mmax]
                             != row[v + MINMATCH:v + mmax])
        mlen = MINMATCH + int(neq[0]) if len(neq) else mmax
        seqs.append((v, v - c, mlen))
        p = v + mlen
    return seqs, states, p


def chain_walk(data: torch.Tensor, lens: torch.Tensor, cand: torch.Tensor,
               valid: torch.Tensor, walkers: int = 8):
    """Stage 3 and 4 of the kernel over :func:`segment_candidates`' output.

    The chain (from p, the next valid position v >= p, its match length
    capped at min(273, n - 5 - v), p = v + mlen; no table is written) is
    walked from the start of each of ``walkers`` segments of the positions
    at once, each walk to its segment's end; then the joins, in order: the
    true chain enters segment w at e (segment 0's walk is the true chain);
    where e is a state of w's walk, that walk from e on is the true chain,
    else the chain is walked on from e to the next such state or the
    segment's end.  Then the sequences' bytes at the running sum of their
    sizes, and the last literal run.  Returns (comp (B, C) uint8 zeroed
    past olen, olen (B,) int32, sequences (B,) int64) as
    :func:`lz4_rows_reference` lays them out."""
    B, N = data.shape
    C = _bound(N)
    comp = torch.zeros((B, C), dtype=torch.uint8)
    olen = torch.zeros((B,), dtype=torch.int32)
    nseq = torch.zeros((B,), dtype=torch.int64)
    rows, cands, valids = data.numpy(), cand.numpy(), valid.numpy()

    def length(out: bytearray, L: int) -> None:
        if L >= 15:
            out += b"\xff" * ((L - 15) // 255) + bytes([(L - 15) % 255])

    for b in range(B):
        n = int(lens[b])
        P = max(0, n - 11)
        row = rows[b, :n]
        vpos = np.flatnonzero(valids[b, :P])
        cseg = _segment_len(P, walkers)
        bounds = [(min(P, w * cseg), min(P, min(P, w * cseg) + cseg))
                  for w in range(walkers)]
        walks = [_walk(row, n, vpos, cands[b], cb, ce) for cb, ce in bounds]
        seqs, _, e = walks[0]
        seqs = list(seqs)
        for (_, ce), (wseqs, states, wexit) in zip(bounds[1:], walks[1:]):
            states = set(states)
            while e < ce:
                if e in states:
                    seqs += [q for q in wseqs if q[0] >= e]
                    e = wexit
                    break
                link, _, e = _walk(row, n, vpos, cands[b], e, ce, 1)
                seqs += link
        out = bytearray()
        anchor = 0
        for v, d, mlen in seqs:
            lit, m = v - anchor, mlen - MINMATCH
            out.append((min(lit, 15) << 4) | min(m, 15))
            length(out, lit)
            out += row[anchor:v].tobytes()
            out += d.to_bytes(2, "little")
            length(out, m)
            anchor = v + mlen
        nseq[b] = len(seqs)
        lit = n - anchor
        out.append(min(lit, 15) << 4)
        length(out, lit)
        out += row[anchor:].tobytes()
        comp[b, :len(out)] = torch.frombuffer(out, dtype=torch.uint8)
        olen[b] = len(out)
    return comp, olen, nseq


def edge_rows(seed: int = 5) -> list[bytes]:
    """Blocks at the edges of the kernel's stages (seeded): repeats across
    the borders of 4 segments (a 300-byte chunk and its copies on zeros,
    each copy's candidates in the nearest earlier segment that has them,
    some across an empty one); dense hash collisions (2-4 symbols, 14,000+
    sequences: past the sequences kept in shared memory); rows shorter
    than 13 bytes; lengths that are no multiple of 16 or of any segment
    count; incompressible 64 KB (no sequence, the widest output);
    all-equal bytes (241 capped matches); a two-byte period; a repeat at
    the largest distances a 64 KB block allows (65,520 and 65,524 match;
    65,532 may not: its position is past n - 12); and a 9,536 B tail of
    JSON records like the main path's."""
    rng = np.random.default_rng(seed)

    def rand(n, hi=256):
        return rng.integers(0, hi, n, dtype=np.uint8)

    cross = np.zeros(65536, np.uint8)
    cross[1000:1300] = rand(300) | 1
    for at in (16330, 40000, 49100):
        cross[at:at + 300] = cross[1000:1300]
    far = []
    for d in (65520, 65524, 65532):
        row = np.zeros(65536, np.uint8)
        row[:16] = rand(16) | 1
        row[d:] = row[:65536 - d]
        far.append(row.tobytes())
    rec = (b'{"seq": %07d, "user": "u%05d", "event": "click", '
           b'"props": "abcdefghijklmnopqrstuvwxyz0123456789"}')
    tail = b"".join((rec % (i, i % 1000) * 11)[:1024] for i in range(10))
    return ([cross.tobytes(), rand(65536, 4).tobytes(),
             rand(65531, 3).tobytes()]
            + [(b"abc" * 5)[:k] for k in (11, 12, 13)]
            + [rand(n, 5).tobytes() for n in (33, 1007, 4133)]
            + [rand(65536).tobytes(), b"\x07" * 65536,
               b"ab" * 32767 + b"xy"]
            + far + [tail[:9536]])


def parse_sequences(block: bytes) -> list[tuple[int, int, int]]:
    """The sequences of one LZ4 block, from its token stream: (literal
    length, offset, match length) each; the last literal run is not
    one."""
    def length(i, L):
        if L == 15:
            while True:
                x = block[i]
                i += 1
                L += x
                if x != 255:
                    break
        return i, L

    i, out = 0, []
    while i < len(block):
        tok = block[i]
        i, lit = length(i + 1, tok >> 4)
        i += lit
        if i >= len(block):            # the last literal run
            break
        off = block[i] | block[i + 1] << 8
        i, m = length(i + 2, tok & 15)
        out.append((lit, off, m + MINMATCH))
    return out


# -------------------------------------------------------- CUDA kernel --

def _bind(so: str) -> ctypes.CDLL:
    """The kernel's library; its attribute ``held`` is the same library
    called with the GIL held (ctypes.PyDLL), for the engine's round."""
    L = ctypes.CDLL(so)
    H = ctypes.PyDLL(so)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    L.lz4_rows_launch.argtypes = [vp] * 11 + [i64, i32, i32, vp]
    L.lz4_rows_launch.restype = i32
    L.lz4_rows_ctas_per_sm.argtypes = [i32]
    L.lz4_rows_ctas_per_sm.restype = i32
    L.lz4_rows_scratch_bytes.argtypes = [i64, i32]
    L.lz4_rows_scratch_bytes.restype = i64
    H.lz4_rows_round.argtypes = [i32, vp, vp, i64, i64, i64, i32, vp, vp,
                                 i64, vp, vp, vp, i64, vp, vp, vp]
    H.lz4_rows_round.restype = i32
    for lib in (L, H):
        lib.lz4_rows_readback.argtypes = [i32, vp, vp, i64, vp, vp, vp, i32]
        lib.lz4_rows_readback.restype = i64
    L.held = H
    return L


def _kernel_lib() -> ctypes.CDLL:
    global _lib, build_log
    with _lib_lock:
        if _lib is None:
            so, log = _crc.build_kernel(CU_SRC, SO)
            build_log = log or build_log
            _lib = _bind(so)
    return _lib


def ctas_per_sm(N: int = LZ4F_BLOCKSIZE, device=None) -> int:
    """CTAs of the kernel resident on one SM of ``device`` (default: the
    current card) at row width ``N`` (cudaOccupancyMaxActiveBlocksPer
    Multiprocessor)."""
    lib = _kernel_lib()
    with torch.cuda.device(_crc.resolve_device(device)):
        k = lib.lz4_rows_ctas_per_sm(N)
    if k < 0:
        raise RuntimeError(f"lz4_rows_ctas_per_sm({N}): cudaError {-k}")
    return k


def _launch_rows(data, lens, with_crc: str, lib=None):
    """One kernel launch on the padded rows, on torch's current stream,
    serialized with the card's other launches of the port
    (crc32c_torch.serialized_launch: the CRC grid is cooperative and must
    not share the card).  The launch's scratch (the candidates' distances
    and the sequence tables, one slice per CTA of the persistent grid) is
    allocated on the stream and given back to the caching allocator after
    the launch is queued: stream order keeps it the kernel's until the
    kernel ends.  ``lib``: another build of the kernel (the stage
    clocks'), whose launches are not counted."""
    B, N = data.shape
    data, lens = data.contiguous(), lens.contiguous()
    dev = data.device
    # 16 bytes of slack: the CRC epilogue reads whole 16-byte chunks
    comp = torch.empty((B * _bound(N) + 16,), dtype=torch.uint8,
                       device=dev)[:B * _bound(N)].view(B, _bound(N))
    olen = torch.empty((B,), dtype=torch.int32, device=dev)
    cc = (torch.empty((B,), dtype=torch.int64, device=dev)
          if with_crc == "both" else None)
    cr = (torch.empty((B,), dtype=torch.int64, device=dev)
          if with_crc != "none" else None)
    if not B:
        return comp, olen, cc, cr
    counted = lib is None
    lib = lib or _kernel_lib()
    stream = torch.cuda.current_stream(dev)
    consts = _crc._device_consts(stream.device).data_ptr()
    with torch.cuda.device(stream.device):
        nbytes = lib.lz4_rows_scratch_bytes(B, N)
    if nbytes < 0:
        raise RuntimeError(f"lz4_rows_scratch_bytes: cudaError {-nbytes}")
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    _crc.serialized_launch(
        stream, lambda: lib.lz4_rows_launch(
            data.data_ptr(), None, lens.data_ptr(), comp.data_ptr(), None,
            None, olen.data_ptr(), ptr(cc), ptr(cr), consts,
            scratch.data_ptr(), B, N, _bound(N), stream.cuda_stream),
        "lz4_rows")
    if counted:
        _count(launched=1)
    return comp, olen, cc, cr


def lz4_rows(data: torch.Tensor, lens: torch.Tensor, with_crc: str = "none"):
    """LZ4-compress each row ``data[b, :lens[b]]``; returns (comp (B, C)
    uint8 zeroed past olen, olen (B,) int32, crc_comp, crc_raw) as
    :func:`lz4_rows_reference` does.  A CUDA ``data`` launches
    csrc/lz4_rows.cu on torch's current stream (lens outside [0, N] are
    clamped there); a CPU ``data`` runs the plain version."""
    _check(data, lens, with_crc)
    if data.device.type == "cpu":
        return lz4_rows_reference(data, lens, with_crc)
    if data.device.type != "cuda":
        raise ValueError(f"lz4_rows: unsupported device {data.device}")
    return _launch_rows(data, lens, with_crc)


#: the kernel's stages, in the order of its stage clocks
STAGES = ("stage row + empty tables", "candidates (segment walks)",
          "fix-up + bitmask", "chain (a walk a segment)",
          "chain joins (warp 0)", "emission", "CRC epilogue")
SO_CLOCKS = os.path.join(_crc.BUILD_DIR, "liblz4_rows_clocks.so")
_clocks_lib = None


def stage_clocks(data: torch.Tensor, lens: torch.Tensor,
                 with_crc: str = "both") -> dict:
    """SM cycles of each of the kernel's :data:`STAGES` in one launch on
    CUDA rows, summed over every CTA's rows (thread 0's ``clock64``
    between the barriers that end the stages), from a diagnostic build of
    csrc/lz4_rows.cu with ``-DLZ4_STAGE_CLOCKS`` (built at first use).
    The diagnostic launch is not counted in :data:`launches`."""
    global _clocks_lib
    _check(data, lens, with_crc)
    if data.device.type != "cuda":
        raise ValueError("stage_clocks needs CUDA rows")
    with _lib_lock:
        if _clocks_lib is None:
            so, _ = _crc.build_kernel(CU_SRC, SO_CLOCKS,
                                      ("-DLZ4_STAGE_CLOCKS",))
            L = _bind(so)
            L.lz4_rows_stage_clocks.argtypes = [ctypes.c_void_p]
            L.lz4_rows_stage_clocks.restype = ctypes.c_int
            _clocks_lib = L
    out = (ctypes.c_ulonglong * len(STAGES))()

    def read_and_zero():
        err = _clocks_lib.lz4_rows_stage_clocks(out)
        if err:
            raise RuntimeError(f"lz4_rows_stage_clocks: cudaError {err}")

    with torch.cuda.device(data.device):
        torch.cuda.synchronize()
        read_and_zero()
        _launch_rows(data, lens, with_crc, _clocks_lib)
        torch.cuda.synchronize()
        read_and_zero()
    return dict(zip(STAGES, list(out)))


def lz4_block_compress_many(blocks: list[bytes], device=None) -> list[bytes]:
    """Compress many ≤ 64 KB blocks in one launch (the E route of
    ``GpuCodecProvider(lz4_force=True)``); bytes equal
    ``cpu.lz4_block_compress``'s."""
    if not blocks:
        return []
    dev = _crc.resolve_device(device)
    N = next_pow2(max(len(b) for b in blocks))
    data, lens = pad_right(blocks, N)
    d, ln = torch.from_numpy(data), torch.from_numpy(lens)
    if dev.type != "cpu":
        d, ln = d.to(dev), ln.to(dev)
        _count(h2d=data.nbytes + lens.nbytes)
    comp, olen, _, _ = lz4_rows(d, ln)
    olen = olen.cpu().numpy()
    # only the bytes made come back: one row slice per block, then one copy
    width = int(olen.max())
    rows = comp[:, :width].cpu().numpy()
    if dev.type != "cpu":
        _count(d2h=rows.nbytes + olen.nbytes)
    return [rows[i, :olen[i]].tobytes() for i in range(len(blocks))]


# ------------------------------------------------------ engine staging --
# The engine's form of the route (ops/engine.py's compress route): a
# round's blocks are packed back to back (each buffer 16-byte aligned)
# with their metadata into a pinned slot of the lane's rings by one native
# call (lz4_pack.cpp tk_lz4_pack_round), and one more (lz4_rows_round) queues
# on the lane's stream the slot's H2D copy, the chain's wait, one launch
# with the CRC epilogue ("both") into a packed output claimed by an atomic
# cursor, and the D2H copy of the round's metadata (cursor, offsets, CRCs,
# lengths) into the slot.  The readback (lz4_rows_readback) waits for
# that copy, then copies only the cursor's bytes into pinned memory.  The
# device and pinned buffers are reused, the lane's and each slot's
# (Lz4Lane).
#
# The calls hold the GIL, except a blocking readback and the pack of a
# large round: beside a thread that runs Python, a thread that gives the
# GIL up waits up to the interpreter's switch interval (5 ms) to take it
# back, far longer than the pack of a small round or the launch takes.

#: rounds of more bytes give the GIL up while they are packed, so that the
#: client's other threads run meanwhile.  Beside a busy thread this costs
#: the pack about 5 ms of wall on an H100's host up to 16 MiB and nothing
#: from 32 MiB (a longer held call is made to hand the GIL over anyway);
#: in the devlz4 benchmark cell the client's CPU a record read a lower
#: median with this cut than with every pack holding the GIL or with a
#: 16 MiB cut (18.52, 19.17 and 19.21 us; 7, 7 and 3 runs).
PACK_RELEASE_BYTES = 4 << 20
_NOT_READY = -600               # -cudaErrorNotReady: the round is running

_pack_fns = None


class Lz4Plan:
    """One launch of the engine's compress route, planned by
    :func:`plan_lz4` from the lengths of the job buffers it carries."""

    __slots__ = ("B", "N", "buf_lens", "lens", "row_offs", "spans",
                 "flat_bytes", "nbytes", "cap", "out_words")


def plan_lz4(buf_lens) -> Lz4Plan:
    """Cut buffers of ``buf_lens`` bytes into LZ4F blocks of 64 KB (an
    empty buffer has none) and lay them back to back: each buffer starts
    16-byte aligned, so its full blocks are contiguous and aligned.
    ``spans`` gives (first block, block count) per buffer; ``row_offs``
    and ``lens`` each block's offset in the slot and its length.  Plain
    Python over the buffers: beside busy threads, a call into NumPy or
    torch may cost the GIL (see above)."""
    block = LZ4F_BLOCKSIZE
    plan = Lz4Plan()
    plan.buf_lens = [int(n) for n in buf_lens]
    spans, row_offs, lens = [], [], []
    flat = cap = 0
    for n in plan.buf_lens:
        spans.append((len(lens), -(-n // block)))
        for o in range(0, n, block):
            ln = min(block, n - o)
            row_offs.append(flat + o)
            lens.append(ln)
            cap += ln + 16 + ln // 255
        flat += (n + 15) & ~15
    plan.B = B = len(lens)
    plan.N = max(16, (max(lens) + 15) & ~15) if B else 16
    plan.lens, plan.row_offs, plan.spans = lens, row_offs, spans
    plan.flat_bytes = flat
    # then B int64 row offsets and B int32 lengths, padded to 8 bytes
    plan.nbytes = flat + 8 * B + 4 * (B + B % 2)
    plan.cap = max(16, cap)
    # cursor, offsets, crc_comp, crc_raw (int64 each), olen (int32 pairs)
    plan.out_words = 1 + 3 * B + -(-B // 2)
    return plan


def _packers():
    """tk_lz4_pack_round of the port's native codec library, bound twice:
    (called with the GIL held, called with it released)."""
    global _pack_fns
    if _pack_fns is None:
        from .native.build import build
        so = build()
        fns = []
        for L in (ctypes.PyDLL(so), ctypes.CDLL(so)):
            fn = L.tk_lz4_pack_round
            fn.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                           ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int64]
            fn.restype = ctypes.c_int64
            fns.append(fn)
        _pack_fns = tuple(fns)
    return _pack_fns


def pack_lz4(slot: "_crc.Slot", plan: Lz4Plan, bufs) -> None:
    """Write the planned buffers (bytes) into ``slot``, each from its
    16-byte aligned offset with zeros after it, then the metadata, in one
    native call (after the slot's last launch no longer reads it)."""
    if plan.nbytes > slot.cap:
        raise ValueError(f"launch of {plan.nbytes} B over its slot's "
                         f"{slot.cap}")
    if len(bufs) != len(plan.buf_lens):
        raise ValueError(f"{len(bufs)} buffers for a plan of "
                         f"{len(plan.buf_lens)}")
    for b, n in zip(bufs, plan.buf_lens):
        if len(b) != n:
            raise ValueError(f"a buffer of {len(b)} B planned as {n}")
    bufs = [b if type(b) is bytes else bytes(b) for b in bufs]
    held, released = _packers()
    pack = released if plan.nbytes > PACK_RELEASE_BYTES else held
    slot.wait()
    n = len(bufs)
    got = pack((ctypes.c_char_p * n)(*bufs),
               (ctypes.c_int64 * n)(*plan.buf_lens), n,
               slot.host.data_ptr(), slot.cap)
    if got != plan.nbytes:
        raise RuntimeError(f"tk_lz4_pack_round wrote {got} B, the plan "
                           f"{plan.nbytes}")


class Lz4Lane:
    """A lane's compress rounds: the lane's ``bufs``
    (crc32c_torch.LaneBuffers: its stream, and the ``flat`` and ``out``
    its rounds share with its CRC launches) and, made on a card's first
    round, what only the rounds reuse: the kernel's ``scratch`` (sized
    once, for its widest launch), ``rb_stream`` for the bulk readback (the
    lane's own stream may already hold the next launch), and the device
    and pinned buffers of each staging slot a round has used
    (``rounds``)."""

    __slots__ = ("bufs", "scratch", "rb_stream", "rounds")

    def __init__(self, bufs: "_crc.LaneBuffers"):
        self.bufs = bufs
        self.scratch = self.rb_stream = None
        self.rounds: dict = {}      # staging slot -> _Round


class _Round:
    """A staging slot's compress round on a card: the kernel's packed
    output ``comp``, the pinned ``back`` its bytes come back into, and
    ``done``, the event the round's native call records."""

    __slots__ = ("comp", "back", "done")

    def __init__(self, stream):
        self.comp = self.back = None
        # recorded once so that the CUDA event exists: the round's native
        # call records it again
        self.done = torch.cuda.Event()
        self.done.record(stream)


def _grow(t, n: int, **kw):
    """``t``, or a new tensor of at least ``n`` elements when it is
    smaller (None: none yet)."""
    if t is not None and t.numel() >= n:
        return t
    return torch.empty((_crc._pow2(n, 1024),), **kw)


def _reserve(slot: "_crc.Slot", plan: Lz4Plan, lane: Lz4Lane) -> _Round:
    """Grow the device and pinned buffers a round in ``slot`` on ``lane``
    reuses: torch calls, made only when a round outgrows them."""
    bufs = lane.bufs
    dev = bufs.device
    if (bufs.flat is None or bufs.flat.numel() < plan.nbytes
            or bufs.out is None or bufs.out.numel() < plan.out_words):
        with torch.cuda.stream(bufs.stream):
            bufs.reserve(plan.nbytes, 0, plan.out_words)
    if lane.scratch is None:
        lib = _kernel_lib()
        with torch.cuda.device(dev):
            nbytes = lib.lz4_rows_scratch_bytes(1 << 40, LZ4F_BLOCKSIZE)
        if nbytes < 0:
            raise RuntimeError(f"lz4_rows_scratch_bytes: cudaError {-nbytes}")
        with torch.cuda.stream(bufs.stream):
            lane.scratch = torch.empty((nbytes,), dtype=torch.uint8,
                                       device=dev)
        lane.rb_stream = torch.cuda.Stream(dev)
    rnd = lane.rounds.get(slot)
    if rnd is None:
        rnd = lane.rounds[slot] = _Round(bufs.stream)
    if rnd.comp is None or rnd.comp.numel() < plan.cap + 16:
        # 16 bytes of slack: the CRC epilogue reads whole 16-byte chunks
        with torch.cuda.stream(bufs.stream):
            rnd.comp = _grow(rnd.comp, plan.cap + 16, dtype=torch.uint8,
                             device=dev)
    rnd.back = _grow(rnd.back, plan.cap, dtype=torch.uint8, pin_memory=True)
    slot.out = _grow(slot.out, plan.out_words, dtype=torch.int64,
                     pin_memory=True)
    return rnd


def launch_lz4(slot: "_crc.Slot", plan: Lz4Plan, lane: Lz4Lane):
    """Queue the round packed in ``slot`` on ``lane``: on a card one
    native call (lz4_rows_round) makes the H2D copy, the chain's wait
    (crc32c_torch.chained_launch), the kernel ("both") and the D2H copy of
    the metadata into ``slot.out``, and records the round's event; returns
    None (:func:`read_lz4` reads it back).  A CPU lane runs
    :func:`lz4_rows` on rows rebuilt from the slot (the plain version) and
    returns read_lz4's tuple."""
    B = plan.B
    bufs = lane.bufs
    if bufs.stream is None:
        flat = slot.host[:plan.flat_bytes]
        data = torch.zeros((B, plan.N), dtype=torch.uint8)
        for r, (o, n) in enumerate(zip(plan.row_offs, plan.lens)):
            data[r, :n] = flat[o:o + n]
        comp, olen, cc, cr = lz4_rows(
            data, torch.tensor(plan.lens, dtype=torch.int32), "both")
        olen = olen.numpy()
        offs = np.cumsum(olen.astype(np.int64)) - olen
        packed = np.concatenate([comp[r, :olen[r]].numpy()
                                 for r in range(B)] or [np.zeros(0, np.uint8)])
        return (packed, offs, olen, cc.numpy().astype(np.uint32),
                cr.numpy().astype(np.uint32))
    rnd = _reserve(slot, plan, lane)
    lib = _kernel_lib()
    stream = bufs.stream
    args = (stream.device_index, slot.host.data_ptr(), bufs.flat.data_ptr(),
            plan.nbytes, plan.flat_bytes, B, plan.N, rnd.comp.data_ptr(),
            bufs.out.data_ptr(), plan.out_words, slot.out.data_ptr(),
            _crc._device_consts(bufs.device).data_ptr(),
            lane.scratch.data_ptr(), lane.scratch.numel(), stream.cuda_stream)
    _crc.chained_launch(
        stream, lambda wait: lib.held.lz4_rows_round(
            *args, 0 if wait is None else wait.cuda_event,
            rnd.done.cuda_event), rnd.done, "lz4_rows")
    slot.event = rnd.done
    _count(launched=1, h2d=plan.nbytes)
    return None


def read_lz4(slot: "_crc.Slot", plan: Lz4Plan, lane: Lz4Lane):
    """A card round's results once its metadata has landed: (packed bytes
    (uint8 array), offsets (B,), olen (B,), crc_comp (B,) uint32, crc_raw
    (B,) uint32), views of pinned buffers valid until the slot's next
    launch.  One native call (lz4_rows_readback) waits for the round and
    copies only the cursor's bytes back, on the lane's readback stream; it
    holds the GIL when the round is done already, and a round still
    running is waited for in a second call that gives the GIL up."""
    lib = _kernel_lib()
    rnd = lane.rounds[slot]
    rb = lane.rb_stream
    args = (rb.device_index, rnd.done.cuda_event, slot.out.data_ptr(),
            plan.cap, rnd.comp.data_ptr(), rnd.back.data_ptr(),
            rb.cuda_stream)
    used = lib.held.lz4_rows_readback(*args, 0)
    if used == _NOT_READY:
        used = lib.lz4_rows_readback(*args, 1)
    if used < 0:
        raise RuntimeError(f"lz4_rows_readback: cudaError {-used}")
    slot.event = None
    if used > plan.cap:
        raise RuntimeError(f"lz4 launch wrote {used} B past its {plan.cap}")
    B = plan.B
    m = slot.out.numpy()[:plan.out_words]
    offs = m[1:1 + B]
    cc = m[1 + B:1 + 2 * B].astype(np.uint32)
    cr = m[1 + 2 * B:1 + 3 * B].astype(np.uint32)
    olen = m[1 + 3 * B:].view(np.int32)[:B]
    _count(d2h=plan.out_words * 8 + used)
    return rnd.back.numpy()[:used], offs, olen, cc, cr


# ------------------------------------------------------ warm registry --
# The port of lz4_jax.py's warm registry (:220-357), keyed by device.  One
# build serves every shape, so a device is warm once the build is loaded,
# the CRC constants are on that device and one launch on a small row has
# matched the plain version there.  The live engines own the registry:
# each holds it from its start, the last one's close() drops it
# (drop_device_kernels), and the tests assert device_kernel_count() == 0
# once every engine is closed.  (The JAX package drops it at ANY engine's
# close, which sends every other live engine's compress jobs to the CPU
# until it re-warms.)

_READY: dict[str, bool] = {}
_HOLDERS = 0                    # engines started and not yet closed
_warm_lock = threading.Lock()


def kernel_ready(device=None) -> bool:
    """True once :func:`warm_kernel` has run for ``device``."""
    return _crc._dev_key(device) in _READY


def ready_kernel(device=None):
    """The warmed kernel wrapper for ``device`` (:func:`lz4_rows`, every
    shape), or None before :func:`warm_kernel`."""
    return lz4_rows if kernel_ready(device) else None


def warm_bucket_count(device=None) -> int:
    """Warm compress kernels on ``device``: 1 or 0."""
    return int(kernel_ready(device))


def warm_kernel(device=None) -> None:
    """Make ``device`` warm.  Idempotent and safe from any thread; a card
    whose build or first launch fails raises (the engine's lane then
    fails its compress jobs with that error)."""
    key = _crc._dev_key(device)
    if key in _READY:
        return
    with _warm_lock:
        if key in _READY:
            return
        dev = torch.device(key)
        if dev.type == "cuda":
            _kernel_lib()
            row = (b"warm " * 13)[:64]
            data, lens = pad_right([row], 64)
            want = lz4_rows_reference(torch.from_numpy(data),
                                      torch.from_numpy(lens), "both")
            got = lz4_rows(torch.from_numpy(data).to(dev),
                           torch.from_numpy(lens).to(dev), "both")
            torch.cuda.synchronize(dev)
            if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
                raise RuntimeError(f"warm lz4 launch on {key} differs from "
                                   f"the plain version")
        _READY[key] = True


def device_kernel_count() -> int:
    """Warm devices held by the registry (0 after every engine close)."""
    return len(_READY)


def release_device_kernels() -> None:
    """Drop the warm registry."""
    with _warm_lock:
        _READY.clear()


def hold_device_kernels() -> None:
    """An engine starts: the registry stays until every holder has
    let go (AsyncOffloadEngine.__init__)."""
    global _HOLDERS
    with _warm_lock:
        _HOLDERS += 1


def drop_device_kernels() -> None:
    """An engine closed (AsyncOffloadEngine.close()): the last live
    engine's close drops the registry; an earlier one leaves it warm for
    the engines still running."""
    global _HOLDERS
    with _warm_lock:
        _HOLDERS -= 1
        if not _HOLDERS:
            _READY.clear()


def release() -> None:
    """Drop every cached compress state of the port: the warm registry
    (the ctypes library stays loaded for the process)."""
    release_device_kernels()
