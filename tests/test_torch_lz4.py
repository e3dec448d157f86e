"""The port's LZ4 kernel module (librdkafka_tpu_torch/ops/lz4_torch.py) and
its codec step (models/codec_step.py) held against the JAX package's
lz4_jax (E and the fused F) and models/codec_step (I), and against the
native deterministic encoder.  On the CPU the kernel's wrapper runs its
plain PyTorch version; everything is exact (bytes and uint32 CRCs,
tolerance 0), inputs seeded through numpy."""
import numpy as np
import pytest
import torch

from librdkafka_tpu.models import codec_step as jax_step
from librdkafka_tpu.ops import lz4_jax
from librdkafka_tpu_torch.models import codec_step as port_step
from librdkafka_tpu_torch.ops import cpu as native
from librdkafka_tpu_torch.ops import crc32c_torch, lz4_torch
from librdkafka_tpu_torch.ops.packing import (FrameBlob, lz4f_frame,
                                              pad_right)
from librdkafka_tpu_torch.utils.crc import crc32c

from test_0017_codecs import CORPORA, IDS


def _rows(blocks, N):
    data, lens = pad_right(blocks, N)
    return data, lens, torch.from_numpy(data), torch.from_numpy(lens)


def _port_blocks(blocks):
    return lz4_torch.lz4_block_compress_many(blocks, device="cpu")


@pytest.mark.parametrize("name", IDS)
def test_reference_equals_jax_and_native_on_corpora(name):
    block = CORPORA[name][:65536]
    got, = _port_blocks([block])
    assert got == native.lz4_block_compress(block)
    assert got == lz4_jax.lz4_block_compress_many([block])[0]


def test_reference_mixed_sizes_and_runs():
    rng = np.random.default_rng(11)
    blocks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (0, 1, 12, 13, 100, 5000, 65536)]
    blocks += [b"z" * n for n in (15, 300, 65536)]
    got = _port_blocks(blocks)
    assert got == [native.lz4_block_compress(b) for b in blocks]
    assert got == lz4_jax.lz4_block_compress_many(blocks)
    # the edges: a block under 13 bytes is one token plus literals, and
    # an empty one the single byte 0x00
    assert got[0] == b"\x00"
    assert got[2] == bytes([12 << 4]) + blocks[2]


@pytest.mark.parametrize("N", [4096, 65536])
def test_fused_outputs_equal_jax_fused(N):
    """(comp, olen, crc_comp, crc_raw) of with_crc="both" against the JAX
    package's fused compress→CRC launch (_fused_for), row for row."""
    rng = np.random.default_rng(N)
    lens = [0, 1, 13, N // 3, N - 1, N]
    blocks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              if i % 2 else (b"abc%d" % i * N)[:n]
              for i, n in enumerate(lens)]
    data, lns, d, ln = _rows(blocks, N)
    comp, olen, cc, cr = lz4_torch.lz4_rows(d, ln, "both")
    try:
        j_comp, j_olen, j_cc, j_cr = (np.asarray(x) for x in
                                      lz4_jax._fused_for(N)(data, lns))
    finally:
        lz4_jax.release_device_kernels()    # engine-owned in the package
    assert np.array_equal(comp.numpy(), j_comp)
    assert np.array_equal(olen.numpy(), j_olen)
    assert cc.tolist() == j_cc.astype(np.int64).tolist()
    assert cr.tolist() == j_cr.astype(np.int64).tolist()
    for i, b in enumerate(blocks):
        want = native.lz4_block_compress(b)
        assert comp[i, :olen[i]].numpy().tobytes() == want
        assert not comp[i, olen[i]:].any()
        assert int(cc[i]) == crc32c(want) and int(cr[i]) == crc32c(b)


@pytest.mark.parametrize("mode", ["none", "raw", "both"])
def test_with_crc_modes(mode):
    rng = np.random.default_rng(7)
    blocks = [(b"mode-%s " % mode.encode()) * 50,
              rng.integers(0, 256, 700, dtype=np.uint8).tobytes(), b""]
    _, _, d, ln = _rows(blocks, 1024)
    comp, olen, cc, cr = lz4_torch.lz4_rows(d, ln, mode)
    assert comp.shape == (3, 1024 + 1024 // 255 + 16)
    assert olen.dtype == torch.int32
    assert (cc is not None) == (mode == "both")
    assert (cr is not None) == (mode != "none")
    if cr is not None:
        assert cr.tolist() == [crc32c(b) for b in blocks]
    if cc is not None:
        assert cc.tolist() == [crc32c(native.lz4_block_compress(b))
                               for b in blocks]


def test_wrapper_checks_and_devices(monkeypatch):
    d = torch.zeros((2, 64), dtype=torch.uint8)
    ln = torch.tensor([3, 64], dtype=torch.int32)
    with pytest.raises(ValueError):
        lz4_torch.lz4_rows(d.to(torch.int32), ln)
    with pytest.raises(ValueError):
        lz4_torch.lz4_rows(torch.zeros((2, 70), dtype=torch.uint8), ln)
    with pytest.raises(ValueError):
        lz4_torch.lz4_rows(d, ln.to(torch.int64))
    with pytest.raises(ValueError):
        lz4_torch.lz4_rows(d, ln, "crc")
    with pytest.raises(ValueError):
        lz4_torch.lz4_rows_reference(d, torch.tensor([3, 65],
                                                     dtype=torch.int32))
    with pytest.raises(ValueError):          # neither CPU nor CUDA
        lz4_torch.lz4_rows(d.to("meta"), ln.to("meta"))
    # the entry point's default device is the card: no silent CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        lz4_torch.lz4_block_compress_many([b"x" * 100])
    before = lz4_torch.launches
    lz4_torch.lz4_block_compress_many([b"x" * 100], device="cpu")
    assert lz4_torch.launches == before      # the plain version: no launch


def test_plan_lz4_layout():
    lens = [0, 5, 65536, 70_000, 17]
    plan = lz4_torch.plan_lz4(lens)
    assert plan.spans == [(0, 0), (0, 1), (1, 1), (2, 2), (4, 1)]
    assert plan.lens == [5, 65536, 65536, 70_000 - 65536, 17]
    assert all(o % 16 == 0 for o in plan.row_offs)
    # each buffer starts 16-byte aligned; its blocks are back to back
    assert plan.row_offs == [0, 16, 16 + 65536, 16 + 2 * 65536,
                             16 + 65536 + 70_000]
    assert plan.N == 65536
    assert plan.flat_bytes == 16 + 65536 + 70_000 + 32
    assert plan.nbytes == plan.flat_bytes + 8 * 5 + 4 * 6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_lz4_equals_array_formulation(seed):
    """The plan, walked buffer by buffer, against the same plan in array
    form: block lengths and offsets, width, output bound, slot bytes."""
    rng = np.random.default_rng(seed)
    buf_lens = rng.choice([0, 1, 15, 16, 17, 255, 65535, 65536, 65537,
                           200_000], 40)
    plan = lz4_torch.plan_lz4(buf_lens)
    block = 65536
    padded = (buf_lens + 15) & ~15
    offs = np.cumsum(padded) - padded
    lens = np.concatenate([np.minimum(block, n - np.arange(0, n, block))
                           for n in buf_lens if n])
    within = np.concatenate([np.arange(0, n, block) for n in buf_lens if n])
    owner = np.repeat(np.arange(len(buf_lens)), -(-buf_lens // block))
    assert plan.lens == lens.tolist()
    assert plan.row_offs == (offs[owner] + within).tolist()
    assert plan.N == int((lens.max() + 15) & ~15)
    assert plan.cap == int(lens.sum() + lens.size * 16 + (lens // 255).sum())
    assert plan.flat_bytes == int(padded.sum())
    assert plan.out_words == 1 + 3 * lens.size + -(-lens.size // 2)


def _slot_reference(plan, bufs) -> bytes:
    """The slot a round's pack must write, from its plan alone: each
    buffer and zeros up to its 16-byte padding, then the blocks' row
    offsets (int64) and lengths (int32, one zero more for an odd count)."""
    parts = []
    for b in bufs:
        parts += [bytes(b), bytes(-len(b) & 15)]
    lens = plan.lens + [0] * (plan.B % 2)
    return (b"".join(parts) + np.array(plan.row_offs, np.int64).tobytes()
            + np.array(lens, np.int32).tobytes())


def _packed(sizes, seed=7):
    """Random buffers of ``sizes``, their plan, and the bytes that
    pack_lz4 wrote into a slot first filled with other bytes."""
    rng = np.random.default_rng(seed)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]
    plan = lz4_torch.plan_lz4([len(b) for b in bufs])
    slot = crc32c_torch.Slot(crc32c_torch.slot_bucket(plan.nbytes), pin=False)
    slot.host.fill_(0xA5)
    lz4_torch.pack_lz4(slot, plan, bufs)
    return bufs, plan, slot.host.numpy()[:plan.nbytes].tobytes()


_PACK_CASES = {
    "empty": [0, 0, 0],
    "one_byte": [1],
    "15_16_17": [15, 16, 17],
    "64k": [65536],
    "2x64k": [2 * 65536],
    "64k_plus_1": [65537],
    "mixed64": np.random.default_rng(64).choice(
        [0, 1, 15, 16, 17, 1000, 65535, 65536, 65537, 140_000], 64).tolist(),
}


@pytest.mark.parametrize("case", sorted(_PACK_CASES))
def test_pack_lz4_equals_plan_layout(case):
    """The native pack writes, byte for byte, the slot the plan lays out:
    each buffer 16-byte aligned with zero padding, then the metadata."""
    bufs, plan, got = _packed(_PACK_CASES[case])
    assert len(got) == plan.nbytes
    assert got == _slot_reference(plan, bufs)


@pytest.mark.parametrize("over", [False, True], ids=["below_cut", "over_cut"])
def test_pack_lz4_either_side_of_the_release_cut(monkeypatch, over):
    """A round of more than PACK_RELEASE_BYTES is packed by the binding
    that gives the GIL up, a smaller one by the one that keeps it; both
    write the plan's layout."""
    held, released = lz4_torch._packers()
    used = []

    def tally(name, fn):
        return lambda *a: (used.append(name), fn(*a))[1]

    monkeypatch.setattr(lz4_torch, "_pack_fns",
                        (tally("held", held), tally("released", released)))
    cut = lz4_torch.PACK_RELEASE_BYTES
    sizes = ([1 << 20] * (cut >> 20) + [65537, 3] if over
             else [1 << 20] * ((cut >> 20) - 1) + [17])
    bufs, plan, got = _packed(sizes)
    assert (plan.nbytes > cut) == over
    assert used == ["released" if over else "held"]
    assert got == _slot_reference(plan, bufs)


def test_pack_lz4_two_chunk_round(monkeypatch):
    """A round the engine cuts into two launches: each chunk's slot is
    the plan's layout of its own buffers."""
    from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine
    monkeypatch.setattr(crc32c_torch, "LAUNCH_BYTES", 250_000)
    sizes = [70_000, 90_000, 65536, 1, 150_000, 17]
    chunks = AsyncOffloadEngine._chunks(np.array(sizes, np.int64))
    assert len(chunks) == 2, chunks
    for a, b in chunks:
        bufs, plan, got = _packed(sizes[a:b], seed=a)
        assert got == _slot_reference(plan, bufs)


def test_pack_lz4_refuses_what_does_not_fit():
    plan = lz4_torch.plan_lz4([100, 200])
    slot = crc32c_torch.Slot(crc32c_torch.slot_bucket(plan.nbytes), pin=False)
    with pytest.raises(ValueError):        # a buffer the plan did not see
        lz4_torch.pack_lz4(slot, plan, [b"x" * 100, b"y" * 199])
    with pytest.raises(ValueError):
        lz4_torch.pack_lz4(slot, plan, [b"x" * 100])
    small = lz4_torch.plan_lz4([2 << 20])
    with pytest.raises(ValueError):        # more than the slot holds
        lz4_torch.pack_lz4(slot, small, [bytes(2 << 20)])


def test_warm_registry_cpu():
    lz4_torch.release()
    assert lz4_torch.device_kernel_count() == 0
    assert not lz4_torch.kernel_ready("cpu")
    assert lz4_torch.ready_kernel("cpu") is None
    lz4_torch.warm_kernel("cpu")
    assert lz4_torch.kernel_ready("cpu")
    assert lz4_torch.ready_kernel("cpu") is lz4_torch.lz4_rows
    assert lz4_torch.warm_bucket_count("cpu") == 1
    assert lz4_torch.device_kernel_count() == 1
    lz4_torch.release_device_kernels()
    assert lz4_torch.device_kernel_count() == 0


# ---------------------------------- the kernel's decomposition (stage 2-3) --
# csrc/lz4_rows.cu finds every position's candidate through S segment
# tables and a prefix-max fix-up, then walks the chain read-only; its CPU
# model (segment_candidates, chain_walk) must give JAX's and native's
# bytes for every segment count, on the corpora and the kernel's edge rows.

_DECOMP = {}


def _decomp_rows():
    if not _DECOMP:
        blocks = [CORPORA[k][:65536] for k in IDS] + lz4_torch.edge_rows()
        _, _, d, ln = _rows(blocks, 65536)
        _DECOMP.update(
            blocks=blocks, d=d, ln=ln,
            native=[native.lz4_block_compress(b) for b in blocks],
            jax=lz4_jax.lz4_block_compress_many(blocks))
    return _DECOMP


@pytest.mark.parametrize("S", [1, 2, 4, 6, 8, 32])
def test_segment_candidates_equal_sort(S):
    """Every position that can start a match gets the candidate of the
    sort formulation (_compress_rows, lz4_jax.py:83-90), and the same
    valid bit."""
    r = _decomp_rows()
    d, ln = r["d"], r["ln"]
    cand, valid = lz4_torch.segment_candidates(d, ln, S)
    B, N = d.shape
    pos = torch.arange(N, dtype=torch.int64).expand(B, N)
    x = d.to(torch.int64)

    def at(i):
        return torch.gather(x, 1, i.clamp(0, N - 1))

    val = at(pos) | (at(pos + 1) << 8) | (at(pos + 2) << 16) \
        | (at(pos + 3) << 24)
    want = lz4_torch.sort_candidates(lz4_torch._hash(val))
    want_valid = ((want >= 0) & (torch.gather(val, 1, want.clamp(0, N - 1))
                                 == val)
                  & (pos + 12 <= ln.to(torch.int64).view(B, 1)))
    for b, blk in enumerate(r["blocks"]):
        P = max(0, len(blk) - 11)
        assert torch.equal(cand[b, :P], want[b, :P]), b
        assert (cand[b, P:] == -1).all()
    assert torch.equal(valid, want_valid)


@pytest.mark.parametrize("S", [1, 2, 4, 6, 8, 32])
def test_chain_walk_equals_jax_and_native(S):
    """S candidate segments, then S chain walks joined in order (S = 1 is
    the serial walk; the kernel takes 6 and 8)."""
    r = _decomp_rows()
    cand, valid = lz4_torch.segment_candidates(r["d"], r["ln"], S)
    comp, olen, nseq = lz4_torch.chain_walk(r["d"], r["ln"], cand, valid,
                                            walkers=S)
    for b in range(len(r["blocks"])):
        got = comp[b, :olen[b]].numpy().tobytes()
        assert got == r["native"][b], b
        assert got == r["jax"][b], b
        assert not comp[b, olen[b]:].any()
        assert int(nseq[b]) == len(lz4_torch.parse_sequences(got))


@pytest.mark.parametrize("mode", ["none", "both", "raw"])
def test_edge_rows_reference_equals_native(mode):
    """The plain version on the kernel's edge rows, every with_crc mode
    (the card holds the kernel to it on the same rows)."""
    blocks = lz4_torch.edge_rows()
    _, _, d, ln = _rows(blocks, 65536)
    comp, olen, cc, cr = lz4_torch.lz4_rows(d, ln, mode)
    want = [native.lz4_block_compress(b) for b in blocks]
    assert [comp[i, :olen[i]].numpy().tobytes()
            for i in range(len(blocks))] == want
    if cc is not None:
        assert cc.tolist() == [crc32c(w) for w in want]
    if cr is not None:
        assert cr.tolist() == [crc32c(b) for b in blocks]


def test_edge_rows_shapes():
    """The edge rows hold what they are named for."""
    blocks = lz4_torch.edge_rows()
    outs = [native.lz4_block_compress(b) for b in blocks]
    seqs = [lz4_torch.parse_sequences(o) for o in outs]
    offs = [{off for _, off, _ in s} for s in seqs]
    lens = [len(b) for b in blocks]
    assert {15330, 23670, 9100} <= offs[0]     # copies across the borders
    assert min(len(s) for s in seqs[1:3]) > 2048
    assert min(lens) == 11 and 9536 in lens
    assert any(n % 16 and n % 32 for n in lens)
    assert max(len(o) for o in outs) == 65536 + (65536 - 15) // 255 + 2
    assert 241 in [len(s) for s in seqs]          # all-equal: capped
    assert 65520 in offs[-4] and 65524 in offs[-3]
    assert not {65532, 65535} & offs[-2]


# -------------------------------------------------- frames (test_0135) --

def test_frameblob_region_crc_folds_exactly():
    rng = np.random.default_rng(1)
    raws = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (100, 65536, 7)]
    bodies = []
    for raw in raws:
        comp = native.lz4_block_compress(raw)
        bodies.append((comp, crc32c(comp), raw, crc32c(raw)))
    blob = lz4f_frame(bodies)
    assert isinstance(blob, FrameBlob)
    for prefix in (b"", b"hdr", b"\x00" * 61):
        assert blob.region_crc(prefix) == crc32c(prefix + bytes(blob))


def test_lz4f_frame_matches_native_deterministic():
    """Frames assembled from the kernel's rows (store-raw rule included)
    equal the native deterministic encoder's, empty frame too."""
    assert bytes(lz4f_frame([])) == native.lz4f_compress_many(
        [b""], deterministic=True)[0]
    rng = np.random.default_rng(3)
    buf = (b"frame " * 20_000) + rng.integers(0, 256, 70_000,
                                              dtype=np.uint8).tobytes()
    blocks = [buf[i:i + 65536] for i in range(0, len(buf), 65536)]
    comp = _port_blocks(blocks)
    blob = lz4f_frame([(c, crc32c(c), b, crc32c(b))
                       for c, b in zip(comp, blocks)])
    assert bytes(blob) == native.lz4f_compress_many(
        [buf], deterministic=True)[0]
    assert blob.region_crc() == crc32c(bytes(blob))


# ------------------------------------------------------ codec step (I) --

def test_batched_codec_step_equals_jax():
    import jax
    data, lens = port_step.example_inputs()
    j_data, j_lens = jax_step.example_inputs()
    assert np.array_equal(data, j_data) and np.array_equal(lens, j_lens)
    j_out, j_olen, j_crc = (np.asarray(x) for x in jax.jit(
        jax_step.batched_codec_step())(j_data, j_lens))
    out, olen, crc = port_step.batched_codec_step()(
        torch.from_numpy(data), torch.from_numpy(lens))
    assert np.array_equal(out.numpy(), j_out)
    assert np.array_equal(olen.numpy(), j_olen)
    assert crc.tolist() == j_crc.astype(np.int64).tolist()


def test_pipelined_codec_step_through_engine():
    from librdkafka_tpu_torch.ops.engine import AsyncOffloadEngine
    eng = AsyncOffloadEngine(devices=["cpu"])
    try:
        submit = port_step.pipelined_codec_step(eng, 1024, 4, device="cpu")
        tickets = [submit(*port_step.example_inputs(1024, 4, seed))
                   for seed in range(3)]
        for seed, t in enumerate(tickets):
            out, olen, crc = t.result(120)
            data, _ = port_step.example_inputs(1024, 4, seed)
            assert isinstance(out, np.ndarray)
            assert crc.tolist() == [crc32c(r.tobytes()) for r in data]
            assert [out[i, :olen[i]].tobytes() for i in range(4)] == [
                native.lz4_block_compress(r.tobytes()) for r in data]
    finally:
        eng.close()
    assert lz4_torch.device_kernel_count() == 0
