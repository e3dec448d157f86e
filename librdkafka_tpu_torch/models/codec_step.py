"""The batched codec step: LZ4-compress many blocks and checksum them in
one launch — the port of librdkafka_tpu/models/codec_step.py.

``batched_codec_step(block_bytes, n_blocks)`` returns a function mapping
``(data (B, N) uint8, lens (B,) int32)`` to ``(compressed (B, C) uint8,
out_lens (B,) int32, crcs (B,) int64 holding the uint32)``: the LZ4
block encode of every row plus the CRC32C of every raw row, one launch
of the hand-written kernel (ops/lz4_torch.py ``lz4_rows`` with
``with_crc="raw"``).  The JAX step ran a vmapped encoder and the CRC
kernel over left-padded rows; here the CRC is the kernel's epilogue over
each row's first ``lens[b]`` bytes, the standard CRC32C (equal to the
JAX step's for full rows, which is what ``example_inputs`` gives).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import lz4_torch


def batched_codec_step(block_bytes: int = 4096, n_blocks: int = 8):
    """The step for B = ``n_blocks`` rows of ``block_bytes`` each.  It
    runs where its inputs lie: on the card through the kernel, on the
    CPU through the kernel's plain version."""
    N, B = block_bytes, n_blocks

    def step(data: torch.Tensor, lens: torch.Tensor):
        if data.shape != (B, N):
            raise ValueError(f"data must be ({B}, {N}), not "
                             f"{tuple(data.shape)}")
        out, olen, _, crc = lz4_torch.lz4_rows(data, lens, with_crc="raw")
        return out, olen, crc

    return step


def pipelined_codec_step(engine, block_bytes: int = 4096,
                         n_blocks: int = 8, device=None):
    """Drive the step through the async offload engine (ops/engine.py):
    returns ``submit(data, lens) -> Ticket``.  The arrays are copied to
    ``device`` (the card unless the caller asks for the CPU) and the step
    runs on the dispatch thread, on lane 0's stream, with the engine's
    in-flight depth, so a caller prepares step k+1 while step k runs; a
    ticket resolves to the host tuple ``(compressed, out_lens, crcs)``
    of numpy arrays."""
    step = batched_codec_step(block_bytes, n_blocks)
    dev = lz4_torch._crc.resolve_device(device)

    def run(data, lens):
        return step(torch.as_tensor(data).to(dev, non_blocking=True),
                    torch.as_tensor(lens).to(dev, non_blocking=True))

    def submit(data, lens):
        return engine.submit_compute(run, data, lens)

    return submit


def example_inputs(block_bytes: int = 4096, n_blocks: int = 8,
                   seed: int = 0):
    """Deterministic example (data, lens) for :func:`batched_codec_step`,
    numpy arrays (the JAX package's, value for value)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 64, (n_blocks, block_bytes), dtype=np.uint8)
    lens = np.full((n_blocks,), block_bytes, dtype=np.int32)
    return data, lens
