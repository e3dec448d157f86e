"""The package's entry points: the port of the repository's
``__graft_entry__.py``.

``entry()`` — the flagship step, the batched MessageSet codec step (LZ4
block encode plus the CRC32C of many partition blocks in one launch of
csrc/lz4_rows.cu), with its example inputs on the device.

``dryrun_multichip(n_devices)`` — the sharded codec step (kernel H,
parallel/mesh.py) over a mesh of ``n_devices`` devices, one step on tiny
shapes, including the cross-device sum of the compressed byte counter.

Both run on the card unless the caller asks otherwise: ``entry(device=
"cpu")`` and ``dryrun_multichip(n, devices=["cpu"] * n)`` run the
kernels' plain PyTorch versions on the host.
"""
from __future__ import annotations

import torch

from .models import batched_codec_step, example_inputs
from .ops import cpu
from .ops.crc32c_torch import resolve_device
from .parallel.mesh import make_mesh, shard_compress
from .utils.crc import crc32c


def entry(device=None):
    """(step, (data, lens)): the codec step for 8 blocks of 4,096 B and
    its deterministic example inputs as tensors on ``device`` (the card
    by default; a host without CUDA raises)."""
    dev = resolve_device(device)
    step = batched_codec_step(block_bytes=4096, n_blocks=8)
    data, lens = example_inputs(block_bytes=4096, n_blocks=8)
    return step, (torch.from_numpy(data).to(dev),
                  torch.from_numpy(lens).to(dev))


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run ``shard_compress`` over a mesh of the first ``n_devices`` of
    ``devices`` (default: the visible cards; fewer than ``n_devices``
    raises) on 2n+1 small blocks, holding the blocks to the native block
    encoder, the CRCs to crc32c and the total to the summed lengths."""
    mesh = make_mesh(n_devices, devices)
    blocks = [(b"block-%d " % i) * 40 for i in range(2 * n_devices + 1)]
    outs, crcs, total = shard_compress(mesh, blocks)
    for got, b in zip(outs, blocks):
        if got != cpu.lz4_block_compress(b):
            raise AssertionError("sharded lz4 mismatch")
    if [int(c) for c in crcs] != [crc32c(b) for b in blocks]:
        raise AssertionError("sharded crc32c mismatch")
    if total != sum(len(o) for o in outs):
        raise AssertionError("sharded total != the summed lengths")
