#!/usr/bin/env python3
"""Probe the LZ4 kernel (librdkafka_tpu_torch/csrc/lz4_rows.cu) alone on one
CUDA card: build it, print ptxas's registers and spills and the CTAs an SM
holds at 64 KB rows, hold it byte for byte against the native
deterministic encoder (and the CRCs against the native crc32c) in every
``with_crc`` mode on its edge rows, chip_smoke's sweep and the main path's
1,024 blocks, then time it in every mode (CUDA events, L2 flushed) and
print the SM cycles of each of its stages (a -DLZ4_STAGE_CLOCKS build) a
row at 1,024, 264 and 132 rows: two CTAs an SM, one CTA a slot, one CTA an
SM.  Run from the root of the repository:

    python3 scripts/lz4_stages.py

Exits non-zero when a row differs.  The numbers are the kernel's alone;
chip_smoke.py phase 5 holds the whole compress route.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs                                     # noqa: E402
from librdkafka_tpu_torch import CpuCodecProvider           # noqa: E402
from librdkafka_tpu_torch.ops import cpu as native          # noqa: E402
from librdkafka_tpu_torch.ops import lz4_torch as lz4       # noqa: E402
from librdkafka_tpu_torch.ops.packing import (LZ4F_BLOCKSIZE,  # noqa: E402
                                              pad_right)
from librdkafka_tpu_torch.protocol.msgset import MsgsetWriterV2  # noqa: E402


def main_path_blocks() -> list[bytes]:
    work = cs.workload(CpuCodecProvider())
    bufs = [MsgsetWriterV2(codec="lz4").build(recs, cs.NOW_MS).records_bytes
            for recs in work["parts"]]
    return [b[i:i + LZ4F_BLOCKSIZE] for b in bufs
            for i in range(0, len(b), LZ4F_BLOCKSIZE)]


def exact(name: str, blocks: list[bytes]) -> int:
    """Rows that differ from native, over the three modes."""
    data, lens = pad_right(blocks, LZ4F_BLOCKSIZE)
    d, ln = torch.from_numpy(data).cuda(), torch.from_numpy(lens).cuda()
    want = [native.lz4_block_compress(b) for b in blocks]
    bad = 0
    for mode in lz4.MODES:
        comp, olen, cc, cr = lz4.lz4_rows(d, ln, mode)
        torch.cuda.synchronize()
        comp, olen = comp.cpu().numpy(), olen.cpu().numpy()
        wrong = [i for i in range(len(blocks))
                 if comp[i, :olen[i]].tobytes() != want[i]
                 or comp[i, olen[i]:].any()]
        if cc is not None and cc.cpu().tolist() != [native.crc32c(w)
                                                    for w in want]:
            wrong.append("crc_comp")
        if cr is not None and cr.cpu().tolist() != [native.crc32c(b)
                                                    for b in blocks]:
            wrong.append("crc_raw")
        print(f"{name} ({len(blocks)} blocks) with_crc={mode}: "
              f"{'exact' if not wrong else f'DIFFERS at {wrong[:8]}'}")
        bad += len(wrong)
    return bad


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("lz4_stages: needs a CUDA card")
    print(cs.phase_device()["smi"])
    print(f"CTAs per SM at N = 65536: {lz4.ctas_per_sm(65536)}")
    blocks = main_path_blocks()
    bad = (exact("edge rows", lz4.edge_rows())
           + exact("sweep", cs.lz4_sweep(np.random.default_rng(0)))
           + exact("main path", blocks))
    data, lens = pad_right(blocks, LZ4F_BLOCKSIZE)
    d, ln = torch.from_numpy(data).cuda(), torch.from_numpy(lens).cuda()
    for mode in lz4.MODES:
        print(f"lz4_rows with_crc={mode} at {len(blocks)} blocks: "
              f"{cs.kernel_ms(lambda: lz4.lz4_rows(d, ln, mode), 10):.4f} ms "
              f"(L2 flushed)")
    t0 = time.perf_counter()
    for B in (1024, 264, 132):
        clk = lz4.stage_clocks(d[:B], ln[:B], "both")
        print(f"stage cycles a row at {B} rows: " + "; ".join(
            f"{k} {v / B:.0f}" for k, v in clk.items()))
    print(f"stage clocks took {time.perf_counter() - t0:.1f} s "
          f"(their build included)")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
