"""The oracle: what a partition log read back from the broker must hold.

It takes the raw log bytes of every partition, as the broker stored
them, and the records the traffic sent, regenerated from the seed, and
counts what is wrong.  Every count must be 0.  It imports nothing of the
program under test.
"""
from __future__ import annotations

import numpy as np

from . import batch as B
from .crc32c import crc32c_many
from .lz4 import Lz4Error, decode_frame

#: the numbers :func:`check_log` returns, each compared against 0
LOG_CHECKS = ("stored_vs_acked", "frame_bad", "crc_bad", "seq_bad",
              "lz4_bad", "record_bad", "value_bad")


def check_log(parts: dict, expect, acked: dict, *, idempotent: bool,
              codec: str, rng: np.random.Generator,
              slice_batches: int) -> tuple[dict, dict]:
    """Judge a topic's logs.

    ``parts`` maps a partition to ``(start_offset, end_offset, log)``:
    the first offset the broker still holds (retention drops the oldest
    batches), the offset after its last record, and the stored batches'
    bytes.  ``expect(p, offset)`` is the value the traffic sent as that
    record; ``acked[p]`` counts the records acknowledged to partition
    ``p``.  Every batch's framing and CRC32C is checked.  In every
    partition, ``slice_batches`` consecutive batches from a start drawn
    with ``rng`` (all of them where it holds fewer) are decompressed and
    every record in them is held to ``expect``.  Returns (counts, what
    was covered)."""
    c = dict.fromkeys(LOG_CHECKS, 0)
    batches = []                      # (partition, Batch, log)
    first = {}                        # partition -> its first in batches
    pid_epoch = set()
    reasons: dict[str, int] = {}         # what made batches frame_bad
    for p, (start, end, log) in sorted(parts.items()):
        c["stored_vs_acked"] += abs(end - acked.get(p, 0))
        nxt = start
        first[p] = len(batches)
        try:
            for b in B.iter_batches(log):
                batches.append((p, b, log))
                why = [k for k, bad in (
                    ("offset_gap", b.base_offset != nxt),
                    ("empty", b.record_count < 1),
                    ("last_offset_delta",
                     b.last_offset_delta != b.record_count - 1),
                    # lz4, or none where lz4 would not shrink the batch
                    # (the writer then stores it plain, as librdkafka)
                    ("codec", b.codec not in (codec, "none")),
                    ("control", b.control or b.transactional),
                    ("timestamps", b.max_timestamp < b.first_timestamp))
                    if bad]
                c["frame_bad"] += bool(why)
                for k in why:
                    reasons[k] = reasons.get(k, 0) + 1
                nxt = b.base_offset + b.record_count
                if idempotent:
                    pid_epoch.add((b.producer_id, b.producer_epoch))
                    # one producer wrote the topic from offset 0, so a
                    # batch's first sequence is its first offset
                    c["seq_bad"] += (b.producer_id < 0
                                     or b.base_sequence != b.base_offset)
        except B.BatchError as e:
            c["frame_bad"] += 1
            reasons[str(e)] = reasons.get(str(e), 0) + 1
            continue
        if nxt != end:
            c["frame_bad"] += 1
            reasons["log_end"] = reasons.get("log_end", 0) + 1
    c["seq_bad"] += max(0, len(pid_epoch) - 1)
    covered = {"batches": len(batches), "records_stored": 0,
               "batches_sampled": 0, "records_sampled": 0}
    if reasons:
        covered["frame_bad_reasons"] = reasons
    for p, b, log in batches:
        covered["records_stored"] += b.record_count
    # every batch's CRC32C, over one buffer per partition log
    by_log: dict[int, list] = {}
    for p, b, log in batches:
        by_log.setdefault(id(log), [log, []])[1].append(b)
    for log, bs in by_log.values():
        got = crc32c_many(log, [b.start + B.CRC_START for b in bs],
                          [b.start + b.length for b in bs])
        c["crc_bad"] += int(sum(int(g) != b.crc for g, b in zip(got, bs)))
    if not batches:
        return c, covered
    ends = sorted(first.values())[1:] + [len(batches)]
    pick = []
    for a, z in zip(sorted(first.values()), ends):
        a += int(rng.integers(0, max(1, z - a - slice_batches + 1)))
        pick += range(a, min(z, a + slice_batches))
    for k in pick:
        p, b, log = batches[k]
        payload = log[b.start + B.HEADER_SIZE:b.start + b.length]
        if b.codec == "lz4":
            try:
                payload = decode_frame(payload)
            except Lz4Error:
                c["lz4_bad"] += 1
                continue
        elif b.codec != "none":
            c["lz4_bad"] += 1
            continue
        try:
            recs = B.parse_records(payload, b.record_count)
        except B.BatchError:
            c["record_bad"] += 1
            continue
        covered["batches_sampled"] += 1
        covered["records_sampled"] += len(recs)
        for i, r in enumerate(recs):
            if r.offset_delta != i or r.key is not None or r.headers:
                c["record_bad"] += 1
            elif r.value != expect(p, b.base_offset + i):
                c["value_bad"] += 1
    return c, covered
