"""The oracle of an exactly-once copy: what the output topic's logs, read
back from the broker, must hold against the input the copy read.

The copy read record ``i`` of the input at partition ``i mod N``, offset
``i // N`` (one idempotent feeder wrote the input from offset 0), with
key ``i`` as 8 bytes big-endian and a known value, and wrote its key and
value to the same partition of the output inside transactions.  This
module applies read_committed itself: it gathers each partition's data
batches by (producer id, epoch) and resolves them at that producer's
COMMIT or ABORT control record; a transaction with no marker in the
log counts as open.  It imports nothing of the program under test.

Every count it returns must be 0:

over every batch
    ``frame_bad``   framing: offsets contiguous, counts, codec, a data
                    batch transactional with a producer id, a control
                    batch one record of COMMIT or ABORT
    ``crc_bad``     the stored CRC32C
    ``seq_bad``     sequences contiguous per (producer id, epoch)
    ``marker_bad``  a control batch with no data of its (producer id,
                    epoch) before it since that producer's last marker
over every partition
    ``count_bad``   the committed records from the first committed
                    batch held to the end, against the group's committed
                    input offset less that batch's first key's offset
    ``offsets_bad`` the group's committed input offset against the
                    offset after the last committed record's key
over ``slice_batches`` consecutive committed data batches a partition
    ``lz4_bad``, ``record_bad``, ``key_bad`` (keys consecutive and of
    their partition: a duplicate or a gap), ``value_bad``
"""
from __future__ import annotations

import struct

import numpy as np

from . import batch as B
from .crc32c import crc32c_many
from .lz4 import Lz4Error, decode_frame

EOS_CHECKS = ("frame_bad", "crc_bad", "seq_bad", "marker_bad", "count_bad",
              "offsets_bad", "lz4_bad", "record_bad", "key_bad",
              "value_bad")

#: a control record's key: version int16, type int16 (0 ABORT, 1 COMMIT)
_CTRL_KEY = struct.Struct(">hh")
ABORT, COMMIT = 0, 1


def key_index(key: bytes) -> int:
    """The input record index a copied key carries."""
    return int.from_bytes(key, "big")


def _payload(log: bytes, b: B.Batch) -> bytes:
    """A batch's records section, decompressed; raises Lz4Error."""
    payload = log[b.start + B.HEADER_SIZE:b.start + b.length]
    if b.codec == "lz4":
        return decode_frame(payload)
    if b.codec != "none":
        raise Lz4Error(f"codec {b.codec}")
    return payload


def _records(log: bytes, b: B.Batch) -> list[B.Record]:
    """A batch's records; raises Lz4Error or BatchError."""
    return B.parse_records(_payload(log, b), b.record_count)


class _Partition:
    """One partition's batches, resolved: each data batch's fate
    (``committed``, ``aborted``, ``open``)."""

    def __init__(self, p: int, start: int, end: int, log: bytes):
        self.p, self.start, self.end, self.log = p, start, end, log
        self.batches: list[B.Batch] = []
        self.fate: dict[int, str] = {}         # batch index -> fate
        self.committed: list[int] = []         # committed data batches


def _scan(part: _Partition, codec: str, c: dict, reasons: dict) -> None:
    """Framing, sequences and markers of one partition's log."""
    def bad(kind: str, why: str) -> None:
        c[kind] += 1
        reasons[why] = reasons.get(why, 0) + 1
    nxt = part.start
    seq: dict = {}                     # (pid, epoch) -> next sequence
    open_txn: dict = {}                # pid -> (epoch, [batch indexes])
    seen: set = set()                  # pids with data in the held log
    try:
        for b in B.iter_batches(part.log):
            k = len(part.batches)
            part.batches.append(b)
            why = [w for w, is_bad in (
                ("offset_gap", b.base_offset != nxt),
                ("empty", b.record_count < 1),
                ("last_offset_delta",
                 b.last_offset_delta != b.record_count - 1),
                ("not_transactional", not b.transactional),
                ("no_producer_id", b.producer_id < 0),
                ("timestamps", b.max_timestamp < b.first_timestamp))
                if is_bad]
            if b.control:
                why += [w for w, is_bad in (
                    ("control_count", b.record_count != 1),
                    ("control_codec", b.codec != "none")) if is_bad]
            elif b.codec not in (codec, "none"):
                why.append("codec")
            for w in why:
                reasons[w] = reasons.get(w, 0) + 1
            c["frame_bad"] += bool(why)
            nxt = b.base_offset + b.record_count
            pe = (b.producer_id, b.producer_epoch)
            if not b.control:
                want = seq.get(pe)
                if b.base_sequence < 0 or (want is not None
                                           and b.base_sequence != want):
                    bad("seq_bad", "sequence")
                seq[pe] = b.base_sequence + b.record_count
                seen.add(b.producer_id)
                cur = open_txn.get(b.producer_id)
                if cur is not None and cur[0] != b.producer_epoch:
                    # a new epoch over an unmarked transaction
                    bad("marker_bad", "epoch_without_marker")
                    for j in cur[1]:
                        part.fate[j] = "open"
                    cur = None
                if cur is None:
                    cur = open_txn[b.producer_id] = (b.producer_epoch, [])
                cur[1].append(k)
                continue
            try:
                recs = _records(part.log, b)
                kind = _CTRL_KEY.unpack(recs[0].key)[1]
            except (B.BatchError, Lz4Error, TypeError, struct.error):
                bad("frame_bad", "control_record")
                continue
            if kind not in (ABORT, COMMIT):
                bad("frame_bad", "control_type")
                continue
            cur = open_txn.pop(b.producer_id, None)
            if cur is None or cur[0] != b.producer_epoch:
                # retention may have dropped the data of a partition's
                # first transactions, before any data held of the pid
                if not (part.start > 0 and b.producer_id not in seen):
                    bad("marker_bad", "marker_without_data")
                if cur is not None:
                    open_txn[b.producer_id] = cur
                continue
            for j in cur[1]:
                part.fate[j] = "committed" if kind == COMMIT else "aborted"
    except B.BatchError as e:
        bad("frame_bad", str(e))
        return
    if nxt != part.end:
        bad("frame_bad", "log_end")
    for cur in open_txn.values():
        for j in cur[1]:
            part.fate[j] = "open"
    part.committed = [j for j in sorted(part.fate)
                      if part.fate[j] == "committed"]


def _edge_keys(part: _Partition, c: dict) -> tuple:
    """The first key of the first committed batch and the last key of
    the last one; None where a batch does not decode."""
    out = []
    for j, pick in ((part.committed[0], 0), (part.committed[-1], -1)):
        try:
            recs = _records(part.log, part.batches[j])
            out.append(key_index(recs[pick].key))
        except (B.BatchError, Lz4Error, TypeError):
            c["lz4_bad"] += 1
            out.append(None)
    return tuple(out)


def check_eos(parts: dict, committed: dict, *, nparts: int, expect,
              codec: str, rng: np.random.Generator,
              slice_batches: int) -> tuple[dict, dict, dict]:
    """Judge an exactly-once copy's output topic.

    ``parts`` maps an output partition to ``(start_offset, end_offset,
    log)`` as the broker holds it; ``committed[p]`` is the group's
    committed offset of input partition ``p`` (absent or negative where
    none); ``expect(i)`` is input record ``i``'s value.  Returns
    (counts, what was covered, hidden): ``hidden[p]`` lists the
    ``(first, last)`` offsets of every data batch of an aborted or open
    transaction, which no read_committed consumer may return."""
    c = dict.fromkeys(EOS_CHECKS, 0)
    reasons: dict = {}
    scanned = []
    for p, (start, end, log) in sorted(parts.items()):
        part = _Partition(p, start, end, log)
        _scan(part, codec, c, reasons)
        scanned.append(part)
    covered = {"batches": 0, "records_committed": 0, "transactions": {},
               "batches_sampled": 0, "records_sampled": 0}
    if reasons:
        covered["bad_reasons"] = reasons
    hidden: dict = {}
    fates: dict = {}
    for part in scanned:
        covered["batches"] += len(part.batches)
        for j, f in part.fate.items():
            fates[f] = fates.get(f, 0) + 1
            if f != "committed":
                b = part.batches[j]
                hidden.setdefault(part.p, []).append(
                    (b.base_offset, b.base_offset + b.record_count - 1))
        covered["transactions"] = fates
        if part.batches:
            got = crc32c_many(
                part.log, [b.start + B.CRC_START for b in part.batches],
                [b.start + b.length for b in part.batches])
            c["crc_bad"] += int(sum(int(g) != b.crc
                                    for g, b in zip(got, part.batches)))
        n = sum(part.batches[j].record_count for j in part.committed)
        covered["records_committed"] += n
        want = committed.get(part.p, -1)
        want = want if want is not None and want >= 0 else 0
        if not part.committed:
            c["count_bad"] += want
            c["offsets_bad"] += want
            continue
        first, last = _edge_keys(part, c)
        if first is None or last is None:
            continue
        c["count_bad"] += abs(n - (want - first // nparts))
        c["offsets_bad"] += abs(want - (last // nparts + 1))
        # the slice: consecutive committed batches from a seeded start
        z = len(part.committed)
        a = int(rng.integers(0, max(1, z - slice_batches + 1)))
        prev = None
        for j in part.committed[a:a + slice_batches]:
            b = part.batches[j]
            try:
                payload = _payload(part.log, b)
            except Lz4Error:
                c["lz4_bad"] += 1
                prev = None
                continue
            try:
                recs = B.parse_records(payload, b.record_count)
            except B.BatchError:
                c["record_bad"] += 1
                prev = None
                continue
            covered["batches_sampled"] += 1
            covered["records_sampled"] += len(recs)
            for i, r in enumerate(recs):
                if (r.offset_delta != i or r.key is None
                        or len(r.key) != 8 or r.headers):
                    c["record_bad"] += 1
                    prev = None
                    continue
                k = key_index(r.key)
                if k % nparts != part.p or (prev is not None
                                            and k != prev + nparts):
                    c["key_bad"] += 1
                prev = k
                if r.value != expect(k):
                    c["value_bad"] += 1
    return c, covered, hidden


def visible(hidden: dict, seen: dict) -> int:
    """Records a consumer returned (``seen[p]``: their offsets) that lie
    in a data batch of an aborted or open transaction (``hidden``, from
    :func:`check_eos`)."""
    n = 0
    for p, offs in seen.items():
        spans = hidden.get(p, ())
        n += sum(1 for o in offs for a, z in spans if a <= o <= z)
    return n
