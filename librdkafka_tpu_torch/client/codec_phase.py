"""The broker's codec phases, synchronous route: how a producer's writer
phase and a consumer's fetch verify drive a codec provider.

A port of two pieces of librdkafka_tpu/client/broker.py, without sockets,
tickets, tracing or per-item error plumbing:

  * :func:`write_batches` — the synchronous branch of
    ``_begin_writer_phase`` / ``_assemble_and_submit_crc``
    (broker.py:242-381): compress every partition's records in one
    ``compress_many``, drop incompressible results (:347-349), assemble
    each batch with CRC=0, checksum every CRC region in ONE
    ``crc32c_many``, patch the CRCs.
  * :func:`read_batches` — the CRC and decompress part of
    ``_begin_fetch_partition`` / ``_finish_fetch_partition``
    (broker.py:2305-2400): v2 regions through one batched
    ``crc32c_many``, legacy MsgVer0/1 regions through one batched
    ``crc32_many``, a mismatch raises :class:`CrcMismatch`; then one
    ``decompress_many`` per codec and the record walk.
"""
from __future__ import annotations

from ..ops.packing import FrameBlob
from ..protocol import proto
from ..protocol.msgset import (CrcMismatch, MsgsetWriterV2, Record,
                               iter_batches, iter_legacy_crc_regions,
                               parse_msgset_v01, parse_records_v2,
                               split_msgset_segments)


def write_batches(provider, parts, codec: str | None,
                  now_ms: int) -> list[bytes]:
    """One MessageSet v2 batch per partition: ``parts`` holds one list of
    records (objects with ``key``, ``value``, ``headers``, ``timestamp``)
    per partition; returns the wire batches in the same order."""
    writers = [MsgsetWriterV2(codec=codec).build(msgs, now_ms)
               for msgs in parts]
    idxs = [i for i, w in enumerate(writers) if w.codec is not None]
    blobs = {}
    if idxs:
        out = provider.compress_many(
            codec, [writers[i].records_bytes for i in idxs])
        blobs = dict(zip(idxs, out))

    wire: list = [None] * len(writers)
    regions, pending = [], []
    for i, w in enumerate(writers):
        blob = blobs.get(i)
        if blob is not None and len(blob) >= len(w.records_bytes):
            blob = None           # incompressible: send plain
            w.codec = None
        region = w.assemble(blob)
        if isinstance(blob, FrameBlob):
            # a fused compress→CRC frame carries per-part CRCs: fold the
            # batch CRC over the header prefix instead of re-scanning
            wire[i] = w.patch_crc(blob.region_crc(
                bytes(region[:len(region) - len(blob)])))
            continue
        regions.append(region)
        pending.append(i)
    if regions:
        for i, crc in zip(pending, provider.crc32c_many(regions)):
            wire[i] = writers[i].patch_crc(int(crc))
    return wire


def read_batches(provider, blobs) -> list[list[Record]]:
    """Verify and decode fetch-response record blobs (v2 batches, legacy
    MsgVer0/1 message sets or both); returns each blob's records.
    Raises :class:`CrcMismatch` on the first bad checksum."""
    layout = []                   # per blob: [("v2", i) | ("legacy", seg)]
    batches = []                  # (info, payload) of every v2 batch
    v2_regions = []
    legacy = []                   # (offset, stored crc, region)
    for blob in blobs:
        items = []
        for kind, seg in split_msgset_segments(blob):
            if kind == "legacy":
                items.append(("legacy", seg))
                legacy.extend(iter_legacy_crc_regions(seg))
                continue
            for info, payload, full in iter_batches(seg):
                items.append(("v2", len(batches)))
                batches.append((info, payload))
                v2_regions.append(full[proto.V2_OF_Attributes:])
        layout.append(items)

    if v2_regions:
        crcs = provider.crc32c_many(v2_regions)
        for (info, _), crc in zip(batches, crcs):
            if int(crc) != info.crc:
                raise CrcMismatch(
                    f"CRC mismatch at offset {info.base_offset}")
    if legacy:
        crcs = provider.crc32_many([r for _, _, r in legacy])
        for (off, want, _), got in zip(legacy, crcs):
            if int(got) != want:
                raise CrcMismatch(f"legacy CRC mismatch at offset {off}")

    payloads = [p for _, p in batches]
    by_codec: dict[str, list[int]] = {}
    for i, (info, _) in enumerate(batches):
        if info.codec:
            by_codec.setdefault(info.codec, []).append(i)
    for codec, idxs in by_codec.items():
        out = provider.decompress_many(codec, [payloads[i] for i in idxs])
        for i, raw in zip(idxs, out):
            payloads[i] = raw

    def decompress_one(codec, value):
        return provider.decompress_many(codec, [value])[0]

    result = []
    for items in layout:
        recs: list[Record] = []
        for kind, ref in items:
            if kind == "v2":
                recs.extend(parse_records_v2(batches[ref][0], payloads[ref]))
            else:
                recs.extend(parse_msgset_v01(ref, decompress_one))
        result.append(recs)
    return result
