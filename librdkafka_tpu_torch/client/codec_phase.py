"""The broker's codec phases: how a producer's writer phase and a
consumer's fetch verify drive a codec provider.

A port of pieces of librdkafka_tpu/client/broker.py, without sockets,
tracing or per-item error plumbing:

  * :func:`submit_batches` — ``_begin_writer_phase`` /
    ``_assemble_and_submit_crc`` / ``_PendingCodec`` (broker.py:110-381):
    compression rides the provider's ``compress_submit`` (an engine host
    job) and the batch CRCs ride ``crc32c_submit`` (an engine ticket), so
    round k+1 is framed while round k is in flight.  A provider without
    those seams, or with its pipeline off, runs each stage synchronously:
    one ``compress_many``, incompressible results sent plain
    (broker.py:347-349), every CRC region in ONE ``crc32c_many``.
  * :func:`submit_read` — ``_codec_submit`` / ``_decompress_submit`` /
    ``_begin_fetch_partition`` / ``_finish_fetch_partition``
    (broker.py:2268-2400): v2 regions through one ``crc32c_submit``,
    legacy MsgVer0/1 regions through one ``crc32_submit``, one
    ``decompress_submit`` per codec, all submitted before any resolves;
    without a seam each falls back to a pre-resolved SyncTicket — one
    code path, as in the reference.  A mismatch raises
    :class:`CrcMismatch` at resolve time.

:func:`write_batches` and :func:`read_batches` are the same phases
resolved at once.
"""
from __future__ import annotations

from ..ops.cpu import SyncTicket
from ..ops.packing import FrameBlob
from ..protocol import proto
from ..protocol.msgset import (CrcMismatch, MsgsetWriterV2, Record,
                               iter_batches, iter_legacy_crc_regions,
                               parse_msgset_v01, parse_records_v2,
                               split_msgset_segments)


class PendingBatches:
    """A produce round in flight, as a two-stage state machine: the
    compress ticket (``comp``), then the CRC ticket (``crc``) of the
    assembled regions; :meth:`done` advances it without blocking and
    :meth:`result` returns the wire batches in partition order."""

    __slots__ = ("provider", "writers", "comp", "crc", "pending", "wire")

    def __init__(self, provider, writers: list):
        self.provider = provider
        self.writers = writers
        self.comp = None            # (writer indexes, ticket) | None
        self.crc = None             # ticket of the assembled regions
        self.pending: list[int] = []    # writers awaiting ``crc``
        self.wire: list = [None] * len(writers)

    def done(self) -> bool:
        if self.comp is not None:
            if not self.comp[1].done():
                return False
            self._assemble(self._blobs(timeout=None))
        return self.crc is None or self.crc.done()

    def result(self, timeout: float | None = 120.0) -> list[bytes]:
        if self.comp is not None:
            self._assemble(self._blobs(timeout))
        if self.crc is not None:
            crcs, self.crc = self.crc.result(timeout), None
            for i, crc in zip(self.pending, crcs):
                self.wire[i] = self.writers[i].patch_crc(int(crc))
        return self.wire

    def _blobs(self, timeout) -> dict:
        idxs, ticket = self.comp
        blobs = dict(zip(idxs, ticket.result(timeout)))
        self.comp = None
        return blobs

    def _assemble(self, blobs: dict) -> None:
        """Compression resolved: incompressible check, writer assembly,
        CRC submit — the synchronous phase tail."""
        regions = []
        for i, w in enumerate(self.writers):
            blob = blobs.get(i)
            if blob is not None and len(blob) >= len(w.records_bytes):
                blob = None           # incompressible: send plain
                w.codec = None
            region = w.assemble(blob)
            if isinstance(blob, FrameBlob):
                # a fused compress→CRC frame carries per-part CRCs: fold
                # the batch CRC over the header prefix instead of
                # re-scanning
                self.wire[i] = w.patch_crc(blob.region_crc(
                    bytes(region[:len(region) - len(blob)])))
                continue
            regions.append(region)
            self.pending.append(i)
        if regions:
            self.crc = _submit(self.provider, "crc32c_submit",
                               self.provider.crc32c_many, regions)


def _submit(provider, name: str, sync_fn, *bufs, **seam_kw):
    """The provider's async seam ``name`` for ``bufs`` (with ``seam_kw``),
    or a pre-resolved ticket of ``sync_fn`` computed here (a raising
    computation re-raises at resolve time, where the synchronous path
    raised it)."""
    seam = getattr(provider, name, None)
    if seam is not None:
        try:
            t = seam(*bufs, **seam_kw)
        except Exception:       # e.g. an engine closed under us
            t = None
        if t is not None:
            return t
    try:
        return SyncTicket(sync_fn(*bufs))
    except Exception as e:
        return SyncTicket(exc=e)


def submit_batches(provider, parts, codec: str | None, now_ms: int,
                   qos=None) -> PendingBatches:
    """Start one MessageSet v2 batch per partition: ``parts`` holds one
    list of records (objects with ``key``, ``value``, ``headers``,
    ``timestamp``) per partition.  ``qos`` is an optional ``(topic,
    weight)`` pair per partition (broker.py:264-288), passed to a
    provider that declares ``accepts_qos``.  Returns at once when the
    provider has submit seams; ``.result()`` gives the wire batches in
    order."""
    writers = [MsgsetWriterV2(codec=codec).build(msgs, now_ms)
               for msgs in parts]
    pend = PendingBatches(provider, writers)
    idxs = [i for i, w in enumerate(writers) if w.codec is not None]
    if not idxs:
        pend._assemble({})
        return pend
    kw = ({"qos": [qos[i] for i in idxs]}
          if qos is not None and getattr(provider, "accepts_qos", False)
          else {})
    t = _submit(provider, "compress_submit", provider.compress_many,
                codec, [writers[i].records_bytes for i in idxs], **kw)
    pend.comp = (idxs, t)
    if isinstance(t, SyncTicket):
        pend.done()         # resolved: assemble and submit the CRCs now
    return pend


def write_batches(provider, parts, codec: str | None,
                  now_ms: int) -> list[bytes]:
    """:func:`submit_batches`, resolved."""
    return submit_batches(provider, parts, codec, now_ms).result()


class PendingRead:
    """A fetch verify in flight: the v2 CRC ticket, the legacy CRC
    ticket and one decompress ticket per codec; :meth:`result` checks
    the CRCs (raising :class:`CrcMismatch`), then parses the records of
    each blob."""

    __slots__ = ("provider", "layout", "batches", "v2", "legacy",
                 "legacy_owners", "dec")

    def __init__(self, provider):
        self.provider = provider
        self.layout = []            # per blob: [("v2", i) | ("legacy", seg)]
        self.batches = []           # (info, payload) of every v2 batch
        self.v2 = None              # crc32c ticket of the v2 regions
        self.legacy = None          # crc32 ticket of the legacy regions
        self.legacy_owners = []     # (offset, stored crc) per legacy region
        self.dec = []               # (batch indexes, ticket) per codec

    def done(self) -> bool:
        return all(t is None or t.done() for t in
                   [self.v2, self.legacy, *(t for _, t in self.dec)])

    def result(self, timeout: float | None = 120.0) -> list[list[Record]]:
        if self.v2 is not None:
            crcs = self.v2.result(timeout)
            for (info, _), crc in zip(self.batches, crcs):
                if int(crc) != info.crc:
                    raise CrcMismatch(
                        f"CRC mismatch at offset {info.base_offset}")
        if self.legacy is not None:
            crcs = self.legacy.result(timeout)
            for (off, want), got in zip(self.legacy_owners, crcs):
                if int(got) != want:
                    raise CrcMismatch(f"legacy CRC mismatch at offset {off}")
        payloads = [p for _, p in self.batches]
        for idxs, t in self.dec:
            for i, raw in zip(idxs, t.result(timeout)):
                payloads[i] = raw

        def decompress_one(codec, value):
            return self.provider.decompress_many(codec, [value])[0]

        result = []
        for items in self.layout:
            recs: list[Record] = []
            for kind, ref in items:
                if kind == "v2":
                    recs.extend(parse_records_v2(self.batches[ref][0],
                                                 payloads[ref]))
                else:
                    recs.extend(parse_msgset_v01(ref, decompress_one))
            result.append(recs)
        return result


def submit_read(provider, blobs) -> PendingRead:
    """Start the verify and decode of fetch-response record blobs (v2
    batches, legacy MsgVer0/1 message sets or both).  Submission order —
    CRCs first, then the decompress jobs — matches the engine's dispatch
    order, so the card checksums while the dispatch thread inflates; the
    decompress runs eagerly (a mismatch is the rare path and its bytes
    are dropped at resolve time)."""
    pend = PendingRead(provider)
    v2_regions, legacy_regions = [], []
    for blob in blobs:
        items = []
        for kind, seg in split_msgset_segments(blob):
            if kind == "legacy":
                items.append(("legacy", seg))
                for off, crc, region in iter_legacy_crc_regions(seg):
                    pend.legacy_owners.append((off, crc))
                    legacy_regions.append(region)
                continue
            for info, payload, full in iter_batches(seg):
                items.append(("v2", len(pend.batches)))
                pend.batches.append((info, payload))
                v2_regions.append(full[proto.V2_OF_Attributes:])
        pend.layout.append(items)
    if v2_regions:
        pend.v2 = _submit(provider, "crc32c_submit", provider.crc32c_many,
                          v2_regions)
    if legacy_regions:
        pend.legacy = _submit(provider, "crc32_submit", provider.crc32_many,
                              legacy_regions)
    by_codec: dict[str, list[int]] = {}
    for i, (info, _) in enumerate(pend.batches):
        if info.codec:
            by_codec.setdefault(info.codec, []).append(i)
    for codec, idxs in by_codec.items():
        pend.dec.append((idxs, _submit(
            provider, "decompress_submit", provider.decompress_many,
            codec, [pend.batches[i][1] for i in idxs])))
    return pend


def read_batches(provider, blobs) -> list[list[Record]]:
    """Verify and decode fetch-response record blobs; returns each
    blob's records.  Raises :class:`CrcMismatch` on the first bad
    checksum.  :func:`submit_read`, resolved."""
    return submit_read(provider, blobs).result()
