"""The codec phases: how the client drives a codec provider's seams.

The broker runs these, and so do the public front ends below:

  * :func:`begin_round` — a producer's writer phase (phase 2 of a
    produce round, on the ``rdk:codec`` worker): fused fast-lane batches
    built in one native call, the other writers compressed per (codec,
    level) group through the provider's ``compress_submit`` (an engine
    host job), assembled (incompressible results sent plain, a
    :class:`FrameBlob`'s part CRCs folded into the batch CRC), and their
    CRCs batched through ``crc32c_submit``, so round k+1 is framed while
    round k is in flight.  One bad batch fails only itself, or its group.
  * :func:`submit_fetch` — a consumer's fetch verify: v2 regions through
    ``crc32c_submit``, legacy MsgVer0/1 regions through ``crc32_submit``,
    then one ``decompress_submit`` per codec, all submitted before any
    resolves.  Its callers resolve the tickets: the broker with an error
    op and a fetch backoff, :class:`PendingRead` by raising
    :class:`CrcMismatch`.
  * :func:`submit` — the seam rule under both: the provider's async seam
    when it has one and it gives a ticket, else a pre-resolved
    :class:`SyncTicket` of the synchronous call.

:func:`submit_batches` / :func:`write_batches` and :func:`submit_read` /
:func:`read_batches` are the front ends: they build writers from records
or split blobs and call the same functions.
"""
from __future__ import annotations

from ..obs import trace as _trace
from ..ops.cpu import SyncTicket
from ..ops.native.build import enqlane
from ..ops.packing import FrameBlob
from ..protocol import proto
from ..protocol.msgset import (CrcMismatch, MsgsetWriterV2, Record,
                               iter_batches, iter_legacy_crc_regions,
                               parse_msgset_v01, parse_records_v2,
                               split_msgset_segments)


def seam_ticket(provider, name: str, *args, **kw):
    """The ticket of the provider's async seam ``name``, or None when it
    has none, returns None (pipeline off, CPU route) or raises (e.g. an
    engine closed under us)."""
    seam = getattr(provider, name, None)
    if seam is None:
        return None
    try:
        return seam(*args, **kw)
    except Exception:
        return None


def sync_ticket(fn, *args) -> SyncTicket:
    """``fn(*args)`` as a pre-resolved ticket; an exception re-raises at
    resolve time, where the synchronous path raised it."""
    try:
        return SyncTicket(fn(*args))
    except Exception as e:
        return SyncTicket(exc=e)


def submit(provider, name: str, sync_fn, *args, **kw):
    """The seam rule: the provider's async seam ``name`` for ``args``
    (with ``kw``), or a pre-resolved ticket of ``sync_fn(*args)``."""
    t = seam_ticket(provider, name, *args, **kw)
    return sync_ticket(sync_fn, *args) if t is None else t


# ------------------------------------------------------ the writer phase --

class FusedJob:
    """The writer of an ArenaBatch that the fused native builder
    (tk_torch_enqlane.build_batch) finishes in one GIL-released call:
    frame + compress + v2 header + CRC, no intermediate Python bytes.
    The idempotence fields are captured at batch formation, as for a
    MsgsetWriterV2."""

    __slots__ = ("codec_id", "pid", "epoch", "base_seq", "now_ms",
                 "attrs")

    def __init__(self, codec_id: int, pid: int, epoch: int,
                 base_seq: int, now_ms: int, attrs: int = 0):
        self.codec_id = codec_id
        self.pid = pid
        self.epoch = epoch
        self.base_seq = base_seq
        self.now_ms = now_ms
        # extra v2 attribute bits (ATTR_TRANSACTIONAL for EOS batches)
        self.attrs = attrs


def fused_builder():
    """The extension's ``build_batch``, or None without the extension."""
    m = enqlane()
    return getattr(m, "build_batch", None) if m else None


class PendingBatches:
    """A produce round in flight, as a two-stage state machine: the
    compress tickets of its (codec, level) groups (``comp``), then the
    CRC ticket (``crc``) of the assembled regions.  ``items`` are ``(tp,
    msgs, w)`` triples, opaque but for the writer ``w``; ``out`` holds
    ``(tp, msgs, wire | None, exc | None)`` per item as it resolves.
    :meth:`done` advances the round without blocking."""

    __slots__ = ("provider", "items", "out", "writers", "comp", "crc",
                 "pending", "t_comp", "t_crc")

    def __init__(self, provider, items: list):
        self.provider = provider
        self.items = items
        self.out: list = [None] * len(items)
        self.writers: list[int] = []    # items that are not fused jobs
        self.comp = None                # [(item indexes, ticket)] | None
        self.crc = None                 # ticket of the assembled regions
        self.pending: list[int] = []    # items awaiting ``crc``
        self.t_comp = self.t_crc = 0    # stage submits (while tracing)

    @property
    def resolved(self) -> bool:
        """No stage is in flight: :meth:`finish` will not wait."""
        return self.comp is None and self.crc is None

    def done(self) -> bool:
        if self.comp is not None:
            if not all(t.done() for _, t in self.comp):
                return False
            self._resolve_comp(None)
        return self.crc is None or self.crc.done()

    def finish(self, comp_timeout: float | None = 120.0,
               crc_timeout: float | None = None) -> list:
        """Wait for both stages; ``(tp, msgs, wire | None, exc | None)``
        per item, in ``items`` order (same-partition batches stay
        FIFO)."""
        if self.comp is not None:
            self._resolve_comp(comp_timeout)
        if self.crc is not None:
            t, self.crc = self.crc, None
            self._patch(t, crc_timeout)
            if self.t_crc:
                # submit -> checksums patched (the engine's fan-in wait
                # + launch + readback)
                _trace.complete("produce", "crc_ticket", self.t_crc,
                                {"batches": len(self.pending)})
        return self.out

    def result(self, timeout: float | None = 120.0) -> list[bytes]:
        """The wire batches in order; raises the first batch's error."""
        for _tp, _msgs, _wire, exc in self.finish(timeout, timeout):
            if exc is not None:
                raise exc
        return [wire for _tp, _msgs, wire, _exc in self.out]

    def _fail(self, idxs, exc: Exception) -> None:
        for i in idxs:
            tp, msgs, _w = self.items[i]
            self.out[i] = (tp, msgs, None, exc)

    def _resolve_comp(self, timeout) -> None:
        tickets, self.comp = self.comp, None
        blobs: dict = {}
        try:
            for idxs, t in tickets:
                blobs.update(zip(idxs, t.result(timeout)))
        except Exception as e:      # a failed group fails the round
            self._fail(self.writers, e)
            return
        if self.t_comp:
            _trace.complete("produce", "compress", self.t_comp,
                            {"groups": len(tickets),
                             "batches": len(self.writers)})
        self._assemble(blobs)

    def _assemble(self, blobs: dict) -> None:
        """Compression resolved: incompressible check, writer assembly,
        CRC submit; a provider without a CRC seam is patched here."""
        t_crc = _trace.now() if _trace.enabled else 0
        regions = []
        for i in self.writers:
            tp, msgs, w = self.items[i]
            blob = blobs.get(i)
            try:
                if blob is not None and len(blob) >= len(w.records_bytes):
                    blob = None       # incompressible: send plain
                    w.codec = None
                region = w.assemble(blob)
                if isinstance(blob, FrameBlob):
                    # a fused compress→CRC frame carries per-part CRCs:
                    # fold the batch CRC over the header prefix with
                    # crc32c_combine instead of re-scanning the frame
                    self.out[i] = (tp, msgs, w.patch_crc(blob.region_crc(
                        bytes(region[:len(region) - len(blob)]))), None)
                    continue
                regions.append(region)
                self.pending.append(i)
            except Exception as e:
                self.out[i] = (tp, msgs, None, e)
        if not regions:
            return
        t = seam_ticket(self.provider, "crc32c_submit", regions)
        if t is None:
            self._patch(sync_ticket(self.provider.crc32c_many, regions),
                        None)
        else:
            self.crc = t
            self.t_crc = t_crc

    def _patch(self, ticket, timeout) -> None:
        try:
            for i, crc in zip(self.pending, ticket.result(timeout)):
                tp, msgs, w = self.items[i]
                self.out[i] = (tp, msgs, w.patch_crc(int(crc)), None)
        except Exception as e:
            self._fail(self.pending, e)


def begin_round(provider, items: list, level_of=None,
                qos_of=None) -> PendingBatches:
    """Start a produce round's writer phase over ``items``, ``(tp, msgs,
    w)`` triples whose ``w`` is a :class:`FusedJob` or an unassembled
    MsgsetWriterV2.  ``level_of(item)`` gives a batch's compression level
    (-1 without it); ``qos_of(item)`` its ``(topic, weight)`` pair,
    offered only to a provider that declares ``accepts_qos``.  When any
    group's ``compress_submit`` gives no ticket, every group of the round
    compresses through ``compress_many``."""
    pend = PendingBatches(provider, items)
    build = None
    groups: dict = {}
    for i, (tp, msgs, w) in enumerate(items):
        if not isinstance(w, FusedJob):
            pend.writers.append(i)
            if w.codec is not None:
                level = -1 if level_of is None else level_of(items[i])
                groups.setdefault((w.codec, level), []).append(i)
            continue
        try:
            build = build or fused_builder()
            if build is None:           # extension vanished mid-flight
                raise RuntimeError("fused builder unavailable")
            t0 = _trace.now() if _trace.enabled else 0
            wire = build(msgs.base, msgs.klens, msgs.vlens, msgs.count,
                         w.now_ms, w.pid, w.epoch, w.base_seq, w.codec_id,
                         w.attrs, msgs.tss, msgs.hbuf, msgs.hlens)
            if t0:
                # the one-call frame+compress+CRC fast lane
                _trace.complete("produce", "fused_build", t0,
                                {"topic": tp.topic,
                                 "partition": tp.partition,
                                 "msgs": msgs.count})
            pend.out[i] = (tp, msgs, wire, None)
        except Exception as e:
            pend.out[i] = (tp, msgs, None, e)
    if not groups:
        if pend.writers:
            pend._assemble({})
        return pend
    bufs = {key: [items[i][2].records_bytes for i in idxs]
            for key, idxs in groups.items()}
    t_comp = _trace.now() if _trace.enabled else 0
    qos = qos_of if getattr(provider, "accepts_qos", False) else None
    tickets = []
    for (codec, level), idxs in groups.items():
        kw = {} if qos is None else {"qos": [qos(items[i]) for i in idxs]}
        t = seam_ticket(provider, "compress_submit", codec,
                        bufs[codec, level], level, **kw)
        if t is None:
            break
        tickets.append((idxs, t))
    else:
        pend.comp = tickets
        pend.t_comp = t_comp
        return pend
    t_comp = _trace.now() if _trace.enabled else 0
    blobs: dict = {}
    try:
        for (codec, level), idxs in groups.items():
            blobs.update(zip(idxs, provider.compress_many(
                codec, bufs[codec, level], level)))
    except Exception as e:
        pend._fail(pend.writers, e)
        return pend
    if t_comp:
        _trace.complete("produce", "compress", t_comp,
                        {"groups": len(groups),
                         "batches": len(pend.writers)})
    pend._assemble(blobs)
    return pend


def submit_batches(provider, parts, codec: str | None, now_ms: int,
                   qos=None) -> PendingBatches:
    """Start one MessageSet v2 batch per partition: ``parts`` holds one
    list of records (objects with ``key``, ``value``, ``headers``,
    ``timestamp``) per partition.  ``qos`` is an optional ``(topic,
    weight)`` pair per partition.  Returns at once when the provider has
    submit seams; ``.result()`` gives the wire batches in order."""
    items = [(i, None, MsgsetWriterV2(codec=codec).build(msgs, now_ms))
             for i, msgs in enumerate(parts)]
    return begin_round(provider, items, None,
                       None if qos is None else lambda item: qos[item[0]])


def write_batches(provider, parts, codec: str | None,
                  now_ms: int) -> list[bytes]:
    """:func:`submit_batches`, resolved."""
    return submit_batches(provider, parts, codec, now_ms).result()


# ------------------------------------------------------ the fetch verify --

def submit_fetch(provider, v2_regions: list, legacy_regions: list,
                 compressed) -> tuple:
    """Submit a fetch's verify and decode in the engine's dispatch order,
    so the card checksums while the dispatch thread inflates: the v2
    regions through crc32c, the legacy regions through crc32, then one
    decompress per codec of ``compressed``, ``(codec, ref, payload)`` per
    batch in order.  The decompress runs eagerly: a mismatch is the rare
    path and its bytes are dropped at resolve time.  Returns ``(v2 ticket
    | None, legacy ticket | None, [(codec, refs, ticket)])``."""
    v2 = (submit(provider, "crc32c_submit", provider.crc32c_many,
                 v2_regions) if v2_regions else None)
    legacy = (submit(provider, "crc32_submit", provider.crc32_many,
                     legacy_regions) if legacy_regions else None)
    groups: dict = {}
    for codec, ref, payload in compressed:
        refs, bufs = groups.setdefault(codec, ([], []))
        refs.append(ref)
        bufs.append(payload)
    return v2, legacy, [
        (codec, refs, submit(provider, "decompress_submit",
                             provider.decompress_many, codec, bufs))
        for codec, (refs, bufs) in groups.items()]


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
        self.dec = []               # (codec, batch indexes, ticket)

    def done(self) -> bool:
        return all(t is None or t.done() for t in
                   [self.v2, self.legacy, *(t for *_, t in self.dec)])

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
        for _codec, idxs, t in self.dec:
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
    batches, legacy MsgVer0/1 message sets or both) through
    :func:`submit_fetch`."""
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
    pend.v2, pend.legacy, pend.dec = submit_fetch(
        provider, v2_regions, legacy_regions,
        [(info.codec, i, payload)
         for i, (info, payload) in enumerate(pend.batches) if info.codec])
    return pend


def read_batches(provider, blobs) -> list[list[Record]]:
    """Verify and decode fetch-response record blobs; returns each
    blob's records.  Raises :class:`CrcMismatch` on the first bad
    checksum.  :func:`submit_read`, resolved."""
    return submit_read(provider, blobs).result()
