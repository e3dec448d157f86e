"""Offset-based socket buffer helpers (broker transport + mock cluster).

The reference sends straight from segmented buffers via iovecs
(rd_kafka_transport_socket_sendmsg, rdkafka_transport.c:109).  The
Python analog keeps one bytearray per connection and consumes it by
OFFSET: the previous ``del buf[:n]`` pattern memmoved the whole
remaining buffer once per socket chunk (~16MB of GIL-held shifting per
1MB batch).

The memoryview discipline here is load-bearing: a raising ``send()``
pins the traceback — and with it any live buffer export — so the chunk
view must be released in a ``finally`` or a later ``buf.clear()``
raises BufferError.
"""
from __future__ import annotations

import ssl as _ssl
import struct
from typing import Optional

#: consumed-prefix size at which the buffer is compacted even though it
#: has not fully drained (sustained backpressure must not retain every
#: byte ever sent)
COMPACT_THRESHOLD = 1 << 20

_WOULD_BLOCK = (_ssl.SSLWantReadError, _ssl.SSLWantWriteError,
                BlockingIOError, InterruptedError)


def send_from(sock, buf: bytearray,
              off: int) -> tuple[int, bool, Optional[OSError]]:
    """Send buf[off:]; returns (new_off, blocked, error)."""
    err: Optional[OSError] = None
    blocked = False
    mv = memoryview(buf)
    try:
        total = len(mv)
        while off < total:
            chunk = mv[off:]
            try:
                off += sock.send(chunk)
            except _WOULD_BLOCK:
                blocked = True
                break
            except OSError as e:
                err = e
                break
            finally:
                chunk.release()
    finally:
        mv.release()
    return off, blocked, err


def compact_consumed(buf: bytearray, off: int) -> int:
    """Reclaim the consumed prefix; returns the new offset."""
    if off >= len(buf):
        buf.clear()
        return 0
    if off >= COMPACT_THRESHOLD:
        del buf[:off]
        return 0
    return off


class SegWriter:
    """Segment-queue socket write buffer — the actual iovec analog of
    the reference's rd_kafka_transport_socket_sendmsg
    (rdkafka_transport.c:109): request segments (small SegBuf header
    chunks + large spliced RecordBatch bytes) queue WITHOUT being
    copied into one flat buffer, and drain via ``sendmsg`` scatter-
    gather on plain sockets (per-segment ``send`` on TLS / wrapped
    sockets, which lack sendmsg).

    ``queued_total`` / ``sent_total`` are monotonic byte counters — the
    request-boundary bookkeeping (_unsent_req_ends) keys off them."""

    __slots__ = ("_segs", "_off", "queued_total", "sent_total")

    #: max iovecs per sendmsg call (well under any platform IOV_MAX)
    MAX_IOV = 64

    def __init__(self):
        from collections import deque
        self._segs: "deque[memoryview]" = deque()
        self._off = 0                  # consumed prefix of _segs[0]
        self.queued_total = 0
        self.sent_total = 0

    def append(self, segs) -> int:
        """Queue buffer segments (bytes/bytearray/memoryview); returns
        the bytes queued."""
        n = 0
        segq = self._segs
        for s in segs:
            ln = len(s)
            if ln:
                segq.append(s if isinstance(s, memoryview)
                            else memoryview(s))
                n += ln
        self.queued_total += n
        return n

    def pending(self) -> int:
        return self.queued_total - self.sent_total

    def clear(self) -> None:
        for s in self._segs:
            s.release()
        self._segs.clear()
        self._off = 0
        self.queued_total = 0
        self.sent_total = 0

    def _advance(self, n: int) -> None:
        self.sent_total += n
        segq = self._segs
        off = self._off + n
        while segq and off >= len(segq[0]):
            off -= len(segq[0])
            segq.popleft().release()
        self._off = off

    def send(self, sock) -> tuple[int, bool, Optional[OSError]]:
        """Drain as much as the socket accepts; returns
        (bytes_sent_now, blocked, error)."""
        sent = 0
        blocked = False
        err: Optional[OSError] = None
        use_sendmsg = (not isinstance(sock, _ssl.SSLSocket)
                       and hasattr(sock, "sendmsg"))
        segq = self._segs
        while segq:
            try:
                if use_sendmsg:
                    iov = []
                    off = self._off
                    for s in segq:
                        iov.append(s[off:] if off else s)
                        off = 0
                        if len(iov) >= self.MAX_IOV:
                            break
                    n = sock.sendmsg(iov)
                else:
                    head = segq[0]
                    n = sock.send(head[self._off:] if self._off else head)
            except _WOULD_BLOCK:
                blocked = True
                break
            except OSError as e:
                err = e
                break
            if n <= 0:
                blocked = True
                break
            self._advance(n)
            sent += n
        return sent, blocked, err


def extract_frames(buf: bytearray,
                   max_bytes: Optional[int] = None
                   ) -> tuple[list[bytes], Optional[int]]:
    """Pop every complete 4-byte-length-prefixed frame off the front of
    ``buf`` (ONE compaction per call).  Returns (frames, bad_size):
    bad_size is the offending length when a frame exceeds max_bytes or
    is negative — the caller decides how to die."""
    frames: list[bytes] = []
    off = 0
    blen = len(buf)
    while blen - off >= 4:
        (n,) = struct.unpack_from(">i", buf, off)
        if n < 0 or (max_bytes is not None and n > max_bytes):
            if off:
                del buf[:off]
            return frames, n
        if blen - off < 4 + n:
            break
        frames.append(bytes(buf[off + 4:off + 4 + n]))
        off += 4 + n
    if off:
        del buf[:off]
    return frames, None
