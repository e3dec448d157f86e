"""KIP-227 incremental fetch sessions (client side).

The v1.3.0 reference issues sessionless full fetches — every Fetch
request re-lists every fetchable partition, so the steady-state request
cost is O(partitions) per RTT even when nothing changed.  This module
goes beyond the reference: a per-broker ``FetchSession`` negotiates a
session with the broker (Fetch v7+) and from then on sends only the
partitions whose fetch state CHANGED since the last request — an offset
that moved (data consumed, or a seek), a newly added partition, or a
removal (which rides the request's ``forgotten_topics`` array).  A
request with an empty topic list is the steady-state win: it tells the
broker "long-poll my whole session book", costing O(1) bytes for any
number of idle partitions.

Epoch protocol (KIP-227, FetchSessionHandler.java):

- epoch ``-1``  sessionless full fetch (what the reference always sends;
  what this client sends with ``fetch.session.enable=false`` or against
  pre-v7 brokers),
- epoch ``0`` + session_id ``0``  "create a session": the request carries
  the full partition list, the response carries the broker-assigned
  ``session_id``,
- epoch ``1, 2, ...``  incremental requests carrying only changes; the
  broker omits partitions with no data and no error from the response.

Top-level response errors ``FETCH_SESSION_ID_NOT_FOUND`` (the broker
evicted the session — cache pressure, or the broker died and restarted)
and ``INVALID_FETCH_SESSION_EPOCH`` (request/response desync) reset the
session: the next fetch is a full epoch-0 negotiation.  Transport errors
and broker disconnects reset the same way — the session cache lives in
broker memory and dies with it.

Threading: a FetchSession belongs to one Broker and is mutated ONLY on
that broker's serve thread (build at request time, commit/reset at
response time).  The stats emitter reads id/epoch/counter snapshots
lock-free, same single-writer discipline as the Broker fields — the
slots are declared relaxed with that justification.
"""
from __future__ import annotations

from typing import Optional

from ..analysis.races import register_slots

#: session_epoch of a sessionless (full) fetch request
SESSIONLESS_EPOCH = -1
#: session_epoch that asks the broker to create a new session
INITIAL_EPOCH = 0


class FetchSession:
    """Per-broker incremental fetch session state (the client-side
    mirror of the broker's session cache entry)."""

    __slots__ = ("session_id", "epoch", "book", "inflight",
                 "c_partitions_sent", "c_full_fetches", "c_resets",
                 "_pending", "overflowed", "overflow_inflight")

    def __init__(self):
        self.session_id = 0
        self.epoch = INITIAL_EPOCH      # next epoch to SEND
        # committed book: (topic, partition) -> (fetch_offset, max_bytes)
        # as last acknowledged by the broker
        self.book: dict[tuple, tuple] = {}
        self.inflight = False           # one session request at a time
        self.c_partitions_sent = 0      # cumulative, for stats/bench
        self.c_full_fetches = 0         # epoch-0 negotiations issued
        self.c_resets = 0               # session teardowns (errors)
        # book snapshot sent with the in-flight request, committed on
        # success (the broker applies it when it ACCEPTS the request)
        self._pending: Optional[dict] = None
        # partitions already granted their one immediate-return
        # overflow fetch this epoch (see Broker._consumer_serve) —
        # cleared at each session build so the next epoch absorbs them
        self.overflowed: set[tuple] = set()
        # overflow fetches out (their callbacks count down, errors too):
        # no session request is built while one is (see
        # Broker._consumer_serve); a reset leaves it to the callbacks
        self.overflow_inflight = 0

    # ------------------------------------------------------------ build --
    def build(self, wanted: dict[tuple, tuple]):
        """Compute the request for the next fetch given ``wanted`` —
        the complete current set of fetchable partitions, as
        {(topic, partition): (fetch_offset, max_bytes)}.

        Returns ``(epoch, to_send, forgotten)`` where ``to_send`` is the
        list of keys to serialize into the request's topic list and
        ``forgotten`` the keys for ``forgotten_topics``.  The caller
        must treat the request's EFFECTIVE partition set as all of
        ``wanted`` — the broker may return data for any partition in
        the session book, not just the listed ones."""
        if self.epoch == INITIAL_EPOCH:
            to_send = list(wanted)
            forgotten: list = []
            self.c_full_fetches += 1
        else:
            to_send = [k for k, v in wanted.items()
                       if self.book.get(k) != v]
            forgotten = [k for k in self.book if k not in wanted]
        self._pending = dict(wanted)
        self.inflight = True
        self.overflowed.clear()
        self.c_partitions_sent += len(to_send)
        return self.epoch, to_send, forgotten

    # --------------------------------------------------------- response --
    def on_success(self, session_id: int) -> None:
        """The broker accepted the request: commit the pending book and
        advance the epoch (epoch 0 adopts the broker-assigned id)."""
        if self._pending is not None:
            self.book = self._pending
            self._pending = None
        if self.epoch == INITIAL_EPOCH:
            self.session_id = session_id
        # KIP-227 wraps to 1 (0 and -1 are reserved)
        self.epoch = self.epoch + 1 if self.epoch < 0x7fffffff else 1
        self.inflight = False

    def reset(self, reason: str = "") -> None:
        """Tear the session down: the next fetch renegotiates from a
        full epoch-0 request (session errors, transport errors, broker
        disconnect, migration)."""
        if (self.session_id == 0 and self.epoch == INITIAL_EPOCH
                and not self.book and not self.inflight):
            return                      # nothing negotiated yet: no-op
        self.session_id = 0
        self.epoch = INITIAL_EPOCH
        self.book.clear()
        self._pending = None
        self.inflight = False
        self.overflowed.clear()
        self.c_resets += 1

    def stats(self) -> dict:
        """Lock-free snapshot for the stats emitter (single-writer
        fields; a one-emit-stale gauge is acceptable)."""
        return {"session_id": self.session_id,
                "epoch": self.epoch,
                "partitions_sent": self.c_partitions_sent,
                "partitions_total": len(self.book),
                "full_fetches": self.c_full_fetches,
                "resets": self.c_resets}

    def __repr__(self):
        return (f"FetchSession(id={self.session_id}, epoch={self.epoch}, "
                f"book={len(self.book)})")


# lockset declarations (analysis/races.py; slot form — FetchSession is
# __slots__).  RELAXED with the Broker justification: every mutation
# happens on the owning broker's serve thread (request build + response
# commit/reset both run there); the stats emitter takes lock-free
# int/len snapshots, atomic under the GIL.
register_slots(FetchSession, "session_id", "epoch", "book", "inflight",
               "c_partitions_sent", "c_full_fetches", "c_resets",
               "_pending", "overflowed", "overflow_inflight",
               prefix="fetch_session",
               relaxed=True)
