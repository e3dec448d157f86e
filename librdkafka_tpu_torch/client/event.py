"""Event API (reference: src/rdkafka_event.c, 314 LoC).

The reference exposes internal ops as polymorphic ``rd_kafka_event_t``
objects the app polls from a queue (``rd_kafka_event_type``,
rdkafka_event.c:33) as an alternative to callback dispatch; an optional
**background thread** (src/rdkafka_background.c:109, created
rdkafka.c:2189-2196) serves an app-registered event callback off its
own queue so the app never has to poll.

Here: :class:`Event` wraps an internal Op (events ARE ops in the
reference too), ``Kafka.queue_poll()`` pops typed events from the reply
queue, and setting the ``background_event_cb`` conf property spawns the
background thread at client creation.
"""
from __future__ import annotations

import threading
from typing import Optional, TYPE_CHECKING

from .queue import Op, OpQueue, OpType

if TYPE_CHECKING:
    from .kafka import Kafka


#: rd_kafka_event_type_t analog
EVENT_NONE = "NONE"
EVENT_DR = "DR"
EVENT_ERROR = "ERROR"
EVENT_LOG = "LOG"
EVENT_STATS = "STATS"
EVENT_FETCH = "FETCH"
EVENT_REBALANCE = "REBALANCE"
EVENT_OFFSET_COMMIT = "OFFSET_COMMIT"
EVENT_OAUTHBEARER_TOKEN_REFRESH = "OAUTHBEARER_TOKEN_REFRESH"
EVENT_THROTTLE = "THROTTLE"

_OP_TO_EVENT = {
    OpType.DR: EVENT_DR,
    OpType.ERR: EVENT_ERROR,
    OpType.CONSUMER_ERR: EVENT_ERROR,
    OpType.LOG: EVENT_LOG,
    OpType.STATS: EVENT_STATS,
    OpType.FETCH: EVENT_FETCH,
    OpType.REBALANCE: EVENT_REBALANCE,
    OpType.OFFSET_COMMIT: EVENT_OFFSET_COMMIT,
    OpType.OAUTHBEARER_REFRESH: EVENT_OAUTHBEARER_TOKEN_REFRESH,
    OpType.THROTTLE: EVENT_THROTTLE,
}


class Event:
    """Polymorphic event (rd_kafka_event_t): one Op viewed through the
    event-type accessors. Accessors return None when the event is not
    of the matching type, like the reference's NULL returns."""

    __slots__ = ("op",)

    def __init__(self, op: Op):
        self.op = op

    @property
    def type(self) -> str:
        return _OP_TO_EVENT.get(self.op.type, EVENT_NONE)

    # ------------------------------------------------------- accessors ---
    def messages(self) -> list:
        """DR: the acked/failed messages (rd_kafka_event_message_array).
        FETCH: the consumed message batch."""
        if self.op.type == OpType.DR:
            return list(self.op.payload)
        if self.op.type == OpType.FETCH:
            return list(self.op.payload[1])
        return []

    def error(self):
        """ERROR: the KafkaError (rd_kafka_event_error)."""
        if self.op.type == OpType.ERR:
            return self.op.payload
        if self.op.type == OpType.CONSUMER_ERR:
            return self.op.payload[1].error
        return None

    def stats(self) -> Optional[str]:
        """STATS: the JSON blob (rd_kafka_event_stats)."""
        return self.op.payload if self.op.type == OpType.STATS else None

    def log(self) -> Optional[tuple]:
        """LOG: (level, fac, message) (rd_kafka_event_log)."""
        return self.op.payload if self.op.type == OpType.LOG else None

    def throttle(self) -> Optional[tuple]:
        """THROTTLE: (broker_name, broker_id, throttle_ms)
        (rd_kafka_event_throttle_time et al.)."""
        return (self.op.payload if self.op.type == OpType.THROTTLE
                else None)

    def rebalance(self) -> Optional[tuple]:
        """REBALANCE: (err_code, {topic: [partitions]})."""
        return (self.op.payload if self.op.type == OpType.REBALANCE
                else None)

    def __repr__(self):
        return f"Event({self.type})"


class BackgroundThread:  # lint: ok shared-state
    # shared-state pragma: the only cross-thread surfaces are the
    # forwarded OpQueue (declared in queue.py) and a threading.Event.
    """The background event-serving thread (rdkafka_background.c:109):
    the reply queue is forwarded to a private queue served by this
    thread, which invokes the app's ``background_event_cb`` for every
    event — the app never needs to poll."""

    def __init__(self, rk: "Kafka", event_cb):
        self.rk = rk
        self.event_cb = event_cb
        self.queue = OpQueue("background")
        rk.rep.forward_to(self.queue)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._main,
                                       name="rdk:background", daemon=True)
        self.thread.start()

    def _main(self):
        while not self._stop.is_set():
            op = self.queue.pop(0.1)
            if op is None:
                continue
            try:
                self.event_cb(Event(op))
            except Exception as e:
                self.rk.log("ERROR", f"background_event_cb raised: {e!r}")
            finally:
                if op.type == OpType.DR:
                    self.rk._dr_served(len(op.payload))

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=2.0)
