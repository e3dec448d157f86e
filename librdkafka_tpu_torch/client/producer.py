"""Public Producer API (reference: rd_kafka_producev / rd_kafka_produce,
src/rdkafka_msg.c:241-478, plus flush/purge from rdkafka.c)."""
from __future__ import annotations

from typing import Optional

from .conf import Conf
from .kafka import Kafka, PRODUCER
from .msg import PARTITION_UA


class Producer:
    """
    >>> p = Producer({"bootstrap.servers": "...", "linger.ms": 5})
    >>> p.produce("topic", b"value", key=b"k", on_delivery=cb)
    >>> p.flush()
    """

    def __init__(self, conf):
        if isinstance(conf, dict):
            c = Conf()
            dr = conf.pop("on_delivery", None)
            c.update(conf)
            if dr:
                c.set("dr_msg_cb", dr)
            conf = c
        self._rk = Kafka(conf, PRODUCER)
        # bound-method alias: produce() goes straight to the client hot
        # path (str encoding + on_delivery handled there)
        self.produce = self._rk.produce

    def io_event_enable(self, fd: int, payload: bytes = b"1") -> None:
        """select()/epoll() integration: every op landing on the reply
        queue (DRs, errors, stats) writes ``payload`` to ``fd``
        (reference: rd_kafka_queue_io_event_enable on the main queue)."""
        self._rk.rep.io_event_enable(fd, payload)

    def list_topics(self, timeout: float = 10.0) -> dict:
        """rd_kafka_metadata analog: full cluster metadata snapshot."""
        return self._rk.list_topics(timeout)

    def cluster_id(self, timeout: float = 5.0):
        """rd_kafka_clusterid analog."""
        return self._rk.cluster_id(timeout)

    def controller_id(self, timeout: float = 5.0) -> int:
        """rd_kafka_controllerid analog."""
        return self._rk.controller_id(timeout)

    def set_topic_conf(self, topic: str, conf: dict) -> None:
        """Per-topic configuration override (rd_kafka_topic_new analog):
        e.g. {'compression.codec': 'snappy'} for one topic."""
        self._rk.set_topic_conf(topic, conf)

    def produce_batch(self, topic: str, msgs: list[dict],
                      partition: int = PARTITION_UA) -> int:
        """Batch produce (reference: rd_kafka_produce_batch,
        rdkafka_msg.c:478). Returns the number enqueued; like the
        reference sets ``rkmessages[i].err``, each failed input dict
        gets an ``"error"`` key with the per-message KafkaError (e.g.
        MSG_SIZE_TOO_LARGE, _QUEUE_FULL) instead of being silently
        dropped."""
        from .errors import Err, KafkaError, KafkaException

        # per-message errors are recorded INTO the dicts; validate the
        # shape up front so a stray non-dict fails fast instead of
        # aborting the batch midway with no error recorded
        for m in msgs:
            if not isinstance(m, dict):
                raise TypeError(
                    f"produce_batch messages must be dicts, got "
                    f"{type(m).__name__}")
        n = 0
        i = 0
        lane = self._rk._lane
        batch_c = getattr(lane, "produce_batch", None)
        total = len(msgs)
        while i < total:
            if batch_c is not None and isinstance(msgs, list):
                # native run: eligible records append straight into
                # their arenas with no Python frame per record; the C
                # side stops at the first item needing the per-item
                # path below — which itself stays on the (widened)
                # fast lane for explicit timestamps, headers, and
                # murmur2 auto-partition via Kafka._produce_slow
                nxt, appended = batch_c(topic, msgs, i, partition)
                n += appended
                i = nxt
                if i >= total:
                    break
            m = msgs[i]
            i += 1
            try:
                self.produce(topic, value=m.get("value"), key=m.get("key"),
                             partition=m.get("partition", partition),
                             headers=m.get("headers", ()),
                             timestamp=m.get("timestamp", 0))
                n += 1
                m.pop("error", None)
            except KafkaException as e:
                m["error"] = e.error
            except Exception as e:
                m["error"] = KafkaError(Err._FAIL, repr(e))
        return n

    # ------------------------------------------------------ transactions --
    def _txnmgr(self):
        from .errors import Err, KafkaException
        t = self._rk.txnmgr
        if t is None:
            raise KafkaException(
                Err._NOT_IMPLEMENTED,
                "transactional API requires transactional.id to be "
                "configured")
        return t

    def init_transactions(self, timeout: float = -1) -> None:
        """Acquire the transactional (pid, epoch) from the transaction
        coordinator; fences any previous instance of the same
        transactional.id (rd_kafka_init_transactions analog). Must be
        called once before the first begin_transaction()."""
        self._txnmgr().init_transactions(timeout)

    def begin_transaction(self) -> None:
        """Start a transaction; all following produce() calls and
        send_offsets_to_transaction() belong to it until
        commit_transaction()/abort_transaction()."""
        self._txnmgr().begin_transaction()

    def send_offsets_to_transaction(self, offsets, group_metadata,
                                    timeout: float = -1) -> None:
        """Commit consumed offsets atomically with this transaction
        (EOS consume-transform-produce). ``offsets`` is a list of
        TopicPartition with .offset; ``group_metadata`` is a
        Consumer.consumer_group_metadata() object or a group id str."""
        self._txnmgr().send_offsets_to_transaction(offsets, group_metadata,
                                                   timeout)

    def commit_transaction(self, timeout: float = -1) -> None:
        """Flush all in-flight messages, then commit the transaction
        (the coordinator writes COMMIT markers into every registered
        partition)."""
        self._txnmgr().commit_transaction(timeout)

    def abort_transaction(self, timeout: float = -1) -> None:
        """Purge queued messages, drain in-flight ones, then abort the
        transaction (ABORT markers make everything produced in it
        invisible to read_committed consumers)."""
        self._txnmgr().abort_transaction(timeout)

    def poll(self, timeout: float = 0.0) -> int:
        return self._rk.poll(timeout)

    def flush(self, timeout: float = 10.0) -> int:
        return self._rk.flush(timeout)

    def purge(self, in_queue: bool = True, in_flight: bool = False) -> None:
        self._rk.purge(in_queue, in_flight)

    def __len__(self) -> int:
        # rd_kafka_outq_len semantics: unacked messages PLUS undelivered
        # delivery-report ops (rdkafka.c:3905) — the documented
        # `while len(p): p.poll(...)` drain pattern must not exit while
        # DR callbacks are still queued
        return self._rk.outq_len

    def close(self, timeout: float = 5.0):
        self._rk.close(timeout)

    def trace_dump(self, path: str) -> int:
        """Export the flight-recorder trace rings as Chrome trace-event
        JSON (trace.enable=true; see TRACING.md)."""
        return self._rk.trace_dump(path)

    # escape hatch for tests / advanced use
    @property
    def rk(self) -> Kafka:
        return self._rk
