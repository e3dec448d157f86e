"""Delivery reports and a full queue, shared by the traffic kinds that
produce."""
from __future__ import annotations


def queue_full(e: Exception) -> bool:
    """Is ``e`` the producer's "queue is full" (``BufferError``, or
    ``KafkaException`` with ``_QUEUE_FULL``)?"""
    if isinstance(e, BufferError):
        return True
    err = getattr(e, "error", None)
    return getattr(getattr(err, "code", None), "name", "") == "_QUEUE_FULL"


def produce_one(produce, poll, topic: str, value: bytes, part: int) -> None:
    """produce() once, serving delivery reports while the queue is full,
    as rdkafka_performance does."""
    while True:
        try:
            produce(topic, value=value, partition=part)
            return
        except Exception as e:
            if not queue_full(e):
                raise
            poll(0.001)

