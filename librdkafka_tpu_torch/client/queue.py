"""L2 event/op runtime: ops, MPSC queues with forwarding, timers.

The rebuild of the reference's op/queue/timer trio (src/rdkafka_op.c,
rdkafka_queue.c, rdkafka_timer.c): every cross-thread interaction flows
through ``OpQueue`` (mutex+condvar MPSC, reference rdkafka_queue.h:47),
including delivery reports, fetched messages, rebalance events, and admin
results. Queue *forwarding* (rd_kafka_q_fwd_set0, rdkafka_queue.c:127)
re-plumbs per-partition fetch queues into the single consumer queue so one
poll serves all partitions.
"""
from __future__ import annotations

import enum
import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..analysis import interleave as _itl
from ..analysis.locks import new_cond, new_lock
from ..analysis.races import shared


class OpType(enum.Enum):
    """Op types (subset of the reference's ~40, rdkafka_op.h:73-124)."""
    FETCH = "fetch"                  # consumed message
    ERR = "err"
    CONSUMER_ERR = "consumer_err"
    DR = "dr"                        # delivery report
    STATS = "stats"
    LOG = "log"
    REBALANCE = "rebalance"
    OFFSET_COMMIT = "offset_commit"
    THROTTLE = "throttle"
    PARTITION_JOIN = "partition_join"
    PARTITION_LEAVE = "partition_leave"
    BROKER_WAKEUP = "wakeup"
    TERMINATE = "terminate"
    ADMIN_RESULT = "admin_result"
    OAUTHBEARER_REFRESH = "oauthbearer_refresh"
    PURGE = "purge"
    MOCK = "mock"


@dataclass
class Op:
    type: OpType
    payload: Any = None
    version: int = 0      # epoch barrier for stale-op filtering (op versioning)
    cb: Optional[Callable] = None


class OpQueue:
    """MPSC op queue with forwarding and optional wakeup callback."""

    # lockset-checked shared state (analysis/races.py): every field
    # producers/consumers race over is guarded by ``queue.opq`` —
    # including the wakeup callback, which is PUBLISHED under the lock
    # (the --races sweep caught the old unlocked set against push()'s
    # locked read)
    _items = shared("queue.opq.items")
    _fwd = shared("queue.opq.fwd")
    _wakeup_cb = shared("queue.opq.wakeup_cb")
    disabled = shared("queue.opq.disabled")

    def __init__(self, name: str = "q"):
        self.name = name
        self._lock = new_lock("queue.opq")
        self._cond = new_cond("queue.opq", self._lock)
        self._items: list[Op] = []
        self._fwd: Optional["OpQueue"] = None
        self._wakeup_cb: Optional[Callable[[], None]] = None
        self.disabled = False

    # -- forwarding (rd_kafka_q_fwd_set) ---------------------------------
    def forward_to(self, dst: Optional["OpQueue"]) -> None:
        with self._lock:
            self._fwd = dst
            if dst is not None and self._items:
                items, self._items = self._items, []
            else:
                items = []
        for op in items:
            dst.push(op)

    def set_wakeup_cb(self, cb: Optional[Callable[[], None]]):
        with self._lock:
            self._wakeup_cb = cb

    def io_event_enable(self, fd: int, payload: bytes = b"1") -> None:
        """App event-loop integration (reference:
        rd_kafka_queue_io_event_enable, rdkafka_queue.h:294): every
        enqueue writes ``payload`` to ``fd`` so the app can select()/
        epoll() on it alongside its other fds. Pass fd < 0 to disable.
        The write is non-blocking and best-effort — a full pipe means a
        wakeup is already pending."""
        if fd < 0:
            with self._lock:
                self._wakeup_cb = None
            return
        import os

        def _wake(_fd=fd, _payload=bytes(payload)):
            try:
                os.write(_fd, _payload)
            except (BlockingIOError, OSError):
                pass
        with self._lock:
            self._wakeup_cb = _wake

    def push(self, op: Op) -> None:
        if _itl.active:
            _itl.maybe_yield("opq.push")
        with self._lock:
            fwd = self._fwd
            if fwd is None:
                if self.disabled:
                    return
                self._items.append(op)
                self._cond.notify()
                wcb = self._wakeup_cb
            else:
                wcb = None
        if fwd is not None:
            fwd.push(op)
            return
        if wcb:
            wcb()

    def pop(self, timeout: Optional[float] = None) -> Optional[Op]:
        if _itl.active:
            _itl.maybe_yield("opq.pop")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while not self._items:
                remain = None if deadline is None else deadline - time.monotonic()
                if self._fwd is not None:
                    # forwarded queue: new pushes go to the target, so
                    # nothing will ever arrive here — but honor the
                    # caller's timeout instead of busy-returning (the
                    # reference's rd_kafka_q_pop on a fwd queue waits).
                    # A None timeout returns immediately rather than
                    # blocking forever on a dead queue.
                    if remain is not None and remain > 0:
                        self._cond.wait(timeout=remain)
                    return None
                if remain is not None and remain <= 0:
                    return None
                if not self._cond.wait(timeout=remain):
                    return None
            return self._items.pop(0)

    def pop_all(self) -> list[Op]:
        with self._lock:
            items, self._items = self._items, []
            return items

    def pop_upto(self, n: int, timeout: Optional[float] = None) -> list[Op]:
        """Batch pop for consumer_poll-style serving
        (rd_kafka_q_serve_rkmessages, rdkafka_queue.c:519)."""
        first = self.pop(timeout)
        if first is None:
            return []
        out = [first]
        with self._lock:
            take = min(n - 1, len(self._items))
            out.extend(self._items[:take])
            del self._items[:take]
        return out

    def serve(self, handler: Callable[[Op], None], timeout: float = 0.0,
              max_ops: int = 0) -> int:
        """Pop and dispatch ops; returns count served (rd_kafka_q_serve)."""
        served = 0
        t = timeout
        while True:
            op = self.pop(t)
            if op is None:
                return served
            t = 0.0
            (op.cb or handler)(op)
            served += 1
            if max_ops and served >= max_ops:
                return served

    def __len__(self) -> int:
        # follow forwarding like rd_kafka_q_len (rkq_fwdq chain): a
        # forwarded queue's ops live in its destination.  The
        # destination's len is taken AFTER our lock drops — the
        # pytest --lockdep sweep flagged the old nested hold as a
        # queue.opq self-order (len(A) inside A.lock takes B.lock;
        # a forwarding cycle would deadlock), and a length read is
        # inherently a snapshot anyway.
        with self._lock:
            fwd = self._fwd
            if fwd is None:
                return len(self._items)
        return len(fwd)


class SyncReply:  # lint: ok shared-state
    """Condvar-blocking reply slot for synchronous request/response
    calls (shared-state pragma: the condvar IS the whole state —
    callers own the predicate's storage and declare it at their layer)
    — the reference's pattern of enqueuing an op with a replyq
    and blocking in rd_kafka_q_serve on it (rdkafka_queue.c:431),
    without the op-object overhead: response callbacks call
    :meth:`post` after recording their result; the caller blocks in
    :meth:`wait` until its predicate holds or the deadline passes.
    Replaces the sleep-polled waits flagged in rounds 2-3."""

    def __init__(self):
        self._cond = new_cond("queue.sync_reply")

    def post(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def wait(self, predicate: Callable[[], bool],
             timeout: float) -> bool:
        """Block until ``predicate()`` is true; returns False on
        timeout. The predicate is evaluated under the condvar lock, so
        a post() between check and wait cannot be lost."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while not predicate():
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return False
                self._cond.wait(remain)
            return True


@dataclass(order=True)
class _Timer:
    next_fire: float
    seq: int
    interval: float = field(compare=False)   # 0 = one-shot
    callback: Callable = field(compare=False)
    active: bool = field(default=True, compare=False)


class Timers:
    """Monotonic timer wheel served by an owning thread
    (reference: rd_kafka_timers_run, rdkafka_timer.c:226)."""

    # add() runs on app/broker threads, run()/next_timeout on the
    # owner; both sides hold ``queue.timers``
    _heap = shared("queue.timers.heap")
    _seq = shared("queue.timers.seq")

    def __init__(self):
        self._heap: list[_Timer] = []
        self._lock = new_lock("queue.timers")
        self._seq = 0

    def add(self, interval_s: float, callback: Callable,
            *, once: bool = False, initial_delay: Optional[float] = None) -> _Timer:
        with self._lock:
            self._seq += 1
            t = _Timer(time.monotonic() + (initial_delay if initial_delay
                                           is not None else interval_s),
                       self._seq, 0.0 if once else interval_s, callback)
            heapq.heappush(self._heap, t)
            return t

    def stop(self, timer: _Timer) -> None:
        timer.active = False

    def next_timeout(self, default: float = 1.0) -> float:
        with self._lock:
            while self._heap and not self._heap[0].active:
                heapq.heappop(self._heap)
            if not self._heap:
                return default
            return max(0.0, min(default, self._heap[0].next_fire - time.monotonic()))

    def run(self) -> int:
        """Fire all due timers; returns count fired."""
        fired = 0
        now = time.monotonic()
        while True:
            with self._lock:
                while self._heap and not self._heap[0].active:
                    heapq.heappop(self._heap)
                if not self._heap or self._heap[0].next_fire > now:
                    return fired
                t = heapq.heappop(self._heap)
                if t.interval > 0:
                    t.next_fire = now + t.interval
                    heapq.heappush(self._heap, t)
            t.callback()
            fired += 1
