"""Runtime lock-order checker (the kernel-lockdep idea, in-process).

The reference client ships its locking discipline as build-time
tooling — helgrind/TSAN suppressions and the ``rd_kafka_*lock`` wrap
macros — because a deadlock that needs three threads and a slow broker
to line up will never show up in a unit test.  This module is that
tooling for the Python rebuild:

  * Locks are created through :mod:`.locks`'s ``new_lock/new_rlock/
    new_cond`` factory.  With the checker DISABLED (default) the
    factory returns plain ``threading`` primitives — the decision is
    made once at creation time, so the production hot path pays
    nothing at all (same near-zero-when-off contract as
    ``obs/trace.py``, just moved from per-event to per-object).
  * Enabled, the factory returns :class:`DepLock`/:class:`DepRLock`/
    :class:`DepCondition` wrappers.  Every acquisition is recorded
    against the per-thread stack of locks already held; each FIRST
    observation of "acquired B while holding A" stores one edge
    A->B in the global lock-order graph together with the acquiring
    thread's name and formatted stack (stacks are captured only when
    an edge is first seen, so steady-state tracking is dict lookups).
  * Locks are keyed by their *class name* (the string given to the
    factory), not by instance — two broker threads taking
    ``kafka.toppar`` then ``kafka.msg_cnt`` in opposite orders is an
    inversion even though the instances differ.  Same-name nesting of
    two DISTINCT instances records a self-edge and is reported (two
    threads + two instances + opposite order = deadlock); re-entrant
    acquisition of one :class:`DepRLock` instance is NOT an edge and
    is never flagged.
  * :func:`report` finds cycles in the order graph: a 2-cycle is an
    ``inconsistent_order`` pair (the classic AB/BA), anything longer a
    ``cycle`` — both reported with every participating edge's stack.
  * Blocking calls (socket select/connect, device launch readback,
    ``queue.get``-style waits) are marked at the call site with
    ``if lockdep.enabled: lockdep.note_blocking("what")``; holding ANY
    tracked lock there is a ``held_across_blocking`` violation with
    both the lock's acquisition stack and the blocking site's stack.
    Condition waits are exempt by construction — ``wait()`` releases
    the condvar lock through the wrapper, so the held-set is already
    correct when the thread parks.

The checker is refcounted like the tracer (N clients may enable it via
the ``analysis.lockdep`` conf knob; ``pytest --lockdep`` holds one
reference for the whole session).  State survives disable() so the
graph can be inspected after a run; :func:`reset` clears it.
"""
from __future__ import annotations

import threading
import traceback
from contextlib import contextmanager
from typing import Optional

from . import interleave as _itl

#: master switch — the locks factory consults this at CREATION time,
#: instrumented primitives consult it per acquisition (so a disable()
#: mid-run stops recording without swapping objects out)
enabled = False

#: stack frames kept per captured edge/violation stack
STACK_DEPTH = 16

_enable_count = 0


class _Edge:
    """One observed order "from -> to" with the stack that created it."""

    __slots__ = ("src", "dst", "thread", "stack", "held_stack", "count")

    def __init__(self, src: str, dst: str, thread: str, stack: str,
                 held_stack: Optional[str]):
        self.src = src
        self.dst = dst
        self.thread = thread
        self.stack = stack              # where dst was acquired
        self.held_stack = held_stack    # where src had been acquired
        self.count = 1

    def as_dict(self) -> dict:
        return {"from": self.src, "to": self.dst, "thread": self.thread,
                "count": self.count, "stack": self.stack,
                "held_stack": self.held_stack}


class _State:
    """The global order graph + violation lists (swappable for tests)."""

    def __init__(self):
        self.lock = threading.Lock()    # plain: guards the dicts below
        self.edges: dict[tuple[str, str], _Edge] = {}
        self.adj: dict[str, set[str]] = {}
        self.classes: set[str] = set()
        self.blocking: list[dict] = []
        self._blocking_seen: set[tuple[str, str]] = set()
        self.acquisitions = 0


_state = _State()
_local = threading.local()


def _held() -> list:
    """This thread's stack of currently-held instrumented locks —
    entries are [lock_obj, class_name, acquire_stack_str_or_None]."""
    h = getattr(_local, "held", None)
    if h is None:
        h = _local.held = []
    return h


def _capture() -> str:
    return "".join(traceback.format_stack(limit=STACK_DEPTH)[:-2])


def _note_acquire(obj, name: str) -> None:
    if not enabled:
        return
    held = _held()
    st = _state
    with st.lock:
        st.acquisitions += 1
        st.classes.add(name)
        new_edges = []
        for ent in held:
            src = ent[1]
            if src == name and ent[0] is obj:
                continue        # re-entrant same instance (DepRLock)
            key = (src, name)
            e = st.edges.get(key)
            if e is not None:
                e.count += 1
            else:
                new_edges.append(ent)
        if new_edges:
            stack = _capture()
            for ent in new_edges:
                key = (ent[1], name)
                st.edges[key] = _Edge(ent[1], name,
                                      threading.current_thread().name,
                                      stack, ent[2])
                st.adj.setdefault(ent[1], set()).add(name)
    # No per-acquire stack capture: locks are taken via ``with`` (the
    # lint forbids manual acquire()), so the holder's frame is still ON
    # the current stack whenever a nested acquire creates an edge or a
    # blocking marker fires — the single capture taken there shows both
    # acquisition sites.  This keeps steady-state tracking at dict
    # lookups (stacks are captured only for NEW edges/violations).
    held.append([obj, name, None])


def _note_release(obj) -> None:
    held = getattr(_local, "held", None)
    if not held:
        return
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is obj:
            del held[i]
            return


def held_locks() -> list:
    """This thread's currently-held instrumented locks as
    ``[(lock_obj, class_name)]`` — the lockset source for the Eraser-
    style detector (analysis/races.py): each declared-variable access
    snapshots this stack and refines its candidate set with it."""
    held = getattr(_local, "held", None)
    if not held:
        return []
    return [(e[0], e[1]) for e in held]


def note_blocking(what: str) -> None:
    """Call-site marker for a blocking operation (socket select or
    connect, device readback, ``queue.get``).  Guard with
    ``if lockdep.enabled:`` — this function is the slow path."""
    if not enabled:
        return
    held = getattr(_local, "held", None)
    if not held:
        return
    st = _state
    with st.lock:
        for ent in held:
            key = (what, ent[1])
            if key in st._blocking_seen:
                continue
            st._blocking_seen.add(key)
            st.blocking.append({
                "call": what,
                "lock": ent[1],
                "thread": threading.current_thread().name,
                "stack": _capture(),
                "held_stack": ent[2],
            })


# ------------------------------------------------ instrumented types --
class DepLock:
    """Instrumented ``threading.Lock``."""

    def __init__(self, name: str):
        self.name = name
        self._lk = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _itl.active:
            # schedule-explorer yield point (analysis/interleave.py):
            # a preemption just before the acquire is how another
            # thread wins a race for this lock's critical section
            _itl.maybe_yield(f"lock:{self.name}")
        got = self._lk.acquire(blocking, timeout)
        if got:
            _note_acquire(self, self.name)
        return got

    def release(self) -> None:
        _note_release(self)
        self._lk.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<DepLock {self.name!r}>"


class DepRLock:
    """Instrumented ``threading.RLock``: only the OUTERMOST acquisition
    records an edge — re-entrancy is the type's contract, not an
    ordering fact, and must never be flagged."""

    def __init__(self, name: str):
        self.name = name
        self._rl = threading.RLock()
        self._owner: Optional[int] = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _itl.active and self._owner != threading.get_ident():
            _itl.maybe_yield(f"rlock:{self.name}")
        got = self._rl.acquire(blocking, timeout)
        if got:
            me = threading.get_ident()
            if self._owner == me:
                self._count += 1        # re-entrant: no edge, no push
            else:
                self._owner = me
                self._count = 1
                _note_acquire(self, self.name)
        return got

    def release(self) -> None:
        me = threading.get_ident()
        if self._owner == me:
            if self._count > 1:
                self._count -= 1
                self._rl.release()
                return
            # final level: clear tracking BEFORE the inner release —
            # the instant it drops, another thread's acquire may set
            # _owner, so touching it afterwards would race
            self._owner = None
            self._count = 0
            _note_release(self)
        # non-owner misuse reaches here with tracking untouched and
        # raises from the real RLock
        self._rl.release()

    # Condition(wait) integration: fully release every recursion level
    # and restore it after, keeping the held-set in step (the stdlib
    # RLock provides these for exactly this purpose)
    def _release_save(self):
        _note_release(self)
        count, owner = self._count, self._owner
        self._owner = None
        self._count = 0
        return (self._rl._release_save(), count, owner)

    def _acquire_restore(self, state):
        inner, count, owner = state
        self._rl._acquire_restore(inner)
        self._owner = owner
        self._count = count
        _note_acquire(self, self.name)

    def _is_owned(self):
        return self._rl._is_owned()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<DepRLock {self.name!r}>"


class DepCondition:
    """Instrumented ``threading.Condition`` over a Dep lock.  The
    stdlib Condition drives the lock purely through acquire()/release()
    (or ``_release_save``/``_acquire_restore`` when the lock provides
    them), so wait() keeps the per-thread held-set correct: the lock
    leaves the set while the thread parks and re-enters on wakeup."""

    def __init__(self, name: str, lock=None):
        self._dep = lock if lock is not None else DepLock(name)
        self._cond = threading.Condition(self._dep)
        self.name = name

    # lock protocol (with cond: ...)
    def acquire(self, *a, **kw):
        return self._dep.acquire(*a, **kw)

    def release(self) -> None:
        self._dep.release()

    def __enter__(self):
        self._cond.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cond.__exit__(*exc)

    # condvar protocol
    def wait(self, timeout: Optional[float] = None):
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self):
        return f"<DepCondition {self.name!r}>"


# ---------------------------------------------------- enable/report --
def enable() -> None:
    """Turn the checker on (refcounted — the ``analysis.lockdep`` conf
    knob, ``pytest --lockdep`` and the stress CLI each hold one
    reference).  Locks created while enabled are instrumented; locks
    created before stay plain (enable BEFORE building the clients you
    want checked)."""
    global enabled, _enable_count
    with _state.lock:
        _enable_count += 1
        enabled = True


def disable() -> None:
    """Drop one reference; the last disables recording.  The graph is
    kept for :func:`report` — :func:`reset` clears it."""
    global enabled, _enable_count
    with _state.lock:
        if _enable_count > 0:
            _enable_count -= 1
        if _enable_count == 0:
            enabled = False


def reset() -> None:
    """Clear the order graph and violation lists (not the refcount)."""
    global _state
    _state = _State()


@contextmanager
def scope():
    """Fresh graph for the duration (tests that build synthetic
    deadlocks must not pollute a ``--lockdep`` session's graph)."""
    global _state
    prev, _state = _state, _State()
    try:
        yield _state
    finally:
        _state = prev


def _find_cycles(adj: dict[str, set[str]]) -> list[list[str]]:
    """Cycle enumeration, deduped per node-set: every 2-cycle, plus one
    representative longer cycle per distinct set (the graph has tens of
    nodes, so plain DFS is fine)."""
    cycles: list[list[str]] = []
    seen: set[frozenset] = set()
    # self-edges (same class, distinct instances)
    for a, outs in adj.items():
        if a in outs:
            cycles.append([a, a])
            seen.add(frozenset((a,)))
    # 2-cycles first: they are the classic AB/BA report
    for a, outs in adj.items():
        for b in outs:
            if a != b and a in adj.get(b, ()):
                key = frozenset((a, b))
                if key not in seen:
                    seen.add(key)
                    cycles.append([a, b, a])
    # longer cycles: DFS from each node
    def dfs(start: str, node: str, path: list[str], visiting: set[str]):
        for nxt in adj.get(node, ()):
            if nxt == start and len(path) > 2:
                key = frozenset(path)
                if key not in seen:
                    seen.add(key)
                    cycles.append(path + [start])
            elif nxt not in visiting and len(path) < 8:
                visiting.add(nxt)
                dfs(start, nxt, path + [nxt], visiting)
                visiting.discard(nxt)

    for a in list(adj):
        dfs(a, a, [a], {a})
    return cycles


def report() -> dict:
    """The findings: ``cycles`` (each with every participating edge's
    acquisition stacks) and ``blocking`` violations, plus graph-size
    gauges.  ``clean(report())`` is the gate predicate."""
    st = _state
    with st.lock:
        adj = {k: set(v) for k, v in st.adj.items()}
        edges = dict(st.edges)
        blocking = list(st.blocking)
        classes = len(st.classes)
        acq = st.acquisitions
    out_cycles = []
    for path in _find_cycles(adj):
        evs = []
        for i in range(len(path) - 1):
            e = edges.get((path[i], path[i + 1]))
            if e is not None:
                evs.append(e.as_dict())
        out_cycles.append({
            "kind": ("inconsistent_order" if len(path) == 3
                     else "self_order" if len(path) == 2
                     else "cycle"),
            "path": path,
            "edges": evs,
        })
    return {"classes": classes, "edges": len(edges),
            "acquisitions": acq, "cycles": out_cycles,
            "blocking": blocking}


def clean(rep: Optional[dict] = None) -> bool:
    rep = rep if rep is not None else report()
    return not rep["cycles"] and not rep["blocking"]


def format_report(rep: Optional[dict] = None) -> str:
    """Human-readable findings (the check.sh / pytest summary)."""
    rep = rep if rep is not None else report()
    lines = [f"lockdep: {rep['classes']} lock classes, "
             f"{rep['edges']} order edges, "
             f"{rep['acquisitions']} acquisitions"]
    for c in rep["cycles"]:
        lines.append(f"\n=== {c['kind']}: {' -> '.join(c['path'])} ===")
        for e in c["edges"]:
            lines.append(f"--- {e['from']} -> {e['to']} "
                         f"(thread {e['thread']}, seen {e['count']}x)")
            if e.get("held_stack"):
                lines.append(f"  {e['from']} acquired at:")
                lines.append("    " +
                             e["held_stack"].strip().replace("\n", "\n    "))
            lines.append(f"  {e['to']} acquired at:")
            lines.append("    " + e["stack"].strip().replace("\n", "\n    "))
    for b in rep["blocking"]:
        lines.append(f"\n=== held across blocking: {b['lock']} held at "
                     f"{b['call']} (thread {b['thread']}) ===")
        if b.get("held_stack"):
            lines.append(f"  {b['lock']} acquired at:")
            lines.append("    " +
                         b["held_stack"].strip().replace("\n", "\n    "))
        lines.append("  blocking call at:")
        lines.append("    " + b["stack"].strip().replace("\n", "\n    "))
    if clean(rep):
        lines.append("lockdep: clean (no cycles, no held-across-blocking)")
    return "\n".join(lines)
