"""Eraser-style lockset data-race detector over the declared
shared-state surface (Savage et al., SOSP 1997 — the dynamic complement
of lockdep's lock-ORDER checking).

lockdep proves the locks that ARE taken nest consistently; it
says nothing about state touched with the wrong lock, or no lock at
all.  This module closes that gap for every field a concurrent layer
*declares*:

  * ``shared()`` — a class-body marker for cross-thread mutable
    attributes.  DISABLED (the default) the marker deletes itself at
    class creation, so the attribute is a plain instance attribute and
    the hot path pays literally nothing (the ``bench.py --smoke``
    ``races_overhead`` gate holds this to <1% of the produce budget —
    same contract as the locks factory).  ENABLED, a :class:`Guarded`
    data descriptor is installed on the class (values keep living in
    the instance ``__dict__``/slot, so enable/disable retrofit cleanly
    onto already-imported classes) and every attribute get/set records
    ``(thread, current lockset)`` from lockdep's per-thread held-stack.
  * ``register_slots()`` — the same declaration for ``__slots__``
    classes: the member descriptor is wrapped while enabled and
    restored on disable.
  * ``shared_dict()`` / ``shared_list()`` / ``shared_counter()`` —
    factories for the container idioms where the interesting mutation
    is a METHOD call, invisible to an attribute descriptor
    (``self.acked.append(...)`` reads the attribute): enabled they
    return :class:`SharedDict`/:class:`SharedList`/:class:`SharedCounter`
    wrappers whose mutators record WRITE accesses; disabled they return
    the plain ``dict``/``list``/counter.

Each declared variable walks the classic lockset state machine:

  VIRGIN --first access--> EXCLUSIVE --2nd thread read--> SHARED
                               |                            |
                          2nd thread write               write
                               v                            v
                         SHARED_MODIFIED <------------------+

The candidate set C(v) is initialized to the accessing thread's held
lockset when the variable leaves EXCLUSIVE and refined by intersection
on every subsequent access.  A WRITE with C(v) empty in
SHARED_MODIFIED is reported with both access stacks (the racing
write's and the other threads' first-access stacks) — reads never
report (the ``read-shared`` pattern is legal), they only refine, so an
unlocked reader still convicts the *next* write.  One report per
variable.

``relaxed=True`` declarations are tracked through the same machine but
reported separately and never fail the gate — for judged
single-writer/snapshot-reader patterns; every relaxed declaration
carries a written justification at the use site (the shared-state lint
rule's analog of the pragma).

Enable paths: ``races.enable()`` (refcounted; also holds a lockdep
reference — locksets come from its held-stack, so the instrumented
lock wrappers must be live); in the JAX package also the
``analysis.races`` conf knob and ``pytest --races``.
"""
from __future__ import annotations

import threading
import traceback
from contextlib import contextmanager
from typing import Optional

from . import interleave as _itl
from . import lockdep

#: master switch — declaration factories consult this at CREATION /
#: install time; Guarded descriptors are only installed while enabled
enabled = False

STACK_DEPTH = 16

_enable_count = 0
_reg_lock = threading.Lock()

#: declared variables: ("attr", cls, attr, var, relaxed) for plain
#: classes, ("slot", cls, attr, var, relaxed, member) for __slots__
_registry: list[tuple] = []

#: lock id -> class name, for readable candidate sets in reports
_lock_names: dict[int, str] = {}


class _VarState:
    """Per-variable lockset state (keyed by (id(owner), attr))."""

    __slots__ = ("var", "state", "owner_ident", "lockset", "threads",
                 "first_stacks", "reported", "relaxed", "written")

    def __init__(self, var: str, relaxed: bool):
        self.var = var
        self.state = "virgin"
        self.owner_ident: Optional[int] = None
        self.lockset: Optional[frozenset] = None    # candidate set C(v)
        self.threads: dict[int, str] = {}           # ident -> name
        self.first_stacks: dict[str, str] = {}      # thread name -> stack
        self.reported = False
        self.relaxed = relaxed
        self.written = False


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.vars: dict[tuple, _VarState] = {}
        self.races: list[dict] = []
        self.relaxed_races: list[dict] = []
        self.accesses = 0


_state = _State()

#: thread identity for the state machine: a monotonic per-thread token
#: (threading.local dies with its thread) — NOT get_ident(), whose
#: pthread ids are recycled the moment a thread exits, which would
#: alias a new thread onto a dead owner and silently keep a variable
#: EXCLUSIVE (a false negative the 0130 suite reproduces)
_tl = threading.local()
_tid_lock = threading.Lock()
_tid_next = 0


def _tid() -> int:
    t = getattr(_tl, "tid", None)
    if t is None:
        global _tid_next
        with _tid_lock:
            _tid_next += 1
            t = _tl.tid = _tid_next
    return t


def _capture() -> str:
    return "".join(traceback.format_stack(limit=STACK_DEPTH)[:-2])


def _held_set() -> frozenset:
    """The current thread's lockset, as lock-instance ids (Eraser
    refines on instances: Toppar A's lock does not protect Toppar B's
    queue even though both are class ``kafka.toppar``)."""
    held = lockdep.held_locks()
    if not held:
        return frozenset()
    for obj, name in held:
        _lock_names.setdefault(id(obj), name)
    return frozenset(id(obj) for obj, _n in held)


def _lockset_names(ls) -> list:
    return sorted({_lock_names.get(i, "?") for i in ls}) if ls else []


def reset_var(key: tuple, var: str, relaxed: bool) -> None:
    """Forget a variable's history (first initialization / container
    construction) — guards against id() reuse of dead instances
    bleeding SHARED state into a fresh object."""
    st = _state
    with st.lock:
        st.vars[key] = _VarState(var, relaxed)


def record(key: tuple, var: str, is_write: bool, relaxed: bool,
           cls_name: str = "") -> None:
    """One access to declared variable ``key``; the heart of the
    detector.  Called only while enabled (callers guard)."""
    ident = _tid()
    lockset = _held_set()
    st = _state
    report = None
    with st.lock:
        st.accesses += 1
        vs = st.vars.get(key)
        if vs is None:
            vs = st.vars[key] = _VarState(var, relaxed)
        tname = vs.threads.get(ident)
        if tname is None:
            tname = threading.current_thread().name
            vs.threads[ident] = tname
            if len(vs.first_stacks) < 8:       # bounded per variable
                vs.first_stacks[tname] = _capture()
        if vs.state == "virgin":
            vs.state = "exclusive"
            vs.owner_ident = ident
            vs.written = is_write
        elif vs.state == "exclusive":
            if ident == vs.owner_ident:
                vs.written = vs.written or is_write
            else:
                # second thread: leave EXCLUSIVE; C(v) starts as the
                # locks held right now and refines from here on.  A
                # read lands in SHARED even when the owner wrote (the
                # classic diagram): the single-writer/multi-reader
                # pattern convicts only when the owner writes AGAIN
                # with the candidate set already empty.
                vs.lockset = lockset
                vs.state = "shared_modified" if is_write else "shared"
                vs.written = vs.written or is_write
        else:
            vs.lockset = (lockset if vs.lockset is None
                          else vs.lockset & lockset)
            if is_write:
                vs.written = True
                if vs.state == "shared":
                    vs.state = "shared_modified"
        if (is_write and vs.state == "shared_modified"
                and not vs.lockset and not vs.reported):
            vs.reported = True
            report = {
                "kind": "empty_lockset_write",
                "var": vs.var,
                "class": cls_name,
                "state": vs.state,
                "relaxed": vs.relaxed,
                "thread": threading.current_thread().name,
                "threads": sorted(set(vs.threads.values())),
                "lockset": _lockset_names(lockset),
                "stack": _capture(),
                "other_stacks": [
                    {"thread": t, "stack": s}
                    for t, s in vs.first_stacks.items()
                    if t != threading.current_thread().name],
            }
            (st.relaxed_races if vs.relaxed else st.races).append(report)


# ------------------------------------------------------- descriptors --
class Guarded:
    """Data descriptor recording every get/set of a declared attribute.
    Values live in the instance ``__dict__`` (or the wrapped slot), so
    installing/removing the descriptor never migrates state.  Also a
    schedule-explorer yield point: a preemption between the recorded
    read and the following write is exactly the lost-update window."""

    __slots__ = ("var", "attr", "relaxed", "slot", "cls_name")

    def __init__(self, var: str, attr: str, relaxed: bool,
                 slot=None, cls_name: str = ""):
        self.var = var
        self.attr = attr
        self.relaxed = relaxed
        self.slot = slot            # member descriptor for __slots__
        self.cls_name = cls_name

    def __set_name__(self, owner, name):    # direct use as class var
        _register_attr(owner, name, self.var or None, self.relaxed)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if self.slot is not None:
            val = self.slot.__get__(obj, objtype)
        else:
            try:
                val = obj.__dict__[self.attr]
            except KeyError:
                raise AttributeError(self.attr) from None
        if enabled:
            record((id(obj), self.attr), self.var, False, self.relaxed,
                   self.cls_name)
            if _itl.active:
                _itl.maybe_yield(f"get:{self.var}")
        return val

    def __set__(self, obj, value):
        if self.slot is not None:
            try:
                self.slot.__get__(obj)
                first = False
            except AttributeError:
                first = True
            if _itl.active and not first:
                _itl.maybe_yield(f"set:{self.var}")
            self.slot.__set__(obj, value)
        else:
            first = self.attr not in obj.__dict__
            if _itl.active and not first:
                _itl.maybe_yield(f"set:{self.var}")
            obj.__dict__[self.attr] = value
        if enabled:
            if first:
                # __init__ assignment: fresh state (also defuses id()
                # reuse of a dead instance)
                reset_var((id(obj), self.attr), self.var, self.relaxed)
            record((id(obj), self.attr), self.var, True, self.relaxed,
                   self.cls_name)

    def __delete__(self, obj):
        if enabled:
            record((id(obj), self.attr), self.var, True, self.relaxed,
                   self.cls_name)
        if self.slot is not None:
            self.slot.__delete__(obj)
        else:
            obj.__dict__.pop(self.attr, None)


class shared:
    """Class-body declaration of a cross-thread mutable attribute::

        class OpQueue:
            _items = shared("queue.opq.items")

    Disabled at class creation, the marker deletes itself — the
    attribute is a plain instance attribute.  The declaration is
    registered either way, so ``enable()`` can retrofit a
    :class:`Guarded` descriptor onto the already-created class (and
    ``disable()`` remove it again)."""

    def __init__(self, name: Optional[str] = None, *,
                 relaxed: bool = False):
        self.name = name
        self.relaxed = relaxed

    def __set_name__(self, owner, attr):
        _register_attr(owner, attr, self.name, self.relaxed)


def _register_attr(owner, attr: str, name: Optional[str],
                   relaxed: bool) -> None:
    var = name or f"{owner.__name__}.{attr}"
    with _reg_lock:
        _registry.append(("attr", owner, attr, var, relaxed))
        if enabled:
            setattr(owner, attr,
                    Guarded(var, attr, relaxed, cls_name=owner.__name__))
        else:
            # resolve to a plain attribute: zero cost until enabled
            if attr in owner.__dict__:
                delattr(owner, attr)


def register_slots(cls, *attrs: str, relaxed: bool = False,
                   prefix: Optional[str] = None) -> None:
    """Declare ``__slots__`` members of ``cls`` as shared state (a
    class-body ``shared()`` marker would collide with the slot
    descriptor).  Call after the class definition::

        register_slots(Toppar, "msgq_bytes", "inflight")
    """
    with _reg_lock:
        for attr in attrs:
            member = cls.__dict__[attr]     # the member_descriptor
            var = f"{prefix or cls.__name__}.{attr}"
            _registry.append(("slot", cls, attr, var, relaxed, member))
            if enabled:
                setattr(cls, attr, Guarded(var, attr, relaxed,
                                           slot=member,
                                           cls_name=cls.__name__))


def _install_all() -> None:
    for ent in _registry:
        if ent[0] == "attr":
            _k, cls, attr, var, relaxed = ent
            setattr(cls, attr, Guarded(var, attr, relaxed,
                                       cls_name=cls.__name__))
        else:
            _k, cls, attr, var, relaxed, member = ent
            setattr(cls, attr, Guarded(var, attr, relaxed, slot=member,
                                       cls_name=cls.__name__))


def _uninstall_all() -> None:
    for ent in _registry:
        if ent[0] == "attr":
            _k, cls, attr, _var, _relaxed = ent
            if isinstance(cls.__dict__.get(attr), Guarded):
                delattr(cls, attr)
        else:
            _k, cls, attr, _var, _relaxed, member = ent
            setattr(cls, attr, member)


# -------------------------------------------------------- containers --
class SharedList(list):
    """List whose mutators record WRITE accesses (ledger idiom:
    ``oracle.acked.append(...)``) and whose readers record reads."""

    def __init__(self, var: str, relaxed: bool = False, seq=()):
        super().__init__(seq)
        self._var = var
        self._relaxed = relaxed
        reset_var((id(self),), var, relaxed)

    def _w(self):
        if enabled:
            record((id(self),), self._var, True, self._relaxed,
                   "SharedList")

    def _r(self):
        if enabled:
            record((id(self),), self._var, False, self._relaxed,
                   "SharedList")

    def append(self, x):
        self._w()
        super().append(x)

    def extend(self, it):
        self._w()
        super().extend(it)

    def insert(self, i, x):
        self._w()
        super().insert(i, x)

    def pop(self, i=-1):
        self._w()
        return super().pop(i)

    def remove(self, x):
        self._w()
        super().remove(x)

    def clear(self):
        self._w()
        super().clear()

    def __setitem__(self, i, v):
        self._w()
        super().__setitem__(i, v)

    def __iter__(self):
        self._r()
        return super().__iter__()

    def __len__(self):
        self._r()
        return super().__len__()

    def __getitem__(self, i):
        self._r()
        return super().__getitem__(i)


class SharedDict(dict):
    """Dict whose mutators record WRITE accesses (table idiom:
    ``self.txns[txn] = "open"``)."""

    def __init__(self, var: str, relaxed: bool = False, m=()):
        super().__init__(m)
        self._var = var
        self._relaxed = relaxed
        reset_var((id(self),), var, relaxed)

    def _w(self):
        if enabled:
            record((id(self),), self._var, True, self._relaxed,
                   "SharedDict")

    def _r(self):
        if enabled:
            record((id(self),), self._var, False, self._relaxed,
                   "SharedDict")

    def __setitem__(self, k, v):
        self._w()
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._w()
        super().__delitem__(k)

    def pop(self, *a):
        self._w()
        return super().pop(*a)

    def popitem(self):
        self._w()
        return super().popitem()

    def setdefault(self, k, d=None):
        self._w()
        return super().setdefault(k, d)

    def update(self, *a, **kw):
        self._w()
        super().update(*a, **kw)

    def clear(self):
        self._w()
        super().clear()

    def __getitem__(self, k):
        self._r()
        return super().__getitem__(k)

    def get(self, k, d=None):
        self._r()
        return super().get(k, d)

    def __contains__(self, k):
        self._r()
        return super().__contains__(k)

    def __len__(self):
        self._r()
        return super().__len__()

    def __iter__(self):
        self._r()
        return super().__iter__()

    def items(self):
        self._r()
        return super().items()

    def keys(self):
        self._r()
        return super().keys()

    def values(self):
        self._r()
        return super().values()


class _PlainCounter:
    """The disabled counter: a bare int cell (no recording)."""

    __slots__ = ("v",)

    def __init__(self, v: int = 0):
        self.v = v

    def add(self, n: int = 1) -> None:
        self.v += n

    @property
    def value(self) -> int:
        return self.v

    def __int__(self) -> int:
        return self.v


class SharedCounter(_PlainCounter):
    """Counter whose ``add`` records a write (the ``+=`` idiom, as an
    object for call sites that want an explicit cell)."""

    __slots__ = ("_var", "_relaxed")

    def __init__(self, var: str, relaxed: bool = False, v: int = 0):
        super().__init__(v)
        self._var = var
        self._relaxed = relaxed
        reset_var((id(self),), var, relaxed)

    def add(self, n: int = 1) -> None:
        if enabled:
            record((id(self),), self._var, True, self._relaxed,
                   "SharedCounter")
            if _itl.active:
                _itl.maybe_yield(f"counter:{self._var}")
        self.v += n

    @property
    def value(self) -> int:
        if enabled:
            record((id(self),), self._var, False, self._relaxed,
                   "SharedCounter")
        return self.v


def shared_list(var: str, relaxed: bool = False):
    """A list declared as shared state — plain ``list`` when the
    detector is off (creation-time decision, like the locks factory)."""
    if enabled:
        return SharedList(var, relaxed)
    return []


def shared_dict(var: str, relaxed: bool = False):
    if enabled:
        return SharedDict(var, relaxed)
    return {}


def shared_counter(var: str, relaxed: bool = False):
    if enabled:
        return SharedCounter(var, relaxed)
    return _PlainCounter()


# ------------------------------------------------------ enable/report --
def enable() -> None:
    """Turn the detector on (refcounted).  Installs Guarded descriptors
    on every registered class and holds a lockdep reference — the
    lockset of each access IS lockdep's per-thread held-stack, so the
    instrumented lock wrappers must be live.  Like lockdep: enable
    BEFORE building the clients you want swept (containers and locks
    created earlier stay plain)."""
    global enabled, _enable_count
    with _reg_lock:
        _enable_count += 1
        if _enable_count == 1:
            enabled = True
            _install_all()
    lockdep.enable()


def disable() -> None:
    """Drop one reference; the last uninstalls the descriptors.  State
    survives for :func:`report`; :func:`reset` clears it."""
    global enabled, _enable_count
    with _reg_lock:
        if _enable_count > 0:
            _enable_count -= 1
            lockdep.disable()
        if _enable_count == 0:
            enabled = False
            _uninstall_all()


def reset() -> None:
    global _state
    _state = _State()


@contextmanager
def scope():
    """Fresh findings state for the duration (tests that plant races
    must not pollute a ``--races`` session's report)."""
    global _state
    prev, _state = _state, _State()
    try:
        yield _state
    finally:
        _state = prev


def report() -> dict:
    st = _state
    with st.lock:
        states = {}
        for vs in st.vars.values():
            states[vs.state] = states.get(vs.state, 0) + 1
        return {"vars": len(st.vars),
                "accesses": st.accesses,
                "states": states,
                "races": list(st.races),
                "relaxed_races": list(st.relaxed_races)}


def clean(rep: Optional[dict] = None) -> bool:
    rep = rep if rep is not None else report()
    return not rep["races"]


def format_report(rep: Optional[dict] = None) -> str:
    rep = rep if rep is not None else report()
    lines = [f"races: {rep['vars']} shared vars, "
             f"{rep['accesses']} accesses, states {rep['states']}"]
    for r in rep["races"] + [dict(x, _relaxed_note=True)
                             for x in rep["relaxed_races"]]:
        tag = " (RELAXED, informational)" if r.get("_relaxed_note") else ""
        lines.append(f"\n=== empty-lockset write: {r['var']} "
                     f"[{r['class']}]{tag} ===")
        lines.append(f"  threads: {', '.join(r['threads'])}; racing "
                     f"write on {r['thread']} held {r['lockset'] or '{}'}")
        lines.append(f"  write at:")
        lines.append("    " + r["stack"].strip().replace("\n", "\n    "))
        for o in r["other_stacks"]:
            lines.append(f"  {o['thread']} first accessed at:")
            lines.append("    " +
                         o["stack"].strip().replace("\n", "\n    "))
    if clean(rep):
        lines.append("races: clean (no empty-lockset writes)")
    return "\n".join(lines)
