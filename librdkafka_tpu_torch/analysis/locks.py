"""Central lock factory: every concurrent layer creates its primitives
here so the lockdep checker can swap in instrumented wrappers.

Disabled (the default), each function returns the PLAIN ``threading``
primitive — the choice is made once, at creation time, so production
code pays literally nothing per acquisition (the bench.py --smoke
``lockdep_overhead`` gate holds this to <1% of the produce budget).
Enabled (``lockdep.enable()``; in the JAX package also the
``analysis.lockdep=true`` conf knob and ``pytest --lockdep``), the same
call sites get
:class:`~.lockdep.DepLock`-family wrappers and every acquisition feeds
the global lock-order graph.

Names are lock CLASSES, not instances: all Toppar locks share
``"kafka.toppar"`` so an ordering inversion between any two broker
threads is visible regardless of which partitions were involved.
The lint's ``lock-factory`` rule keeps new lock sites in ``client/``,
``ops/engine.py``, ``ops/tpu.py``, ``mock/`` and ``chaos/`` from
bypassing this factory.
"""
from __future__ import annotations

import threading

from . import lockdep


def new_lock(name: str):
    """A mutex for lock class ``name`` — ``threading.Lock()`` when the
    checker is off, an instrumented :class:`~.lockdep.DepLock` when
    on."""
    if lockdep.enabled:
        return lockdep.DepLock(name)
    return threading.Lock()


def new_rlock(name: str):
    """A re-entrant mutex (``threading.RLock`` / ``DepRLock``) —
    re-entrant acquisition is never reported as an ordering edge."""
    if lockdep.enabled:
        return lockdep.DepRLock(name)
    return threading.RLock()


def new_cond(name: str, lock=None):
    """A condition variable, optionally sharing ``lock`` (itself
    factory-made so waits keep the held-set coherent)."""
    if lockdep.enabled:
        return lockdep.DepCondition(name, lock)
    return threading.Condition(lock)
