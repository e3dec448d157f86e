"""Seeded schedule explorer: deterministic preemption injection at the
concurrency yield points (the CHESS idea — Musuvathi et al., OSDI 2008
— scaled down to preemption-bounded fuzzing over this package's
instrumented seams).

The default thread scheduler explores a vanishingly thin slice of the
interleaving space: the GIL switches every ~5 ms, so a read-modify-
write that spans a few bytecodes virtually never gets preempted
mid-window, and a latent lost-update or ordering bug can survive every
straight test run.  The explorer widens the slice *deterministically*:

  * **Yield points** — the instrumented lock wrappers
    (``lockdep.DepLock/DepRLock`` acquire), ``OpQueue`` push/pop, and
    the lockset detector's :class:`~.races.Guarded` descriptor (a
    preemption between a recorded read and the following write is
    exactly the lost-update window).  Each point calls
    :func:`maybe_yield`, one module-attribute check when no fuzzer is
    installed (the trace-hook contract).
  * **SchedFuzzer(seed, preemption_bound)** — at each yield point the
    calling thread consults ITS OWN ``random.Random`` stream, seeded
    from ``(seed, thread name)`` (threads are named — the
    ``thread-name`` lint rule — and a thread's workload is
    deterministic, so its decision sequence is too: same seed ⇒ same
    per-thread preemption trace, independent of wall-clock
    interleaving).  A firing preemption sleeps the thread for a few
    hundred microseconds — long enough that every other runnable
    thread makes real progress through the window.  ``preemption_
    bound`` caps injected preemptions per thread (the CHESS insight:
    most schedule bugs need very few preemptions).
  * **replay_key()** — the chaos-style deterministic projection:
    ``(seed, bound, p)``.  A failing schedule re-runs exactly by
    installing a fuzzer with the same key (``SchedFuzzer.from_key``).

The JAX package's ``analysis/stress.py`` reruns the engine-pipeline and
txn legs under N seeded schedules so
latent races and orderings the default scheduler never produces
surface in CI, attributed by the lockset detector's reports.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Optional

#: fast-path guard: yield sites check this one module attribute before
#: calling maybe_yield (the hot-path cost when no fuzzer is installed)
active = False

_fuzzer: Optional["SchedFuzzer"] = None


class SchedFuzzer:
    """Deterministic preemption injector.

    ``seed``              one integer seeds every per-thread stream
    ``preemption_bound``  max injected preemptions PER THREAD
    ``p``                 per-yield-point preemption probability
    ``sleep_s``           (lo, hi) preemption sleep range, drawn from
                          the same per-thread stream
    """

    def __init__(self, seed: int, preemption_bound: int = 40,
                 p: float = 0.1,
                 sleep_s: tuple = (0.0002, 0.0015)):
        self.seed = int(seed)
        self.preemption_bound = int(preemption_bound)
        self.p = float(p)
        self.sleep_s = (float(sleep_s[0]), float(sleep_s[1]))
        self._tl = threading.local()
        self._trace_lock = threading.Lock()
        #: injected preemptions, in firing order:
        #: (thread name, yield point, per-thread yield seq)
        self.trace: list[tuple] = []

    @classmethod
    def from_key(cls, key: tuple) -> "SchedFuzzer":
        """Rebuild the fuzzer a :meth:`replay_key` describes."""
        tag, seed, bound, p_milli = key
        assert tag == "sched"
        return cls(seed, preemption_bound=bound, p=p_milli / 1000.0)

    def replay_key(self) -> tuple:
        """Deterministic projection (the CHAOS.md replay contract):
        identical across runs with one seed; rebuild via
        :meth:`from_key` to replay a failing schedule exactly."""
        return ("sched", self.seed, self.preemption_bound,
                round(self.p * 1000))

    # ------------------------------------------------------ per thread --
    def _slot(self):
        tl = self._tl
        if getattr(tl, "rng", None) is None:
            name = threading.current_thread().name
            tl.rng = random.Random(f"{self.seed}|{name}")
            tl.seq = 0
            tl.fired = 0
            tl.name = name
        return tl

    def maybe_yield(self, point: str) -> None:
        tl = self._slot()
        if tl.fired >= self.preemption_bound:
            return
        tl.seq += 1
        if tl.rng.random() >= self.p:
            return
        tl.fired += 1
        delay = tl.rng.uniform(*self.sleep_s)
        with self._trace_lock:
            self.trace.append((tl.name, point, tl.seq))
        time.sleep(delay)

    def trace_for(self, thread_name: str) -> list:
        """One thread's preemption decisions (deterministic given that
        thread's workload — the determinism-test projection; the global
        ``trace`` ordering depends on real interleaving)."""
        with self._trace_lock:
            return [t for t in self.trace if t[0] == thread_name]


def install(fuzzer: SchedFuzzer) -> None:
    """Install ``fuzzer`` as the process-wide scheduler (one at a
    time; yield points fire from the instant this returns)."""
    global _fuzzer, active
    _fuzzer = fuzzer
    active = True


def uninstall() -> None:
    global _fuzzer, active
    active = False
    _fuzzer = None


def maybe_yield(point: str) -> None:
    """Module-level yield point: call sites guard with
    ``if interleave.active:`` so an uninstalled fuzzer costs one
    attribute check."""
    f = _fuzzer
    if f is not None:
        f.maybe_yield(point)
