"""Generative traffic shapes: what a population of real clients does.

Production load is not a constant-rate loop — it ramps with the day,
bursts on events, concentrates on hot keys and hot partitions, and
fans one stream out to many consumer groups.  This module expresses
those shapes as **plain JSON-able dicts** (specs) so they ship to the
fleet's worker processes over the stdin line protocol unchanged, plus
the samplers that execute a spec inside one worker.

**Determinism contract** (the fleet analog of chaos/schedule.py's):
every random choice in a fleet run draws from ``random.Random`` seeded
along a fixed derivation chain — one plan seed assigns each worker its
own ``seed`` in spec order, and each worker's sampler consumes only
its own rng.  The plan's ``replay_key()`` is a digest of the fully
resolved spec list: two plans built from the same seed and parameters
are byte-identical, no matter when or where the workers actually run
(wall-clock pacing is execution, not identity — exactly like a chaos
schedule's timeline wall offsets).

Shape catalog (``rate_at(spec, t)`` gives msgs/s at elapsed t):

  flat(rate)                      constant rate
  diurnal(base, peak, period_s)   raised-cosine day cycle: base at
                                  t=0, peak at period/2
  bursts(quiet, burst, period_s,  square wave: ``burst`` for the first
         duty)                    ``duty`` fraction of each period,
                                  ``quiet`` for the rest
  stack(*shapes)                  sum of component shapes (diurnal +
                                  bursts = the flagship's day-with-
                                  storms curve)

Skew catalog:

  zipf(n_keys, s)                 Zipf(s) hot-key distribution over
                                  ``n_keys`` ranked keys (rank 1
                                  hottest); ZipfSampler draws keys
  hot_partitions(n, hot, weight)  partition picker: the ``hot``
                                  partition with probability
                                  ``weight``, uniform over the rest
                                  otherwise
"""
from __future__ import annotations

import hashlib
import json
import math
import random
from bisect import bisect_left
from typing import Optional


# ------------------------------------------------------------- shapes --
def flat(rate: float) -> dict:
    return {"kind": "flat", "rate": float(rate)}


def diurnal(base: float, peak: float, period_s: float,
            phase: float = 0.0) -> dict:
    """Raised-cosine 'day': rate(t) = base + (peak-base) *
    (1 - cos(2*pi*(t/period + phase))) / 2."""
    return {"kind": "diurnal", "base": float(base), "peak": float(peak),
            "period_s": float(period_s), "phase": float(phase)}


def bursts(quiet: float, burst: float, period_s: float,
           duty: float = 0.25) -> dict:
    """Burst/quiet square wave: ``burst`` msgs/s for the first
    ``duty`` fraction of every ``period_s`` window, ``quiet`` after."""
    return {"kind": "bursts", "quiet": float(quiet), "burst": float(burst),
            "period_s": float(period_s), "duty": float(duty)}


def stack(*shapes: dict) -> dict:
    return {"kind": "stack", "parts": list(shapes)}


def rate_at(shape: dict, t: float) -> float:
    """Instantaneous target rate (msgs/s) of ``shape`` at elapsed
    ``t`` seconds.  Pure: same (spec, t) always gives the same rate."""
    k = shape["kind"]
    if k == "flat":
        return shape["rate"]
    if k == "diurnal":
        frac = (1.0 - math.cos(
            2.0 * math.pi * (t / shape["period_s"] + shape["phase"]))) / 2.0
        return shape["base"] + (shape["peak"] - shape["base"]) * frac
    if k == "bursts":
        inside = (t % shape["period_s"]) < shape["duty"] * shape["period_s"]
        return shape["burst"] if inside else shape["quiet"]
    if k == "stack":
        return sum(rate_at(p, t) for p in shape["parts"])
    raise ValueError(f"unknown shape kind {k!r}")


# --------------------------------------------------------------- skew --
def zipf(n_keys: int, s: float = 1.2) -> dict:
    return {"kind": "zipf", "n_keys": int(n_keys), "s": float(s)}


def hot_partitions(n: int, hot: int, weight: float = 0.6) -> dict:
    """``weight`` of the traffic lands on partition ``hot``; the rest
    spreads uniformly over all ``n`` partitions."""
    return {"kind": "hot", "n": int(n), "hot": int(hot),
            "weight": float(weight)}


class ZipfSampler:
    """Draws key ranks 0..n-1 from Zipf(s) via an inverse-CDF table —
    rank 0 is the hottest key.  All randomness comes from the caller's
    rng, so a worker's key sequence replays from its spec seed."""

    def __init__(self, spec: dict, rng: random.Random):
        self._rng = rng
        n, s = spec["n_keys"], spec["s"]
        weights = [1.0 / (r + 1) ** s for r in range(n)]
        total = sum(weights)
        self._cdf = []
        acc = 0.0
        for w in weights:
            acc += w / total
            self._cdf.append(acc)
        self._cdf[-1] = 1.0

    def rank(self) -> int:
        return bisect_left(self._cdf, self._rng.random())


class PartitionPicker:
    """Executes a hot_partitions() spec (or uniform when spec is
    None) against the worker's rng."""

    def __init__(self, n_partitions: int, spec: Optional[dict],
                 rng: random.Random):
        self._n = n_partitions
        self._spec = spec
        self._rng = rng

    def pick(self) -> int:
        if self._spec is None:
            return self._rng.randrange(self._n)
        if self._rng.random() < self._spec["weight"]:
            return self._spec["hot"]
        return self._rng.randrange(self._spec["n"])


class Pacer:
    """Credit-based rate limiter: ``take(t)`` accrues ``rate_at(t)``
    credits per second and returns how many whole messages to send
    now (capped so a long stall cannot release an unbounded burst)."""

    BURST_CAP = 64.0

    def __init__(self, shape: dict):
        self._shape = shape
        self._last: Optional[float] = None
        self._credit = 0.0

    def take(self, t: float) -> int:
        if self._last is None:
            self._last = t
            return 0
        dt = max(0.0, t - self._last)
        self._last = t
        self._credit = min(self.BURST_CAP,
                           self._credit + dt * rate_at(self._shape, t))
        n = int(self._credit)
        self._credit -= n
        return n


# --------------------------------------------------------------- plan --
class TrafficPlan:
    """One fleet's fully resolved worker population.

    Derivation: a single ``random.Random(seed)`` is consumed in fixed
    spec order — per-producer phase jitter, hot-key/hot-partition
    placement, per-worker seeds — so the spec list (and therefore
    ``replay_key()``) is a pure function of the constructor arguments.

    Topology: ``producers`` producer workers spread round-robin over
    ``topics``; ``groups`` consumer groups of ``group_size`` members
    each, every group subscribing to ALL topics (fan-out: one produced
    record is consumed once per group).
    """

    def __init__(self, seed: int, *, producers: int = 2, groups: int = 1,
                 group_size: int = 2, topics: Optional[list] = None,
                 partitions: int = 4, shape: Optional[dict] = None,
                 keys: Optional[dict] = None,
                 hot_partition_weight: float = 0.0,
                 isolation: str = "read_uncommitted",
                 strategy: str = "range,roundrobin",
                 max_s: float = 120.0):
        self.seed = seed
        self.topics = list(topics) if topics else ["fleet"]
        self.partitions = partitions
        rng = random.Random(seed)
        shape = shape or flat(100.0)
        self.specs: list[dict] = []
        for i in range(producers):
            sh = json.loads(json.dumps(shape))   # per-worker copy
            if sh["kind"] in ("diurnal", "bursts"):
                sh = stack(sh)
            if sh["kind"] == "stack":
                # de-synchronize the fleet: each producer's cycles sit
                # at a seeded phase offset, like real user populations
                for part in sh["parts"]:
                    if part["kind"] == "diurnal":
                        part["phase"] = round(rng.random(), 6)
            skew = None
            if hot_partition_weight > 0:
                skew = hot_partitions(partitions, rng.randrange(partitions),
                                      hot_partition_weight)
            self.specs.append({
                "role": "producer", "name": f"p{i:02d}",
                "topic": self.topics[i % len(self.topics)],
                "partitions": partitions, "shape": sh,
                "keys": keys, "part_skew": skew,
                "seed": rng.randrange(1 << 31), "max_s": max_s})
        for g in range(groups):
            for m in range(group_size):
                self.specs.append({
                    "role": "consumer", "name": f"g{g}:c{m}",
                    "group": f"fleet-g{g}-{seed}", "group_idx": g,
                    "topics": self.topics, "isolation": isolation,
                    "strategy": strategy,
                    "seed": rng.randrange(1 << 31), "max_s": max_s})
        self.n_groups = groups

    @property
    def workers(self) -> int:
        return len(self.specs)

    def replay_key(self) -> str:
        """Digest of the fully resolved population — equal iff two
        plans would drive byte-identical worker behavior (modulo
        wall-clock pacing), the fleet half of a run's replay key."""
        blob = json.dumps(self.specs, sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]
