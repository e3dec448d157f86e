"""Partition assignors + consumer-protocol metadata marshalling.

Reference: src/rdkafka_assignor.c (pluggable partition.assignment.strategy,
protocol metadata wire format) with the builtin range
(rdkafka_range_assignor.c), roundrobin (rdkafka_roundrobin_assignor.c)
and KIP-429 cooperative-sticky (rdkafka_sticky_assignor.c) strategies;
rd_kafka_assignor_run (:283) executes on the elected leader.

Wire formats are the public Kafka "consumer" embedded protocol:
  Subscription v0: Version i16, Topics [String], UserData Bytes
  Subscription v1: + OwnedPartitions [Topic String, Partitions [Int32]]
                   (KIP-429: the member's current claims ride the
                   JoinGroup so the leader can compute sticky,
                   incremental assignments)
  Assignment:      Version i16, [Topic String, Partitions [Int32]],
                   UserData

Each assignor also names its **rebalance protocol** (EAGER revokes the
world before every rejoin; COOPERATIVE keeps unrevoked partitions
flowing through the rebalance) — ``ASSIGNOR_PROTOCOLS``, the
rd_kafka_rebalance_protocol() analog.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..protocol.types import Array, Bytes, Int16, Int32, Schema, String
from ..utils.buf import SegBuf, Slice

SUBSCRIPTION_SCHEMA = Schema(
    ("version", Int16), ("topics", Array(String)), ("user_data", Bytes))
_OWNED_SCHEMA = Array(Schema(("topic", String),
                             ("partitions", Array(Int32))))
ASSIGNMENT_SCHEMA = Schema(
    ("version", Int16),
    ("topics", Array(Schema(("topic", String),
                            ("partitions", Array(Int32))))),
    ("user_data", Bytes))


def subscription_encode(topics: list[str], user_data: bytes = b"",
                        owned: Optional[dict[str, list[int]]] = None
                        ) -> bytes:
    """``owned`` (topic -> partitions, the member's CURRENT claims)
    selects Subscription v1 — the cooperative assignor's input; eager
    assignors keep emitting v0 exactly as before."""
    buf = SegBuf()
    SUBSCRIPTION_SCHEMA.write(buf, {
        "version": 0 if owned is None else 1,
        "topics": sorted(topics), "user_data": user_data})
    if owned is not None:
        _OWNED_SCHEMA.write(buf, [
            {"topic": t, "partitions": sorted(ps)}
            for t, ps in sorted(owned.items()) if ps])
    return buf.as_bytes()


def subscription_decode(data: bytes) -> dict:
    sl = Slice(data)
    out = SUBSCRIPTION_SCHEMA.read(sl)
    out["owned_partitions"] = {}
    if out["version"] >= 1 and sl.remains() >= 4:
        out["owned_partitions"] = {
            row["topic"]: row["partitions"]
            for row in _OWNED_SCHEMA.read(sl)}
    return out


def assignment_encode(assignment: dict[str, list[int]],
                      user_data: bytes = b"") -> bytes:
    buf = SegBuf()
    ASSIGNMENT_SCHEMA.write(buf, {
        "version": 0,
        "topics": [{"topic": t, "partitions": sorted(ps)}
                   for t, ps in sorted(assignment.items())],
        "user_data": user_data})
    return buf.as_bytes()


def assignment_decode(data: bytes) -> dict[str, list[int]]:
    if not data:
        return {}
    parsed = ASSIGNMENT_SCHEMA.read(Slice(data))
    return {t["topic"]: t["partitions"] for t in parsed["topics"]}


def range_assignor(members: dict[str, list[str]],
                   partitions: dict[str, int]) -> dict[str, dict[str, list[int]]]:
    """Per-topic contiguous ranges (Java RangeAssignor semantics):
    for each topic, sort consumers; first (n_parts % n_consumers) consumers
    get one extra partition."""
    out: dict[str, dict[str, list[int]]] = {m: {} for m in members}
    topics: dict[str, list[str]] = {}
    for member, subscribed in members.items():
        for t in subscribed:
            topics.setdefault(t, []).append(member)
    for topic, consumers in topics.items():
        nparts = partitions.get(topic, 0)
        if nparts <= 0:
            continue
        consumers = sorted(consumers)
        n = len(consumers)
        per, extra = divmod(nparts, n)
        start = 0
        for i, c in enumerate(consumers):
            cnt = per + (1 if i < extra else 0)
            if cnt:
                out[c][topic] = list(range(start, start + cnt))
            start += cnt
    return out


def roundrobin_assignor(members: dict[str, list[str]],
                        partitions: dict[str, int]) -> dict[str, dict[str, list[int]]]:
    """All (topic, partition) pairs sorted, dealt round-robin to the sorted
    eligible consumers (Java RoundRobinAssignor semantics)."""
    out: dict[str, dict[str, list[int]]] = {m: {} for m in members}
    pairs = []
    for t in sorted(partitions):
        for p in range(partitions[t]):
            pairs.append((t, p))
    consumers = sorted(members)
    i = 0
    for t, p in pairs:
        # find next consumer subscribed to t
        for _ in range(len(consumers)):
            c = consumers[i % len(consumers)]
            i += 1
            if t in members[c]:
                out[c].setdefault(t, []).append(p)
                break
    return out


def cooperative_sticky_assignor(
        members: dict[str, list[str]], partitions: dict[str, int],
        owned: Optional[dict[str, dict[str, list[int]]]] = None
        ) -> dict[str, dict[str, list[int]]]:
    """KIP-429 cooperative-sticky (reference: rdkafka_sticky_assignor.c
    + the CooperativeStickyAssignor adjustment): every member keeps the
    partitions it already owns (stickiness maximized), free partitions
    go to the least-loaded eligible member, and **no partition is ever
    assigned to a new owner in the generation it is revoked from the
    old one** — a moving partition is simply left out of this
    generation's assignment (the old owner's incremental revoke +
    rejoin triggers the next generation, which hands it over).

    ``owned``: member -> {topic: [partitions]} claims from the
    Subscription v1 ``owned_partitions`` field.  A partition claimed by
    two members (zombie generation overlap) is kept by NEITHER — both
    revoke, and the next generation reassigns it cleanly.
    """
    owned = owned or {}
    out: dict[str, dict[str, list[int]]] = {m: {} for m in members}
    topic_members: dict[str, list[str]] = {}
    for m, subscribed in members.items():
        for t in subscribed:
            if partitions.get(t, 0) > 0:
                topic_members.setdefault(t, []).append(m)
    all_parts = [(t, p) for t in sorted(topic_members)
                 for p in range(partitions[t])]
    # validate claims: drop unsubscribed topics / out-of-range ids
    claims: dict[tuple[str, int], list[str]] = {}
    for m in sorted(members):
        for t, ps in (owned.get(m) or {}).items():
            if t not in members[m] or partitions.get(t, 0) <= 0:
                continue
            for p in ps:
                if 0 <= p < partitions[t]:
                    claims.setdefault((t, p), []).append(m)
    sticky = {tp: cs[0] for tp, cs in claims.items() if len(cs) == 1}
    conflicted = {tp for tp, cs in claims.items() if len(cs) > 1}
    load = {m: 0 for m in members}
    for (t, p), m in sorted(sticky.items()):
        out[m].setdefault(t, []).append(p)
        load[m] += 1
    # free partitions (unclaimed) placed least-loaded-first; conflicted
    # ones sit out this generation entirely (see docstring)
    for t, p in all_parts:
        if (t, p) in sticky or (t, p) in conflicted:
            continue
        elig = topic_members.get(t)
        if not elig:
            continue
        m = min(elig, key=lambda c: (load[c], c))
        out[m].setdefault(t, []).append(p)
        load[m] += 1
    # rebalance overloaded members: strip sticky partitions down toward
    # the mean, WITHOUT assigning them to anyone this generation — the
    # virtual load bump models where the next generation will put them,
    # so one pass never strips more than the imbalance
    moved = True
    while moved:
        moved = False
        for (t, p), m in sorted(sticky.items()):
            if p not in out[m].get(t, ()):
                continue                       # already stripped
            cands = [c for c in topic_members[t] if c != m]
            if not cands:
                continue
            c = min(cands, key=lambda x: (load[x], x))
            if load[m] - load[c] >= 2:
                out[m][t].remove(p)
                if not out[m][t]:
                    del out[m][t]
                load[m] -= 1
                load[c] += 1                   # virtual: lands next gen
                moved = True
    for m in out:
        out[m] = {t: sorted(ps) for t, ps in out[m].items()}
    return out


ASSIGNORS: dict[str, Callable] = {
    "range": range_assignor,
    "roundrobin": roundrobin_assignor,
    "cooperative-sticky": cooperative_sticky_assignor,
}

#: rebalance protocol per assignor (rd_kafka_rebalance_protocol): the
#: member's effective protocol is the one of the broker-elected
#: assignor, so a group mixing cooperative and eager-only members
#: downgrades to EAGER via the broker's common-protocol selection
ASSIGNOR_PROTOCOLS: dict[str, str] = {
    "range": "EAGER",
    "roundrobin": "EAGER",
    "cooperative-sticky": "COOPERATIVE",
}
