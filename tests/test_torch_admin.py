"""Mirrors of test_0081_admin on the port: topic create, delete and grow
through the controller, config describe and alter, group list, describe
and delete through the coordinator, per-item errors and a fault-injected
retry.

Each case runs one scenario on the port and on the JAX package, at once
in two threads (``test_torch_txn.both``), each against its own 3-broker
mock; the futures' results and error codes, the metadata and the group
descriptions must be equal, and what 0081 expects.  The clients that
produce or consume run ``compression.backend=gpu, gpu.device=cpu`` on the
port (the kernels' plain versions) and the stored blobs of the produce
case compare byte for byte.
"""
import time

import pytest

from test_torch_client import guarded_thread
from test_torch_delivery import mod
from test_torch_txn import PORT, REF, both
from torch_leakguard import no_new_threads

NOW_MS = 1_700_000_000_000


@pytest.fixture(autouse=True)
def _no_thread_left():
    with no_new_threads(guarded_thread):
        yield


def outcome(fut, timeout: float = 25.0):
    """A future's result, or its error code by name."""
    try:
        return fut.result(timeout=timeout)
    except Exception as e:          # KafkaException of either package
        return e.error.code.name


def with_admin(scenario):
    """``scenario(pkg, cluster, admin, admin_module)`` on both packages,
    each with 0081's cluster (3 brokers, topic ``pre`` of 2 partitions,
    no auto-create) and an AdminClient; (port, reference)."""
    def run(pkg):
        cluster = pkg.MockCluster(num_brokers=3, topics={"pre": 2},
                                  auto_create_topics=False)
        am = mod(pkg, "client.admin")
        admin = am.AdminClient({"bootstrap.servers":
                                cluster.bootstrap_servers()})
        try:
            return scenario(pkg, cluster, admin, am)
        finally:
            admin.close()
            cluster.stop()
    return both(run)


def parts_of(admin) -> dict:
    """Topic -> partition count from the admin client's metadata."""
    return {t: len(p) for t, p in admin.list_topics(10)["topics"].items()}


def test_create_topics():
    def scenario(pkg, cluster, admin, am):
        first = admin.create_topics([am.NewTopic("alpha", num_partitions=3),
                                     am.NewTopic("beta", num_partitions=1)])
        out = {t: outcome(f) for t, f in first.items()}
        md = admin.list_topics(10)
        again = admin.create_topics([am.NewTopic("alpha", 1),
                                     am.NewTopic("gamma", 2)])
        again = {t: outcome(f) for t, f in again.items()}
        return out, parts_of(admin), md["controller_id"], again
    port, ref = with_admin(scenario)
    assert port == ref
    assert port[0] == {"alpha": None, "beta": None}
    assert port[1] == {"pre": 2, "alpha": 3, "beta": 1, "gamma": 2}
    assert port[2] == 1
    assert port[3] == {"alpha": "TOPIC_ALREADY_EXISTS", "gamma": None}


def test_delete_topics():
    def scenario(pkg, cluster, admin, am):
        made = outcome(admin.create_topics([am.NewTopic("doomed", 1)])
                       ["doomed"])
        gone = outcome(admin.delete_topics(["doomed"])["doomed"])
        listed = "doomed" in parts_of(admin)
        never = outcome(admin.delete_topics(["never-existed"])
                        ["never-existed"])
        return made, gone, listed, never
    port, ref = with_admin(scenario)
    assert port == ref == (None, None, False, "UNKNOWN_TOPIC_OR_PART")


def test_create_partitions_grow_and_shrink_error():
    def scenario(pkg, cluster, admin, am):
        grow = outcome(admin.create_partitions([am.NewPartitions("pre", 6)])
                       ["pre"])
        n = parts_of(admin)["pre"]
        shrink = outcome(admin.create_partitions(
            [am.NewPartitions("pre", 2)])["pre"])
        return grow, n, shrink, len(cluster.topics["pre"])
    port, ref = with_admin(scenario)
    assert port == ref == (None, 6, "INVALID_PARTITIONS", 6)


def test_describe_and_alter_configs():
    def scenario(pkg, cluster, admin, am):
        res = am.ConfigResource(am.ConfigResource.TOPIC, "pre")
        entries = outcome(admin.describe_configs([res])[res])
        table = {k: (e.value, e.is_sensitive, e.is_read_only, e.source)
                 for k, e in entries.items()}
        res2 = am.ConfigResource(am.ConfigResource.TOPIC, "pre",
                                 set_config={"retention.ms": "1000"})
        altered = outcome(admin.alter_configs([res2])[res2])
        after = outcome(admin.describe_configs([res])[res])
        return table, altered, after["retention.ms"].value
    port, ref = with_admin(scenario)
    assert port == ref
    assert port[0]["retention.ms"][:2] == ("604800000", False)
    assert port[1] is None


def test_group_ops():
    """A live group is listed and described; deleting it fails while its
    member is in, and succeeds after the consumer closed."""
    def scenario(pkg, cluster, admin, am):
        c = pkg.Consumer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "group.id": "admin-g", "auto.offset.reset": "earliest",
            "session.timeout.ms": 6000}))
        try:
            c.subscribe(["pre"])
            deadline = time.monotonic() + 15
            while ("admin-g", "consumer") not in \
                    outcome(admin.list_groups()):
                assert time.monotonic() < deadline, "group never listed"
                c.poll(0.2)
            desc = outcome(admin.describe_groups(["admin-g"])["admin-g"])
            live = outcome(admin.delete_groups(["admin-g"])["admin-g"])
        finally:
            c.close()
        dead = outcome(admin.delete_groups(["admin-g"])["admin-g"])
        return ((desc["state"], desc["protocol_type"], len(desc["members"])),
                live, dead, "admin-g" in cluster.groups)
    port, ref = with_admin(scenario)
    assert port == ref == (("Stable", "consumer", 1), "NON_EMPTY_GROUP",
                           None, False)


def test_create_topics_error_injection_and_retry():
    """A retriable request-level error is retried by the worker, not
    surfaced."""
    def scenario(pkg, cluster, admin, am):
        cluster.push_request_errors(pkg.proto.ApiKey.CreateTopics,
                                    [pkg.Err.REQUEST_TIMED_OUT])
        futs = admin.create_topics([am.NewTopic("resilient", 1)],
                                   operation_timeout=20)
        return outcome(futs["resilient"]), "resilient" in parts_of(admin)
    port, ref = with_admin(scenario)
    assert port == ref == (None, True)


def test_validate_only_does_not_create():
    """validate_only resolves; the mock creates all the same, in both
    packages (0081 accepts either)."""
    def scenario(pkg, cluster, admin, am):
        futs = admin.create_topics([am.NewTopic("phantom", 1)],
                                   validate_only=True)
        return outcome(futs["phantom"]), "phantom" in cluster.topics
    port, ref = with_admin(scenario)
    assert port == ref and port[0] is None


def test_admin_then_produce_consume():
    """A topic the controller created carries a produce round: equal
    blobs, every record read back through a check.crcs consumer."""
    def scenario(pkg, cluster, admin, am):
        made = outcome(admin.create_topics([am.NewTopic("fresh", 2)])
                       ["fresh"])
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 1000, "batch.num.messages": 5}))
        try:
            for i in range(10):
                p.produce("fresh", value=b"m%d" % i, partition=i % 2,
                          timestamp=NOW_MS + i)
            assert p.flush(15.0) == 0
        finally:
            p.close()
        blobs = [[bytes(b) for _o, b in part.log]
                 for part in cluster.topics["fresh"]]
        c = pkg.Consumer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "group.id": "fresh", "auto.offset.reset": "earliest",
            "check.crcs": True}))
        got = []
        try:
            c.assign([pkg.TopicPartition("fresh", q, 0) for q in (0, 1)])
            deadline = time.monotonic() + 20
            while len(got) < 10:
                assert time.monotonic() < deadline, got
                m = c.poll(0.3)
                if m is not None and m.error is None:
                    got.append((m.partition, m.offset, m.value))
        finally:
            c.close()
        return made, blobs, sorted(got)
    port, ref = with_admin(scenario)
    assert port == ref
    assert port[0] is None and sum(map(len, port[1])) == 2
    assert port[2] == sorted((i % 2, i // 2, b"m%d" % i) for i in range(10))
