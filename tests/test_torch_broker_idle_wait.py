"""The wait that ends a broker's serve pass: an UP broker with nothing a
timer must serve (no partition led or fetched, nothing queued, unsent,
awaiting a response or a retry, no codec results or fetches to come
back) blocks on its wakeup pipe and socket for up to 1 s
(``IDLE_WAIT_S``) and counts the pass in ``idle_waits``; any other
broker keeps the 5 ms poll.  An op ends the long wait at once.  CPU
provider and the GPU provider's plain versions (``gpu.device=cpu``),
against the mock cluster."""
import time

import pytest

from librdkafka_tpu_torch import Producer
from librdkafka_tpu_torch.client.broker import Request
from librdkafka_tpu_torch.protocol.proto import ApiKey

BACKENDS = {
    "cpu": {},
    "gpu": {"compression.backend": "gpu", "gpu.device": "cpu",
            "gpu.launch.min.batches": 1},
}


def _producer(backend: str):
    p = Producer({"bootstrap.servers": "", "test.mock.num.brokers": 1,
                  "compression.codec": "lz4", "linger.ms": 5,
                  **BACKENDS[backend]})
    if backend == "gpu":
        assert p._rk.codec_provider.wait_warm(300)
    for i in range(200):
        p.produce("idle", value=b"rec-%06d " % i * 40, partition=i % 4)
    assert p.flush(120) == 0
    return p


def _brokers(p):
    """(the bootstrap broker, the leader) of a one-broker mock cluster."""
    (boot,) = [b for b in p._rk.brokers.values() if b.nodeid < 0]
    (leader,) = [b for b in p._rk.brokers.values() if b.nodeid >= 0]
    return boot, leader


def _counts(b) -> tuple:
    return b.c_wakeups, b.c_idle_waits, dict(b.c_woke)


def _settled(b, timeout: float = 5.0) -> None:
    """Wait until ``b`` blocks in an idle wait: its idle-wait count moved
    and then held for 50 ms with no pass ending."""
    deadline = time.monotonic() + timeout
    i0 = b.c_idle_waits
    while b.c_idle_waits == i0:
        assert time.monotonic() < deadline, "no idle wait"
        time.sleep(0.01)
    while True:
        w = b.c_wakeups
        time.sleep(0.05)
        if b.c_wakeups == w:
            return
        assert time.monotonic() < deadline, "never settled"


@pytest.fixture(params=sorted(BACKENDS))
def producer(request):
    p = _producer(request.param)
    try:
        yield p
    finally:
        p.close()


def test_idle_bootstrap_blocks_in_its_idle_wait(producer):
    """A connected, idle producer's bootstrap broker leads nothing: it
    makes at most 3 passes a second, each an idle wait."""
    boot, _ = _brokers(producer)
    _settled(boot)
    w0, i0, _ = _counts(boot)
    time.sleep(1.0)
    w1, i1, _ = _counts(boot)
    assert w1 - w0 <= 3
    # the idle-wait count moves as the wait starts, the pass count as
    # the pass ends: they differ by at most the pass in flight
    assert abs((i1 - i0) - (w1 - w0)) <= 1
    assert boot.c_idle_waits >= 1


def test_leader_keeps_the_short_poll(producer):
    """The leader of the same producer keeps the 5 ms poll: at least 20
    passes in 0.6 s, and no idle wait."""
    _, leader = _brokers(producer)
    time.sleep(0.3)                     # the acks and DRs settle
    w0, i0, _ = _counts(leader)
    time.sleep(0.6)
    w1, i1, woke1 = _counts(leader)
    assert w1 - w0 >= 20
    assert i1 == i0 == 0
    assert woke1["timeout"] >= 20


def test_request_to_idle_bootstrap_leaves_at_once(producer):
    """A request enqueued to a bootstrap broker in its idle wait leaves
    within 50 ms: the op, not the 1 s timer, ends the wait."""
    boot, _ = _brokers(producer)
    _settled(boot)
    pipe0 = boot.c_woke["pipe"]
    got = []
    req = Request(ApiKey.Metadata,
                  {"topics": ["idle"], "allow_auto_topic_creation": False},
                  abs_timeout=time.monotonic() + 10,
                  cb=lambda err, resp: got.append((err, resp)))
    boot.enqueue_request(req)
    deadline = time.monotonic() + 5
    while not got:
        assert time.monotonic() < deadline, "no metadata response"
        time.sleep(0.005)
    err, resp = got[0]
    assert err is None and resp["topics"][0]["topic"] == "idle"
    assert 0 < req.ts_sent - req.ts_enq < 0.05
    assert boot.c_woke["pipe"] > pipe0


def test_partition_join_ends_the_idle_wait(producer):
    """A PARTITION_JOIN op ends the idle wait at once, and the passes
    after it take the 5 ms poll; a PARTITION_LEAVE gives the broker back
    its idle wait."""
    boot, _ = _brokers(producer)
    tp = next(iter(producer._rk.active_toppars()))
    _settled(boot)
    w0, i0, _ = _counts(boot)
    t0 = time.monotonic()
    boot.add_toppar(tp)
    while boot.c_wakeups == w0:
        assert time.monotonic() - t0 < 0.5, "the join did not wake it"
        time.sleep(0.001)
    assert time.monotonic() - t0 < 0.1
    assert tp in boot.toppars
    time.sleep(0.2)
    w1, i1, _ = _counts(boot)
    assert i1 == i0                     # every pass since polled
    assert w1 - w0 >= 8
    boot.remove_toppar(tp)
    _settled(boot)
    assert boot.c_idle_waits > i1


def test_close_joins_idle_brokers_at_once():
    """close() ends every broker thread, those in their idle wait
    included, within 0.5 s."""
    p = _producer("cpu")
    boot, leader = _brokers(p)
    _settled(boot)
    t0 = time.monotonic()
    p.close()
    for b in (boot, leader):
        b.thread.join(max(0.0, t0 + 0.5 - time.monotonic()))
        assert not b.thread.is_alive(), b.name
    assert time.monotonic() - t0 < 0.5
