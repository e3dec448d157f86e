"""Mirrors of test_0055_producer_latency (the linger gate: linger.ms 0
delivers fast, flush() overrides a long linger and sends the lingering
records as one batch, int_latency reflects linger.ms) on the port, and
chip_smoke.py phase 14a (0055's three cases and a run of awaited
linger-0 records on each leg, with the routes each took) on both
packages at a small size.

Each case runs on the port and on the JAX package at once
(``test_torch_txn.both``), each against its own mock.  The port's
producers run ``compression.backend=gpu, gpu.device=cpu`` (the kernels'
plain versions, every CRC job on the device route); the reference's run
the reference test's own conf.  The bounds are 0055's own.  The kits
here (``kit(pkg)``, ``PORT_GPU``, ``REF_TPU``) serve the other phase-14
mirrors too.
"""
import json
import time
from types import SimpleNamespace

from test_torch_txn import GPU as PORT_GPU
from test_torch_txn import both

#: the JAX package's device route for the phase-14 functions: governor
#: off, quorum 1, no transport gate, and no warm-up thread (its engine
#: then compiles a new padded shape at the launch instead of serving it
#: on the CPU as a warm-up miss; the port's kernels compile nothing)
REF_TPU = {"compression.backend": "tpu", "tpu.governor": False,
           "tpu.launch.min.batches": 1, "tpu.transport.min.mb.s": 0,
           "tpu.warmup": False}


def kit(pkg):
    """The names chip_smoke.py's phase-14 functions drive, from ``pkg``'s
    package (the port's ``p14_kit()`` shape)."""
    import importlib
    root = "librdkafka_tpu_torch" if pkg.port else "librdkafka_tpu"

    def m(name):
        return importlib.import_module(f"{root}.{name}")
    errors = m("client.errors")
    return SimpleNamespace(
        port=pkg.port, Producer=pkg.Producer, Consumer=pkg.Consumer,
        TopicPartition=pkg.TopicPartition, MockCluster=pkg.MockCluster,
        Sockem=m("mock.sockem").Sockem, Err=errors.Err,
        KafkaError=errors.KafkaError, KafkaException=errors.KafkaException,
        Toppar=m("client.partition").Toppar)


def backend(pkg) -> dict:
    """Each package's device route for the phase-14 functions."""
    return dict(PORT_GPU if pkg.port else REF_TPU)


def _deliver_one(p, topic, timeout=10.0):
    done = []
    p.produce(topic, value=b"lat", partition=0,
              on_delivery=lambda e, m: done.append(time.monotonic()))
    t0 = time.monotonic()
    deadline = t0 + timeout
    while not done and time.monotonic() < deadline:
        p.poll(0.01)
    assert done, "never delivered"
    return done[0] - t0


def _on_lat(scenario):
    def run(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"lat": 1})
        try:
            return scenario(pkg, cluster)
        finally:
            cluster.stop()
    return both(run)


# ------------------------------------------------------------ test_0055 --

def test_low_linger_is_fast():
    def scenario(pkg, cluster):
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 0}))
        try:
            _deliver_one(p, "lat")              # warm connection
            lat = min(_deliver_one(p, "lat") for _ in range(5))
            return lat < 0.15
        finally:
            p.close()
    assert _on_lat(scenario) == (True, True)


def test_high_linger_accumulates_then_flush_overrides():
    def scenario(pkg, cluster):
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 5000, "batch.num.messages": 10000}))
        try:
            p.produce("lat", value=b"warm", partition=0)
            assert p.flush(10.0) == 0       # flush sends despite linger
            for i in range(50):
                p.produce("lat", value=b"m%d" % i, partition=0)
            time.sleep(0.4)
            lingering = cluster.partition("lat", 0).end_offset
            t0 = time.monotonic()
            assert p.flush(10.0) == 0
            fast = time.monotonic() - t0 < 2.0
            part = cluster.partition("lat", 0)
            return lingering, fast, part.end_offset, len(part.log)
        finally:
            p.close()
    port, ref = _on_lat(scenario)
    # still lingering after 0.4 s, flush() under 2 s, the 50 as ONE batch
    assert port == ref == (1, True, 51, 2)


def test_int_latency_stat_reflects_linger():
    def scenario(pkg, cluster):
        blobs = []
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": cluster.bootstrap_servers(),
            "linger.ms": 300, "statistics.interval.ms": 200,
            "stats_cb": lambda js: blobs.append(json.loads(js))}))
        try:
            for i in range(20):
                p.produce("lat", value=b"s%d" % i, partition=0)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                p.poll(0.1)
                if any(b["int_latency"]["cnt"] for b in blobs):
                    break
            il = next(b["int_latency"] for b in blobs
                      if b["int_latency"]["cnt"])
            return il["max"] >= 250_000, sorted(il)   # us
        finally:
            p.close()
    port, ref = _on_lat(scenario)
    assert port == ref and port[0]


# ------------------------------------------- chip_smoke.py phase 14a --

P14A_N = 10


def test_phase14a_latency_on_both_packages():
    """chip_smoke.py 14a at 10 awaited records a leg: 0055's bounds on
    every leg; the CPU provider, the GPU (TPU) provider on its governed
    defaults and the ungoverned device route (leg a) take the same routes
    in both packages: the governed defaults offload nothing at linger.ms
    0 (the fan-in window falls to 0 and each one-batch group, below the
    quorum of 4, is served on the CPU), the device route makes one launch
    a batch.  Leg b (the compress route) runs on the card only
    (tests/test_torch_gpu.py -k latency_load, phase 14a): on the CPU its
    plain LZ4 version takes tens of milliseconds a launch, so 0055's
    150 ms bound would time that version, not the linger gate."""
    import chip_smoke

    def scenario(pkg):
        k = kit(pkg)
        # the JAX package's warm-up thread on: its warm registry covers
        # these one-record shapes, and an inline compile (tens of ms to
        # seconds with jax on the CPU) would time XLA, not the linger gate
        gpu = backend(pkg) if pkg.port else {**REF_TPU, "tpu.warmup": True}
        legs = [("cpu", {"compression.backend": "cpu"}, False),
                ("governed", {"compression.backend": "gpu",
                              "gpu.device": "cpu"} if pkg.port
                 else {"compression.backend": "tpu"}, False),
                ("a", gpu, True)]
        out = chip_smoke.p14_latency(k, legs, P14A_N, "cpu", "cpu")
        keys = ("launches", "compress.launches", "cpu_fallback_jobs",
                "fanin_skips")
        return {tag: (out[tag]["batches"],
                      {key: out[tag]["routes"].get(key) for key in keys})
                for tag, _c, _g in legs}
    port, ref = both(scenario)
    n = P14A_N
    assert port == ref == {
        "cpu": (n, dict.fromkeys(("launches", "compress.launches",
                                  "cpu_fallback_jobs", "fanin_skips"))),
        "governed": (n, {"launches": 0, "compress.launches": 0,
                         "cpu_fallback_jobs": n, "fanin_skips": n}),
        "a": (n, {"launches": n, "compress.launches": 0,
                  "cpu_fallback_jobs": 0, "fanin_skips": 0})}
