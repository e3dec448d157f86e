"""Open-loop producer at a fixed rate: independent events, each sent
when it is due, whatever the client's backlog.

The arrivals are a Poisson stream at ``rate`` records/s: the window's
``rate * seconds`` gaps are the exponential distribution's quantiles,
scaled to fill the window exactly and put in an order drawn from the
seed, so every seed sends the same set of gaps.  Records go round-robin
over the partitions, cycling through the seeded pool.  Each record is
timed from its due time to the serving of its delivery report; a record
still undelivered when ``flush`` gives up counts as failed.  Between due
times the application thread waits in ``poll()``, which serves delivery
reports as they arrive.

Workload parameters: ``width``, ``rate``, ``warmup_records`` (sent at
the same rate before the window), ``slice_batches`` (the batches a
partition has decoded and compared record by record, see
:func:`kbench.reference.check.check_log`).
"""
from __future__ import annotations

import time

import numpy as np

from kbench.lib.delivery import produce_one
from kbench.lib.records import POOL, make_pool
from kbench.reference.check import check_log

TOPIC = "kbench"


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times in seconds from the window's start."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng([seed, 2]).permutation(gaps)
    return np.cumsum(gaps) - gaps[0]


class Deliveries:
    """Delivery reports: when each record's arrived, by its position in
    its partition (the offset the broker gave it)."""

    def __init__(self, nparts: int, total: int):
        self.nparts = nparts
        self.at = np.full(total, np.nan)
        self.acked = [0] * nparts
        self.failed = 0
        self.offset_bad = 0

    def __call__(self, msgs) -> None:
        now = time.perf_counter()
        m = msgs[0]
        if m.error is not None:
            self.failed += len(msgs)
            return
        p = m.partition
        if m.offset != self.acked[p]:
            self.offset_bad += 1
        else:
            first = p + self.nparts * m.offset
            self.at[first:first + self.nparts * len(msgs):self.nparts] = now
        self.acked[p] += len(msgs)


def run(h) -> None:
    from librdkafka_tpu_torch import Producer

    t = h.cell["traffic_params"]
    nparts = h.cfg["partitions"]
    rate = float(t["rate"])
    pool = make_pool(h.seed, t["width"])
    warm = int(t["warmup_records"]) // nparts * nparts
    due = arrivals(h.seed, rate, h.seconds)
    broker = h.broker(TOPIC)
    h.mark("broker")
    dr = Deliveries(nparts, warm + len(due))
    p = h.own(Producer(h.client_conf("producer", broker.bootstrap,
                                     dr_batch_cb=dr)))
    if h.cfg["producer"].get("compression.backend") == "gpu":
        if not p._rk.codec_provider.wait_warm(300.0):
            raise RuntimeError("the GPU provider did not warm")
    h.mark("client")
    produce = p.produce
    poll = p.poll

    def send(first: int, when: np.ndarray, t0: float) -> np.ndarray:
        """Send records first.. at t0 + when; returns when each went."""
        sent_at = np.empty(len(when))
        for k, dt in enumerate(when):
            at = t0 + dt
            while (now := time.perf_counter()) < at:
                poll(at - now)
            i = first + k
            produce_one(produce, poll, TOPIC, pool[i % POOL], i % nparts)
            sent_at[k] = time.perf_counter()
        return sent_at

    send(0, np.arange(warm) / rate, time.perf_counter())
    if p.flush(60.0):
        raise RuntimeError("the warm-up did not drain")
    h.setup_done()
    with h.window([p]) as w:
        sent_at = send(warm, due, w.t0)
        while (now := time.perf_counter()) < w.deadline:
            poll(w.deadline - now)
        at = dr.at[warm:]
        h.r.delivered = int(np.sum(at <= w.deadline))
        # the backlog: records due but not yet delivered, at the middle
        # and at the end of the window (a rate above the knee grows it)
        for name, tt in (("backlog_mid", w.t0 + h.seconds / 2),
                         ("backlog_end", w.deadline)):
            h.r.extra[name] = int(np.sum(w.t0 + due <= tt)
                                  - np.sum(at <= tt))
    p.flush(60.0)
    h.drop(p)
    lat = (dr.at[warm:] - (w.t0 + due)) * 1e3
    done = lat[~np.isnan(lat)]
    h.r.extra["acked_per_s"] = np.histogram(
        dr.at[warm:] - w.t0, bins=np.arange(int(h.seconds) + 1))[0].tolist()
    if len(done):
        for q in (50, 90, 95, 99, 99.9):
            h.r.extra[f"deliver_p{q}_ms"] = float(np.percentile(done, q))
    h.r.extra["send_lag_ms_p99"] = float(
        np.percentile((sent_at - (w.t0 + due)) * 1e3, 99))
    h.attempted = len(due)
    undelivered = int(np.isnan(lat).sum())
    h.failed = undelivered
    h.check("undelivered", undelivered, 0)
    h.check("dr_offset_bad", dr.offset_bad, 0)
    t_ref = time.perf_counter()
    logs = broker.dump(TOPIC)
    counts, h.covered = check_log(
        logs, lambda part, off: pool[(part + nparts * off) % POOL],
        dict(enumerate(dr.acked)),
        idempotent=h.cfg["guarantees"]["idempotence"],
        codec=h.cfg["producer"]["compression.codec"],
        rng=np.random.default_rng([h.seed, 1]),
        slice_batches=t["slice_batches"])
    h.r.extra["reference_s"] = time.perf_counter() - t_ref
    for k, v in counts.items():
        h.check(k, v, 0)
