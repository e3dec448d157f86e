"""sockem — socket emulation / network shaping shim.

Rebuild of the reference's tests/sockem.c (805 LoC): a proxy interposed
on each broker connection via the client's ``connect_cb`` conf hook
(the reference interposes through ``socket_cb``/``connect_cb``,
rdkafka_conf.c), applying scriptable network conditions
(tests/sockem.h:63-75 semantics):

  - ``delay`` / ``jitter``: per-direction latency in ms
  - ``rate``: bandwidth cap in bytes/sec
  - ``max_write``: partial writes — at most N bytes forwarded per
    send(), so a request/response frame arrives in many small pieces
    (reference sockem.c "txsize"; exercises frame reassembly)
  - ``rx_drop`` / ``tx_drop``: one-direction partition — data in that
    direction (rx = broker->client, tx = client->broker) is silently
    discarded while set, the classic half-open network partition
  - ``kill()``: drop connections mid-flight (mid-request)

Settings apply live to established connections — the knob set can be
changed while requests are in flight, which is what the reference's
retry/timeout tests (0075-retry.c, 0088-produce_metadata_timeout.c,
0093-holb.c) are built on.

Usage::

    sockem = Sockem(delay=0)
    p = Producer({..., "connect_cb": sockem.connect_cb})
    ...
    sockem.set(delay=2000)      # all connections now add 2s latency
    sockem.kill_all()           # drop every connection mid-flight
"""
from __future__ import annotations

import random
import socket
import threading
import time
from typing import Optional

from ..analysis.locks import new_lock
from ..analysis.races import shared


class _Pump(threading.Thread):  # lint: ok shared-state
    """One direction of one proxied connection.

    shared-state pragma: the pump owns no mutable state of its own —
    it reads the em's live knobs (declared on Sockem) and the conn's
    dead flag (single close()-writer, benign stale read of one poll
    interval)."""

    def __init__(self, conn: "SockemConn", src: socket.socket,
                 dst: socket.socket, label: str):
        super().__init__(daemon=True, name=f"sockem-{label}")
        self.conn = conn
        self.src = src
        self.dst = dst
        self.label = label          # "tx" (client->broker) or "rx"

    def run(self):
        em = self.conn.em
        try:
            while not self.conn.dead:
                try:
                    data = self.src.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break
                # one-direction partition: silently discard this
                # direction's traffic while the drop flag is set (the
                # peer still sees an established connection — exactly a
                # half-open network partition, not a close)
                if (em.tx_drop if self.label == "tx" else em.rx_drop):
                    continue
                # latency: hold the chunk for delay ± jitter
                d = em.delay_s
                if em.jitter_s:
                    d += random.uniform(0, em.jitter_s)
                if d > 0:
                    time.sleep(d)
                # bandwidth cap: pace the write
                if em.rate > 0:
                    time.sleep(len(data) / em.rate)
                if self.conn.dead:
                    break
                # retry on send timeout: a momentarily-full socketpair
                # buffer must stall the pump, not kill the connection
                while data and not self.conn.dead:
                    # partial writes: cap each send at max_write bytes
                    # so one frame lands in many pieces (live-settable,
                    # like delay/rate — re-read every iteration)
                    mw = em.max_write
                    chunk = data[:mw] if mw > 0 else data
                    try:
                        n = self.dst.send(chunk)
                        data = data[n:]
                    except socket.timeout:
                        continue
                    except OSError:
                        return
                if data:
                    break
        finally:
            self.conn.close()


class SockemConn:
    """A proxied broker connection (reference: sockem_t)."""

    # relaxed: dead is written once by close() under sockem.conn; the
    # two pump threads poll it lock-free (a stale False costs one 0.1s
    # poll interval before the socket error surfaces anyway)
    dead = shared("sockem.conn.dead", relaxed=True)

    def __init__(self, em: "Sockem", real: socket.socket):
        self.em = em
        self.real = real
        # the socket handed to the broker thread and our end of it
        self.app_side, self.shim_side = socket.socketpair()
        self.dead = False
        self._lock = new_lock("sockem.conn")
        # short poll timeout so live setting changes & kills apply fast
        self.real.settimeout(0.1)
        self.shim_side.settimeout(0.1)
        self._up = _Pump(self, self.shim_side, self.real, "tx")
        self._down = _Pump(self, self.real, self.shim_side, "rx")
        self._up.start()
        self._down.start()

    def close(self):
        with self._lock:
            if self.dead:
                return
            self.dead = True
        for s in (self.real, self.shim_side):
            try:
                s.close()
            except OSError:
                pass
        # do NOT close app_side: the broker owns it and must observe the
        # peer-close (recv()==b"") itself, like a real dropped connection


class Sockem:
    """Factory + live control panel for emulated connections."""

    # relaxed: the live shaping knobs are written by the controlling
    # (test/chaos) thread via set() and read per-chunk by pump threads
    # — float/int/bool snapshots; applying a setting one chunk late is
    # within the emulation's contract.  conns mutations hold sockem.em.
    delay_s = shared("sockem.delay_s", relaxed=True)
    jitter_s = shared("sockem.jitter_s", relaxed=True)
    rate = shared("sockem.rate", relaxed=True)
    max_write = shared("sockem.max_write", relaxed=True)
    rx_drop = shared("sockem.rx_drop", relaxed=True)
    tx_drop = shared("sockem.tx_drop", relaxed=True)

    def __init__(self, *, delay_ms: float = 0, jitter_ms: float = 0,
                 rate_bps: int = 0, max_write: int = 0,
                 rx_drop: bool = False, tx_drop: bool = False):
        self.delay_s = delay_ms / 1000.0
        self.jitter_s = jitter_ms / 1000.0
        self.rate = rate_bps
        self.max_write = max_write
        self.rx_drop = rx_drop
        self.tx_drop = tx_drop
        self.conns: list[SockemConn] = []
        self._lock = new_lock("sockem.em")
        self.connect_count = 0

    # -------------------------------------------------------- live knobs --
    def set(self, *, delay_ms: Optional[float] = None,
            jitter_ms: Optional[float] = None,
            rate_bps: Optional[int] = None,
            max_write: Optional[int] = None,
            rx_drop: Optional[bool] = None,
            tx_drop: Optional[bool] = None) -> None:
        """Change conditions for all current and future connections
        (reference: sockem_set 'delay'/'jitter'/'rate', sockem.c)."""
        if delay_ms is not None:
            self.delay_s = delay_ms / 1000.0
        if jitter_ms is not None:
            self.jitter_s = jitter_ms / 1000.0
        if rate_bps is not None:
            self.rate = rate_bps
        if max_write is not None:
            self.max_write = max_write
        if rx_drop is not None:
            self.rx_drop = rx_drop
        if tx_drop is not None:
            self.tx_drop = tx_drop

    def kill_all(self) -> int:
        """Drop every live connection mid-flight. Returns count killed."""
        return self.kill()

    def kill(self, count: Optional[int] = None) -> int:
        """Drop live connections mid-flight, oldest (connect order)
        first; ``count=None`` kills all. Returns count killed."""
        with self._lock:
            conns = [c for c in self.conns if not c.dead]
        n = 0
        for c in conns if count is None else conns[:count]:
            c.close()
            n += 1
        self._gc()
        return n

    def _gc(self):
        with self._lock:
            self.conns = [c for c in self.conns if not c.dead]

    @property
    def live_connections(self) -> int:
        self._gc()
        with self._lock:
            return len(self.conns)

    # ------------------------------------------------------- conf hook ----
    def connect_cb(self, host: str, port: int, timeout: float
                   ) -> socket.socket:
        """Plug into client conf: ``{"connect_cb": sockem.connect_cb}``."""
        real = socket.create_connection((host, port), timeout=timeout)
        conn = SockemConn(self, real)
        with self._lock:
            self.conns.append(conn)
            self.connect_count += 1
        return conn.app_side
