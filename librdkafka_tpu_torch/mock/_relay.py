"""Broker serving-plane relay: one OS process per mock broker.

The port's copy of librdkafka_tpu/mock/_relay.py.  Executed BY PATH
(``python .../mock/_relay.py``) from the standalone supervisor
(librdkafka_tpu_torch/mock/standalone.py) — deliberately not ``-m``: the
relay must stay pure-stdlib and import neither package (nor torch or
JAX), so a broker process costs milliseconds to spawn and dies instantly
under SIGKILL.

The relay binds the broker's PUBLIC port and shuttles bytes to the
supervisor's internal MockCluster listener for that broker.  The split
mirrors a replicated deployment: the supervisor holds the storage/
controller plane (what an acks=all quorum would preserve), the relay
IS the broker process clients talk to — ``kill -9`` takes the port
down mid-write (half-written frames lost, connects refused),
``SIGSTOP``/``SIGCONT`` freeze it like a GC pause or VM migration,
and the client must survive with the delivery contract intact.

**Asymmetric brownouts** (the out-of-process analog of sockem's
one-direction rx_drop/tx_drop + latency): live-settable knobs arrive as
JSON command lines on stdin::

    {"set": {"rx_drop": true}}            broker->client data discarded
    {"set": {"tx_drop": true}}            client->broker data discarded
    {"set": {"rx_delay_ms": 200}}         broker->client latency
    {"set": {"tx_delay_ms": 50}}          client->broker latency
    {"set": {}}  /  all-zero knobs        heal

Each command is acked with one JSON line on stdout
(``{"ok": true, "knobs": {...}}``).  Directions are client-relative,
matching sockem: **tx** = client->broker, **rx** = broker->client —
so ``rx_drop`` is the classic half-open partition where the broker
hears requests but its responses vanish.

**Observability** rides the same stdin channel::

    {"trace": 1|0}      enable/disable this relay's trace rings
    {"clock": 1}        ack carries mono_ns (clock offset exchange)
    {"trace_dump": 1}   ack carries pid + the whole ring dump inline

The tracer (the port's obs/trace.py, itself pure stdlib) is loaded BY
PATH on first enable, so the relay never imports the package and its
cold startup stays milliseconds.  Instrumentation is per-connection, not
per-chunk: a ``conn_setup`` span around accept+upstream-connect and a
``conn`` span over each connection's lifetime.

Handshake: one JSON line on stdout — ``{"broker", "port", "pid"}``.
Exits when stdin reaches EOF (supervisor died or closed the pipe), so
an orphaned relay can never linger eating the host.
"""
import argparse
import json
import os
import selectors
import socket
import sys
import time

RECV_CHUNK = 65536
#: per-direction backpressure cap: stop reading a side whose peer is
#: this far behind (a slow client must not balloon the relay)
BUF_MAX = 1 << 20

#: live brownout knobs (stdin-settable; read per-chunk)
KNOBS = {"rx_drop": False, "tx_drop": False,
         "rx_delay_ms": 0.0, "tx_delay_ms": 0.0}

#: obs/trace.py module once {"trace": 1} loaded it by path (the relay
#: must never import the package — see the module docstring)
TRACE = None


def _load_trace():
    global TRACE
    if TRACE is None:
        import importlib.util
        path = os.path.abspath(os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            os.pardir, "obs", "trace.py"))
        spec = importlib.util.spec_from_file_location("_relay_trace", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        TRACE = mod
    return TRACE


class _Half:
    """One direction's state: bytes waiting to be written to ``sock``
    plus any delayed chunks still being 'held in flight'."""

    __slots__ = ("sock", "peer", "buf", "reading", "dir_read", "holdq",
                 "held", "t0")

    def __init__(self, sock, dir_read):
        self.sock = sock
        self.peer = None
        self.buf = bytearray()
        self.reading = True
        #: direction label of data READ from this sock ("tx" for the
        #: client-side half, "rx" for the upstream/broker-side half)
        self.dir_read = dir_read
        #: delayed chunks headed FOR this sock: [(release_t, bytes)]
        self.holdq = []
        self.held = 0               # total bytes in holdq
        self.t0 = 0                 # trace stamp at accept (conn span)


def _events(h: _Half) -> int:
    ev = 0
    if h.reading:
        ev |= selectors.EVENT_READ
    if h.buf:
        ev |= selectors.EVENT_WRITE
    return ev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--broker-id", type=int, required=True)
    ap.add_argument("--port", type=int, default=0,
                    help="public port to bind (0 = ephemeral; restarts "
                         "pass the original port back in)")
    ap.add_argument("--upstream", required=True, metavar="HOST:PORT",
                    help="the supervisor's internal listener for this "
                         "broker")
    args = ap.parse_args(argv)
    uhost, _, uport = args.upstream.rpartition(":")

    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ls.bind(("127.0.0.1", args.port))
    ls.listen(64)
    ls.setblocking(False)

    print(json.dumps({"broker": args.broker_id,
                      "port": ls.getsockname()[1],
                      "pid": os.getpid()}), flush=True)

    sel = selectors.DefaultSelector()
    sel.register(ls, selectors.EVENT_READ, "accept")
    # parent-death watch + brownout command channel: stdin is a pipe
    # from the supervisor; EOF means it is gone
    sel.register(sys.stdin.fileno(), selectors.EVENT_READ, "stdin")
    stdin_buf = bytearray()

    halves: dict[socket.socket, _Half] = {}

    def close_pair(h: _Half):
        if TRACE is not None and TRACE.enabled:
            for side in (h, h.peer):
                if side is not None and side.t0 and side.sock in halves:
                    TRACE.complete("relay", "conn", side.t0,
                                   {"broker": args.broker_id})
                    side.t0 = 0
        for side in (h, h.peer):
            if side is None or side.sock not in halves:
                continue
            try:
                sel.unregister(side.sock)
            except (KeyError, ValueError):
                pass
            try:
                side.sock.close()
            except OSError:
                pass
            del halves[side.sock]

    def update(h: _Half):
        try:
            sel.modify(h.sock, _events(h), "conn")
        except (KeyError, ValueError):
            pass

    def deliver(dst: _Half, data) -> None:
        """Queue ``data`` for ``dst``'s socket and push what fits now;
        applies the backpressure contract on the reading side."""
        src = dst.peer
        dst.buf += data
        try:
            sent = dst.sock.send(dst.buf)
            del dst.buf[:sent]
        except BlockingIOError:
            pass
        except OSError:
            close_pair(dst)
            return
        if src is not None and len(dst.buf) + dst.held > BUF_MAX:
            src.reading = False
            update(src)
        update(dst)

    def handle_cmd(line: bytes) -> None:
        try:
            cmd = json.loads(line)
        except ValueError:
            print(json.dumps({"ok": False, "error": "bad json"}),
                  flush=True)
            return
        if "trace" in cmd:
            tr = _load_trace()
            if cmd["trace"]:
                tr.enable()
            else:
                tr.disable()
            print(json.dumps({"ok": True, "trace": bool(cmd["trace"])}),
                  flush=True)
            return
        if cmd.get("clock"):
            print(json.dumps({"ok": True,
                              "mono_ns": time.monotonic_ns()}),
                  flush=True)
            return
        if cmd.get("trace_dump"):
            evs = (TRACE.collect_events()
                   if TRACE is not None and TRACE.enabled else [])
            print(json.dumps({"ok": True, "pid": os.getpid(),
                              "mono_ns": time.monotonic_ns(),
                              "events": evs},
                             separators=(",", ":")), flush=True)
            return
        knobs = cmd.get("set") or {}
        for k, v in knobs.items():
            if k in ("rx_drop", "tx_drop"):
                KNOBS[k] = bool(v)
            elif k in ("rx_delay_ms", "tx_delay_ms"):
                KNOBS[k] = float(v)
        print(json.dumps({"ok": True, "knobs": KNOBS}), flush=True)

    while True:
        # release due held chunks first; the nearest future release
        # bounds the select timeout so latency injection stays accurate
        now = time.monotonic()
        timeout = None
        for h in list(halves.values()):
            while h.holdq and h.holdq[0][0] <= now:
                _t, data = h.holdq.pop(0)
                h.held -= len(data)
                deliver(h, data)
                if h.sock not in halves:
                    break
            if h.sock in halves and h.holdq:
                left = h.holdq[0][0] - now
                timeout = left if timeout is None else min(timeout, left)
        if timeout is not None:
            timeout = max(0.0, timeout)

        for key, mask in sel.select(timeout):
            if key.data == "stdin":
                chunk = os.read(sys.stdin.fileno(), 4096)
                if not chunk:
                    return 0
                stdin_buf += chunk
                while b"\n" in stdin_buf:
                    raw, _, rest = bytes(stdin_buf).partition(b"\n")
                    stdin_buf = bytearray(rest)
                    if raw.strip():
                        handle_cmd(raw)
                continue
            if key.data == "accept":
                t_acc = (TRACE.now() if TRACE is not None
                         and TRACE.enabled else 0)
                try:
                    cs, _ = ls.accept()
                except OSError:
                    continue
                us = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                try:
                    us.settimeout(5.0)
                    us.connect((uhost or "127.0.0.1", int(uport)))
                except OSError:
                    # storage plane unreachable (broker marked down but
                    # relay still alive — restart race): drop the client
                    cs.close()
                    us.close()
                    continue
                cs.setblocking(False)
                us.setblocking(False)
                ch, uh = _Half(cs, "tx"), _Half(us, "rx")
                ch.peer, uh.peer = uh, ch
                halves[cs] = ch
                halves[us] = uh
                sel.register(cs, _events(ch), "conn")
                sel.register(us, _events(uh), "conn")
                if t_acc:
                    # span over accept + upstream connect; the conn
                    # span itself closes with the pair
                    ch.t0 = t_acc
                    TRACE.complete("relay", "conn_setup", t_acc,
                                   {"broker": args.broker_id})
                continue

            h = halves.get(key.fileobj)
            if h is None:
                continue
            if mask & selectors.EVENT_READ:
                try:
                    data = h.sock.recv(RECV_CHUNK)
                except BlockingIOError:
                    data = None
                except OSError:
                    close_pair(h)
                    continue
                if data == b"":
                    close_pair(h)
                    continue
                if data:
                    # one-direction partition: silently discard this
                    # direction's traffic while its drop knob is set
                    # (the peer still sees an established connection —
                    # a half-open partition, not a close)
                    if KNOBS[h.dir_read + "_drop"]:
                        continue
                    delay = KNOBS[h.dir_read + "_delay_ms"]
                    dst = h.peer
                    if delay > 0:
                        dst.holdq.append(
                            (time.monotonic() + delay / 1000.0, data))
                        dst.held += len(data)
                        if len(dst.buf) + dst.held > BUF_MAX:
                            h.reading = False
                            update(h)
                    else:
                        deliver(dst, data)
            if mask & selectors.EVENT_WRITE and h.sock in halves:
                try:
                    if h.buf:
                        sent = h.sock.send(h.buf)
                        del h.buf[:sent]
                except BlockingIOError:
                    pass
                except OSError:
                    close_pair(h)
                    continue
                if (len(h.buf) + h.held <= BUF_MAX and h.peer is not None
                        and not h.peer.reading):
                    h.peer.reading = True
                    update(h.peer)
                update(h)


if __name__ == "__main__":
    sys.exit(main())
