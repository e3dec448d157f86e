"""Configuration system.

A single declarative property table, the same design as the reference's
``rd_kafka_properties`` table (src/rdkafka_conf.c:224): each property has a
scope (global/topic), type, range/enum, default, producer/consumer
applicability, and optional aliases. Docs are generated from the table
(``python -m librdkafka_tpu_torch.client.conf`` emits the table).

The port's copy of librdkafka_tpu/client/conf.py.  The codec offload
knobs live in the same table (SURVEY.md §5 "config"):
``compression.backend`` selects the codec provider (cpu|gpu), defaulting
to cpu, so the GPU path is strictly opt-in — the analog of gating through
the reference's plugin boundary (src/rdkafka_plugin.c).  ``"tpu"`` is
rejected like any other invalid value: the port carries no JAX provider.

Each ``tpu.*`` knob of the JAX package has a ``gpu.*`` twin with the same
type, default, range and meaning, with one exception:
``tpu.compile.cache.dir`` has no counterpart: there is no JIT cache —
the CUDA kernels are built once by nvcc into the (gitignored) build
directory and reused by every process.

``gpu.device`` (default ``cuda``) is the port's form of the JAX
package's platform choice (``JAX_PLATFORMS``): ``cpu`` runs the kernels'
plain PyTorch versions on the host, which is how the tests ask for it.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .errors import Err, KafkaException

# Scopes
GLOBAL, TOPIC = "global", "topic"
# Applicability
P, C, PC = "P", "C", "PC"   # producer / consumer / both


@dataclass
class Prop:
    name: str
    scope: str                 # GLOBAL or TOPIC
    ptype: str                 # "str" | "int" | "bool" | "enum" | "float" | "ptr" | "list"
    default: Any
    doc: str
    app: str = PC              # P, C or PC
    vmin: Optional[float] = None
    vmax: Optional[float] = None
    enum: Optional[tuple] = None
    alias: Optional[str] = None          # alias target property name
    # validator(coerced_value) -> error string, or None when valid;
    # runs at set() time so a bad value fails HERE with a clear error,
    # never at first use
    validator: Optional[Callable[[Any], Optional[str]]] = None
    deprecated: bool = False             # accepted no-op (reference
                                         # _RK_DEPRECATED rows)
    hidden: bool = False                 # excluded from generated docs
                                         # (reference _RK_HIDDEN rows)
    fallthrough: bool = False            # global row that writes the
                                         # same-name topic-scope knob
                                         # via the default topic conf


def _p(*args, **kw) -> Prop:
    return Prop(*args, **kw)


def _valid_gpu_device(v: Any) -> Optional[str]:
    """gpu.device: ``cuda``, ``cuda:N`` or ``cpu`` — checked at set()
    time so a typo fails here, not at the first launch."""
    s = str(v).strip()
    if s in ("cuda", "cpu") or re.fullmatch(r"cuda:\d+", s):
        return None
    return f"{s!r} is not one of cuda, cuda:N, cpu"


def _valid_ring_events(v) -> Optional[str]:
    """trace.ring.events: a power of two (the ring index wraps with a
    mask) within 64..4194304 — validated HERE so a bad capacity fails
    at set() time, not at the first recorded event."""
    try:
        n = int(str(v).strip())
    except ValueError:
        return f"expected an integer, got {v!r}"
    if n < 64 or n > (1 << 22):
        return f"{n} outside allowed range 64..{1 << 22}"
    if n & (n - 1):
        return f"{n} is not a power of two"
    return None


def _valid_transactional_id(v) -> Optional[str]:
    """transactional.id: empty (non-transactional) or a usable id —
    printable, and within the broker's 249-char resource-name bound, so
    a bad id fails at set() time instead of at init_transactions()."""
    s = str(v)
    if not s:
        return None
    if len(s) > 249:
        return f"id is {len(s)} chars; the broker bound is 249"
    if any(ord(c) < 0x20 or ord(c) == 0x7F for c in s):
        return "id contains control characters"
    return None


#: The declarative property table. Mirrors rdkafka_conf.c:224's table shape.
PROPERTIES: list[Prop] = [
    # ---- global: general ----
    _p("builtin.features", GLOBAL, "str",
       "gzip,snappy,lz4,zstd,ssl,sasl,regex,mocks,gpu-codec",
       "Indicates builtin features for this build."),
    _p("client.id", GLOBAL, "str", "rdkafka", "Client identifier."),
    _p("client.rack", GLOBAL, "str", "",
       "Rack identifier sent in Fetch v11+ (KIP-392): brokers may "
       "redirect this consumer to a same-rack follower replica."),
    _p("bootstrap.servers", GLOBAL, "str", "", "Initial list of brokers host:port,..."),
    _p("metadata.broker.list", GLOBAL, "str", "", "Alias for bootstrap.servers.",
       alias="bootstrap.servers"),
    _p("message.max.bytes", GLOBAL, "int", 1000000, "Maximum Kafka protocol request message size.",
       vmin=1000, vmax=1000000000),
    _p("message.copy.max.bytes", GLOBAL, "int", 65535,
       "Maximum size for message to be copied to buffer (larger are referenced).",
       vmin=0, vmax=1000000000),
    _p("receive.message.max.bytes", GLOBAL, "int", 100000000,
       "Maximum Kafka protocol response message size.", vmin=1000, vmax=2147483647),
    _p("max.in.flight.requests.per.connection", GLOBAL, "int", 1000000,
       "Maximum number of in-flight requests per broker connection.", vmin=1, vmax=1000000),
    _p("max.in.flight", GLOBAL, "int", 1000000, "Alias.",
       alias="max.in.flight.requests.per.connection"),
    _p("metadata.request.timeout.ms", GLOBAL, "int", 60000, "Non-topic request timeout.",
       vmin=10, vmax=900000),
    _p("topic.metadata.refresh.interval.ms", GLOBAL, "int", 300000,
       "Period of topic/broker metadata refresh; -1 disables.", vmin=-1, vmax=3600000),
    _p("metadata.max.age.ms", GLOBAL, "int", 900000,
       "Metadata cache max age.", vmin=1, vmax=86400000),
    _p("topic.metadata.refresh.fast.interval.ms", GLOBAL, "int", 250,
       "Refresh interval while leaders are unknown.", vmin=1, vmax=60000),
    _p("topic.metadata.refresh.sparse", GLOBAL, "bool", True,
       "Sparse metadata requests (only subscribed topics)."),
    _p("topic.metadata.interest.only", GLOBAL, "bool", True,
       "Interest-set metadata (beyond the reference): "
       "refreshes request only subscribed/produced topics with "
       "per-topic staleness — an empty interest set sends a "
       "brokers-only probe instead of a full sweep; full enumerations "
       "happen only for regex subscriptions, the periodic refresh and "
       "explicit all-topics requests. false restores the reference's "
       "empty-set full-sweep shape."),
    _p("topic.blacklist", GLOBAL, "list", "", "Topic blacklist regex list."),
    _p("debug", GLOBAL, "list", "",
       "Comma-separated debug contexts: generic,broker,topic,metadata,feature,queue,msg,"
       "protocol,cgrp,security,fetch,interceptor,plugin,consumer,admin,eos,mock,all"),
    _p("socket.timeout.ms", GLOBAL, "int", 60000, "Network request timeout.", vmin=10, vmax=300000),
    _p("socket.send.buffer.bytes", GLOBAL, "int", 0, "SO_SNDBUF; 0=system default.",
       vmin=0, vmax=100000000),
    _p("socket.receive.buffer.bytes", GLOBAL, "int", 0, "SO_RCVBUF; 0=system default.",
       vmin=0, vmax=100000000),
    _p("socket.keepalive.enable", GLOBAL, "bool", False, "Enable TCP keep-alive."),
    _p("socket.nagle.disable", GLOBAL, "bool", False, "Disable Nagle (TCP_NODELAY)."),
    _p("socket.max.fails", GLOBAL, "int", 1,
       "Disconnect broker after this many send failures.", vmin=0, vmax=1000000),
    _p("broker.address.ttl", GLOBAL, "int", 1000, "DNS resolve cache ttl ms.", vmin=0, vmax=86400000),
    _p("broker.address.family", GLOBAL, "enum", "any", "Address family.",
       enum=("any", "v4", "v6")),
    _p("reconnect.backoff.jitter.ms", GLOBAL, "int", 0,
       "No longer used: a fixed -25%..+50% jitter is applied to every "
       "reconnect backoff (see reconnect.backoff.ms / "
       "reconnect.backoff.max.ms). Accepted for conf compatibility "
       "(reference deprecates it the same way, rdkafka_conf.c:437).",
       vmin=0, vmax=3600000, deprecated=True),
    _p("reconnect.backoff.ms", GLOBAL, "int", 100,
       "Initial reconnect backoff; doubled per failure up to "
       "reconnect.backoff.max.ms, with -25%..+50% jitter per attempt.",
       vmin=0, vmax=3600000),
    _p("reconnect.backoff.max.ms", GLOBAL, "int", 10000, "Max reconnect backoff.",
       vmin=0, vmax=3600000),
    _p("statistics.interval.ms", GLOBAL, "int", 0,
       "Statistics emit interval; 0 disables.", vmin=0, vmax=86400000),
    _p("log_level", GLOBAL, "int", 6, "Max syslog level.", vmin=0, vmax=7),
    _p("log.queue", GLOBAL, "bool", False, "Forward logs to queue instead of stderr."),
    _p("log.thread.name", GLOBAL, "bool", True, "Print thread name in logs."),
    _p("log.connection.close", GLOBAL, "bool", True, "Log broker disconnects."),
    _p("internal.termination.signal", GLOBAL, "int", 0, "Unused (signal shim).", vmin=0, vmax=128),
    _p("api.version.request", GLOBAL, "bool", True,
       "Request broker supported api versions (ApiVersionRequest)."),
    _p("api.version.request.timeout.ms", GLOBAL, "int", 10000, "", vmin=1, vmax=300000),
    _p("api.version.fallback.ms", GLOBAL, "int", 0,
       "How long to use broker.version.fallback after ApiVersion failure.",
       vmin=0, vmax=604800000),
    _p("broker.version.fallback", GLOBAL, "str", "0.10.0",
       "Assumed broker version when ApiVersionRequest unsupported."),
    # ---- global: security ----
    _p("security.protocol", GLOBAL, "enum", "plaintext", "Protocol to talk to brokers.",
       enum=("plaintext", "ssl", "sasl_plaintext", "sasl_ssl")),
    _p("ssl.cipher.suites", GLOBAL, "str", "", "Cipher suites."),
    _p("ssl.curves.list", GLOBAL, "str", "",
       "Colon-separated supported curves/groups in preference order "
       "(OpenSSL SSL_CTX_set1_groups_list; reference rdkafka_conf.c "
       "ssl.curves.list)."),
    _p("ssl.sigalgs.list", GLOBAL, "str", "",
       "Colon-separated signature algorithms in preference order "
       "(OpenSSL SSL_CTX_set1_sigalgs_list)."),
    _p("ssl.key.location", GLOBAL, "str", "", "Client private key path (PEM)."),
    _p("ssl.key.password", GLOBAL, "str", "", "Key passphrase."),
    _p("ssl.key.pem", GLOBAL, "str", "",
       "Client private key as a PEM string (in-memory alternative to "
       "ssl.key.location; reference ssl.key.pem)."),
    _p("ssl_key", GLOBAL, "ptr", None,
       "Client private key as in-memory PEM/DER bytes (the "
       "rd_kafka_conf_set_ssl_cert analog)."),
    _p("ssl.certificate.location", GLOBAL, "str", "", "Client cert path (PEM)."),
    _p("ssl.certificate.pem", GLOBAL, "str", "",
       "Client certificate as a PEM string (in-memory alternative to "
       "ssl.certificate.location)."),
    _p("ssl_certificate", GLOBAL, "ptr", None,
       "Client certificate as in-memory PEM/DER bytes."),
    _p("ssl.ca.location", GLOBAL, "str", "", "CA bundle path."),
    _p("ssl_ca", GLOBAL, "ptr", None,
       "CA certificate(s) as in-memory PEM/DER bytes."),
    _p("ssl.crl.location", GLOBAL, "str", "",
       "CRL file for broker certificate revocation checking."),
    _p("ssl.keystore.location", GLOBAL, "str", "", "PKCS#12 keystore path."),
    _p("ssl.keystore.password", GLOBAL, "str", "", "Keystore password."),
    _p("enable.ssl.certificate.verification", GLOBAL, "bool", True, "Verify broker cert."),
    _p("ssl.endpoint.identification.algorithm", GLOBAL, "enum", "none",
       "Endpoint identification.", enum=("none", "https")),
    _p("ssl.certificate.verify_cb", GLOBAL, "ptr", None,
       "Certificate verification callback: cb(broker_name, broker_id, "
       "depth, der_bytes, openssl_ok) -> bool; returning False rejects "
       "the connection (reference ssl.certificate.verify_cb)."),
    _p("open_cb", GLOBAL, "ptr", None,
       "File-open hook: cb(path, os_flags) -> OS fd or file object; "
       "used by the file offset store (reference open_cb opens files "
       "with CLOEXEC)."),
    _p("closesocket_cb", GLOBAL, "ptr", None,
       "Socket-close hook: cb(socket) called before every broker "
       "socket close (pairs with connect_cb; reference closesocket_cb)."),
    _p("sasl.mechanisms", GLOBAL, "str", "GSSAPI",
       "SASL mechanism: GSSAPI, PLAIN, SCRAM-SHA-256, SCRAM-SHA-512, OAUTHBEARER."),
    _p("sasl.mechanism", GLOBAL, "str", "GSSAPI", "Alias.", alias="sasl.mechanisms"),
    _p("sasl.username", GLOBAL, "str", "", "SASL username (PLAIN/SCRAM)."),
    _p("sasl.password", GLOBAL, "str", "", "SASL password (PLAIN/SCRAM)."),
    _p("sasl.oauthbearer.config", GLOBAL, "str", "", "OAUTHBEARER unsecured token config."),
    _p("enable.sasl.oauthbearer.unsecure.jwt", GLOBAL, "bool", False,
       "Enable builtin unsecured JWT handler."),
    _p("sasl.kerberos.service.name", GLOBAL, "str", "kafka", "Kerberos service name."),
    _p("sasl.kerberos.principal", GLOBAL, "str", "kafkaclient", "Client principal."),
    _p("sasl.kerberos.kinit.cmd", GLOBAL, "str",
       'kinit -R -t "%{sasl.kerberos.keytab}" -k %{sasl.kerberos.principal}'
       ' || kinit -t "%{sasl.kerberos.keytab}" -k'
       ' %{sasl.kerberos.principal}',
       "Shell command refreshing/acquiring the client's Kerberos ticket; "
       "run at client creation and every "
       "sasl.kerberos.min.time.before.relogin ms. %{prop} expands to "
       "config values."),
    _p("sasl.kerberos.keytab", GLOBAL, "str", "",
       "Kerberos keytab path (used via %{sasl.kerberos.keytab} in "
       "sasl.kerberos.kinit.cmd)."),
    _p("sasl.kerberos.min.time.before.relogin", GLOBAL, "int", 60000,
       "Minimum ms between Kerberos ticket refreshes; 0 disables.",
       vmin=0, vmax=86400000),
    # ---- global: plugins/interceptors ----
    _p("plugin.library.paths", GLOBAL, "str", "",
       "List of plugin libraries/modules to load (module:... python entry points)."),
    _p("interceptors", GLOBAL, "ptr", None, "Interceptors added through the API."),
    # ---- global: consumer group ----
    _p("group.id", GLOBAL, "str", "", "Consumer group id.", app=C),
    _p("group.instance.id", GLOBAL, "str", "",
       "Static membership instance id.", app=C),
    _p("partition.assignment.strategy", GLOBAL, "str", "range,roundrobin",
       "Assignor names in preference order: range, roundrobin (EAGER "
       "protocol) and cooperative-sticky (KIP-429 COOPERATIVE "
       "incremental rebalancing). The broker picks the first strategy "
       "every group member supports, so a group mixing cooperative and "
       "eager-only members downgrades to the common eager assignor; "
       "list an eager fallback after cooperative-sticky for rolling "
       "upgrades.", app=C),
    _p("session.timeout.ms", GLOBAL, "int", 10000, "Group session timeout.", app=C,
       vmin=1, vmax=3600000),
    _p("heartbeat.interval.ms", GLOBAL, "int", 3000, "Group heartbeat interval.", app=C,
       vmin=1, vmax=3600000),
    _p("group.protocol.type", GLOBAL, "str", "consumer", "Group protocol type.", app=C),
    _p("coordinator.query.interval.ms", GLOBAL, "int", 600000,
       "Coordinator re-query interval.", app=C, vmin=1, vmax=3600000),
    _p("max.poll.interval.ms", GLOBAL, "int", 300000,
       "Max time between polls before leaving the group.", app=C, vmin=1, vmax=86400000),
    _p("enable.auto.commit", GLOBAL, "bool", True, "Auto offset commit.", app=C),
    _p("auto.commit.interval.ms", GLOBAL, "int", 5000,
       "Auto commit interval.", app=C, vmin=0, vmax=86400000),
    _p("enable.auto.offset.store", GLOBAL, "bool", True,
       "Auto-store offset of last consumed message.", app=C),
    _p("queued.min.messages", GLOBAL, "int", 100000,
       "Min messages to keep in local fetch queue.", app=C, vmin=1, vmax=10000000),
    _p("queued.max.messages.kbytes", GLOBAL, "int", 1048576,
       "Max kbytes in local fetch queue.", app=C, vmin=1, vmax=2097151),
    _p("fetch.wait.max.ms", GLOBAL, "int", 100, "Fetch max wait.", app=C, vmin=0, vmax=300000),
    _p("fetch.message.max.bytes", GLOBAL, "int", 1048576,
       "Initial max bytes per topic+partition to fetch.", app=C, vmin=1, vmax=1000000000),
    _p("max.partition.fetch.bytes", GLOBAL, "int", 1048576, "Alias.", app=C,
       alias="fetch.message.max.bytes"),
    _p("fetch.max.bytes", GLOBAL, "int", 52428800, "Max bytes per fetch request.", app=C,
       vmin=0, vmax=2147483135),
    _p("fetch.num.inflight", GLOBAL, "int", 4,
       "Max outstanding FetchRequests per broker, over disjoint "
       "partition sets (the reference keeps the fetch pipe full instead "
       "of serializing one Fetch per round trip, rdkafka_broker.c:4279).",
       app=C, vmin=1, vmax=64),
    _p("fetch.min.bytes", GLOBAL, "int", 1, "Min bytes broker should accumulate.", app=C,
       vmin=1, vmax=100000000),
    _p("fetch.error.backoff.ms", GLOBAL, "int", 500, "Backoff on fetch error.", app=C,
       vmin=0, vmax=300000),
    _p("fetch.session.enable", GLOBAL, "bool", True,
       "KIP-227 incremental fetch sessions (beyond the "
       "reference): negotiate a per-broker session on Fetch v7+ and "
       "send only changed partitions per request (removals ride "
       "forgotten_topics); steady state is an O(1)-byte request for "
       "any partition count. Session errors fall back to a full fetch "
       "and renegotiate. false restores sessionless full fetches.",
       app=C),
    _p("isolation.level", GLOBAL, "enum", "read_committed",
       "Transactional read isolation.", app=C, enum=("read_uncommitted", "read_committed")),
    _p("enable.partition.eof", GLOBAL, "bool", False,
       "Emit PARTITION_EOF event at end of partition.", app=C),
    _p("check.crcs", GLOBAL, "bool", False, "Verify CRC32C of consumed messages.", app=C),
    _p("allow.auto.create.topics", GLOBAL, "bool", False,
       "Allow broker auto topic creation on metadata.", app=C),
    # ---- global: producer ----
    _p("enable.idempotence", GLOBAL, "bool", False,
       "Exactly-once-ish producer: no dupes, no reordering (EOS v1).", app=P),
    _p("transactional.id", GLOBAL, "str", "",
       "Enables the transactional producer: a stable id identifying the "
       "same producer instance across restarts, used by the transaction "
       "coordinator to fence zombie instances (a newer init_transactions "
       "with the same id bumps the epoch; the older instance fails "
       "fatally with PRODUCER_FENCED). Setting it implies "
       "enable.idempotence; produce() is only allowed inside "
       "begin_transaction()..commit/abort_transaction(). Validated at "
       "set() time.", app=P, validator=_valid_transactional_id),
    _p("transaction.timeout.ms", GLOBAL, "int", 60000,
       "Maximum time the transaction coordinator waits for a transaction "
       "status update from this producer before proactively aborting the "
       "ongoing transaction. Sent in InitProducerId; also bounds the "
       "default timeout of the blocking transaction APIs.",
       app=P, vmin=1000, vmax=2147483647),
    _p("enable.gapless.guarantee", GLOBAL, "bool", False,
       "Fatal error if a message could create a sequence gap.", app=P),
    _p("queue.buffering.max.messages", GLOBAL, "int", 100000,
       "Max messages on producer queues.", app=P, vmin=1, vmax=10000000),
    _p("queue.buffering.max.kbytes", GLOBAL, "int", 1048576,
       "Max kbytes on producer queues.", app=P, vmin=1, vmax=2147483647),
    _p("queue.buffering.max.ms", GLOBAL, "float", 0.5,
       "Linger: delay before building MessageSets.", app=P, vmin=0, vmax=900000),
    _p("linger.ms", GLOBAL, "float", 0.5, "Alias.", app=P, alias="queue.buffering.max.ms"),
    _p("message.send.max.retries", GLOBAL, "int", 2, "Send retries.", app=P, vmin=0, vmax=10000000),
    _p("retries", GLOBAL, "int", 2, "Alias.", app=P, alias="message.send.max.retries"),
    _p("retry.backoff.ms", GLOBAL, "int", 100, "Retry backoff.", app=P, vmin=1, vmax=300000),
    _p("queue.buffering.backpressure.threshold", GLOBAL, "int", 1,
       "Backpressure threshold on outstanding requests.", app=P, vmin=1, vmax=1000000),
    _p("compression.codec", GLOBAL, "enum", "none",
       "Message compression codec.", app=P,
       enum=("none", "gzip", "snappy", "lz4", "zstd")),
    _p("compression.type", GLOBAL, "enum", "none", "Alias.", app=P,
       enum=("none", "gzip", "snappy", "lz4", "zstd"), alias="compression.codec"),
    _p("batch.num.messages", GLOBAL, "int", 10000,
       "Max messages per MessageSet.", app=P, vmin=1, vmax=1000000),
    _p("delivery.report.only.error", GLOBAL, "bool", False,
       "Only failed DRs.", app=P),
    _p("dr_cb", GLOBAL, "ptr", None, "Delivery report callback.", app=P),
    _p("dr_msg_cb", GLOBAL, "ptr", None, "Per-message delivery report callback.", app=P),
    _p("dr_batch_cb", GLOBAL, "ptr", None,
       "Batched delivery-report callback: called ONCE per delivered "
       "batch with the list of Messages (each carries .error). The "
       "rd_kafka_event_DR message-array idea (rdkafka_event.c:33) as a "
       "direct callback — per-message Python dispatch halves the "
       "produce rate at high throughput.", app=P),
    _p("consume_cb", GLOBAL, "ptr", None,
       "Message consume callback for callback-based consumption "
       "(Consumer.consume_callback; reference rd_kafka_consume_callback).",
       app=C),
    _p("consume.callback.max.messages", GLOBAL, "int", 0,
       "Maximum number of messages dispatched per consume_callback "
       "call (0 = unlimited).", vmin=0, vmax=1000000, app=C),
    # ---- GPU codec offload knobs (SURVEY.md §5 config section) ----
    _p("compression.backend", GLOBAL, "enum", "cpu",
       "Codec provider for MessageSet compression + CRC32C: 'cpu' uses the "
       "native C++ path, 'gpu' offloads batched CRC32C (and, with "
       "gpu.compress.device, lz4) to hand-written CUDA kernels "
       "(bit-identical wire bytes).", app=PC, enum=("cpu", "gpu")),
    _p("gpu.device", GLOBAL, "str", "cuda",
       "Device of the gpu codec provider: 'cuda' (the first visible "
       "card; one engine lane per visible card), 'cuda:N', or 'cpu' "
       "(the kernels' plain PyTorch versions on the host). A host "
       "without CUDA raises when the client is created unless 'cpu' "
       "is asked for. No effect with compression.backend=cpu.",
       validator=_valid_gpu_device),
    _p("gpu.launch.min.batches", GLOBAL, "int", 4,
       "Min partition batches to coalesce into one GPU launch (launch quorum); "
       "fewer than this falls back to the CPU provider.", vmin=1, vmax=4096),
    _p("codec.pipeline.depth", GLOBAL, "int", 2,
       "Max codec launches in flight per broker; 0 = compress inline on "
       "the broker thread (pipeline overlap of batch build vs codec).",
       vmin=0, vmax=64, app=P),
    _p("gpu.mesh.devices", GLOBAL, "int", 0,
       "Number of devices the async offload engine spreads its "
       "per-device CRC dispatch lanes over (0 = every device of the "
       "pool, 1 = single-lane; the pool is the visible cards with "
       "gpu.device=cuda, eight lanes of the plain version with "
       "gpu.device=cpu): each lane gets its own stream, staging rings "
       "and in-flight launch tracking, whole launch groups route to the "
       "least-loaded lane, and groups of at least 8 64KB blocks a lane "
       "split across every lane, one shard a card (parallel/mesh.py) — "
       "wire bytes bit-identical on every route. Also shards the DEVICE "
       "lz4 encoder's block compression when gpu.lz4.force=true. No "
       "effect with compression.backend=cpu.",
       vmin=0, vmax=8192),
    _p("gpu.transport.min.mb.s", GLOBAL, "int", 100,
       "Adaptive offload gate: minimum measured host<->device bandwidth "
       "(MB/s, probed once in a subprocess) for CRC32C launches to leave "
       "the host. Below it every launch costs more in transfer than the "
       "whole CPU checksum, so the provider self-routes to CPU. "
       "0 disables the gate.", vmin=0, vmax=1_000_000),
    _p("gpu.pipeline.depth", GLOBAL, "int", 2,
       "Async offload engine (ops/engine.py): max device launches kept "
       "in flight by the dedicated dispatch thread (double buffering — "
       "the codec worker frames batch k while batch k+1 executes on the "
       "device). 0 disables the engine: every provider call dispatches "
       "synchronously. No effect with compression.backend=cpu.",
       vmin=0, vmax=8),
    _p("gpu.pipeline.fanin.us", GLOBAL, "int", 500,
       "Async offload engine: bounded fan-in window (microseconds) a "
       "below-quorum async CRC submission waits for other brokers' "
       "batches to merge into one launch (cross-broker micro-batch "
       "aggregation), so gpu.launch.min.batches is met at high toppar "
       "counts instead of falling back to the CPU provider. 0 "
       "dispatches immediately. With gpu.governor=true this is the CAP "
       "of the adaptive window (sized from the observed submission "
       "inter-arrival EWMA — low-rate traffic skips the wait "
       "entirely). No effect with compression.backend=cpu.",
       vmin=0, vmax=100_000),
    _p("gpu.governor", GLOBAL, "bool", True,
       "Adaptive offload governor (ops/engine.py): online cost-model "
       "CPU/GPU routing of at-quorum CRC launch groups (EWMA of "
       "per-bucket device launch time vs observed CPU-provider "
       "ns/byte, with periodic exploration launches so the model "
       "tracks host drift), adaptive fan-in window sizing, and fused "
       "multi-polynomial launches (crc32c + legacy crc32 in one "
       "launch with a per-segment polynomial). false restores the static "
       "policy: always-device above gpu.launch.min.batches, fixed "
       "fan-in window, per-polynomial launches. gpu.launch.min.batches "
       "remains a hard floor either way; wire bytes are bit-identical "
       "on every route. No effect with compression.backend=cpu."),
    _p("gpu.warmup", GLOBAL, "bool", True,
       "Background kernel warmup: a low-priority engine thread builds "
       "the CUDA kernels (nvcc at first use) and makes one warm launch "
       "for both polynomials at engine start; until a lane is warm its "
       "launches are served by the CPU provider (bit-identical), so a "
       "kernel build never stalls a hot-path launch. false: the "
       "dispatch thread builds inline on first use. No effect with "
       "compression.backend=cpu."),
    _p("gpu.fetch.pipeline.depth", GLOBAL, "int", 4,
       "Consumer fetch codec pipeline: max fetch partitions per broker "
       "whose CRC-verify/decompress offload tickets may be in flight "
       "before the serve loop blocks on the oldest (the consumer-side "
       "mirror of gpu.pipeline.depth — that knob still sizes the device "
       "engine's launch depth; this one bounds how many partitions may "
       "be decompressed ahead of the queued.max.messages.kbytes "
       "accounting). With compression.backend=cpu tickets resolve "
       "eagerly, so the depth has no effect there.", vmin=1, vmax=64,
       app=C),
    _p("gpu.lz4.force", GLOBAL, "bool", False,
       "Route lz4 block compression to the device encoder "
       "(csrc/lz4_rows.cu) on the synchronous compress path, every 64KB "
       "block of a round in one launch. Default off: backend=gpu runs "
       "lz4 on CPU and only CRC32C on the card unless "
       "gpu.compress.device opens the engine's compress route.",
       app=P),
    _p("gpu.compress.device", GLOBAL, "bool", False,
       "Producer lz4 device-compression route: batch 64KB blocks into "
       "the engine's staging rings and run the LZ4 kernel with its "
       "fused CRC32C epilogue — one launch and one readback per round "
       "yields the LZ4F frames AND the CRCs of their parts (the host "
       "folds the MessageSet v2 batch CRC with crc32c_combine, never "
       "re-scanning the frame bytes). Wire bytes are bit-identical to "
       "the deterministic CPU encoder on every route: the governor's "
       "cost model may still send any group to that encoder, and "
       "warmup misses are served there too. Off (default): lz4 "
       "compresses on the native CPU fast path as an engine host job. "
       "Non-lz4 codecs and consumer decompress always stay host-side. "
       "No effect with compression.backend=cpu.", app=P),
    # ---- flight-recorder tracing (obs/trace.py; TRACING.md) ----
    _p("trace.enable", GLOBAL, "bool", False,
       "Flight-recorder event tracing (obs/trace.py): per-thread ring "
       "buffers record spans across the whole offload pipeline — "
       "produce() enqueue, batch assembly, compress/CRC tickets, the "
       "engine's fan-in/launch/readback, ProduceRequest tx and ack, and "
       "the consumer fetch mirror (CRC verify, decompress, deliver) — "
       "with governor route decisions attached as span args. Export "
       "with Kafka.trace_dump(path) as Chrome trace-event JSON "
       "(Perfetto / chrome://tracing / scripts/traceview.py). Disabled, "
       "every hook costs one attribute check (bench.py --smoke gates "
       "the overhead at < 2% of the produce budget)."),
    _p("trace.ring.events", GLOBAL, "int", 8192,
       "Per-thread trace ring capacity in events; a power of two "
       "(validated at set() time). Each ring keeps the LAST this-many "
       "events of its thread — sizing bounds both memory and how far "
       "back a flight-recorder dump can see.",
       vmin=64, vmax=4194304, validator=_valid_ring_events),
    _p("trace.dump.on.fatal", GLOBAL, "bool", True,
       "Flight-recorder mode: with tracing enabled, auto-dump the last "
       "trace.ring.events events per thread to a JSON file on fatal "
       "error, CRC mismatch, or request timeout (bounded dumps per "
       "process; see TRACING.md for the dump location and format)."),
    # ---- concurrency analysis (analysis/lockdep.py; ANALYSIS.md) ----
    _p("analysis.lockdep", GLOBAL, "bool", False,
       "Run this client under the lockdep lock-order checker "
       "(analysis/lockdep.py): every Lock/RLock/Condition the client "
       "creates is instrumented, feeding the global lock-order graph "
       "(AB/BA inversions, cycles, locks held across blocking calls). "
       "Inspect with analysis.lockdep.report(). Debug/CI tool — "
       "instrumented acquisitions cost a few microseconds; disabled "
       "(default) the factory returns plain threading primitives and "
       "the hot path pays nothing (bench.py --smoke gates this at "
       "< 1% of the produce budget)."),
    _p("analysis.races", GLOBAL, "bool", False,
       "Run this client under the Eraser-style lockset data-race "
       "detector (analysis/races.py; implies the lockdep checker — "
       "locksets come from its held-stack): every declared shared "
       "field access refines a candidate lockset, and an empty-lockset "
       "write is reported with both access stacks. Inspect with "
       "analysis.races.report(). Debug/CI tool — disabled (default) "
       "the shared() declarations resolve to plain attributes and the "
       "hot path pays nothing (bench.py --smoke races_overhead gate, "
       "< 1% of the produce budget)."),
    # ---- callbacks / opaque ----
    _p("error_cb", GLOBAL, "ptr", None, "Error callback."),
    _p("throttle_cb", GLOBAL, "ptr", None, "Throttle callback."),
    _p("stats_cb", GLOBAL, "ptr", None, "Statistics callback."),
    _p("background_event_cb", GLOBAL, "ptr", None,
       "Background event callback: events are served from a dedicated "
       "background thread instead of poll() (rdkafka_background.c)."),
    _p("enabled_events", GLOBAL, "list", "",
       "Event types to generate for queue_poll()/background consumption "
       "(rd_kafka_conf_set_events analog): dr, error, log, stats."),
    _p("log_cb", GLOBAL, "ptr", None, "Log callback."),
    _p("oauthbearer_token_refresh_cb", GLOBAL, "ptr", None, "OAUTHBEARER refresh callback."),
    _p("socket_cb", GLOBAL, "ptr", None, "Socket creation callback (sockem hook)."),
    _p("connect_cb", GLOBAL, "ptr", None, "Socket connect callback (sockem hook)."),
    _p("rebalance_cb", GLOBAL, "ptr", None, "Rebalance callback.", app=C),
    _p("offset_commit_cb", GLOBAL, "ptr", None, "Offset commit result callback.", app=C),
    _p("opaque", GLOBAL, "ptr", None, "Application opaque."),
    _p("default_topic_conf", GLOBAL, "ptr", None, "Default topic config object."),
    # ---- test / mock ----
    _p("test.mock.num.brokers", GLOBAL, "int", 0,
       "Create an in-process mock cluster with this many brokers "
       "(reference: rdkafka_mock.c via rdkafka_conf.c).", vmin=0, vmax=10000),
    _p("test.mock.default.partitions", GLOBAL, "int", 4,
       "Partition count for topics auto-created by the mock cluster.",
       vmin=1, vmax=10000),

    # ---- topic scope ----
    _p("request.required.acks", TOPIC, "int", -1,
       "Required acks: -1=all ISR, 0=none, 1=leader.", app=P, vmin=-1, vmax=1000),
    _p("acks", TOPIC, "int", -1, "Alias.", app=P, alias="request.required.acks"),
    _p("request.timeout.ms", TOPIC, "int", 5000,
       "Ack timeout of produce request.", app=P, vmin=1, vmax=900000),
    _p("message.timeout.ms", TOPIC, "int", 300000,
       "Local message delivery timeout; 0=infinite.", app=P, vmin=0, vmax=2147483647),
    _p("delivery.timeout.ms", TOPIC, "int", 300000, "Alias.", app=P,
       alias="message.timeout.ms"),
    _p("partitioner", TOPIC, "enum", "consistent_random",
       "Partitioner: random, consistent, consistent_random, murmur2, murmur2_random.",
       app=P, enum=("random", "consistent", "consistent_random", "murmur2",
                    "murmur2_random")),
    _p("partitioner_cb", TOPIC, "ptr", None, "Custom partitioner callback.", app=P),
    _p("compression.level", TOPIC, "int", -1,
       "Codec-specific compression level.", app=P, vmin=-1, vmax=12),
    _p("auto.offset.reset", TOPIC, "enum", "largest",
       "Offset reset policy when no committed offset.", app=C,
       enum=("smallest", "earliest", "beginning", "largest", "latest", "end", "error")),
    _p("offset.store.method", TOPIC, "enum", "broker",
       "Offset commit store method; none = offsets are not stored.",
       app=C, enum=("none", "file", "broker")),
    _p("offset.store.path", TOPIC, "str", ".",
       "Path to local offset file store (legacy).", app=C),
    _p("offset.store.sync.interval.ms", TOPIC, "int", -1,
       "fsync interval for file store.", app=C, vmin=-1, vmax=86400000),

    # ---- reference-parity tail (rdkafka_conf.c rows) ----
    # Deprecated no-ops the reference still accepts (_RK_DEPRECATED):
    _p("socket.blocking.max.ms", GLOBAL, "int", 1000,
       "No longer used.", vmin=1, vmax=60000, deprecated=True),
    _p("topic.metadata.refresh.fast.cnt", GLOBAL, "int", 10,
       "No longer used.", vmin=0, vmax=1000, deprecated=True),
    _p("offset.store.method", GLOBAL, "enum", "broker",
       "Offset commit store method (deprecated at global scope; routes "
       "to the topic property).", app=C, enum=("none", "file", "broker"),
       deprecated=True, fallthrough=True),
    _p("produce.offset.report", TOPIC, "bool", False,
       "No longer used.", app=P, deprecated=True),
    _p("queuing.strategy", TOPIC, "enum", "fifo",
       "Producer queuing strategy (EXPERIMENTAL, deprecated in the "
       "reference; only FIFO preserves produce ordering).", app=P,
       enum=("fifo", "lifo"), deprecated=True),
    _p("msg_order_cmp", TOPIC, "ptr", None,
       "Message queue ordering comparator (deprecated, see "
       "queuing.strategy).", app=P, deprecated=True),
    _p("auto.commit.enable", TOPIC, "bool", True,
       "Legacy simple-consumer topic-scope auto commit (deprecated; use "
       "the global enable.auto.commit).", app=C, deprecated=True),
    _p("enable.auto.commit", TOPIC, "bool", True, "Alias.", app=C,
       alias="auto.commit.enable", deprecated=True),
    _p("auto.commit.interval.ms", TOPIC, "int", 60000,
       "Legacy simple-consumer topic-scope commit interval (deprecated).",
       app=C, vmin=10, vmax=86400000, deprecated=True),
    # Java-client guidance rows (_RK_C_INVALID): setting them fails with
    # a pointer at the right property (rdkafka_conf.c:715-729)
    _p("ssl.truststore.location", GLOBAL, "invalid", None,
       "Java TrustStores are not supported, use `ssl.ca.location` and a "
       "certificate file instead."),
    _p("sasl.jaas.config", GLOBAL, "invalid", None,
       "Java JAAS configuration is not supported, see sasl.mechanisms / "
       "sasl.username / sasl.password and the sasl.* properties instead."),
    # Hidden rows (_RK_HIDDEN: functional, excluded from generated docs)
    _p("enable.sparse.connections", GLOBAL, "bool", True,
       "Only connect to brokers the client needs to talk to (bootstrap "
       "brokers and brokers with led partitions or queued requests); "
       "when disabled, connect to every discovered broker.", hidden=True),
    _p("ut_handle_ProduceResponse", GLOBAL, "ptr", None,
       "Unit-test interceptor for ProduceResponse handling: "
       "fn(broker_id, base_msgid, err) -> err-or-None override.",
       hidden=True),
    # Per-topic codec override (reference topic-scope compression.codec,
    # rdkafka_conf.c:1360: 'inherit' falls through to the global row)
    _p("compression.codec", TOPIC, "enum", "inherit",
       "Compression codec for this topic; inherit = use the global "
       "compression.codec.", app=P,
       enum=("none", "gzip", "snappy", "lz4", "zstd", "inherit")),
    _p("compression.type", TOPIC, "enum", "inherit", "Alias.", app=P,
       enum=("none", "gzip", "snappy", "lz4", "zstd", "inherit"),
       alias="compression.codec"),
    _p("topic.qos.weight", TOPIC, "float", 1.0,
       "Per-topic quality-of-service weight for the offload engine's "
       "governor (compression.backend=gpu with the device compress "
       "route): weighted fan-in admission — a high-weight topic's "
       "submissions shrink the fan-in window so latency-sensitive "
       "batches launch sooner — weight-ordered host-job dispatch, and "
       "shed-based isolation: when every lane is saturated, topics "
       "whose recent byte share exceeds 1.5x their weight share are "
       "served on the bit-identical CPU encoder instead of queueing "
       "ahead of higher-weight work. 1.0 (default) = neutral; > 1 "
       "prioritizes, < 1 marks bulk/background traffic. Per-topic "
       "routed/shed counts surface in statistics "
       "(codec_engine.compress.qos). No effect with "
       "compression.backend=cpu.", vmin=0.001, vmax=1000.0, app=P),
    _p("opaque", TOPIC, "ptr", None,
       "Per-topic application opaque (rd_kafka_topic_conf_set_opaque)."),
    _p("consume.callback.max.messages", TOPIC, "int", 0,
       "Maximum number of messages dispatched per consume_callback call "
       "(0 = unlimited; topic-scope row mirrors the reference, the global "
       "row is this tree's addition).", vmin=0, vmax=1000000, app=C),
]

#: Rows this tree adds over the reference's 154-row table
#: (rdkafka_conf.c:224). Everything in the reference table exists here
#: too (test_0110 asserts the union both ways against the reference
#: source); these are the intentional extras — the GPU codec-offload
#: knobs plus three client conveniences.
GPU_ADDITIONS = frozenset({
    (GLOBAL, "compression.backend"),
    (GLOBAL, "gpu.device"),
    (GLOBAL, "gpu.launch.min.batches"),
    (GLOBAL, "gpu.lz4.force"),
    (GLOBAL, "gpu.mesh.devices"),
    (GLOBAL, "gpu.transport.min.mb.s"),
    (GLOBAL, "gpu.pipeline.depth"),
    (GLOBAL, "gpu.pipeline.fanin.us"),
    (GLOBAL, "gpu.fetch.pipeline.depth"),
    (GLOBAL, "gpu.governor"),
    (GLOBAL, "gpu.warmup"),
    (GLOBAL, "gpu.compress.device"),
    (TOPIC, "topic.qos.weight"),
    (GLOBAL, "codec.pipeline.depth"),
    (GLOBAL, "allow.auto.create.topics"),       # KIP-361 (post-1.3.0)
    (GLOBAL, "consume.callback.max.messages"),  # global mirror of the
                                                # reference's topic row
    (GLOBAL, "fetch.num.inflight"),             # fetch pipelining depth
    (GLOBAL, "dr_batch_cb"),                    # batched DR callback
    (GLOBAL, "test.mock.default.partitions"),   # mock-cluster knob
    # transactional producer (librdkafka grows these in 1.4; the
    # 1.3.0 reference table stops at the idempotent producer)
    (GLOBAL, "transactional.id"),
    (GLOBAL, "transaction.timeout.ms"),
    # flight-recorder tracing (no reference analog — the
    # reference's nearest is the debug-context log stream, rdlog.c)
    (GLOBAL, "trace.enable"),
    (GLOBAL, "trace.ring.events"),
    (GLOBAL, "trace.dump.on.fatal"),
    # concurrency analysis (lockdep, lockset races;
    # the reference's analog is
    # build-time helgrind/TSAN CI, not a conf row)
    (GLOBAL, "analysis.lockdep"),
    (GLOBAL, "analysis.races"),
})

# Scope-keyed lookup: the reference's table has rows of the same name in
# both scopes (compression.codec, opaque, offset.store.method, ...)
_BY_NAME: dict[tuple, Prop] = {}
for prop in PROPERTIES:
    assert (prop.scope, prop.name) not in _BY_NAME, prop.name
    _BY_NAME[(prop.scope, prop.name)] = prop

_TRUE = {"true", "t", "1", "yes", "on"}
_FALSE = {"false", "f", "0", "no", "off"}


class _ConfBase:
    """Shared get/set machinery for global and topic config."""

    _scope = GLOBAL

    def __init__(self, initial: Optional[dict] = None):
        self._values: dict[str, Any] = {}
        self._explicit: set[str] = set()
        if initial:
            for k, v in initial.items():
                self.set(k, v)

    # -- core API (reference: rd_kafka_conf_set, rdkafka_conf.c) --
    def set(self, name: str, value: Any) -> None:
        prop = _BY_NAME.get((self._scope, name))
        if prop is None:
            raise KafkaException(Err._INVALID_ARG,
                                 f"No such {self._scope} configuration property: {name!r}")
        if prop.ptype == "invalid":
            # reference _RK_C_INVALID rows: fail with guidance
            raise KafkaException(Err._INVALID_ARG,
                                 f"{name!r}: {prop.doc}")
        if prop.alias:
            return self.set(prop.alias, value)
        val = self._coerce(prop, value)
        if prop.validator is not None:
            err = prop.validator(val)
            if err is not None:
                raise KafkaException(
                    Err._INVALID_ARG,
                    f"Configuration property {prop.name!r}: {err}")
        self._values[prop.name] = val
        self._explicit.add(prop.name)
        # mutation counter + listeners: cached eligibility decisions
        # (e.g. the produce fast lane keyed on dr callbacks) revalidate
        # on change
        self.version = getattr(self, "version", 0) + 1
        for cb in getattr(self, "_listeners", ()):
            cb()

    def add_listener(self, cb) -> None:
        """Invoke ``cb()`` after every set() (post-creation conf
        mutations must invalidate cached eligibility decisions)."""
        if not hasattr(self, "_listeners"):
            self._listeners = []
        self._listeners.append(cb)

    def get(self, name: str) -> Any:
        prop = _BY_NAME.get((self._scope, name))
        if prop is None:
            raise KafkaException(Err._INVALID_ARG,
                                 f"No such {self._scope} configuration property: {name!r}")
        if prop.alias:
            return self.get(prop.alias)
        return self._values.get(prop.name, prop.default)

    def is_set(self, name: str) -> bool:
        prop = _BY_NAME.get((self._scope, name))
        if prop and prop.alias:
            name = prop.alias
        return name in self._explicit

    def update(self, d: dict) -> None:
        for k, v in d.items():
            self.set(k, v)

    def dump(self) -> dict:
        """All effective values (reference: rd_kafka_conf_dump)."""
        out = {}
        for prop in PROPERTIES:
            if (prop.scope == self._scope and not prop.alias
                    and prop.ptype not in ("ptr", "invalid")):
                out[prop.name] = self.get(prop.name)
        return out

    def copy(self):
        dup = type(self)()
        dup._values = dict(self._values)
        dup._explicit = set(self._explicit)
        return dup

    @staticmethod
    def _coerce(prop: Prop, value: Any) -> Any:
        t = prop.ptype
        if t == "ptr":
            return value
        if t == "bool":
            if isinstance(value, bool):
                return value
            sval = str(value).strip().lower()
            if sval in _TRUE:
                return True
            if sval in _FALSE:
                return False
            raise KafkaException(Err._INVALID_ARG,
                                 f"Expected bool for {prop.name!r}, got {value!r}")
        if t == "int":
            try:
                ival = int(str(value).strip())
            except ValueError:
                raise KafkaException(Err._INVALID_ARG,
                                     f"Expected int for {prop.name!r}, got {value!r}")
            if prop.vmin is not None and not (prop.vmin <= ival <= prop.vmax):
                raise KafkaException(
                    Err._INVALID_ARG,
                    f"Configuration property {prop.name!r} value {ival} is outside "
                    f"allowed range {int(prop.vmin)}..{int(prop.vmax)}")
            return ival
        if t == "float":
            try:
                fval = float(str(value).strip())
            except ValueError:
                raise KafkaException(Err._INVALID_ARG,
                                     f"Expected float for {prop.name!r}, got {value!r}")
            if prop.vmin is not None and not (prop.vmin <= fval <= prop.vmax):
                raise KafkaException(Err._INVALID_ARG,
                                     f"{prop.name!r} value {fval} outside range")
            return fval
        if t == "enum":
            sval = str(value).strip().lower()
            if sval not in prop.enum:
                raise KafkaException(
                    Err._INVALID_ARG,
                    f"Invalid value {value!r} for enum property {prop.name!r} "
                    f"(allowed: {', '.join(prop.enum)})")
            return sval
        if t == "list":
            if isinstance(value, (list, tuple)):
                return list(value)
            return [s for s in re.split(r"[,\s]+", str(value)) if s]
        return str(value)


class Conf(_ConfBase):
    """Global client configuration (reference: rd_kafka_conf_t).

    Topic-scoped properties set here fall through to the default topic
    config (the reference's conf fallthrough behavior)."""
    _scope = GLOBAL

    def set(self, name: str, value: Any) -> None:
        # fallthrough: names that only exist topic-scope route to the
        # default topic conf, as do explicit fallthrough rows (global
        # offset.store.method); names in BOTH scopes otherwise
        # (compression.codec, opaque, ...) take the global row, as the
        # reference does
        gprop = _BY_NAME.get((GLOBAL, name))
        if ((gprop is None or gprop.fallthrough)
                and (TOPIC, name) in _BY_NAME):
            tc = super().get("default_topic_conf")
            if tc is None:
                tc = TopicConf()
                super().set("default_topic_conf", tc)
            tc.set(name, value)
            return
        super().set(name, value)

    def get(self, name: str) -> Any:
        # fallthrough rows read back from where set() wrote (the
        # default topic conf), so set→get round-trips
        gprop = _BY_NAME.get((GLOBAL, name))
        if (gprop is not None and gprop.fallthrough
                and (TOPIC, name) in _BY_NAME):
            tc = super().get("default_topic_conf")
            if tc is not None:
                return tc.get(name)
            return _BY_NAME[(TOPIC, name)].default
        return super().get(name)

    def topic_conf(self) -> "TopicConf":
        tc = self.get("default_topic_conf")
        return tc.copy() if tc is not None else TopicConf()


class TopicConf(_ConfBase):
    """Per-topic configuration (reference: rd_kafka_topic_conf_t)."""
    _scope = TOPIC


def generate_configuration_md() -> str:
    """Auto-generate CONFIGURATION.md from the table, like the reference does."""
    out = ["# Configuration properties", ""]
    for scope, title in ((GLOBAL, "Global configuration properties"),
                         (TOPIC, "Topic configuration properties")):
        out += [f"## {title}", "",
                "Property | C/P | Range | Default | Description",
                "---------|-----|-------|---------|------------"]
        for prop in PROPERTIES:
            if prop.scope != scope or prop.hidden:
                continue
            rng = ""
            if prop.vmin is not None:
                rng = f"{int(prop.vmin)} .. {int(prop.vmax)}"
            elif prop.enum:
                rng = ", ".join(prop.enum)
            doc = prop.doc if not prop.alias else f"Alias for `{prop.alias}`: {prop.doc}"
            if prop.deprecated:
                doc = f"**DEPRECATED** {doc}"
            out.append(f"{prop.name} | {prop.app} | {rng} | {prop.default} | {doc}")
        out.append("")
    out += [
        "## Appendix: delta vs the reference table", "",
        "Every property in librdkafka 1.3.0's declarative table "
        "(src/rdkafka_conf.c:224, 154 rows incl. both scopes) exists in "
        "this table with the same name, scope and semantics — including "
        "the deprecated no-op rows, the hidden rows "
        "(enable.sparse.connections, ut_handle_ProduceResponse) and the "
        "Java-guidance error rows (ssl.truststore.location, "
        "sasl.jaas.config). Windows-only behavior (SSPI) is out of "
        "scope but its conf rows are accepted.", "",
        "Rows this tree ADDS over the reference:", ""]
    for scope, name in sorted(GPU_ADDITIONS):
        prop = _BY_NAME[(scope, name)]
        out.append(f"- `{name}` ({scope}): {prop.doc}")
    out.append("")
    return "\n".join(out)


if __name__ == "__main__":
    print(generate_configuration_md())
