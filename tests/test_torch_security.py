"""Mirrors of test_0097_ssl (TLS, mutual TLS, sasl_ssl SCRAM, the ssl.*
breadth), test_0111_oauthbearer and test_0109_gssapi on the port.

Each case of 0097 and 0111 runs one scenario on the port
(``compression.backend=gpu, gpu.device=cpu``: the kernels' plain versions,
governor off, every CRC job on the device route) and on the JAX package
(the reference case's own conf), at once in two threads, each against its
own mock cluster with the same certificates (``tests/tlsutil.make_certs``,
imported inside the fixture: it skips its importing module where
``cryptography`` is absent, and 0109's and 0111's cases need no
certificate).  Records carry fixed timestamps and ``batch.num.messages``
fixes the batches, so the stored blobs compare byte for byte; the DR
error codes, the records read and the committed offsets compare too.
0109's cases drive each package's ``GssapiClient`` through 0109's own
``ScriptedCtx`` stand-in for a GSS context (no KDC here).
"""
import os
import struct
import time
from collections import deque

import pytest

from test_0109_gssapi import SSF_NONE_1MB, TOK_AP_REP, TOK_AP_REQ, ScriptedCtx
from test_torch_client import guarded_thread
from test_torch_delivery import mod
from test_torch_txn import PORT, REF, both
from torch_leakguard import no_new_threads

NOW_MS = 1_700_000_000_000


@pytest.fixture(autouse=True)
def _no_thread_left():
    with no_new_threads(guarded_thread):
        yield


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    pytest.importorskip("cryptography")
    from tlsutil import make_certs
    return make_certs(str(tmp_path_factory.mktemp("tls")))


def code(err):
    """An error's code by name; None for success."""
    return None if err is None else err.code.name


def tls_cluster(pkg, certs, topics, *, mtls=False, sasl=None, brokers=1):
    """A mock whose brokers speak TLS (requiring a client certificate with
    ``mtls``), with a SASL credential table ``sasl``."""
    tls = {"certfile": certs["server_cert"], "keyfile": certs["server_key"]}
    if mtls:
        tls.update(cafile=certs["ca"], require_client_cert=True)
    return pkg.MockCluster(num_brokers=brokers, topics=topics, tls=tls,
                           sasl_users=sasl)


def ssl_conf(cluster, certs, **extra) -> dict:
    return {"bootstrap.servers": cluster.bootstrap_servers(),
            "security.protocol": "ssl", "ssl.ca.location": certs["ca"],
            **extra}


def produce(pkg, cluster, topic: str, conf: dict, n: int = 1,
            parts: int = 1, flush: float = 15.0) -> dict:
    """``n`` records round robin over ``parts`` partitions, fixed
    timestamps, one batch a partition; the DR codes (sorted), the stored
    blobs of each partition."""
    drs = []
    p = pkg.Producer(pkg.conf({
        "linger.ms": 1000, "batch.num.messages": max(1, n // parts),
        "dr_msg_cb": lambda e, m: drs.append(code(e)), **conf}))
    try:
        for i in range(n):
            p.produce(topic, value=b"%s-%d" % (topic.encode(), i),
                      key=b"k%d" % i, partition=i % parts,
                      timestamp=NOW_MS + i)
        assert p.flush(flush) == 0
    finally:
        p.close()
    return {"drs": sorted(drs, key=lambda c: c or ""),
            "blobs": [[bytes(b) for _o, b in cluster.partition(topic, q).log]
                      for q in range(parts)]}


def consume(pkg, cluster, topic: str, conf: dict, n: int, group: str):
    """Read ``n`` records through a check.crcs group consumer, commit, and
    return each partition's (offset, value) list and the group's
    committed offsets."""
    c = pkg.Consumer(pkg.conf({"group.id": group,
                               "auto.offset.reset": "earliest",
                               "check.crcs": True, **conf}))
    got = {}
    try:
        c.subscribe([topic])
        deadline = time.monotonic() + 20
        while sum(map(len, got.values())) < n:
            assert time.monotonic() < deadline, got
            m = c.poll(0.5)
            if m is not None and m.error is None:
                got.setdefault(m.partition, []).append((m.offset, m.value))
        c.commit(asynchronous=False)
    finally:
        c.close()
    committed = {q: v[0] for (t, q), v in cluster.groups[group].offsets.items()
                 if t == topic}
    return got, committed


def produce_on(certs, topics: dict, conf_of, n=1, parts=1, **cluster_kw):
    """The scenario "produce ``n`` records to a fresh TLS mock with
    ``conf_of(cluster)``" on both packages; (port, reference)."""
    (topic,) = topics

    def scenario(pkg):
        cluster = tls_cluster(pkg, certs, topics, **cluster_kw)
        try:
            return produce(pkg, cluster, topic, conf_of(cluster), n, parts)
        finally:
            cluster.stop()
    return both(scenario)


def delivered(res, n=1):
    return res["drs"] == [None] * n and sum(map(len, res["blobs"])) >= 1


def refused(res, err="_MSG_TIMED_OUT"):
    return res["drs"] == [err] and res["blobs"] == [[]]


# ------------------------------------------------------------ test_0097 --

def test_produce_consume_over_ssl(certs):
    def scenario(pkg):
        cluster = tls_cluster(pkg, certs, {"sec": 2}, brokers=2)
        try:
            conf = ssl_conf(cluster, certs)
            out = produce(pkg, cluster, "sec", conf, n=50, parts=2)
            out["read"], out["committed"] = consume(
                pkg, cluster, "sec", ssl_conf(cluster, certs), 50, "g-ssl")
            return out
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref
    assert port["drs"] == [None] * 50
    assert sorted(v for q in port["read"].values() for _o, v in q) == \
        sorted(b"sec-%d" % i for i in range(50))
    assert port["committed"] == {0: 25, 1: 25}


def test_ssl_verification_rejects_unknown_ca(certs):
    """No ssl.ca.location: the system CAs do not know the mock's issuer,
    the handshake fails closed and the record times out."""
    port, ref = produce_on(certs, {"sec": 1}, lambda c: {
        "bootstrap.servers": c.bootstrap_servers(),
        "security.protocol": "ssl", "message.timeout.ms": 1500})
    assert port == ref
    assert refused(port)


def test_ssl_verification_disabled_allows_unknown_ca(certs):
    port, ref = produce_on(certs, {"sec": 1}, lambda c: {
        "bootstrap.servers": c.bootstrap_servers(),
        "security.protocol": "ssl",
        "enable.ssl.certificate.verification": False})
    assert port == ref and delivered(port)


def test_endpoint_identification_https(certs):
    port, ref = produce_on(certs, {"sec": 1}, lambda c: ssl_conf(c, certs, **{
        "ssl.endpoint.identification.algorithm": "https"}))
    assert port == ref and delivered(port)


def test_mutual_tls_with_pkcs12_keystore(certs):
    """The keystore's client pair passes a listener that requires one;
    without a client certificate the record times out."""
    port, ref = produce_on(certs, {"mtls": 1}, lambda c: ssl_conf(c, certs, **{
        "ssl.keystore.location": certs["client_p12"],
        "ssl.keystore.password": "kstore"}), mtls=True)
    assert port == ref and delivered(port)
    port, ref = produce_on(certs, {"mtls": 1}, lambda c: ssl_conf(
        c, certs, **{"message.timeout.ms": 1500}), mtls=True)
    assert port == ref and refused(port)


def test_mutual_tls_with_pem_cert_key(certs):
    port, ref = produce_on(certs, {"mtls2": 1}, lambda c: ssl_conf(
        c, certs, **{"ssl.certificate.location": certs["client_cert"],
                     "ssl.key.location": certs["client_key"]}), mtls=True)
    assert port == ref and delivered(port)


def test_sasl_ssl_scram(certs):
    port, ref = produce_on(certs, {"auth": 1}, lambda c: ssl_conf(c, certs, **{
        "security.protocol": "sasl_ssl", "sasl.mechanisms": "SCRAM-SHA-256",
        "sasl.username": "alice", "sasl.password": "wonderland"}),
        sasl={"alice": "wonderland"})
    assert port == ref and delivered(port)


def test_sasl_ssl_scram_bad_password(certs):
    port, ref = produce_on(certs, {"auth": 1}, lambda c: ssl_conf(c, certs, **{
        "security.protocol": "sasl_ssl", "sasl.mechanisms": "SCRAM-SHA-512",
        "sasl.username": "alice", "sasl.password": "wrong",
        "message.timeout.ms": 1500}), sasl={"alice": "wonderland"})
    assert port == ref and refused(port)


def test_gssapi_rejected_at_creation():
    """sasl_plaintext selects GSSAPI by default: without python-gssapi
    both packages refuse at creation."""
    def scenario(pkg):
        with pytest.raises(pkg.KafkaException) as ei:
            pkg.Producer(pkg.conf({"bootstrap.servers": "127.0.0.1:1",
                                   "security.protocol": "sasl_plaintext"}))
        return code(ei.value.error), ei.value.error.reason
    port, ref = both(scenario)
    assert port == ref and port[0] == "_UNSUPPORTED_FEATURE"


def _read(path: str, mode: str = "r"):
    with open(path, mode) as f:
        return f.read()


def test_mtls_with_in_memory_pems(certs):
    port, ref = produce_on(certs, {"mem": 1}, lambda c: {
        "bootstrap.servers": c.bootstrap_servers(),
        "security.protocol": "ssl", "ssl_ca": _read(certs["ca"], "rb"),
        "ssl.certificate.pem": _read(certs["client_cert"]),
        "ssl.key.pem": _read(certs["client_key"])}, mtls=True)
    assert port == ref and delivered(port)


def test_mtls_cert_file_key_in_memory(certs):
    port, ref = produce_on(certs, {"mix": 1}, lambda c: ssl_conf(c, certs, **{
        "ssl.certificate.location": certs["client_cert"],
        "ssl.key.pem": _read(certs["client_key"])}), mtls=True)
    assert port == ref and delivered(port)


def test_ssl_key_bytes_variant(certs):
    port, ref = produce_on(certs, {"memb": 1}, lambda c: {
        "bootstrap.servers": c.bootstrap_servers(),
        "security.protocol": "ssl", "ssl_ca": _read(certs["ca"], "rb"),
        "ssl_certificate": _read(certs["client_cert"], "rb"),
        "ssl_key": _read(certs["client_key"], "rb")}, mtls=True)
    assert port == ref and delivered(port)


def _server_der(certs) -> bytes:
    import ssl
    return ssl.PEM_cert_to_DER_cert(_read(certs["server_cert"]))


@pytest.mark.parametrize("verdict", [False, True])
def test_certificate_verify_cb(certs, verdict):
    """ssl.certificate.verify_cb sees the server's DER certificate; False
    fails the connection (the record times out), True lets it through
    (0097's ``_rejects`` and ``_accepts`` cases)."""
    def scenario(pkg):
        calls = []

        def cb(broker_name, broker_id, depth, der, ok):
            calls.append((broker_id, depth, bytes(der), ok))
            return verdict
        extra = {} if verdict else {"socket.timeout.ms": 3000,
                                    "message.timeout.ms": 2000}
        cluster = tls_cluster(pkg, certs, {"sec": 1})
        try:
            out = produce(pkg, cluster, "sec", ssl_conf(
                cluster, certs, **{"ssl.certificate.verify_cb": cb},
                **extra), flush=8.0 if not verdict else 15.0)
        finally:
            cluster.stop()
        return out, calls[:1]
    (port, pcalls), (ref, rcalls) = both(scenario)
    assert port == ref and pcalls == rcalls
    assert pcalls and pcalls[0][2] == _server_der(certs)
    assert delivered(port) if verdict else refused(port)


def test_curves_and_sigalgs_lists(certs):
    port, ref = produce_on(certs, {"sec": 1}, lambda c: ssl_conf(c, certs, **{
        "ssl.curves.list": "X25519:P-256",
        "ssl.sigalgs.list": "RSA-PSS+SHA256:rsa_pkcs1_sha256"}))
    assert port == ref and delivered(port)

    def junk(pkg):
        out = []
        for key in ("ssl.curves.list", "ssl.sigalgs.list"):
            with pytest.raises(pkg.KafkaException) as ei:
                pkg.Producer(pkg.conf({"bootstrap.servers": "127.0.0.1:1",
                                       "security.protocol": "ssl",
                                       "ssl.ca.location": certs["ca"],
                                       key: "NOT-A-" + key.split(".")[1]}))
            out.append(code(ei.value.error))
        return out
    port, ref = both(junk)
    assert port == ref and len(port) == 2


def test_crl_location_rejects_revoked(certs, tmp_path):
    """A CRL revoking the server certificate fails the handshake (the
    record times out); an empty CRL from the same CA lets it through."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from tlsutil import load_key_and_cert

    ca_key, ca_cert, srv_cert = load_key_and_cert(certs)
    now = datetime.datetime.now(datetime.timezone.utc)

    def crl(revoke=None) -> str:
        b = (x509.CertificateRevocationListBuilder()
             .issuer_name(ca_cert.subject).last_update(now)
             .next_update(now + datetime.timedelta(days=1)))
        if revoke is not None:
            b = b.add_revoked_certificate(
                x509.RevokedCertificateBuilder().serial_number(revoke)
                .revocation_date(now).build())
        path = tmp_path / f"{revoke}.crl"
        path.write_bytes(b.sign(ca_key, hashes.SHA256()).public_bytes(
            serialization.Encoding.PEM))
        return str(path)
    revoked, empty = crl(srv_cert.serial_number), crl()
    port, ref = produce_on(certs, {"crl": 1}, lambda c: ssl_conf(c, certs, **{
        "ssl.crl.location": revoked, "message.timeout.ms": 2500}))
    assert port == ref and refused(port)
    port, ref = produce_on(certs, {"crl": 1}, lambda c: ssl_conf(
        c, certs, **{"ssl.crl.location": empty}))
    assert port == ref and delivered(port)


def test_open_and_closesocket_cbs(tmp_path):
    """closesocket_cb fires when a broker socket closes; open_cb serves
    the file offset store's opens."""
    def scenario(pkg):
        opened, closed = [], []
        store = tmp_path / ("port" if pkg.port else "ref")
        store.mkdir()

        def open_cb(path, flags):
            opened.append(os.path.basename(path))
            return os.open(path, flags | os.O_CREAT, 0o644)
        cluster = pkg.MockCluster(num_brokers=1, topics={"oc": 1})
        try:
            out = produce(pkg, cluster, "oc", {
                "bootstrap.servers": cluster.bootstrap_servers(),
                "closesocket_cb": lambda s: closed.append(True)})
            c = pkg.Consumer(pkg.conf({
                "bootstrap.servers": cluster.bootstrap_servers(),
                "group.id": "goc", "auto.offset.reset": "earliest",
                "open_cb": open_cb, "offset.store.method": "file",
                "offset.store.path": str(store) + os.sep}))
            try:
                c.subscribe(["oc"])
                deadline = time.monotonic() + 15
                m = None
                while m is None and time.monotonic() < deadline:
                    m = c.poll(0.2)
                assert m is not None and m.error is None
                c.commit(asynchronous=False)
            finally:
                c.close()
            return out, bool(closed), opened[:1], (store / "oc-0.offset") \
                .read_text()
        finally:
            cluster.stop()
    port, ref = both(scenario)
    assert port == ref
    assert delivered(port[0]) and port[1] and port[2] == ["oc-0.offset"]


# ------------------------------------------------------------ test_0111 --

def _oauth_produce(conf: dict):
    def scenario(pkg):
        cluster = pkg.MockCluster(num_brokers=1, topics={"auth": 1})
        calls = []

        def refresh(rk_handle, cfg):
            calls.append(cfg)
            rk_handle.set_oauthbearer_token(
                "eyJhbGciOiJub25lIn0.eyJzdWIiOiJ0In0.",
                lifetime_ms=int((time.time() + 300) * 1000), principal="t")
        extra = dict(conf)
        if extra.pop("refresh", False):
            extra["oauthbearer_token_refresh_cb"] = refresh
        try:
            return produce(pkg, cluster, "auth", {
                "bootstrap.servers": cluster.bootstrap_servers(),
                "security.protocol": "sasl_plaintext",
                "sasl.mechanisms": "OAUTHBEARER", **extra}, flush=15.0), \
                calls[:1]
        finally:
            cluster.stop()
    return both(scenario)


def test_unsecured_jws_builtin_handler():
    port, ref = _oauth_produce({"enable.sasl.oauthbearer.unsecure.jwt": True,
                                "sasl.oauthbearer.config": "principal=tester"})
    assert port == ref and delivered(port[0])


def test_refresh_cb_supplies_token():
    port, ref = _oauth_produce({"refresh": True})
    assert port == ref and delivered(port[0]) and len(port[1]) == 1


def test_no_token_and_handler_disabled_fails_auth():
    port, ref = _oauth_produce({"message.timeout.ms": 1500})
    assert port == ref and refused(port[0])


# ------------------------------------------------------------ test_0109 --

def gssapi_client(pkg, ssf_plain=SSF_NONE_1MB, host="broker1.example.com",
                  **conf):
    """``pkg``'s GssapiClient on a conf stub, with 0109's scripted GSS
    context; (client, context)."""
    c = pkg.Conf()
    c.update({"security.protocol": "sasl_plaintext",
              "sasl.mechanisms": "PLAIN", **conf})
    ctxs = []

    def factory(service, h):
        ctxs.append(ScriptedCtx(service, h, ssf_plain))
        return ctxs[-1]
    rk = type("RkStub", (), {"conf": c})()
    cli = mod(pkg, "client.sasl").GssapiClient(rk, host, ctx_factory=factory)
    return cli, ctxs[0]


def on_both(fn):
    """``fn(pkg)`` on each package, one after the other (no threads: the
    case runs no client); (port, reference)."""
    return fn(PORT), fn(REF)


def test_token_relay_and_security_layer_exchange():
    def scenario(pkg):
        cli, ctx = gssapi_client(
            pkg, **{"sasl.kerberos.principal": "client@EXAMPLE.COM"})
        return [cli.first_message(), cli.step(TOK_AP_REP), ctx.complete,
                cli.step(b"WRAPPED[" + SSF_NONE_1MB + b"]"), ctx.wrapped_out,
                cli.step(b"")]
    port, ref = on_both(scenario)
    layer = struct.pack(">I", 0x01000000)
    assert port == ref == [TOK_AP_REQ, b"", True,
                           b"WRAPPED[" + layer + b"]", layer, None]


@pytest.mark.parametrize("conf,service", [
    ({"sasl.kerberos.service.name": "brokersvc"}, "brokersvc"),
    ({}, "kafka")], ids=["from_conf", "default_kafka"])
def test_hostbased_service_name(conf, service):
    port, ref = on_both(lambda pkg: (lambda c: (c.service, c.host))(
        gssapi_client(pkg, **conf)[1]))
    assert port == ref == (service, "broker1.example.com")


@pytest.mark.parametrize("ssf,match", [
    (bytes([0x04, 0, 0x40, 0]), "security layer"),
    (b"\x01\x00", "malformed")], ids=["no_layer_none", "malformed_ssf"])
def test_security_layer_token_rejected(ssf, match):
    def scenario(pkg):
        cli, ctx = gssapi_client(pkg, ssf_plain=ssf, host="h")
        cli.first_message()
        cli.step(TOK_AP_REP)
        with pytest.raises(pkg.KafkaException, match=match) as ei:
            cli.step(b"WRAPPED[" + ssf + b"]")
        return code(ei.value.error), ei.value.error.reason
    port, ref = on_both(scenario)
    assert port == ref


def test_fail_fast_without_python_gssapi():
    def scenario(pkg):
        sasl = mod(pkg, "client.sasl")
        assert not sasl.gssapi_available()
        c = pkg.Conf()
        c.update({"security.protocol": "sasl_plaintext",
                  "sasl.mechanisms": "GSSAPI"})
        with pytest.raises(pkg.KafkaException, match="python-gssapi") as ei:
            sasl.validate_mechanism(c)
        return code(ei.value.error), ei.value.error.reason
    port, ref = on_both(scenario)
    assert port == ref


def test_render_conf_template():
    def scenario(pkg):
        c = pkg.Conf()
        c.update({"sasl.kerberos.keytab": "/etc/krb.keytab",
                  "sasl.kerberos.principal": "svc@REALM"})
        return mod(pkg, "client.sasl").render_conf_template(
            c, 'kinit -t "%{sasl.kerberos.keytab}" -k '
               '%{sasl.kerberos.principal} %{no.such.prop}')
    port, ref = on_both(scenario)
    assert port == ref == 'kinit -t "/etc/krb.keytab" -k svc@REALM '


def test_kinit_cmd_runs_at_creation_and_on_timer(tmp_path, monkeypatch):
    """sasl.kerberos.kinit.cmd runs at creation and every
    min.time.before.relogin ms, its %{...} rendered (GSSAPI's
    availability stubbed: no KDC)."""
    def scenario(pkg):
        monkeypatch.setattr(mod(pkg, "client.sasl"), "gssapi_available",
                            lambda: True)
        marker = tmp_path / ("port" if pkg.port else "ref")
        p = pkg.Producer(pkg.conf({
            "bootstrap.servers": "127.0.0.1:1",
            "security.protocol": "sasl_plaintext",
            "sasl.mechanisms": "GSSAPI",
            "sasl.kerberos.principal": "tester@X",
            "sasl.kerberos.kinit.cmd":
                f"echo run-%{{sasl.kerberos.principal}} >> {marker}",
            "sasl.kerberos.min.time.before.relogin": 200}))
        try:
            deadline = time.monotonic() + 5
            while not (marker.exists()
                       and len(marker.read_text().splitlines()) >= 2):
                assert time.monotonic() < deadline, "kinit ran < 2 times"
                time.sleep(0.05)
            return marker.read_text().splitlines()[:2]
        finally:
            p.close()
    port, ref = both(scenario)
    assert port == ref == ["run-tester@X"] * 2


# ------------------------------------------------- chip_smoke phase 13 --

def test_phase13_openssl_certificates_carry_a_sasl_ssl_round(tmp_path):
    """chip_smoke.py phase 13's certificates where ``cryptography`` is
    absent (the openssl command): both packages run a mutual-TLS
    SCRAM-SHA-512 round with the PKCS#12 keystore on them, equal blobs."""
    import shutil

    import chip_smoke
    openssl = shutil.which("openssl")
    if openssl is None:
        pytest.skip("no openssl command on this host")
    pytest.importorskip("cryptography")   # the clients' PKCS#12 decode
    certs = chip_smoke.p13_openssl_certs(openssl, str(tmp_path))
    port, ref = produce_on(certs, {"p13": 2}, lambda c: {
        "bootstrap.servers": c.bootstrap_servers(),
        **chip_smoke.p13_scram(certs)}, n=20, parts=2, mtls=True,
        sasl=chip_smoke.P13_USERS)
    assert port == ref and delivered(port, 20)


def test_disconnect_mid_sasl_fails_the_exchange_once():
    """A connection dropped while a SASL step awaits its response (a
    close() racing a reconnect's authentication does it): the step's
    failure callback calls sasl_done, which disconnects again.  The port
    empties the in-flight table before failing its requests, so the
    step fails once and the broker thread lives on; the reference fails
    the same request again from the nested disconnect until the thread
    dies of RecursionError (ROADMAP queue 3)."""
    from types import SimpleNamespace

    def scenario(pkg):
        broker = mod(pkg, "client.broker")
        b = broker.Broker.__new__(broker.Broker)
        errors = []
        b.name, b.sock, b.terminate = "fake:0/1", None, True
        b.state = broker.BrokerState.DOWN
        b.rk = SimpleNamespace(op_err=errors.append,
                               log=lambda *a, **k: None,
                               dbg=lambda *a, **k: None)
        b._rbuf, b._wbuf, b._unsent_req_ends = bytearray(), [], []
        b._fetch_session = SimpleNamespace(reset=lambda why: None)
        b.outq = deque()
        b.waitresp = {7: broker.Request(
            pkg.proto.ApiKey.SaslAuthenticate, {"auth_bytes": b""},
            cb=lambda err, resp: b.sasl_done(err))}
        try:
            b._disconnect(mod(pkg, "client.errors").KafkaError(
                pkg.Err._TRANSPORT, "dropped"))
        except RecursionError:
            return "RecursionError"
        return [e.code.name for e in errors], b.waitresp
    port, ref = on_both(scenario)
    assert port == (["_TRANSPORT"], {})
    assert ref == "RecursionError"
