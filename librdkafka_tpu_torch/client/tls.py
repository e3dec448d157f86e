"""TLS transport support (reference: src/rdkafka_ssl.c, src/rdkafka_cert.c).

The reference builds one OpenSSL ``SSL_CTX`` per client instance at
``rd_kafka_ssl_ctx_init`` (rdkafka_ssl.c:~1100) from the ``ssl.*``
configuration properties, loading CA bundles, client cert/key pairs and
PKCS#12 keystores (rdkafka_cert.c:~200), then drives the per-connection
handshake from the transport poll loop (rdkafka_transport.c:612-719).

This module is the rebuild's equivalent: ``make_client_ctx(conf)``
constructs a single :class:`ssl.SSLContext` per client from the same
property names; the broker thread drives the non-blocking handshake in
its connection FSM (client/broker.py, state CONNECT).
"""
from __future__ import annotations

import os
import ssl
import tempfile
from typing import Optional

from .errors import Err, KafkaError, KafkaException


def uses_ssl(conf) -> bool:
    return conf.get("security.protocol") in ("ssl", "sasl_ssl")


def make_client_ctx(conf) -> Optional[ssl.SSLContext]:
    """Build the client SSLContext from ``ssl.*`` conf properties.

    Maps the reference's property semantics (rdkafka_conf.c ssl section):
      - ssl.ca.location: CA bundle file or directory; default = system CAs
      - ssl.certificate.location / ssl.key.location / ssl.key.password:
        client cert+key PEM pair
      - ssl.keystore.location / ssl.keystore.password: PKCS#12 keystore
        holding the client key+cert (rdkafka_cert.c PKCS12 path)
      - ssl.cipher.suites: OpenSSL cipher list
      - enable.ssl.certificate.verification: peer verification on/off
      - ssl.endpoint.identification.algorithm: "https" = hostname check
    """
    if not uses_ssl(conf):
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)

    verify = conf.get("enable.ssl.certificate.verification")
    algo = conf.get("ssl.endpoint.identification.algorithm")
    # check_hostname must be disabled before verify_mode can be relaxed
    ctx.check_hostname = bool(verify) and algo == "https"
    ctx.verify_mode = ssl.CERT_REQUIRED if verify else ssl.CERT_NONE

    ca = conf.get("ssl.ca.location")
    ca_mem = conf.get("ssl_ca")               # in-memory PEM/DER bytes
    if ca:
        try:
            if os.path.isdir(ca):
                ctx.load_verify_locations(capath=ca)
            else:
                ctx.load_verify_locations(cafile=ca)
        except (ssl.SSLError, OSError) as e:
            raise KafkaException(Err._SSL, f"ssl.ca.location {ca!r}: {e}")
    elif ca_mem:
        try:
            # load_verify_locations(cadata=...) takes PEM str or DER bytes
            if isinstance(ca_mem, bytes) and b"-----BEGIN" in ca_mem:
                ca_mem = ca_mem.decode()
            ctx.load_verify_locations(cadata=ca_mem)
        except (ssl.SSLError, ValueError) as e:
            raise KafkaException(Err._SSL, f"ssl_ca: {e}")
    elif verify:
        ctx.load_default_certs(ssl.Purpose.SERVER_AUTH)

    crl = conf.get("ssl.crl.location")
    if crl:
        if not verify:
            # OpenSSL ignores verify_flags entirely under CERT_NONE —
            # a CRL that can never be consulted must not pass silently
            raise KafkaException(
                Err._INVALID_ARG,
                "ssl.crl.location requires "
                "enable.ssl.certificate.verification=true (revocation "
                "checking is part of verification)")
        try:
            ctx.verify_flags |= ssl.VERIFY_CRL_CHECK_LEAF
            ctx.load_verify_locations(cafile=crl)
        except (ssl.SSLError, OSError) as e:
            raise KafkaException(Err._SSL, f"ssl.crl.location {crl!r}: {e}")

    _load_client_cert(ctx, conf)

    ks = conf.get("ssl.keystore.location")
    if ks:
        _load_pkcs12(ctx, ks, conf.get("ssl.keystore.password"))

    ciphers = conf.get("ssl.cipher.suites")
    if ciphers:
        try:
            ctx.set_ciphers(ciphers)
        except ssl.SSLError as e:
            raise KafkaException(Err._SSL, f"ssl.cipher.suites: {e}")
    curves = conf.get("ssl.curves.list")
    if curves:
        _ctx_ctrl_str(ctx, _SSL_CTRL_SET_GROUPS_LIST, curves,
                      "ssl.curves.list")
    sigalgs = conf.get("ssl.sigalgs.list")
    if sigalgs:
        _ctx_ctrl_str(ctx, _SSL_CTRL_SET_SIGALGS_LIST, sigalgs,
                      "ssl.sigalgs.list")
    return ctx


def _load_client_cert(ctx: ssl.SSLContext, conf) -> None:
    """Client cert+key from file paths, in-memory PEM strings
    (ssl.certificate.pem / ssl.key.pem), or in-memory bytes
    (ssl_certificate / ssl_key — the rd_kafka_conf_set_ssl_cert analog,
    reference rdkafka_cert.c:1-556). Python's ssl module only ingests
    cert chains from files, so in-memory material goes through a
    transient file deleted right after the load (same pattern as the
    PKCS#12 path)."""
    cert = conf.get("ssl.certificate.location")
    key = conf.get("ssl.key.location")
    pw = conf.get("ssl.key.password") or None
    cert_mem = conf.get("ssl.certificate.pem") or conf.get("ssl_certificate")
    key_mem = conf.get("ssl.key.pem") or conf.get("ssl_key")
    if cert and not key_mem:
        try:
            ctx.load_cert_chain(cert, keyfile=key or None, password=pw)
        except (ssl.SSLError, OSError) as e:
            raise KafkaException(Err._SSL, f"client certificate: {e}")
        return
    if cert and key_mem and not cert_mem:
        # cert from file + key in memory (the reference allows any
        # mix of rd_kafka_conf_set_ssl_cert and file rows): read the
        # file so both halves go through the transient-PEM load below
        try:
            with open(cert, "rb") as f:
                cert_mem = f.read()
        except OSError as e:
            raise KafkaException(Err._SSL, f"client certificate: {e}")
    if not cert_mem:
        if key_mem:
            # key without a certificate is as much a config error as the
            # mirror case below — failing here beats an opaque
            # handshake rejection at connect time
            raise KafkaException(
                Err._INVALID_ARG,
                "ssl.key.pem / ssl_key requires ssl.certificate.pem / "
                "ssl_certificate (or ssl.certificate.location)")
        return
    if not key_mem and not key:
        raise KafkaException(
            Err._INVALID_ARG,
            "in-memory client certificate requires ssl.key.pem / "
            "ssl_key (or ssl.key.location)")
    blob = b""
    for part in (cert_mem, key_mem):
        if part is None:
            continue
        if isinstance(part, str):
            part = part.encode()
        if b"-----BEGIN" not in part:
            raise KafkaException(
                Err._INVALID_ARG,
                "in-memory certificate/key must be PEM (DER client "
                "material: use ssl.keystore.location)")
        blob += part if part.endswith(b"\n") else part + b"\n"
    fd, tmp = tempfile.mkstemp(suffix=".pem")
    try:
        os.write(fd, blob)
        os.close(fd)
        try:
            ctx.load_cert_chain(tmp, keyfile=key or None, password=pw)
        except (ssl.SSLError, OSError) as e:
            raise KafkaException(Err._SSL,
                                 f"in-memory client certificate: {e}")
    finally:
        os.unlink(tmp)


# OpenSSL SSL_CTX_ctrl sub-commands (public ABI constants; the Python
# ssl module has no API for groups/sigalgs, so these reach the already-
# loaded libssl through the process symbol table)
_SSL_CTRL_SET_GROUPS_LIST = 92
_SSL_CTRL_SET_SIGALGS_LIST = 98

_libssl_handle = None


def _libssl(ctypes):
    """Handle to the libssl the interpreter's _ssl module already
    mapped (CDLL(None) can't see it: _ssl loads it RTLD_LOCAL)."""
    global _libssl_handle
    if _libssl_handle is None:
        path = None
        try:
            with open("/proc/self/maps") as f:
                for line in f:
                    if "libssl" in line:
                        path = line.split()[-1]
                        break
        except OSError:
            pass
        _libssl_handle = ctypes.CDLL(path)   # None falls back to process
    return _libssl_handle


def _ctx_ctrl_str(ctx: ssl.SSLContext, cmd: int, value: str,
                  propname: str) -> None:
    """Apply an SSL_CTX_ctrl string option (curves/sigalgs lists) to the
    context's underlying SSL_CTX. CPython's _ssl.PySSLContext stores the
    SSL_CTX* directly after PyObject_HEAD; a bad list makes
    SSL_CTX_ctrl return 0 and raises, so misconfiguration cannot pass
    silently. If the runtime layout/symbols are unavailable the
    property fails loudly rather than being ignored."""
    import ctypes

    class _PySSLContext(ctypes.Structure):
        _fields_ = [("ob_refcnt", ctypes.c_ssize_t),
                    ("ob_type", ctypes.c_void_p),
                    ("ctx", ctypes.c_void_p)]

    import sys
    import sysconfig
    if (sys.implementation.name != "cpython"
            or sysconfig.get_config_var("Py_GIL_DISABLED")
            or sysconfig.get_config_var("Py_TRACE_REFS")):
        # the struct layout below is standard-CPython-specific; on other
        # builds the pointer extraction would be garbage — refuse
        # loudly instead of dereferencing it
        raise KafkaException(
            Err._NOT_IMPLEMENTED,
            f"{propname}: unsupported on this Python build "
            f"({sys.implementation.name}, free-threaded/debug)")
    try:
        libssl = _libssl(ctypes)
        fn = libssl.SSL_CTX_ctrl
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                       ctypes.c_char_p]
        raw = _PySSLContext.from_address(id(ctx)).ctx
        # layout sanity probe before the real call: SSL_CTX_get_timeout
        # on a correctly-extracted context returns the default session
        # timeout (7200s) — garbage pointers fail this cheaply instead
        # of crashing inside SSL_CTX_ctrl
        get_timeout = libssl.SSL_CTX_get_timeout
        get_timeout.restype = ctypes.c_long
        get_timeout.argtypes = [ctypes.c_void_p]
        if not raw or not (0 < get_timeout(raw) < (1 << 31)):
            raise KafkaException(
                Err._NOT_IMPLEMENTED,
                f"{propname}: SSL_CTX layout probe failed on this "
                f"runtime")
        ok = fn(raw, cmd, 0, value.encode())
    except (OSError, AttributeError) as e:
        raise KafkaException(
            Err._NOT_IMPLEMENTED,
            f"{propname}: cannot reach SSL_CTX_ctrl in this runtime "
            f"({e})")
    if ok != 1:
        raise KafkaException(Err._INVALID_ARG,
                             f"{propname}: OpenSSL rejected {value!r}")


def _load_pkcs12(ctx: ssl.SSLContext, path: str, password: str) -> None:
    """PKCS#12 keystore → client cert chain (rdkafka_cert.c PKCS12 load).

    Python's ssl module cannot ingest PKCS#12 directly; decode with
    `cryptography` and hand the PEM material to the context through a
    transient file (deleted immediately after load).
    """
    try:
        from cryptography.hazmat.primitives.serialization import (
            Encoding, NoEncryption, PrivateFormat, pkcs12)
    except ImportError:
        raise KafkaException(Err._SSL,
                         "ssl.keystore.location requires the 'cryptography' "
                         "package for PKCS#12 decoding")
    try:
        blob = open(path, "rb").read()
        pw = password.encode() if password else None
        pkey, pcert, extra = pkcs12.load_key_and_certificates(blob, pw)
    except Exception as e:
        raise KafkaException(Err._SSL, f"ssl.keystore.location {path!r}: {e}")
    pem = b""
    if pkey is not None:
        pem += pkey.private_bytes(Encoding.PEM, PrivateFormat.PKCS8,
                                  NoEncryption())
    if pcert is not None:
        pem += pcert.public_bytes(Encoding.PEM)
    for c in extra or []:
        pem += c.public_bytes(Encoding.PEM)
    fd, tmp = tempfile.mkstemp(suffix=".pem")
    try:
        os.write(fd, pem)
        os.close(fd)
        ctx.load_cert_chain(tmp)
    finally:
        os.unlink(tmp)


def make_server_ctx(certfile: str, keyfile: str, cafile: str = None,
                    require_client_cert: bool = False) -> ssl.SSLContext:
    """Server-side context for the mock cluster's TLS listener mode."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    if cafile:
        ctx.load_verify_locations(cafile)
    if require_client_cert:
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx
