"""SASL authentication providers: PLAIN, SCRAM-SHA-256/512, OAUTHBEARER,
and GSSAPI/Kerberos (via python-gssapi when installed).

The provider-vtable design mirrors struct rd_kafka_sasl_provider
(src/rdkafka_sasl_int.h:32); the handshake bytes flow over the broker's
normal request path via SaslHandshake + SaslAuthenticate requests
(Kafka >= 1.0 framing). GSSAPI (reference: rdkafka_sasl_cyrus.c:1-645,
which uses libsasl2) is implemented directly over RFC 4752: the GSS
context loop plus the final security-layer negotiation. The GSS context
itself comes from the python-gssapi package (MIT Kerberos); when that is
not installed, selecting GSSAPI fails fast with _UNSUPPORTED_FEATURE at
client creation — exactly like a reference build without WITH_SASL_CYRUS.
The context factory is injectable so the SASL token framing is testable
against recorded vectors without a KDC.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import os
import struct
import time
from typing import TYPE_CHECKING, Optional

from ..protocol.apis import APIS
from ..protocol.proto import ApiKey
from .errors import Err, KafkaError, KafkaException

if TYPE_CHECKING:
    from .broker import Broker
    from .kafka import Kafka


SUPPORTED_MECHANISMS = ("PLAIN", "SCRAM-SHA-256", "SCRAM-SHA-512",
                        "OAUTHBEARER", "GSSAPI")


def gssapi_available() -> bool:
    try:
        import gssapi  # noqa: F401
        return True
    except Exception:
        return False


def validate_mechanism(conf) -> None:
    """Fail fast at client creation for unsupported mechanisms
    (reference: rd_kafka_sasl_select_provider, rdkafka_sasl.c:~350)."""
    mech = conf.get("sasl.mechanisms").upper()
    if mech in ("GSSAPI", "KERBEROS") and not gssapi_available():
        raise KafkaException(
            Err._UNSUPPORTED_FEATURE,
            "SASL mechanism GSSAPI (Kerberos) requires the python-gssapi "
            "package (not installed); supported here: "
            + ", ".join(m for m in SUPPORTED_MECHANISMS if m != "GSSAPI"))
    if mech not in SUPPORTED_MECHANISMS:
        raise KafkaException(
            Err._UNSUPPORTED_FEATURE,
            f"Unsupported sasl.mechanisms {mech!r}; supported: "
            + ", ".join(SUPPORTED_MECHANISMS))


def _auth_error(e: Exception) -> KafkaError:
    """Normalize provider exceptions (KafkaException, ValueError from
    SCRAM verification, gssapi.GSSError, ...) into the _AUTHENTICATION
    error sasl_done() reports to the app."""
    if isinstance(e, KafkaException):
        return e.error
    return KafkaError(Err._AUTHENTICATION, f"SASL auth failed: {e}")


def sasl_client_start(rk: "Kafka", broker: "Broker") -> None:
    mech = rk.conf.get("sasl.mechanisms").upper()
    if mech == "PLAIN":
        client = PlainClient(rk)
    elif mech in ("SCRAM-SHA-256", "SCRAM-SHA-512"):
        client = ScramClient(rk, mech)
    elif mech == "OAUTHBEARER":
        try:
            client = OauthBearerClient(rk)
        except KafkaException as e:
            broker.sasl_done(e.error)   # clean auth failure + backoff
            return
    elif mech == "GSSAPI":
        try:
            client = GssapiClient(rk, broker.host)
        except Exception as e:
            # python-gssapi raises gssapi.GSSError from Credentials/
            # Name/SecurityContext construction (e.g. no ticket in the
            # ccache); normalize it to a clean _AUTHENTICATION failure
            # instead of letting it escape as a generic _FAIL
            # disconnect/reconnect loop.
            broker.sasl_done(_auth_error(e))
            return
    else:
        broker.sasl_done(KafkaError(
            Err._UNSUPPORTED_FEATURE,
            f"SASL mechanism {mech} not supported in this build"))
        return
    _handshake(rk, broker, mech, client)


def _handshake(rk, broker, mech, client):
    from .broker import Request

    def on_handshake(err, resp):
        if err is not None:
            broker.sasl_done(err)
            return
        if resp["error_code"] != 0:
            broker.sasl_done(KafkaError(
                Err.from_wire(resp["error_code"]),
                f"SASL {mech} rejected; broker supports "
                f"{resp['mechanisms']}"))
            return
        try:
            first = client.first_message()
        except Exception as e:      # e.g. GSSError: no Kerberos ticket
            broker.sasl_done(_auth_error(e))
            return
        _auth_step(rk, broker, client, first)

    broker._xmit(Request(ApiKey.SaslHandshake, {"mechanism": mech},
                         cb=on_handshake))


def _auth_step(rk, broker, client, out_bytes: bytes):
    from .broker import Request

    def on_auth(err, resp):
        if err is not None:
            broker.sasl_done(err)
            return
        if resp["error_code"] != 0:
            broker.sasl_done(KafkaError(
                Err.from_wire(resp["error_code"]),
                resp.get("error_message") or "SASL authentication failed"))
            return
        try:
            nxt = client.step(resp["auth_bytes"] or b"")
        except Exception as e:      # provider-level failure (bad server
            broker.sasl_done(_auth_error(e))    # sig, GSS error, ...)
            return
        if nxt is None:
            broker.sasl_done(None)       # authenticated
        else:
            _auth_step(rk, broker, client, nxt)

    broker._xmit(Request(ApiKey.SaslAuthenticate, {"auth_bytes": out_bytes},
                         cb=on_auth))


class PlainClient:
    """RFC 4616: [authzid] NUL authcid NUL passwd (rdkafka_sasl_plain.c)."""

    def __init__(self, rk):
        self.user = rk.conf.get("sasl.username")
        self.passwd = rk.conf.get("sasl.password")

    def first_message(self) -> bytes:
        return b"\x00" + self.user.encode() + b"\x00" + self.passwd.encode()

    def step(self, data: bytes) -> Optional[bytes]:
        return None


class ScramClient:
    """RFC 5802 SCRAM (reference: rdkafka_sasl_scram.c, 912 LoC)."""

    def __init__(self, rk, mech: str):
        self.user = rk.conf.get("sasl.username")
        self.passwd = rk.conf.get("sasl.password").encode()
        self.hashname = "sha256" if mech.endswith("256") else "sha512"
        self.nonce = base64.b64encode(os.urandom(24)).decode()
        self.client_first_bare = f"n={self._saslname(self.user)},r={self.nonce}"
        self.server_first = ""
        self.state = 0

    @staticmethod
    def _saslname(s: str) -> str:
        return s.replace("=", "=3D").replace(",", "=2C")

    def first_message(self) -> bytes:
        return ("n,," + self.client_first_bare).encode()

    def step(self, data: bytes) -> Optional[bytes]:
        if self.state == 0:
            self.state = 1
            self.server_first = data.decode()
            fields = dict(kv.split("=", 1) for kv in self.server_first.split(","))
            r, s, i = fields["r"], fields["s"], int(fields["i"])
            if not r.startswith(self.nonce):
                raise ValueError("SCRAM server nonce mismatch")
            salted = hashlib.pbkdf2_hmac(self.hashname, self.passwd,
                                         base64.b64decode(s), i)
            client_key = hmac.new(salted, b"Client Key", self.hashname).digest()
            stored_key = hashlib.new(self.hashname, client_key).digest()
            cfinal_bare = f"c={base64.b64encode(b'n,,').decode()},r={r}"
            auth_msg = ",".join([self.client_first_bare, self.server_first,
                                 cfinal_bare]).encode()
            sig = hmac.new(stored_key, auth_msg, self.hashname).digest()
            proof = bytes(a ^ b for a, b in zip(client_key, sig))
            server_key = hmac.new(salted, b"Server Key", self.hashname).digest()
            self.server_sig = base64.b64encode(
                hmac.new(server_key, auth_msg, self.hashname).digest()).decode()
            return (cfinal_bare + ",p=" +
                    base64.b64encode(proof).decode()).encode()
        if self.state == 1:
            self.state = 2
            fields = dict(kv.split("=", 1) for kv in data.decode().split(","))
            if fields.get("v") != self.server_sig:
                raise ValueError("SCRAM server signature mismatch")
            return None
        return None


class OauthBearerClient:
    """OAUTHBEARER with the builtin unsecured-JWS token handler
    (reference: rdkafka_sasl_oauthbearer.c unsecured JWS builder)."""

    def __init__(self, rk):
        self.rk = rk
        cfg = dict(kv.split("=", 1) for kv in
                   rk.conf.get("sasl.oauthbearer.config").split(",") if "=" in kv)
        self.principal = cfg.get("principal", rk.conf.get("sasl.username")
                                 or "user")
        # app-supplied token via set_oauthbearer_token / the refresh
        # callback takes precedence; with a refresh cb configured, a
        # missing/failed/expired token FAILS auth — never a silent
        # unsecured-JWS fallback against a real broker
        got = rk.get_oauthbearer_token()
        if got is not None:
            self.token, principal, _exp = got
            if principal:
                self.principal = principal
        elif (rk.conf.get("oauthbearer_token_refresh_cb") is not None
                or rk._oauth_token is not None):
            # a configured refresh cb OR a previously app-set (now
            # expired/failed) token means the app owns credentials —
            # failing auth beats fabricating an unsecured JWS
            raise KafkaException(
                Err._AUTHENTICATION,
                "OAUTHBEARER token unavailable: "
                + (rk._oauth_failure or "token expired or not set"))
        elif not rk.conf.get("enable.sasl.oauthbearer.unsecure.jwt"):
            # reference default: the builtin unsecured-JWS handler must
            # be explicitly enabled (rdkafka_conf.c
            # "enable.sasl.oauthbearer.unsecure.jwt"); without it and
            # without an app token source, auth fails
            raise KafkaException(
                Err._AUTHENTICATION,
                "OAUTHBEARER: no token set and the builtin unsecured JWS "
                "handler is disabled "
                "(enable.sasl.oauthbearer.unsecure.jwt=false)")
        else:
            self.token = self._unsecured_jws(
                self.principal, int(cfg.get("lifeSeconds", "3600")))

    @staticmethod
    def _b64url(b: bytes) -> str:
        return base64.urlsafe_b64encode(b).rstrip(b"=").decode()

    def _unsecured_jws(self, principal: str, life: int) -> str:
        import json
        now = int(time.time())
        header = self._b64url(json.dumps({"alg": "none"}).encode())
        claims = self._b64url(json.dumps(
            {"sub": principal, "iat": now, "exp": now + life}).encode())
        return f"{header}.{claims}."

    def first_message(self) -> bytes:
        return (f"n,,\x01auth=Bearer {self.token}\x01\x01").encode()

    def step(self, data: bytes) -> Optional[bytes]:
        return None


class GssapiClient:
    """SASL GSSAPI / Kerberos v5 (RFC 4752; reference:
    rdkafka_sasl_cyrus.c:1-645).

    Two phases, both carried in SaslAuthenticate auth_bytes:

    1. GSS-API context establishment: opaque tokens from the mechanism
       (AP-REQ / AP-REP for krb5) are relayed verbatim until the
       initiator context is complete.
    2. Security-layer negotiation: the server sends ONE wrapped 4-byte
       message (supported-layers bitmask + max message size); the client
       answers with a wrapped [chosen layer | max size | authzid].
       Kafka brokers use no security layer (TLS handles privacy), so we
       select LAYER_NONE.

    ``ctx_factory(service, host)`` builds the GSS security context; the
    default uses python-gssapi with the hostbased service name
    ``<sasl.kerberos.service.name>@<broker host>`` and the default
    credential cache (the reference's cyrus provider resolves the same
    via libsasl2). Tests inject a scripted context — the SASL framing
    above it is exactly what is under test.
    """

    SEC_LAYER_NONE = 0x01        # RFC 4752 security-layer bitmask

    def __init__(self, rk, broker_host: str, ctx_factory=None):
        service = rk.conf.get("sasl.kerberos.service.name")
        # RFC 4752 authzid stays EMPTY (authorize as the authenticated
        # principal) — the reference's cyrus provider does the same; a
        # non-empty authzid that differs from the Kerberos principal is
        # rejected by the broker's authorize check.
        self.authzid = ""
        # sasl.kerberos.principal selects which cached credential to
        # initiate with (the reference uses it for kinit); when the app
        # leaves the row untouched we use the ccache default — keyed on
        # explicit-set, not the value, so configuring the literal
        # default string still looks up that credential
        principal = rk.conf.get("sasl.kerberos.principal")
        explicit = rk.conf.is_set("sasl.kerberos.principal")
        if ctx_factory is None:
            if not gssapi_available():
                raise KafkaException(
                    Err._UNSUPPORTED_FEATURE,
                    "GSSAPI requires the python-gssapi package")
            import gssapi
            creds = None
            if explicit and principal:
                creds = gssapi.Credentials(
                    name=gssapi.Name(principal), usage="initiate")
            name = gssapi.Name(
                f"{service}@{broker_host}",
                name_type=gssapi.NameType.hostbased_service)
            self.ctx = gssapi.SecurityContext(name=name, creds=creds,
                                              usage="initiate")
        else:
            self.ctx = ctx_factory(service, broker_host)
        self._ssf_done = False

    def first_message(self) -> bytes:
        return self.ctx.step(None) or b""

    def step(self, data: bytes) -> Optional[bytes]:
        if not self.ctx.complete:
            # phase 1: relay mechanism tokens. A completing step may
            # produce no output (AP-REP consumed) — send empty bytes,
            # the server's next message starts phase 2.
            return self.ctx.step(data or None) or b""
        if not self._ssf_done:
            # phase 2: RFC 4752 §3.1 — unwrap [bitmask u8 | max u24]
            plain = self.ctx.unwrap(data).message
            if len(plain) != 4:
                raise KafkaException(
                    Err._AUTHENTICATION,
                    f"GSSAPI: malformed security-layer token "
                    f"({len(plain)} bytes, want 4)")
            offered = plain[0]
            if not offered & self.SEC_LAYER_NONE:
                raise KafkaException(
                    Err._AUTHENTICATION,
                    "GSSAPI: server does not offer security layer NONE "
                    f"(bitmask 0x{offered:02x}); TLS provides privacy "
                    "in this client")
            resp = (struct.pack(">I", self.SEC_LAYER_NONE << 24)
                    + self.authzid.encode())
            self._ssf_done = True
            return self.ctx.wrap(resp, False).message
        return None                  # outcome arrives as error_code


def render_conf_template(conf, template: str) -> str:
    """Replace ``%{config.prop.name}`` with the property's value
    (reference: rd_string_render used by the kinit cmd,
    rdkafka_sasl_cyrus.c:206)."""
    import re

    def sub(m):
        try:
            v = conf.get(m.group(1))
        except Exception:
            return ""
        return "" if v is None else str(v)

    return re.sub(r"%\{([^}]+)\}", sub, template)


def kinit_setup(rk: "Kafka") -> None:
    """Execute sasl.kerberos.kinit.cmd at client creation and then every
    sasl.kerberos.min.time.before.relogin ms (0 disables the timer) —
    the ticket-refresh loop of the reference's cyrus provider
    (rdkafka_sasl_cyrus.c:193-260, kinit_refresh_tmr). Only active for
    the GSSAPI mechanism; failures log ERROR and auth proceeds (the
    ccache may still hold a valid ticket)."""
    mech = rk.conf.get("sasl.mechanisms").upper()
    if mech not in ("GSSAPI", "KERBEROS"):
        return
    cmd_tmpl = rk.conf.get("sasl.kerberos.kinit.cmd")
    if not cmd_tmpl:
        return

    def refresh():
        import subprocess
        cmd = render_conf_template(rk.conf, cmd_tmpl)
        try:
            r = subprocess.run(["/bin/sh", "-c", cmd],
                               capture_output=True, text=True, timeout=60)
        except Exception as e:
            rk.log("ERROR", f"kinit execution failed: {e}")
            return
        if r.returncode != 0:
            rk.log("ERROR",
                   f"kinit returned {r.returncode}: "
                   f"{(r.stderr or r.stdout).strip()[:256]}")
        else:
            rk.dbg("security", f"kinit refreshed: {cmd}")

    refresh()
    interval_ms = rk.conf.get("sasl.kerberos.min.time.before.relogin")
    if interval_ms > 0:
        rk.timers.add(interval_ms / 1000.0, refresh)
