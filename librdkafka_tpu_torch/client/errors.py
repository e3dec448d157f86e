"""Error codes and exceptions.

Mirrors the reference's two error spaces (src/rdkafka.h:222-589):
internal/client-local errors are negative (the reference reserves -200..-1),
broker/protocol errors are the non-negative Kafka protocol error codes.
Broker codes are public Apache Kafka protocol constants.
"""
from __future__ import annotations

import enum


class Err(enum.IntEnum):
    """Error codes. Negative = client-local, >= 0 = Kafka protocol codes."""

    # --- client-local (reference: RD_KAFKA_RESP_ERR__* in rdkafka.h:229-330) ---
    _BAD_MSG = -199
    _BAD_COMPRESSION = -198
    _DESTROY = -197
    _FAIL = -196
    _TRANSPORT = -195
    _CRIT_SYS_RESOURCE = -194
    _RESOLVE = -193
    _MSG_TIMED_OUT = -192
    _PARTITION_EOF = -191
    _UNKNOWN_PARTITION = -190
    _FS = -189
    _UNKNOWN_TOPIC = -188
    _ALL_BROKERS_DOWN = -187
    _INVALID_ARG = -186
    _TIMED_OUT = -185
    _QUEUE_FULL = -184
    _ISR_INSUFF = -183
    _NODE_UPDATE = -182
    _SSL = -181
    _WAIT_COORD = -180
    _UNKNOWN_GROUP = -179
    _IN_PROGRESS = -178
    _PREV_IN_PROGRESS = -177
    _EXISTING_SUBSCRIPTION = -176
    _ASSIGN_PARTITIONS = -175
    _REVOKE_PARTITIONS = -174
    _CONFLICT = -173
    _STATE = -172
    _UNKNOWN_PROTOCOL = -171
    _NOT_IMPLEMENTED = -170
    _AUTHENTICATION = -169
    _NO_OFFSET = -168
    _OUTDATED = -167
    _TIMED_OUT_QUEUE = -166
    _UNSUPPORTED_FEATURE = -165
    _WAIT_CACHE = -164
    _INTR = -163
    _KEY_SERIALIZATION = -162
    _VALUE_SERIALIZATION = -161
    _KEY_DESERIALIZATION = -160
    _VALUE_DESERIALIZATION = -159
    _PARTIAL = -158
    _READ_ONLY = -157
    _NOENT = -156
    _UNDERFLOW = -155
    _INVALID_TYPE = -154
    _RETRY = -153
    _PURGE_QUEUE = -152
    _PURGE_INFLIGHT = -151
    _FATAL = -150
    _INCONSISTENT = -149
    _GAPLESS_GUARANTEE = -148
    _MAX_POLL_EXCEEDED = -147
    _UNKNOWN_BROKER = -146

    # --- Kafka broker/protocol error codes (public protocol constants) ---
    NO_ERROR = 0
    UNKNOWN = -1001  # wire value -1; remapped to avoid clashing with local codes
    OFFSET_OUT_OF_RANGE = 1
    INVALID_MSG = 2  # CORRUPT_MESSAGE
    UNKNOWN_TOPIC_OR_PART = 3
    INVALID_MSG_SIZE = 4
    LEADER_NOT_AVAILABLE = 5
    NOT_LEADER_FOR_PARTITION = 6
    REQUEST_TIMED_OUT = 7
    BROKER_NOT_AVAILABLE = 8
    REPLICA_NOT_AVAILABLE = 9
    MSG_SIZE_TOO_LARGE = 10
    STALE_CTRL_EPOCH = 11
    OFFSET_METADATA_TOO_LARGE = 12
    NETWORK_EXCEPTION = 13
    COORDINATOR_LOAD_IN_PROGRESS = 14
    COORDINATOR_NOT_AVAILABLE = 15
    NOT_COORDINATOR = 16
    TOPIC_EXCEPTION = 17  # INVALID_TOPIC_EXCEPTION
    RECORD_LIST_TOO_LARGE = 18
    NOT_ENOUGH_REPLICAS = 19
    NOT_ENOUGH_REPLICAS_AFTER_APPEND = 20
    INVALID_REQUIRED_ACKS = 21
    ILLEGAL_GENERATION = 22
    INCONSISTENT_GROUP_PROTOCOL = 23
    INVALID_GROUP_ID = 24
    UNKNOWN_MEMBER_ID = 25
    INVALID_SESSION_TIMEOUT = 26
    REBALANCE_IN_PROGRESS = 27
    INVALID_COMMIT_OFFSET_SIZE = 28
    TOPIC_AUTHORIZATION_FAILED = 29
    GROUP_AUTHORIZATION_FAILED = 30
    CLUSTER_AUTHORIZATION_FAILED = 31
    INVALID_TIMESTAMP = 32
    UNSUPPORTED_SASL_MECHANISM = 33
    ILLEGAL_SASL_STATE = 34
    UNSUPPORTED_VERSION = 35
    TOPIC_ALREADY_EXISTS = 36
    INVALID_PARTITIONS = 37
    INVALID_REPLICATION_FACTOR = 38
    INVALID_REPLICA_ASSIGNMENT = 39
    INVALID_CONFIG = 40
    NOT_CONTROLLER = 41
    INVALID_REQUEST = 42
    UNSUPPORTED_FOR_MESSAGE_FORMAT = 43
    POLICY_VIOLATION = 44
    OUT_OF_ORDER_SEQUENCE_NUMBER = 45
    DUPLICATE_SEQUENCE_NUMBER = 46
    INVALID_PRODUCER_EPOCH = 47
    INVALID_TXN_STATE = 48
    INVALID_PRODUCER_ID_MAPPING = 49
    INVALID_TRANSACTION_TIMEOUT = 50
    CONCURRENT_TRANSACTIONS = 51
    TRANSACTION_COORDINATOR_FENCED = 52
    TRANSACTIONAL_ID_AUTHORIZATION_FAILED = 53
    SECURITY_DISABLED = 54
    OPERATION_NOT_ATTEMPTED = 55
    KAFKA_STORAGE_ERROR = 56
    LOG_DIR_NOT_FOUND = 57
    SASL_AUTHENTICATION_FAILED = 58
    UNKNOWN_PRODUCER_ID = 59
    REASSIGNMENT_IN_PROGRESS = 60
    DELEGATION_TOKEN_AUTH_DISABLED = 61
    DELEGATION_TOKEN_NOT_FOUND = 62
    DELEGATION_TOKEN_OWNER_MISMATCH = 63
    DELEGATION_TOKEN_REQUEST_NOT_ALLOWED = 64
    DELEGATION_TOKEN_AUTHORIZATION_FAILED = 65
    DELEGATION_TOKEN_EXPIRED = 66
    INVALID_PRINCIPAL_TYPE = 67
    NON_EMPTY_GROUP = 68
    GROUP_ID_NOT_FOUND = 69
    FETCH_SESSION_ID_NOT_FOUND = 70
    INVALID_FETCH_SESSION_EPOCH = 71
    LISTENER_NOT_FOUND = 72
    TOPIC_DELETION_DISABLED = 73
    FENCED_LEADER_EPOCH = 74
    UNKNOWN_LEADER_EPOCH = 75
    UNSUPPORTED_COMPRESSION_TYPE = 76
    STALE_BROKER_EPOCH = 77
    OFFSET_NOT_AVAILABLE = 78
    MEMBER_ID_REQUIRED = 79
    PREFERRED_LEADER_NOT_AVAILABLE = 80
    GROUP_MAX_SIZE_REACHED = 81
    FENCED_INSTANCE_ID = 82
    # KIP-360 era: the broker's explicit zombie-fencing code for a
    # producer whose (pid, epoch) was superseded by a newer instance of
    # the same transactional.id
    PRODUCER_FENCED = 90

    @property
    def is_local(self) -> bool:
        return self.value < 0 and self.value > -1000

    @property
    def wire(self) -> int:
        """The int16 value sent on the wire (UNKNOWN is -1 on the wire)."""
        return -1 if self is Err.UNKNOWN else int(self.value)

    @classmethod
    def from_wire(cls, code: int) -> "Err":
        if code == -1:
            return cls.UNKNOWN
        try:
            return cls(code)
        except ValueError:
            return cls.UNKNOWN

    def __str__(self) -> str:  # e.g. "Local: Broker transport failure"
        return self.name.lstrip("_").replace("_", " ").title()


#: Errors on which a Produce request may be retried without risking
#: reordering/duplication policy violations (reference:
#: rd_kafka_handle_Produce_error, rdkafka_request.c:2415).
RETRIABLE_ERRS = frozenset({
    Err._TRANSPORT, Err._TIMED_OUT, Err.REQUEST_TIMED_OUT,
    Err.NOT_LEADER_FOR_PARTITION, Err.LEADER_NOT_AVAILABLE,
    Err.UNKNOWN_TOPIC_OR_PART, Err.NOT_ENOUGH_REPLICAS,
    Err.NOT_ENOUGH_REPLICAS_AFTER_APPEND, Err.COORDINATOR_LOAD_IN_PROGRESS,
    Err.COORDINATOR_NOT_AVAILABLE, Err.NOT_COORDINATOR,
    Err.NETWORK_EXCEPTION, Err.FENCED_LEADER_EPOCH, Err.UNKNOWN_LEADER_EPOCH,
    Err.KAFKA_STORAGE_ERROR, Err.PREFERRED_LEADER_NOT_AVAILABLE,
})


class KafkaError:
    """Rich error object (reference: rd_kafka_error_t / rd_kafka_resp_err_t)."""

    __slots__ = ("code", "reason", "fatal", "retriable")

    def __init__(self, code: Err, reason: str = "", *, fatal: bool = False,
                 retriable: bool | None = None):
        self.code = code
        self.reason = reason or str(code)
        self.fatal = fatal
        self.retriable = (code in RETRIABLE_ERRS) if retriable is None else retriable

    def __repr__(self):
        return f"KafkaError({self.code.name}, {self.reason!r})"

    def __eq__(self, other):
        if isinstance(other, KafkaError):
            return self.code == other.code
        if isinstance(other, Err):
            return self.code == other
        return NotImplemented

    def __hash__(self):
        return hash(self.code)


class KafkaException(Exception):
    """Exception wrapper carrying a KafkaError."""

    def __init__(self, error: KafkaError | Err, reason: str = ""):
        if isinstance(error, Err):
            error = KafkaError(error, reason)
        self.error = error
        super().__init__(repr(error))
