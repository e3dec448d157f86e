"""Per-API request/response schemas.

One (request, response) Schema pair per Kafka API at the protocol version
this client speaks — the declarative equivalent of the reference's
rd_kafka_XxxRequest() builders + rd_kafka_handle_Xxx() parsers
(src/rdkafka_request.c, 3893 LoC). Both the client and the mock broker
(mock/cluster.py) use these same schemas, making the mock a protocol
oracle: bytes built here must parse there and vice versa.

Versions follow what librdkafka v1.3.0 negotiates for a modern (2.x)
broker: Produce v3 / Fetch v4 (MsgVer2 + read_committed), ApiVersions v0,
JoinGroup v2 (rebalance_timeout), etc.
"""
from __future__ import annotations

from .proto import ApiKey
from .types import (Array, Boolean, Bytes, Int8, Int16, Int32, Int64,
                    NullableString, Schema, String)

# ------------------------------------------------------------- headers ----
REQUEST_HEADER = Schema(
    ("api_key", Int16), ("api_version", Int16),
    ("correlation_id", Int32), ("client_id", NullableString))
RESPONSE_HEADER = Schema(("correlation_id", Int32))

# ---------------------------------------------------------- ApiVersions ---
APIVERSIONS_V0_REQ = Schema()
APIVERSIONS_V0_RESP = Schema(
    ("error_code", Int16),
    ("api_versions", Array(Schema(
        ("api_key", Int16), ("min_version", Int16), ("max_version", Int16)))))

# -------------------------------------------------------------- Metadata --
METADATA_V2_REQ = Schema(("topics", Array(String)))  # null array = all topics
# v4 (KIP-204): producer metadata may auto-create, consumer only when
# allow.auto.create.topics (reference: rd_kafka_MetadataRequest's
# allow_auto_topic_creation flag, rdkafka_request.c)
METADATA_V4_REQ = Schema(("topics", Array(String)),
                         ("allow_auto_topic_creation", Boolean),
                         defaults={"allow_auto_topic_creation": True})
METADATA_V2_RESP = Schema(
    ("brokers", Array(Schema(
        ("node_id", Int32), ("host", String), ("port", Int32),
        ("rack", NullableString)))),
    ("cluster_id", NullableString),
    ("controller_id", Int32),
    ("topics", Array(Schema(
        ("error_code", Int16), ("topic", String), ("is_internal", Boolean),
        ("partitions", Array(Schema(
            ("error_code", Int16), ("partition", Int32), ("leader", Int32),
            ("replicas", Array(Int32)), ("isr", Array(Int32)))))))))
METADATA_V3_RESP = Schema(("throttle_time_ms", Int32),
                          *METADATA_V2_RESP.fields)
METADATA_V4_RESP = METADATA_V3_RESP       # v4 only adds the request flag

# --------------------------------------------------------------- Produce --
# Legacy versions for pre-0.11 brokers (broker.version.fallback;
# reference emits the version the feature set allows,
# rdkafka_request.c:2927 + rdkafka_feature.c)
PRODUCE_V0_REQ = Schema(
    ("acks", Int16), ("timeout", Int32),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("records", Bytes))))))))
PRODUCE_V0_RESP = Schema(
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("error_code", Int16),
            ("base_offset", Int64))))))))
# v2: throttle + per-partition log_append_time, req still w/o txn id
PRODUCE_V2_REQ = PRODUCE_V0_REQ
PRODUCE_V2_RESP = Schema(
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("error_code", Int16),
            ("base_offset", Int64), ("log_append_time", Int64))))))),
    ("throttle_time_ms", Int32))

PRODUCE_V3_REQ = Schema(
    ("transactional_id", NullableString),
    ("acks", Int16), ("timeout", Int32),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("records", Bytes))))))))
PRODUCE_V3_RESP = Schema(
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("error_code", Int16),
            ("base_offset", Int64), ("log_append_time", Int64))))))),
    ("throttle_time_ms", Int32))

# ----------------------------------------------------------------- Fetch --
FETCH_V0_REQ = Schema(
    ("replica_id", Int32), ("max_wait_time", Int32), ("min_bytes", Int32),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("fetch_offset", Int64),
            ("max_bytes", Int32))))))))
FETCH_V0_RESP = Schema(
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("error_code", Int16),
            ("high_watermark", Int64), ("records", Bytes))))))))
FETCH_V2_REQ = FETCH_V0_REQ
FETCH_V2_RESP = Schema(
    ("throttle_time_ms", Int32),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("error_code", Int16),
            ("high_watermark", Int64), ("records", Bytes))))))))

FETCH_V4_REQ = Schema(
    ("replica_id", Int32), ("max_wait_time", Int32), ("min_bytes", Int32),
    ("max_bytes", Int32), ("isolation_level", Int8),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("fetch_offset", Int64),
            ("max_bytes", Int32))))))))
FETCH_V4_RESP = Schema(
    ("throttle_time_ms", Int32),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("error_code", Int16),
            ("high_watermark", Int64), ("last_stable_offset", Int64),
            ("aborted_transactions", Array(Schema(
                ("producer_id", Int64), ("first_offset", Int64)))),
            ("records", Bytes))))))))

# Fetch v5-v11 evolution (KIP-227 sessions, KIP-392 follower fetching —
# reference: rd_kafka_FetchRequest versioning in rdkafka_broker.c:3791+).
# Schema `defaults` keep version-agnostic request bodies working: a
# body WITHOUT session keys serializes as a sessionless full fetch
# (session_id=0, epoch=-1), the reference's only shape.  With
# fetch.session.enable (default) the client goes beyond the reference:
# client/fetch_session.py negotiates per-broker KIP-227 sessions and
# fills session_id/session_epoch/forgotten_topics explicitly
# (Broker._consumer_serve); the mock broker's session cache is the
# other end (mock/cluster.py _h_Fetch).
_FETCH_PART_V5 = Schema(
    ("partition", Int32), ("fetch_offset", Int64),
    ("log_start_offset", Int64), ("max_bytes", Int32),
    defaults={"log_start_offset": -1})
_FETCH_PART_V9 = Schema(
    ("partition", Int32), ("current_leader_epoch", Int32),
    ("fetch_offset", Int64), ("log_start_offset", Int64),
    ("max_bytes", Int32),
    defaults={"current_leader_epoch": -1, "log_start_offset": -1})
_FORGOTTEN = ("forgotten_topics", Array(Schema(
    ("topic", String), ("partitions", Array(Int32)))))


def _fetch_req(part_schema, *, session: bool, rack: bool) -> Schema:
    fields = [("replica_id", Int32), ("max_wait_time", Int32),
              ("min_bytes", Int32), ("max_bytes", Int32),
              ("isolation_level", Int8)]
    defaults = {}
    if session:
        fields += [("session_id", Int32), ("session_epoch", Int32)]
        defaults.update(session_id=0, session_epoch=-1)
    fields.append(("topics", Array(Schema(
        ("topic", String), ("partitions", Array(part_schema))))))
    if session:
        fields.append(_FORGOTTEN)
        defaults["forgotten_topics"] = []
    if rack:
        fields.append(("rack_id", String))
        defaults["rack_id"] = ""
    return Schema(*fields, defaults=defaults)


def _fetch_resp(*, session: bool, preferred: bool) -> Schema:
    part_fields = [("partition", Int32), ("error_code", Int16),
                   ("high_watermark", Int64), ("last_stable_offset", Int64),
                   ("log_start_offset", Int64),
                   ("aborted_transactions", Array(Schema(
                       ("producer_id", Int64), ("first_offset", Int64))))]
    pdef = {"log_start_offset": -1}
    if preferred:
        part_fields.append(("preferred_read_replica", Int32))
        pdef["preferred_read_replica"] = -1
    part_fields.append(("records", Bytes))
    fields = [("throttle_time_ms", Int32)]
    defaults = {}
    if session:
        fields += [("error_code", Int16), ("session_id", Int32)]
        defaults.update(error_code=0, session_id=0)
    fields.append(("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(*part_fields, defaults=pdef)))))))
    return Schema(*fields, defaults=defaults)


FETCH_V5_REQ = _fetch_req(_FETCH_PART_V5, session=False, rack=False)
FETCH_V5_RESP = _fetch_resp(session=False, preferred=False)
FETCH_V7_REQ = _fetch_req(_FETCH_PART_V5, session=True, rack=False)
FETCH_V7_RESP = _fetch_resp(session=True, preferred=False)
FETCH_V9_REQ = _fetch_req(_FETCH_PART_V9, session=True, rack=False)
FETCH_V11_REQ = _fetch_req(_FETCH_PART_V9, session=True, rack=True)
FETCH_V11_RESP = _fetch_resp(session=True, preferred=True)

# ----------------------------------------------------------- ListOffsets --
LISTOFFSETS_V1_REQ = Schema(
    ("replica_id", Int32),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("timestamp", Int64))))))))
LISTOFFSETS_V1_RESP = Schema(
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("error_code", Int16),
            ("timestamp", Int64), ("offset", Int64))))))))

# ------------------------------------------------------- FindCoordinator --
FINDCOORDINATOR_V1_REQ = Schema(("key", String), ("key_type", Int8))
FINDCOORDINATOR_V1_RESP = Schema(
    ("throttle_time_ms", Int32), ("error_code", Int16),
    ("error_message", NullableString),
    ("node_id", Int32), ("host", String), ("port", Int32))

# ------------------------------------------------------------- JoinGroup --
JOINGROUP_V2_REQ = Schema(
    ("group_id", String), ("session_timeout", Int32),
    ("rebalance_timeout", Int32), ("member_id", String),
    ("protocol_type", String),
    ("protocols", Array(Schema(("name", String), ("metadata", Bytes)))))
JOINGROUP_V2_RESP = Schema(
    ("throttle_time_ms", Int32), ("error_code", Int16),
    ("generation_id", Int32), ("protocol", String),
    ("leader_id", String), ("member_id", String),
    ("members", Array(Schema(("member_id", String), ("metadata", Bytes)))))

# JoinGroup v5 (KIP-345 static membership): + group_instance_id
JOINGROUP_V5_REQ = Schema(
    ("group_id", String), ("session_timeout", Int32),
    ("rebalance_timeout", Int32), ("member_id", String),
    ("group_instance_id", NullableString),
    ("protocol_type", String),
    ("protocols", Array(Schema(("name", String), ("metadata", Bytes)))))
JOINGROUP_V5_RESP = Schema(
    ("throttle_time_ms", Int32), ("error_code", Int16),
    ("generation_id", Int32), ("protocol", String),
    ("leader_id", String), ("member_id", String),
    ("members", Array(Schema(
        ("member_id", String), ("group_instance_id", NullableString),
        ("metadata", Bytes)))))

# ------------------------------------------------------------- SyncGroup --
SYNCGROUP_V1_REQ = Schema(
    ("group_id", String), ("generation_id", Int32), ("member_id", String),
    ("assignments", Array(Schema(
        ("member_id", String), ("assignment", Bytes)))))
SYNCGROUP_V1_RESP = Schema(
    ("throttle_time_ms", Int32), ("error_code", Int16),
    ("assignment", Bytes))

# ------------------------------------------------------------- Heartbeat --
HEARTBEAT_V1_REQ = Schema(
    ("group_id", String), ("generation_id", Int32), ("member_id", String))
HEARTBEAT_V1_RESP = Schema(("throttle_time_ms", Int32), ("error_code", Int16))

# ------------------------------------------------------------ LeaveGroup --
LEAVEGROUP_V1_REQ = Schema(("group_id", String), ("member_id", String))
LEAVEGROUP_V1_RESP = Schema(("throttle_time_ms", Int32), ("error_code", Int16))

# ----------------------------------------------------------- OffsetCommit --
OFFSETCOMMIT_V2_REQ = Schema(
    ("group_id", String), ("generation_id", Int32), ("member_id", String),
    ("retention_time", Int64),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("offset", Int64),
            ("metadata", NullableString))))))))
OFFSETCOMMIT_V2_RESP = Schema(
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("error_code", Int16))))))))

# ------------------------------------------------------------ OffsetFetch --
OFFSETFETCH_V1_REQ = Schema(
    ("group_id", String),
    ("topics", Array(Schema(
        ("topic", String), ("partitions", Array(Int32))))))
OFFSETFETCH_V1_RESP = Schema(
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("offset", Int64),
            ("metadata", NullableString), ("error_code", Int16))))))))

# ---------------------------------------------------------- SaslHandshake --
SASLHANDSHAKE_V1_REQ = Schema(("mechanism", String))
SASLHANDSHAKE_V1_RESP = Schema(
    ("error_code", Int16), ("mechanisms", Array(String)))

# ------------------------------------------------------- SaslAuthenticate --
SASLAUTHENTICATE_V0_REQ = Schema(("auth_bytes", Bytes))
SASLAUTHENTICATE_V0_RESP = Schema(
    ("error_code", Int16), ("error_message", NullableString),
    ("auth_bytes", Bytes))

# --------------------------------------------------------- InitProducerId --
INITPRODUCERID_V1_REQ = Schema(
    ("transactional_id", NullableString), ("transaction_timeout_ms", Int32))
INITPRODUCERID_V1_RESP = Schema(
    ("throttle_time_ms", Int32), ("error_code", Int16),
    ("producer_id", Int64), ("producer_epoch", Int16))

# ----------------------------------------------------- AddPartitionsToTxn --
# (KIP-98 transactional producer; reference: the rd_kafka_txn_* request
# builders land in librdkafka 1.4 — this client implements the same
# v0 wire schemas the 2.x brokers of its era negotiate)
ADDPARTITIONSTOTXN_V0_REQ = Schema(
    ("transactional_id", String), ("producer_id", Int64),
    ("producer_epoch", Int16),
    ("topics", Array(Schema(
        ("topic", String), ("partitions", Array(Int32))))))
ADDPARTITIONSTOTXN_V0_RESP = Schema(
    ("throttle_time_ms", Int32),
    ("results", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("error_code", Int16))))))))

# ------------------------------------------------------- AddOffsetsToTxn --
ADDOFFSETSTOTXN_V0_REQ = Schema(
    ("transactional_id", String), ("producer_id", Int64),
    ("producer_epoch", Int16), ("group_id", String))
ADDOFFSETSTOTXN_V0_RESP = Schema(
    ("throttle_time_ms", Int32), ("error_code", Int16))

# ---------------------------------------------------------------- EndTxn --
ENDTXN_V1_REQ = Schema(
    ("transactional_id", String), ("producer_id", Int64),
    ("producer_epoch", Int16), ("committed", Boolean))
ENDTXN_V1_RESP = Schema(
    ("throttle_time_ms", Int32), ("error_code", Int16))

# ------------------------------------------------------- TxnOffsetCommit --
TXNOFFSETCOMMIT_V0_REQ = Schema(
    ("transactional_id", String), ("group_id", String),
    ("producer_id", Int64), ("producer_epoch", Int16),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("offset", Int64),
            ("metadata", NullableString))))))))
TXNOFFSETCOMMIT_V0_RESP = Schema(
    ("throttle_time_ms", Int32),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("error_code", Int16))))))))

# ----------------------------------------------------------- CreateTopics --
CREATETOPICS_V2_REQ = Schema(
    ("topics", Array(Schema(
        ("topic", String), ("num_partitions", Int32),
        ("replication_factor", Int16),
        ("replica_assignment", Array(Schema(
            ("partition", Int32), ("replicas", Array(Int32))))),
        ("configs", Array(Schema(
            ("name", String), ("value", NullableString))))))),
    ("timeout", Int32), ("validate_only", Boolean))
CREATETOPICS_V2_RESP = Schema(
    ("throttle_time_ms", Int32),
    ("topics", Array(Schema(
        ("topic", String), ("error_code", Int16),
        ("error_message", NullableString)))))

# ----------------------------------------------------------- DeleteTopics --
DELETETOPICS_V1_REQ = Schema(("topics", Array(String)), ("timeout", Int32))
DELETETOPICS_V1_RESP = Schema(
    ("throttle_time_ms", Int32),
    ("topics", Array(Schema(("topic", String), ("error_code", Int16)))))

# ------------------------------------------------------- CreatePartitions --
CREATEPARTITIONS_V1_REQ = Schema(
    ("topics", Array(Schema(
        ("topic", String), ("count", Int32),
        ("assignment", Array(Schema(("broker_ids", Array(Int32)))))))),
    ("timeout", Int32), ("validate_only", Boolean))
CREATEPARTITIONS_V1_RESP = Schema(
    ("throttle_time_ms", Int32),
    ("topics", Array(Schema(
        ("topic", String), ("error_code", Int16),
        ("error_message", NullableString)))))

# -------------------------------------------------------- DescribeConfigs --
DESCRIBECONFIGS_V1_REQ = Schema(
    ("resources", Array(Schema(
        ("resource_type", Int8), ("resource_name", String),
        ("config_names", Array(String))))),
    ("include_synonyms", Boolean))
DESCRIBECONFIGS_V1_RESP = Schema(
    ("throttle_time_ms", Int32),
    ("resources", Array(Schema(
        ("error_code", Int16), ("error_message", NullableString),
        ("resource_type", Int8), ("resource_name", String),
        ("entries", Array(Schema(
            ("name", String), ("value", NullableString),
            ("read_only", Boolean), ("source", Int8),
            ("sensitive", Boolean),
            ("synonyms", Array(Schema(
                ("name", String), ("value", NullableString),
                ("source", Int8)))))))))))

# ----------------------------------------------------------- AlterConfigs --
ALTERCONFIGS_V0_REQ = Schema(
    ("resources", Array(Schema(
        ("resource_type", Int8), ("resource_name", String),
        ("entries", Array(Schema(
            ("name", String), ("value", NullableString))))))),
    ("validate_only", Boolean))
ALTERCONFIGS_V0_RESP = Schema(
    ("throttle_time_ms", Int32),
    ("resources", Array(Schema(
        ("error_code", Int16), ("error_message", NullableString),
        ("resource_type", Int8), ("resource_name", String)))))

# --------------------------------------------------------- DescribeGroups --
DESCRIBEGROUPS_V0_REQ = Schema(("groups", Array(String)))
DESCRIBEGROUPS_V0_RESP = Schema(
    ("groups", Array(Schema(
        ("error_code", Int16), ("group_id", String), ("state", String),
        ("protocol_type", String), ("protocol", String),
        ("members", Array(Schema(
            ("member_id", String), ("client_id", String),
            ("client_host", String), ("metadata", Bytes),
            ("assignment", Bytes))))))))

# ------------------------------------------------------------- ListGroups --
LISTGROUPS_V0_REQ = Schema()
LISTGROUPS_V0_RESP = Schema(
    ("error_code", Int16),
    ("groups", Array(Schema(
        ("group_id", String), ("protocol_type", String)))))

# ----------------------------------------------------------- DeleteGroups --
DELETEGROUPS_V0_REQ = Schema(("groups", Array(String)))
DELETEGROUPS_V0_RESP = Schema(
    ("throttle_time_ms", Int32),
    ("results", Array(Schema(("group_id", String), ("error_code", Int16)))))


#: {ApiKey: (version, request_schema, response_schema)} — the single version
#: this client emits per API (negotiation picks min(ours, broker's)).
APIS: dict[ApiKey, tuple[int, Schema, Schema]] = {
    ApiKey.ApiVersions: (0, APIVERSIONS_V0_REQ, APIVERSIONS_V0_RESP),
    ApiKey.Metadata: (4, METADATA_V4_REQ, METADATA_V4_RESP),
    ApiKey.Produce: (3, PRODUCE_V3_REQ, PRODUCE_V3_RESP),
    ApiKey.Fetch: (11, FETCH_V11_REQ, FETCH_V11_RESP),
    ApiKey.ListOffsets: (1, LISTOFFSETS_V1_REQ, LISTOFFSETS_V1_RESP),
    ApiKey.FindCoordinator: (1, FINDCOORDINATOR_V1_REQ, FINDCOORDINATOR_V1_RESP),
    ApiKey.JoinGroup: (5, JOINGROUP_V5_REQ, JOINGROUP_V5_RESP),
    ApiKey.SyncGroup: (1, SYNCGROUP_V1_REQ, SYNCGROUP_V1_RESP),
    ApiKey.Heartbeat: (1, HEARTBEAT_V1_REQ, HEARTBEAT_V1_RESP),
    ApiKey.LeaveGroup: (1, LEAVEGROUP_V1_REQ, LEAVEGROUP_V1_RESP),
    ApiKey.OffsetCommit: (2, OFFSETCOMMIT_V2_REQ, OFFSETCOMMIT_V2_RESP),
    ApiKey.OffsetFetch: (1, OFFSETFETCH_V1_REQ, OFFSETFETCH_V1_RESP),
    ApiKey.SaslHandshake: (1, SASLHANDSHAKE_V1_REQ, SASLHANDSHAKE_V1_RESP),
    ApiKey.SaslAuthenticate: (0, SASLAUTHENTICATE_V0_REQ, SASLAUTHENTICATE_V0_RESP),
    ApiKey.InitProducerId: (1, INITPRODUCERID_V1_REQ, INITPRODUCERID_V1_RESP),
    ApiKey.AddPartitionsToTxn: (0, ADDPARTITIONSTOTXN_V0_REQ,
                                ADDPARTITIONSTOTXN_V0_RESP),
    ApiKey.AddOffsetsToTxn: (0, ADDOFFSETSTOTXN_V0_REQ,
                             ADDOFFSETSTOTXN_V0_RESP),
    ApiKey.EndTxn: (1, ENDTXN_V1_REQ, ENDTXN_V1_RESP),
    ApiKey.TxnOffsetCommit: (0, TXNOFFSETCOMMIT_V0_REQ,
                             TXNOFFSETCOMMIT_V0_RESP),
    ApiKey.CreateTopics: (2, CREATETOPICS_V2_REQ, CREATETOPICS_V2_RESP),
    ApiKey.DeleteTopics: (1, DELETETOPICS_V1_REQ, DELETETOPICS_V1_RESP),
    ApiKey.CreatePartitions: (1, CREATEPARTITIONS_V1_REQ, CREATEPARTITIONS_V1_RESP),
    ApiKey.DescribeConfigs: (1, DESCRIBECONFIGS_V1_REQ, DESCRIBECONFIGS_V1_RESP),
    ApiKey.AlterConfigs: (0, ALTERCONFIGS_V0_REQ, ALTERCONFIGS_V0_RESP),
    ApiKey.DescribeGroups: (0, DESCRIBEGROUPS_V0_REQ, DESCRIBEGROUPS_V0_RESP),
    ApiKey.ListGroups: (0, LISTGROUPS_V0_REQ, LISTGROUPS_V0_RESP),
    ApiKey.DeleteGroups: (0, DELETEGROUPS_V0_REQ, DELETEGROUPS_V0_RESP),
}


#: Explicit (api, version) schema overrides for legacy broker support
#: (broker.version.fallback; reference rdkafka_feature.c maps version
#: ranges to emitted request versions). Versions between table entries
#: resolve DOWN to the nearest listed one.
PRODUCE_V1_RESP = Schema(     # v1: +throttle, no log_append_time yet
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("error_code", Int16),
            ("base_offset", Int64))))))),
    ("throttle_time_ms", Int32))

VERSIONED: dict[tuple[ApiKey, int], tuple[Schema, Schema]] = {
    (ApiKey.Produce, 0): (PRODUCE_V0_REQ, PRODUCE_V0_RESP),
    (ApiKey.Produce, 1): (PRODUCE_V0_REQ, PRODUCE_V1_RESP),
    (ApiKey.Produce, 2): (PRODUCE_V2_REQ, PRODUCE_V2_RESP),
    (ApiKey.Fetch, 0): (FETCH_V0_REQ, FETCH_V0_RESP),
    (ApiKey.Fetch, 1): (FETCH_V2_REQ, FETCH_V2_RESP),
    (ApiKey.Fetch, 2): (FETCH_V2_REQ, FETCH_V2_RESP),
    (ApiKey.Fetch, 3): (FETCH_V2_REQ, FETCH_V2_RESP),
}
# Fetch v3 request adds top-level max_bytes (response like v2)
FETCH_V3_REQ = Schema(
    ("replica_id", Int32), ("max_wait_time", Int32), ("min_bytes", Int32),
    ("max_bytes", Int32),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("fetch_offset", Int64),
            ("max_bytes", Int32))))))))
VERSIONED[(ApiKey.Fetch, 3)] = (FETCH_V3_REQ, FETCH_V2_RESP)
VERSIONED[(ApiKey.Fetch, 4)] = (FETCH_V4_REQ, FETCH_V4_RESP)
VERSIONED[(ApiKey.Fetch, 5)] = (FETCH_V5_REQ, FETCH_V5_RESP)
VERSIONED[(ApiKey.Fetch, 6)] = (FETCH_V5_REQ, FETCH_V5_RESP)
VERSIONED[(ApiKey.Fetch, 7)] = (FETCH_V7_REQ, FETCH_V7_RESP)
VERSIONED[(ApiKey.Fetch, 8)] = (FETCH_V7_REQ, FETCH_V7_RESP)
VERSIONED[(ApiKey.Fetch, 9)] = (FETCH_V9_REQ, FETCH_V7_RESP)
VERSIONED[(ApiKey.Fetch, 10)] = (FETCH_V9_REQ, FETCH_V7_RESP)

# --- group / offset APIs for pre-1.0 brokers (all subset schemas: the
# client builds one superset body dict; a version's schema writes only
# its own fields) ---
JOINGROUP_V0_REQ = Schema(
    ("group_id", String), ("session_timeout", Int32), ("member_id", String),
    ("protocol_type", String),
    ("protocols", Array(Schema(("name", String), ("metadata", Bytes)))))
JOINGROUP_V01_RESP = Schema(
    ("error_code", Int16),
    ("generation_id", Int32), ("protocol", String),
    ("leader_id", String), ("member_id", String),
    ("members", Array(Schema(("member_id", String), ("metadata", Bytes)))))
VERSIONED[(ApiKey.JoinGroup, 0)] = (JOINGROUP_V0_REQ, JOINGROUP_V01_RESP)
VERSIONED[(ApiKey.JoinGroup, 1)] = (JOINGROUP_V2_REQ, JOINGROUP_V01_RESP)
for _jv in (2, 3, 4):
    VERSIONED[(ApiKey.JoinGroup, _jv)] = (JOINGROUP_V2_REQ,
                                          JOINGROUP_V2_RESP)

SYNCGROUP_V0_RESP = Schema(("error_code", Int16), ("assignment", Bytes))
VERSIONED[(ApiKey.SyncGroup, 0)] = (SYNCGROUP_V1_REQ, SYNCGROUP_V0_RESP)

HEARTBEAT_V0_RESP = Schema(("error_code", Int16))
VERSIONED[(ApiKey.Heartbeat, 0)] = (HEARTBEAT_V1_REQ, HEARTBEAT_V0_RESP)
VERSIONED[(ApiKey.LeaveGroup, 0)] = (LEAVEGROUP_V1_REQ, HEARTBEAT_V0_RESP)

# FindCoordinator v0 ("GroupCoordinator"): bare group key, no throttle
FINDCOORDINATOR_V0_REQ = Schema(("key", String))
FINDCOORDINATOR_V0_RESP = Schema(
    ("error_code", Int16),
    ("node_id", Int32), ("host", String), ("port", Int32))
VERSIONED[(ApiKey.FindCoordinator, 0)] = (FINDCOORDINATOR_V0_REQ,
                                          FINDCOORDINATOR_V0_RESP)

# ListOffsets v0: per-partition max_num_offsets + plural offsets reply
LISTOFFSETS_V0_REQ = Schema(
    ("replica_id", Int32),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("timestamp", Int64),
            ("max_num_offsets", Int32))))))))
LISTOFFSETS_V0_RESP = Schema(
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("error_code", Int16),
            ("offsets", Array(Int64)))))))))
VERSIONED[(ApiKey.ListOffsets, 0)] = (LISTOFFSETS_V0_REQ,
                                      LISTOFFSETS_V0_RESP)

# Metadata v0: no rack/is_internal/cluster_id/controller_id; v1 adds
# rack + controller_id + is_internal (cluster_id arrives in v2)
METADATA_V0_RESP = Schema(
    ("brokers", Array(Schema(
        ("node_id", Int32), ("host", String), ("port", Int32)))),
    ("topics", Array(Schema(
        ("error_code", Int16), ("topic", String),
        ("partitions", Array(Schema(
            ("error_code", Int16), ("partition", Int32), ("leader", Int32),
            ("replicas", Array(Int32)), ("isr", Array(Int32)))))))))
METADATA_V1_RESP = Schema(
    ("brokers", Array(Schema(
        ("node_id", Int32), ("host", String), ("port", Int32),
        ("rack", NullableString)))),
    ("controller_id", Int32),
    ("topics", Array(Schema(
        ("error_code", Int16), ("topic", String), ("is_internal", Boolean),
        ("partitions", Array(Schema(
            ("error_code", Int16), ("partition", Int32), ("leader", Int32),
            ("replicas", Array(Int32)), ("isr", Array(Int32)))))))))
VERSIONED[(ApiKey.Metadata, 0)] = (METADATA_V2_REQ, METADATA_V0_RESP)
VERSIONED[(ApiKey.Metadata, 1)] = (METADATA_V2_REQ, METADATA_V1_RESP)
VERSIONED[(ApiKey.Metadata, 2)] = (METADATA_V2_REQ, METADATA_V2_RESP)
VERSIONED[(ApiKey.Metadata, 3)] = (METADATA_V2_REQ, METADATA_V3_RESP)

# OffsetCommit v0/v1 (pre-0.9 brokers)
OFFSETCOMMIT_V0_REQ = Schema(
    ("group_id", String),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("offset", Int64),
            ("metadata", NullableString))))))))
OFFSETCOMMIT_V1_REQ = Schema(
    ("group_id", String), ("generation_id", Int32), ("member_id", String),
    ("topics", Array(Schema(
        ("topic", String),
        ("partitions", Array(Schema(
            ("partition", Int32), ("offset", Int64),
            ("timestamp", Int64), ("metadata", NullableString))))))))
VERSIONED[(ApiKey.OffsetCommit, 0)] = (OFFSETCOMMIT_V0_REQ,
                                       OFFSETCOMMIT_V2_RESP)
VERSIONED[(ApiKey.OffsetCommit, 1)] = (OFFSETCOMMIT_V1_REQ,
                                       OFFSETCOMMIT_V2_RESP)

# CreateTopics v0/v1 and DeleteTopics v0: no throttle (v0 also lacks
# error_message / validate_only)
CREATETOPICS_V0_REQ = Schema(
    ("topics", Array(Schema(
        ("topic", String), ("num_partitions", Int32),
        ("replication_factor", Int16),
        ("replica_assignment", Array(Schema(
            ("partition", Int32), ("replicas", Array(Int32))))),
        ("configs", Array(Schema(
            ("name", String), ("value", NullableString))))))),
    ("timeout", Int32))
CREATETOPICS_V0_RESP = Schema(
    ("topics", Array(Schema(("topic", String), ("error_code", Int16)))))
CREATETOPICS_V1_RESP = Schema(
    ("topics", Array(Schema(
        ("topic", String), ("error_code", Int16),
        ("error_message", NullableString)))))
VERSIONED[(ApiKey.CreateTopics, 0)] = (CREATETOPICS_V0_REQ,
                                       CREATETOPICS_V0_RESP)
VERSIONED[(ApiKey.CreateTopics, 1)] = (CREATETOPICS_V2_REQ,
                                       CREATETOPICS_V1_RESP)
DELETETOPICS_V0_RESP = Schema(
    ("topics", Array(Schema(("topic", String), ("error_code", Int16)))))
VERSIONED[(ApiKey.DeleteTopics, 0)] = (DELETETOPICS_V1_REQ,
                                       DELETETOPICS_V0_RESP)

# DescribeConfigs v0: entries without synonyms, no include_synonyms
DESCRIBECONFIGS_V0_REQ = Schema(
    ("resources", Array(Schema(
        ("resource_type", Int8), ("resource_name", String),
        ("config_names", Array(String))))))
DESCRIBECONFIGS_V0_RESP = Schema(
    ("throttle_time_ms", Int32),
    ("resources", Array(Schema(
        ("error_code", Int16), ("error_message", NullableString),
        ("resource_type", Int8), ("resource_name", String),
        ("entries", Array(Schema(
            ("name", String), ("value", NullableString),
            ("read_only", Boolean), ("is_default", Boolean),
            ("sensitive", Boolean))))))))
VERSIONED[(ApiKey.DescribeConfigs, 0)] = (DESCRIBECONFIGS_V0_REQ,
                                          DESCRIBECONFIGS_V0_RESP)


def schemas_for(api: ApiKey, version: int | None) -> tuple[int, Schema, Schema]:
    """Resolve (version, req_schema, resp_schema): explicit versioned
    entry if present, else the default single-version schema."""
    ver, req_schema, resp_schema = APIS[api]
    if version is not None and version != ver:
        ovr = VERSIONED.get((api, version))
        if ovr is not None:
            return version, ovr[0], ovr[1]
        return version, req_schema, resp_schema
    return ver, req_schema, resp_schema


def build_request_buf(api: ApiKey, corrid: int, client_id: str | None,
                      body: dict, version: int | None = None):
    """Frame a request as a SegBuf: 4-byte size + header + body.  Large
    Bytes fields (RecordBatch wire) ride as spliced read-only segments,
    so the broker can hand the segments straight to sendmsg without
    flattening (reference: requests are rd_buf segment chains sent via
    iovec, rdkafka_buf.c + rdkafka_transport.c:109)."""
    from ..utils.buf import SegBuf
    ver, req_schema, _ = schemas_for(api, version)
    buf = SegBuf()
    szpos = buf.write_i32(0)
    REQUEST_HEADER.write(buf, {"api_key": int(api),
                               "api_version": ver,
                               "correlation_id": corrid,
                               "client_id": client_id})
    req_schema.write(buf, body)
    buf.update_i32(szpos, len(buf) - 4)
    return buf


def build_request(api: ApiKey, corrid: int, client_id: str | None,
                  body: dict, version: int | None = None) -> bytes:
    """Frame a request: 4-byte size + header + body (rd_kafka_buf pattern)."""
    return build_request_buf(api, corrid, client_id, body,
                             version=version).as_bytes()


def build_response(api: ApiKey, corrid: int, body: dict,
                   version: int | None = None) -> bytes:
    from ..utils.buf import SegBuf
    _, _, resp_schema = schemas_for(api, version)
    buf = SegBuf()
    szpos = buf.write_i32(0)
    buf.write_i32(corrid)
    resp_schema.write(buf, body)
    buf.update_i32(szpos, len(buf) - 4)
    return buf.as_bytes()


def parse_request(payload: bytes) -> tuple[dict, dict]:
    """Parse an unframed request (after the 4-byte size). Returns (header, body)."""
    from ..utils.buf import Slice
    sl = Slice(payload)
    hdr = REQUEST_HEADER.read(sl)
    api = ApiKey(hdr["api_key"])
    _, req_schema, _ = schemas_for(api, hdr["api_version"])
    return hdr, req_schema.read(sl)


def parse_response(api: ApiKey, payload: bytes,
                   version: int | None = None) -> tuple[int, dict]:
    """Parse an unframed response. Returns (correlation_id, body)."""
    from ..utils.buf import Slice
    sl = Slice(payload)
    corrid = sl.read_i32()
    _, _, resp_schema = schemas_for(api, version)
    return corrid, resp_schema.read(sl)
