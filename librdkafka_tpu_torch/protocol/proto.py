"""Protocol constants: ApiKeys, attributes, MessageSet v2 layout offsets.

Mirrors src/rdkafka_proto.h (ApiKeys, RD_KAFKAP_MSGSET_V2_OF_* offsets) —
these are public Apache Kafka protocol constants.
"""
from __future__ import annotations

import enum


class ApiKey(enum.IntEnum):
    Produce = 0
    Fetch = 1
    ListOffsets = 2
    Metadata = 3
    OffsetCommit = 8
    OffsetFetch = 9
    FindCoordinator = 10
    JoinGroup = 11
    Heartbeat = 12
    LeaveGroup = 13
    SyncGroup = 14
    DescribeGroups = 15
    ListGroups = 16
    SaslHandshake = 17
    ApiVersions = 18
    CreateTopics = 19
    DeleteTopics = 20
    DeleteRecords = 21
    InitProducerId = 22
    AddPartitionsToTxn = 24
    AddOffsetsToTxn = 25
    EndTxn = 26
    TxnOffsetCommit = 28
    DescribeAcls = 29
    CreateAcls = 30
    DeleteAcls = 31
    DescribeConfigs = 32
    AlterConfigs = 33
    SaslAuthenticate = 36
    CreatePartitions = 37
    DeleteGroups = 42


# MessageSet/RecordBatch compression attribute bits (Attributes int16)
ATTR_CODEC_MASK = 0x07
ATTR_CODEC_NONE = 0
ATTR_CODEC_GZIP = 1
ATTR_CODEC_SNAPPY = 2
ATTR_CODEC_LZ4 = 3
ATTR_CODEC_ZSTD = 4
ATTR_TIMESTAMP_TYPE = 1 << 3      # 0=CreateTime, 1=LogAppendTime
ATTR_TRANSACTIONAL = 1 << 4
ATTR_CONTROL = 1 << 5

CODEC_NAMES = {ATTR_CODEC_GZIP: "gzip", ATTR_CODEC_SNAPPY: "snappy",
               ATTR_CODEC_LZ4: "lz4", ATTR_CODEC_ZSTD: "zstd"}
CODEC_IDS = {v: k for k, v in CODEC_NAMES.items()}

# RecordBatch (MessageSet v2) header field offsets, relative to batch start
# (reference: RD_KAFKAP_MSGSET_V2_OF_* in src/rdkafka_proto.h).
V2_OF_BaseOffset = 0            # int64
V2_OF_Length = 8                # int32: bytes after this field
V2_OF_PartitionLeaderEpoch = 12  # int32
V2_OF_Magic = 16                # int8 == 2
V2_OF_CRC = 17                  # uint32 crc32c over [Attributes..end]
V2_OF_Attributes = 21           # int16
V2_OF_LastOffsetDelta = 23      # int32
V2_OF_FirstTimestamp = 27       # int64
V2_OF_MaxTimestamp = 35         # int64
V2_OF_ProducerId = 43           # int64
V2_OF_ProducerEpoch = 51        # int16
V2_OF_BaseSequence = 53         # int32
V2_OF_RecordCount = 57          # int32
V2_OF_Records = 61              # first record
V2_HEADER_SIZE = V2_OF_Records

# Legacy MessageSet (MsgVer 0/1) per-message layout
V01_OF_Offset = 0
V01_OF_MessageSize = 8
V01_OF_Crc = 12                 # zlib crc32 over [Magic..end]
V01_OF_Magic = 16
V01_OF_Attributes = 17

# Timestamp types (public API values; reference rdkafka.h timestamp enum)
TSTYPE_NOT_AVAILABLE = 0
TSTYPE_CREATE_TIME = 1
TSTYPE_LOG_APPEND_TIME = 2

# Control record keys (version int16, type int16): abort=0, commit=1
CTRL_ABORT = 0
CTRL_COMMIT = 1

RD_KAFKAP_PARTITIONS_MAX = 100000
UNKNOWN_OFFSET = -1001  # RD_KAFKA_OFFSET_INVALID
OFFSET_BEGINNING = -2
OFFSET_END = -1
OFFSET_STORED = -1000
OFFSET_INVALID = -1001
