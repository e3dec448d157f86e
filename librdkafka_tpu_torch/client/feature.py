"""Broker feature negotiation (reference: src/rdkafka_feature.c, 474 LoC).

Maps a broker's advertised ApiVersion ranges to a feature set
(RD_KAFKA_FEATURE_*, rdkafka_feature.h:39-83) that gates what the
client emits: MessageSet version, request versions, ZSTD, idempotence.
When ApiVersions is unsupported (pre-0.10 brokers close the connection
on unknown requests) or disabled (``api.version.request=false``), the
``broker.version.fallback`` property synthesizes an assumed version map
(reference rd_kafka_get_legacy_ApiVersions)."""
from __future__ import annotations

from ..protocol.proto import ApiKey

# feature flags (names follow RD_KAFKA_FEATURE_*)
MSGVER1 = "MSGVER1"                  # magic 1 msgsets (timestamps)
MSGVER2 = "MSGVER2"                  # magic 2 record batches
APIVERSION = "APIVERSION"
BROKER_GROUP_COORDINATOR = "BROKER_GROUP_COORDINATOR"
BROKER_BALANCED_CONSUMER = "BROKER_BALANCED_CONSUMER"
THROTTLETIME = "THROTTLETIME"
OFFSET_TIME = "OFFSET_TIME"
IDEMPOTENT_PRODUCER = "IDEMPOTENT_PRODUCER"
SASL_AUTH_REQ = "SASL_AUTH_REQ"
LZ4 = "LZ4"
ZSTD = "ZSTD"

#: feature → [(api, min_version_required)] (rdkafka_feature.c feature map)
_FEATURE_REQS = {
    MSGVER1: [(ApiKey.Produce, 2), (ApiKey.Fetch, 2)],
    MSGVER2: [(ApiKey.Produce, 3), (ApiKey.Fetch, 4)],
    APIVERSION: [(ApiKey.ApiVersions, 0)],
    BROKER_GROUP_COORDINATOR: [(ApiKey.FindCoordinator, 0)],
    BROKER_BALANCED_CONSUMER: [(ApiKey.FindCoordinator, 0),
                               (ApiKey.OffsetCommit, 1),
                               (ApiKey.OffsetFetch, 1),
                               (ApiKey.JoinGroup, 0),
                               (ApiKey.SyncGroup, 0),
                               (ApiKey.Heartbeat, 0),
                               (ApiKey.LeaveGroup, 0)],
    THROTTLETIME: [(ApiKey.Produce, 1), (ApiKey.Fetch, 1)],
    OFFSET_TIME: [(ApiKey.ListOffsets, 1)],
    IDEMPOTENT_PRODUCER: [(ApiKey.InitProducerId, 0)],
    SASL_AUTH_REQ: [(ApiKey.SaslHandshake, 1),
                    (ApiKey.SaslAuthenticate, 0)],
    LZ4: [(ApiKey.FindCoordinator, 0)],     # >=0.8.3 (like reference)
    ZSTD: [(ApiKey.Produce, 7), (ApiKey.Fetch, 10)],
}


def features_from_api_versions(api_versions: dict[int, int]) -> set[str]:
    """{api_key: max_version} → feature set (rd_kafka_features_check)."""
    out = set()
    for feature, reqs in _FEATURE_REQS.items():
        if all(int(api) in api_versions and api_versions[int(api)] >= minv
               for api, minv in reqs):
            out.add(feature)
    return out


#: broker.version.fallback → assumed {api_key: max_version}
#: (reference rd_kafka_get_legacy_ApiVersions, rdkafka_feature.c)
def fallback_api_versions(version: str) -> dict[int, int]:
    v = _parse_version(version)
    av: dict[int, int] = {}

    def put(api, maxv):
        av[int(api)] = maxv

    # 0.8.x baseline
    put(ApiKey.Produce, 0)
    put(ApiKey.Fetch, 0)
    put(ApiKey.ListOffsets, 0)
    put(ApiKey.Metadata, 0)
    put(ApiKey.OffsetCommit, 0)
    put(ApiKey.OffsetFetch, 0)
    if v >= (0, 8, 3):
        put(ApiKey.FindCoordinator, 0)
        put(ApiKey.OffsetFetch, 1)
    if v >= (0, 9, 0):
        put(ApiKey.Produce, 1)
        put(ApiKey.Fetch, 1)
        put(ApiKey.OffsetCommit, 2)
        put(ApiKey.JoinGroup, 0)
        put(ApiKey.SyncGroup, 0)
        put(ApiKey.Heartbeat, 0)
        put(ApiKey.LeaveGroup, 0)
        put(ApiKey.ListGroups, 0)
        put(ApiKey.DescribeGroups, 0)
    if v >= (0, 10, 0):
        put(ApiKey.Produce, 2)
        put(ApiKey.Fetch, 2)
        put(ApiKey.ApiVersions, 0)
        put(ApiKey.SaslHandshake, 0)
    if v >= (0, 10, 1):
        put(ApiKey.Fetch, 3)
        put(ApiKey.ListOffsets, 1)
        put(ApiKey.JoinGroup, 1)
        put(ApiKey.CreateTopics, 0)
        put(ApiKey.DeleteTopics, 0)
    if v >= (0, 10, 2):
        put(ApiKey.OffsetFetch, 2)
        put(ApiKey.Metadata, 2)
    if v >= (0, 11, 0):
        put(ApiKey.Produce, 3)
        put(ApiKey.Fetch, 4)
        put(ApiKey.InitProducerId, 0)
        put(ApiKey.SaslHandshake, 1)
        put(ApiKey.SaslAuthenticate, 0)
        put(ApiKey.CreatePartitions, 0)
        put(ApiKey.DescribeConfigs, 0)
        put(ApiKey.AlterConfigs, 0)
        put(ApiKey.DeleteGroups, 0)
    if v >= (1, 0, 0):
        put(ApiKey.Metadata, 5)
        put(ApiKey.FindCoordinator, 1)
        put(ApiKey.JoinGroup, 2)
        put(ApiKey.SyncGroup, 1)
        put(ApiKey.Heartbeat, 1)
        put(ApiKey.LeaveGroup, 1)
        put(ApiKey.CreateTopics, 2)
        put(ApiKey.DeleteTopics, 1)
        put(ApiKey.CreatePartitions, 1)
        put(ApiKey.DescribeConfigs, 1)
        put(ApiKey.InitProducerId, 1)
    return av


def _parse_version(s: str) -> tuple:
    parts = []
    for tok in s.strip().split("."):
        digits = "".join(ch for ch in tok if ch.isdigit())
        if not digits:
            break
        parts.append(int(digits))
    while len(parts) < 3:
        parts.append(0)
    return tuple(parts[:3])


def pick_version(api_versions: dict[int, int], api: ApiKey,
                 ours: int) -> int:
    """min(our max, broker max); broker-unknown APIs assume ours."""
    theirs = api_versions.get(int(api))
    return ours if theirs is None else min(ours, theirs)
