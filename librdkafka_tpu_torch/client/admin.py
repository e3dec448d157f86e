"""Admin client (reference: src/rdkafka_admin.c, 2734 LoC).

Each admin operation runs through the reference's generic async worker
state machine (states documented rdkafka_admin.c:91-177, worker at
:645):

    INIT → WAIT_BROKER / WAIT_CONTROLLER → CONSTRUCT_REQUEST
         → WAIT_RESPONSE → (retry on retriable/NOT_CONTROLLER) → DONE

Results are delivered through per-item ``concurrent.futures.Future``
objects (the Pythonic analog of the reference's result events on the
app queue): ``create_topics`` returns ``{topic: Future}``, each future
resolving to ``None`` on success or raising :class:`KafkaException`.

Targets (reference rd_kafka_admin_targets): topic mutation ops go to
the cluster controller (discovered via Metadata), config ops for BROKER
resources to that specific broker, group ops to the group coordinator
(FindCoordinator), everything else to any up broker.
"""
from __future__ import annotations

import time
from concurrent.futures import Future
from typing import Callable, Optional

from ..protocol.proto import ApiKey
from .broker import Request
from .conf import Conf
from .errors import Err, KafkaError, KafkaException

# Kafka AdminResourceType values
RESOURCE_UNKNOWN = 0
RESOURCE_ANY = 1
RESOURCE_TOPIC = 2
RESOURCE_GROUP = 3
RESOURCE_BROKER = 4

# Per-item response errors the worker retries rather than surfaces
# (reference: rd_kafka_admin_worker retriable response handling). NOTE:
# narrower than errors.RETRIABLE_ERRS — e.g. UNKNOWN_TOPIC_OR_PART is a
# final answer for admin ops.
ADMIN_RETRIABLE = frozenset({
    Err.NOT_CONTROLLER, Err.COORDINATOR_NOT_AVAILABLE,
    Err.COORDINATOR_LOAD_IN_PROGRESS, Err.NOT_COORDINATOR,
    Err.REQUEST_TIMED_OUT, Err.NETWORK_EXCEPTION,
})

CONFIG_SOURCE_NAMES = {
    0: "UNKNOWN_CONFIG", 1: "DYNAMIC_TOPIC_CONFIG",
    2: "DYNAMIC_BROKER_CONFIG", 3: "DYNAMIC_DEFAULT_BROKER_CONFIG",
    4: "STATIC_BROKER_CONFIG", 5: "DEFAULT_CONFIG",
}


class NewTopic:
    """Topic specification for create_topics (rd_kafka_NewTopic_t)."""

    def __init__(self, topic: str, num_partitions: int = 1,
                 replication_factor: int = -1,
                 replica_assignment: Optional[list] = None,
                 config: Optional[dict] = None):
        self.topic = topic
        self.num_partitions = num_partitions
        self.replication_factor = replication_factor
        self.replica_assignment = replica_assignment or []
        self.config = dict(config or {})

    def __repr__(self):
        return f"NewTopic({self.topic}, np={self.num_partitions})"


class NewPartitions:
    """Partition-count increase for create_partitions
    (rd_kafka_NewPartitions_t)."""

    def __init__(self, topic: str, new_total_count: int,
                 replica_assignment: Optional[list] = None):
        self.topic = topic
        self.new_total_count = new_total_count
        self.replica_assignment = replica_assignment or []


class ConfigEntry:
    """One config row from describe_configs (rd_kafka_ConfigEntry_t)."""

    __slots__ = ("name", "value", "source", "is_read_only", "is_sensitive",
                 "is_synonym", "synonyms")

    def __init__(self, name, value, source=0, is_read_only=False,
                 is_sensitive=False, is_synonym=False, synonyms=None):
        self.name = name
        self.value = value
        self.source = source
        self.is_read_only = is_read_only
        self.is_sensitive = is_sensitive
        self.is_synonym = is_synonym
        self.synonyms = synonyms or []

    def __repr__(self):
        return f"ConfigEntry({self.name}={self.value})"


class ConfigResource:
    """Target of describe/alter_configs (rd_kafka_ConfigResource_t)."""

    TOPIC = RESOURCE_TOPIC
    BROKER = RESOURCE_BROKER
    GROUP = RESOURCE_GROUP

    def __init__(self, restype: int, name: str,
                 set_config: Optional[dict] = None):
        self.restype = restype
        self.name = name
        self.set_config_dict = dict(set_config or {})

    def set_config(self, name: str, value: str):
        self.set_config_dict[name] = value
        return self

    def __hash__(self):
        return hash((self.restype, self.name))

    def __eq__(self, other):
        return (isinstance(other, ConfigResource)
                and (self.restype, self.name) == (other.restype, other.name))

    def __repr__(self):
        return f"ConfigResource({self.restype}, {self.name!r})"


class _AdminWorker:
    """One in-flight admin operation (reference rd_kafka_admin_worker,
    rdkafka_admin.c:645). Drives target lookup + request + retry with
    timers on the rk main thread; resolves futures from the broker
    thread that receives the response."""

    def __init__(self, rk, *, api: ApiKey, body: dict, target: str,
                 resolve: Callable, fail_all: Callable,
                 timeout_s: float, group: Optional[str] = None):
        self.rk = rk
        self.api = api
        self.body = body
        self.target = target          # "controller" | "any" | "coordinator"
        self.group = group
        self.resolve = resolve        # resolve(resp) -> None (sets futures)
        self.fail_all = fail_all      # fail_all(KafkaError)
        self.deadline = time.monotonic() + timeout_s
        self.state = "INIT"
        self._timer = None
        self._step()                  # enter the FSM

    # ------------------------------------------------------------- states --
    def _retry_soon(self, delay: float = 0.1):
        if time.monotonic() >= self.deadline:
            self.fail_all(KafkaError(Err._TIMED_OUT,
                                     f"{self.api.name} admin op timed out "
                                     f"in state {self.state}"))
            return
        self._timer = self.rk.timers.add(delay, self._step, once=True)

    def _step(self):
        if self.rk.terminating:
            self.fail_all(KafkaError(Err._DESTROY, "client terminating"))
            return
        broker = self._pick_broker()
        if broker is None:
            # WAIT_BROKER / WAIT_CONTROLLER: need metadata or a connection
            self.state = ("WAIT_CONTROLLER" if self.target == "controller"
                          else "WAIT_BROKER")
            self.rk.metadata_refresh(f"admin {self.api.name}")
            self._retry_soon()
            return
        self.state = "WAIT_RESPONSE"
        broker.enqueue_request(Request(self.api, self.body,
                                       cb=self._on_response))

    def _pick_broker(self):
        if self.target == "any":
            return self.rk.any_up_broker()
        if self.target == "controller":
            cid = self.rk.metadata.get("controller_id", -1)
            if cid < 0:
                return None
            b = self.rk.brokers.get(cid)
        elif self.target == "coordinator":
            b = self._coord_broker
        elif self.target.startswith("broker:"):
            b = self.rk.brokers.get(int(self.target[7:]))
        else:
            return None
        if b is None:
            return None
        if not b.is_up():
            # sparse connections: this broker may be idle-unconnected;
            # demand a connection and keep polling
            b.schedule_connect()
            return None
        return b

    _coord_broker = None

    def _on_response(self, err, resp):
        if err is not None:
            if err.retriable and time.monotonic() < self.deadline:
                self._retry_soon(self.rk.conf.get("retry.backoff.ms") / 1e3)
            else:
                self.fail_all(err)
            return
        try:
            needs_retry = self.resolve(resp)
        except Exception as e:            # never leave futures pending
            self.fail_all(KafkaError(Err._FAIL, f"result parse: {e!r}"))
            return
        if needs_retry:
            # some items returned retriable errors (NOT_CONTROLLER etc);
            # re-run the FSM — done futures are skipped on re-resolve
            if self.target == "controller":
                self.rk.metadata_refresh("admin NOT_CONTROLLER")
            self._retry_soon(self.rk.conf.get("retry.backoff.ms") / 1e3)


def _start_coordinator_worker(rk, group: str, worker_kwargs: dict):
    """FindCoordinator first, then run the worker against it
    (reference WAIT_BROKER with coordinator lookup)."""
    w = _AdminWorker.__new__(_AdminWorker)

    def do_find():
        b = rk.any_up_broker()
        if b is None:
            if time.monotonic() >= w.deadline:
                w.fail_all(KafkaError(Err._TIMED_OUT,
                                      "no broker for FindCoordinator"))
            else:
                rk.metadata_refresh("admin coordinator lookup")
                rk.timers.add(0.1, do_find, once=True)
            return
        b.enqueue_request(Request(
            ApiKey.FindCoordinator,
            {"key": group, "key_type": 0},
            cb=on_coord))

    def on_coord(err, resp):
        if err is None and resp["error_code"] == 0:
            nid = resp["node_id"]
            coord = rk.brokers.get(nid)
            w._coord_broker = coord
            w.__init__(rk, **worker_kwargs)
        elif time.monotonic() < w.deadline:
            rk.timers.add(0.25, do_find, once=True)
        else:
            w.fail_all(err or KafkaError(Err.from_wire(resp["error_code"]),
                                         "FindCoordinator failed"))

    # pre-init the fields fail paths need before __init__ runs
    w.rk = rk
    w.deadline = time.monotonic() + worker_kwargs["timeout_s"]
    w.fail_all = worker_kwargs["fail_all"]
    w.state = "WAIT_COORDINATOR"
    do_find()
    return w


class AdminClient:
    """App-facing admin API (reference: the rd_kafka_CreateTopics family,
    rdkafka.h admin section). Owns its own client instance like any
    producer/consumer handle; all methods are async and return dicts of
    futures keyed the way confluent-kafka does."""

    def __init__(self, conf):
        from .kafka import Kafka, PRODUCER
        if isinstance(conf, dict):
            c = Conf()
            c.update(conf)
            conf = c
        # admin handles never produce: force idempotence off
        conf.set("enable.idempotence", False)
        self._rk = Kafka(conf, PRODUCER)

    # --------------------------------------------------------- lifecycle --
    def poll(self, timeout: float = 0.0) -> int:
        return self._rk.poll(timeout)

    def close(self, timeout: float = 5.0):
        self._rk.close(timeout)

    @property
    def rk(self):
        return self._rk

    # -------------------------------------------------------- operations --
    @staticmethod
    def _futures(keys) -> dict:
        return {k: Future() for k in keys}

    @staticmethod
    def _fail_all(futs):
        def fail(err: KafkaError):
            for f in futs.values():
                if not f.done():
                    f.set_exception(KafkaException(err))
        return fail

    @staticmethod
    def _set(fut: Future, err_code: int, err_msg: Optional[str],
             value=None) -> bool:
        """Resolve one per-item result. Returns True when the item hit an
        admin-retriable error and was left pending for the worker to
        retry (the worker's deadline eventually fails it)."""
        if fut.done():
            return False
        err = Err.from_wire(err_code)
        if err in ADMIN_RETRIABLE:
            return True
        if err != Err.NO_ERROR:
            fut.set_exception(KafkaException(
                KafkaError(err, err_msg or err.name)))
        else:
            fut.set_result(value)
        return False

    def create_topics(self, new_topics: list[NewTopic], *,
                      operation_timeout: float = 30.0,
                      validate_only: bool = False) -> dict[str, Future]:
        """CreateTopics via the controller (rdkafka_admin.c
        rd_kafka_CreateTopics, :1296)."""
        futs = self._futures(t.topic for t in new_topics)
        body = {
            "topics": [{
                "topic": t.topic,
                "num_partitions": t.num_partitions,
                "replication_factor": t.replication_factor,
                "replica_assignment": [
                    {"partition": i, "replicas": reps}
                    for i, reps in enumerate(t.replica_assignment)],
                "configs": [{"name": k, "value": v}
                            for k, v in t.config.items()],
            } for t in new_topics],
            "timeout": int(operation_timeout * 1000),
            "validate_only": validate_only,
        }

        def resolve(resp):
            retry = False
            for r in resp["topics"]:
                retry |= self._set(futs[r["topic"]], r["error_code"],
                                   r.get("error_message"))
            return retry

        _AdminWorker(self._rk, api=ApiKey.CreateTopics, body=body,
                     target="controller", resolve=resolve,
                     fail_all=self._fail_all(futs),
                     timeout_s=operation_timeout)
        return futs

    def delete_topics(self, topics: list[str], *,
                      operation_timeout: float = 30.0) -> dict[str, Future]:
        futs = self._futures(topics)
        body = {"topics": list(topics),
                "timeout": int(operation_timeout * 1000)}

        def resolve(resp):
            retry = False
            for r in resp["topics"]:
                retry |= self._set(futs[r["topic"]], r["error_code"], None)
            return retry

        _AdminWorker(self._rk, api=ApiKey.DeleteTopics, body=body,
                     target="controller", resolve=resolve,
                     fail_all=self._fail_all(futs),
                     timeout_s=operation_timeout)
        return futs

    def create_partitions(self, new_parts: list[NewPartitions], *,
                          operation_timeout: float = 30.0,
                          validate_only: bool = False) -> dict[str, Future]:
        futs = self._futures(p.topic for p in new_parts)
        body = {
            "topics": [{
                "topic": p.topic,
                "count": p.new_total_count,
                "assignment": [{"broker_ids": bids}
                               for bids in p.replica_assignment],
            } for p in new_parts],
            "timeout": int(operation_timeout * 1000),
            "validate_only": validate_only,
        }

        def resolve(resp):
            retry = False
            for r in resp["topics"]:
                retry |= self._set(futs[r["topic"]], r["error_code"],
                                   r.get("error_message"))
            return retry

        _AdminWorker(self._rk, api=ApiKey.CreatePartitions, body=body,
                     target="controller", resolve=resolve,
                     fail_all=self._fail_all(futs),
                     timeout_s=operation_timeout)
        return futs

    def describe_configs(self, resources: list[ConfigResource], *,
                         operation_timeout: float = 30.0,
                         include_synonyms: bool = False
                         ) -> dict[ConfigResource, Future]:
        futs = self._futures(resources)
        by_key = {(r.restype, r.name): f for r, f in futs.items()}
        body = {
            "resources": [{"resource_type": r.restype,
                           "resource_name": r.name,
                           "config_names": None}
                          for r in resources],
            "include_synonyms": include_synonyms,
        }
        # BROKER resources must be asked of that broker itself
        target = "any"
        if (len(resources) == 1
                and resources[0].restype == RESOURCE_BROKER
                and resources[0].name.lstrip("-").isdigit()):
            target = f"broker:{resources[0].name}"

        def resolve(resp):
            retry = False
            for r in resp["resources"]:
                fut = by_key.get((r["resource_type"], r["resource_name"]))
                if fut is None:
                    continue
                entries = {
                    e["name"]: ConfigEntry(
                        e["name"], e["value"], e.get("source", 0),
                        e.get("read_only", False), e.get("sensitive", False),
                        synonyms=[ConfigEntry(s["name"], s["value"],
                                              s.get("source", 0),
                                              is_synonym=True)
                                  for s in e.get("synonyms", [])])
                    for e in r["entries"]}
                retry |= self._set(fut, r["error_code"],
                                   r.get("error_message"), entries)
            return retry

        _AdminWorker(self._rk, api=ApiKey.DescribeConfigs, body=body,
                     target=target, resolve=resolve,
                     fail_all=self._fail_all(futs),
                     timeout_s=operation_timeout)
        return futs

    def alter_configs(self, resources: list[ConfigResource], *,
                      operation_timeout: float = 30.0,
                      validate_only: bool = False
                      ) -> dict[ConfigResource, Future]:
        futs = self._futures(resources)
        by_key = {(r.restype, r.name): f for r, f in futs.items()}
        body = {
            "resources": [{
                "resource_type": r.restype,
                "resource_name": r.name,
                "entries": [{"name": k, "value": v}
                            for k, v in r.set_config_dict.items()],
            } for r in resources],
            "validate_only": validate_only,
        }

        def resolve(resp):
            retry = False
            for r in resp["resources"]:
                fut = by_key.get((r["resource_type"], r["resource_name"]))
                if fut is not None:
                    retry |= self._set(fut, r["error_code"],
                                       r.get("error_message"))
            return retry

        _AdminWorker(self._rk, api=ApiKey.AlterConfigs, body=body,
                     target="controller", resolve=resolve,
                     fail_all=self._fail_all(futs),
                     timeout_s=operation_timeout)
        return futs

    # ---------------------------------------------------------- group ops --
    def list_groups(self, *, operation_timeout: float = 30.0) -> Future:
        """ListGroups against any up broker; resolves to
        [(group_id, protocol_type)]."""
        fut = Future()
        futs = {"_": fut}

        def resolve(resp):
            err = Err.from_wire(resp["error_code"])
            if err != Err.NO_ERROR:
                fut.set_exception(KafkaException(KafkaError(err)))
            else:
                fut.set_result([(g["group_id"], g["protocol_type"])
                                for g in resp["groups"]])

        _AdminWorker(self._rk, api=ApiKey.ListGroups, body={},
                     target="any", resolve=resolve,
                     fail_all=self._fail_all(futs),
                     timeout_s=operation_timeout)
        return fut

    def describe_groups(self, groups: list[str], *,
                        operation_timeout: float = 30.0
                        ) -> dict[str, Future]:
        futs = self._futures(groups)

        def resolve(resp):
            retry = False
            for g in resp["groups"]:
                retry |= self._set(futs[g["group_id"]], g["error_code"],
                                   None, {
                    "state": g["state"],
                    "protocol_type": g["protocol_type"],
                    "protocol": g["protocol"],
                    "members": g["members"],
                })
            return retry

        for group in groups:
            _start_coordinator_worker(self._rk, group, dict(
                api=ApiKey.DescribeGroups, body={"groups": [group]},
                target="coordinator", group=group, resolve=resolve,
                fail_all=self._fail_all(
                    {group: futs[group]}),
                timeout_s=operation_timeout))
        return futs

    def delete_groups(self, groups: list[str], *,
                      operation_timeout: float = 30.0) -> dict[str, Future]:
        futs = self._futures(groups)

        def resolve(resp):
            retry = False
            for g in resp["results"]:
                retry |= self._set(futs[g["group_id"]], g["error_code"], None)
            return retry

        for group in groups:
            _start_coordinator_worker(self._rk, group, dict(
                api=ApiKey.DeleteGroups, body={"groups": [group]},
                target="coordinator", group=group, resolve=resolve,
                fail_all=self._fail_all({group: futs[group]}),
                timeout_s=operation_timeout))
        return futs

    # ------------------------------------------------------------ metadata --
    def list_topics(self, timeout: float = 10.0) -> dict:
        """Synchronous metadata snapshot: {topic: {partition: leader}}
        (reference rd_kafka_metadata). Delegates to the shared client
        implementation (Kafka.list_topics)."""
        return self._rk.list_topics(timeout)
