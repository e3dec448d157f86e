#!/usr/bin/env python3
"""Admin client example (reference: examples/rdkafka_example usage of
the Admin API): create a topic, grow it, inspect configs, list groups.

    python -m librdkafka_tpu_torch.examples.admin            # in-process mock
    python -m librdkafka_tpu_torch.examples.admin host:9092  # a real bootstrap
"""
import sys

from librdkafka_tpu_torch import (AdminClient, ConfigResource, NewPartitions,
                                  NewTopic)


def main():
    bootstrap = sys.argv[1] if len(sys.argv) > 1 else ""
    conf = {"bootstrap.servers": bootstrap}
    mock = None
    if not bootstrap:
        from librdkafka_tpu_torch.mock.cluster import MockCluster
        mock = MockCluster(num_brokers=3, auto_create_topics=False)
        conf["bootstrap.servers"] = mock.bootstrap_servers()
    a = AdminClient(conf)

    for topic, fut in a.create_topics([NewTopic("demo", num_partitions=2),
                                       NewTopic("demo2", num_partitions=1)]
                                      ).items():
        try:
            fut.result(15)
            print(f"created {topic}")
        except Exception as e:
            print(f"create {topic} failed: {e}")

    a.create_partitions([NewPartitions("demo", 4)])["demo"].result(15)
    md = a.list_topics(10)
    print("topics:", {t: len(ps) for t, ps in md["topics"].items()},
          "| controller:", md["controller_id"])

    res = ConfigResource(ConfigResource.TOPIC, "demo")
    entries = a.describe_configs([res])[res].result(15)
    for name, e in sorted(entries.items()):
        print(f"  config {name} = {e.value}")

    print("groups:", a.list_groups().result(15))
    a.delete_topics(["demo2"])["demo2"].result(15)
    print("deleted demo2; topics now:",
          list(a.list_topics(10)["topics"]))
    a.close()
    if mock is not None:
        mock.stop()


if __name__ == "__main__":
    main()
