"""Message-queue shell commands — mq.topic.list / mq.topic.configure /
mq.broker.list, after upstream's weed/shell/command_mq_topic_*.go. Brokers are discovered through
the master's cluster-node list (they announce with node_type=broker).
"""

from __future__ import annotations

from typing import TextIO

from seaweedfs_tpu_torch.mq.broker import BrokerClient
from seaweedfs_tpu_torch.shell import CommandEnv, ShellCommand, ShellError, parse_flags, register


def _broker_of(env: CommandEnv) -> str:
    brokers = env.master_call("ListClusterNodes", {}).get("brokers", [])
    if not brokers:
        raise ShellError(
            "no mq broker announced to the master (start `seaweedfs_tpu_torch mq.broker`)"
        )
    return brokers[0]["grpc_address"] or brokers[0]["http_address"]


def do_mq_broker_list(args: list[str], env: CommandEnv, w: TextIO) -> None:
    brokers = env.master_call("ListClusterNodes", {}).get("brokers", [])
    for b in brokers:
        w.write(f"broker {b.get('grpc_address') or b.get('http_address')}\n")
    w.write(f"total {len(brokers)} brokers\n")


register(
    ShellCommand(
        "mq.broker.list",
        "mq.broker.list\n\tlist mq brokers announced to the master",
        do_mq_broker_list,
    )
)


def do_mq_topic_list(args: list[str], env: CommandEnv, w: TextIO) -> None:
    fl = parse_flags(args, namespace="default")
    with BrokerClient(_broker_of(env)) as bc:
        topics = bc.list_topics(namespace=fl.namespace)
    for t in topics:
        w.write(
            f"{fl.namespace}/{t['topic']}: {t.get('partition_count', 1)} partitions\n"
        )
    w.write(f"total {len(topics)} topics\n")


register(
    ShellCommand(
        "mq.topic.list",
        "mq.topic.list [-namespace default]\n\tlist topics on the mq broker",
        do_mq_topic_list,
    )
)


def do_mq_topic_configure(args: list[str], env: CommandEnv, w: TextIO) -> None:
    fl = parse_flags(args, namespace="default", topic="", partitions=4)
    if not fl.topic:
        raise ShellError("mq.topic.configure -topic <name> [-partitions 4]")
    with BrokerClient(_broker_of(env)) as bc:
        bc.configure_topic(
            fl.topic, partition_count=fl.partitions, namespace=fl.namespace
        )
    w.write(
        f"mq.topic.configure: {fl.namespace}/{fl.topic} -> {fl.partitions} partitions\n"
    )


register(
    ShellCommand(
        "mq.topic.configure",
        "mq.topic.configure -topic <name> [-namespace default] [-partitions 4]\n"
        "\tcreate or re-partition a topic",
        do_mq_topic_configure,
    )
)
