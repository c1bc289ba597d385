"""CLI command registry (the weed/command Command-struct pattern): each
command module registers a `Command`; `seaweedfs_tpu_torch.__main__`
dispatches."""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Callable


@dataclass
class Command:
    name: str
    help: str
    configure: Callable[[argparse.ArgumentParser], None]
    run: Callable[[argparse.Namespace], int]


_REGISTRY: dict[str, Command] = {}


def register(cmd: Command) -> Command:
    _REGISTRY[cmd.name] = cmd
    return cmd


def commands() -> dict[str, Command]:
    from seaweedfs_tpu_torch.command import bench_tools, local, servers, sync  # noqa: F401 — registers

    return dict(_REGISTRY)
