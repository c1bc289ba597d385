"""Notification, after upstream's weed/notification/ (kafka/sqs/pubsub
sinks for filer metadata events).

The two concrete queues need no message broker: one is in-memory (tests,
in-process consumers), the other an append-only JSONL log file (durable
handoff to external shippers). The interface matches upstream's: one `send_message(key, message)` per filer event.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Optional


class NotificationQueue:
    """Target for filer metadata event notifications."""

    def send_message(self, key: str, message: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryQueue(NotificationQueue):
    def __init__(self):
        self.messages: list[tuple[str, dict]] = []
        self._lock = threading.Lock()
        self._subscribers: list[Callable[[str, dict], None]] = []

    def send_message(self, key: str, message: dict) -> None:
        with self._lock:
            self.messages.append((key, message))
            subs = list(self._subscribers)
        for fn in subs:
            fn(key, message)

    def subscribe(self, fn: Callable[[str, dict], None]) -> None:
        with self._lock:
            self._subscribers.append(fn)


class LogFileQueue(NotificationQueue):
    """Durable JSONL event log (one file, append-only)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # weedlint: ignore[open-no-ctx] queue-lifetime append handle
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()

    def send_message(self, key: str, message: dict) -> None:
        with self._lock:
            self._f.write(json.dumps({"key": key, "message": message}) + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()


def make_queue(kind: str, path: str = "") -> Optional[NotificationQueue]:
    """Factory, the `[notification.*]` filer.toml seam of the reference."""
    if kind in ("", "none"):
        return None
    if kind == "memory":
        return MemoryQueue()
    if kind == "log":
        if not path:
            raise ValueError("log notification queue needs a file path")
        return LogFileQueue(path)
    raise ValueError(f"unknown notification queue {kind!r} (memory|log|none)")
