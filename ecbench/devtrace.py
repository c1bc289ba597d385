"""From a `torch.profiler` trace of the window to device numbers.

The trace is reduced to plain events: (name, on_device, start_us, end_us,
thread). Device events are the card's kernels, copies and memsets; the
device-side shadows of the benchmark's own spans (`ecbench.*`) are not
work and are dropped. Everything is clipped to the `ecbench.window` span.

  * busy: the union of device events; idle = window - busy.
  * time by kind: copies host to device (`Memcpy HtoD`), device to host
    (`Memcpy DtoH`), other copies and memsets, and kernels (the rest).
  * idle gaps by what the host thread that ran the window was doing: the
    innermost of the benchmark's spans (`ecbench.issue`, `ecbench.drain`)
    and the innermost operation inside it, or `between_calls` outside both.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable, Optional

WINDOW = "ecbench.window"
SPANS = ("ecbench.issue", "ecbench.drain")


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    device: bool
    start: float  # microseconds
    end: float
    thread: int = 0


def from_profiler(prof) -> list[Event]:
    """Plain events of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        on_dev = e.device_type != DeviceType.CPU
        out.append(Event(e.name, on_dev, float(e.time_range.start),
                         float(e.time_range.end), int(getattr(e, "thread", 0) or 0)))
    return out


def kind(name: str) -> str:
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "other_copy"
    return "kernel"


def _union(intervals: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _host_segments(events: list[Event], w0: float, w1: float) -> list[tuple[float, float, str]]:
    """The window's host thread cut into labelled segments: each moment
    belongs to the innermost event open on that thread."""
    evs = sorted((e for e in events if e.name != WINDOW and e.end > w0 and e.start < w1),
                 key=lambda e: (e.start, -e.end))
    points = []
    for i, e in enumerate(evs):
        points += [(max(e.start, w0), 1, i), (min(e.end, w1), 0, i)]
    points.sort()  # at one instant, closes before opens, parents before children
    open_: list[int] = []
    segs: list[tuple[float, float, str]] = []
    prev = w0
    for t, opens, i in points:
        if t > prev:
            segs.append((prev, t, _label([evs[j].name for j in open_])))
            prev = t
        if opens:
            open_.append(i)
        else:
            open_.remove(i)
    if w1 > prev:
        segs.append((prev, w1, "between_calls"))
    return segs


def _label(names: list[str]) -> str:
    top = next((n for n in names if n in SPANS), None)
    if top is None:
        return "between_calls"
    return top if names[-1] == top else f"{top}:{names[-1]}"


def reduce(events: list[Event], top: int = 10) -> Optional[dict]:
    """Device numbers of the traced window, in seconds; None without a
    window span. `kernel_s`, `h2d_s` and `d2h_s` are summed durations;
    `busy_s` the union of all device events."""
    win = [e for e in events if e.name == WINDOW and not e.device]
    if not win:
        return None
    w0, w1 = win[0].start, win[0].end
    thread = win[0].thread
    dev = [e for e in events if e.device and not e.name.startswith("ecbench.")]
    clipped = [(e.name, max(e.start, w0), min(e.end, w1)) for e in dev]
    clipped = [(n, a, b) for n, a, b in clipped if b > a]
    by_kind: dict[str, float] = defaultdict(float)
    by_name: dict[str, float] = defaultdict(float)
    for n, a, b in clipped:
        by_kind[kind(n)] += b - a
        by_name[n] += b - a
    busy = _union((a, b) for _, a, b in clipped)
    busy_us = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host = _host_segments([e for e in events if not e.device and e.thread == thread], w0, w1)
    idle_by: dict[str, float] = defaultdict(float)
    i = 0
    for g0, g1 in gaps:  # both sorted: one merge pass
        while i < len(host) and host[i][1] <= g0:
            i += 1
        j = i
        while j < len(host) and host[j][0] < g1:
            a, b, name = host[j]
            over = min(b, g1) - max(a, g0)
            if over > 0:
                idle_by[name] += over
            j += 1
    s = 1e-6
    return {
        "window_s": (w1 - w0) * s,
        "busy_s": busy_us * s,
        "kernel_s": by_kind["kernel"] * s,
        "h2d_s": by_kind["h2d"] * s,
        "d2h_s": by_kind["d2h"] * s,
        "other_copy_s": by_kind["other_copy"] * s,
        "device_ops": [[n, v * s] for n, v in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[n, v * s] for n, v in sorted(idle_by.items(), key=lambda x: -x[1])[:top]],
    }
