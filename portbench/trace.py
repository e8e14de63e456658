"""Reading a ``torch.profiler`` Chrome trace: the device's operations as
intervals, the time at least one of them ran, the idle gaps between them
and what the host was doing in each.

``utils/profiling.summarize_trace`` of the program sums events by name
with no intervals, host and device alike, so it cannot give an idle share;
the benchmark reads the trace itself.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import gzip
import heapq
import json
import os

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver",
                   "python_function", "user_annotation")
NAME_LENGTH = 120


@dataclasses.dataclass
class Trace:
    """Times in seconds from the trace's first event."""

    kernels: list[tuple[str, float, float]]  # (name, start, duration)
    device: list[tuple[float, float]]  # every device operation's interval
    host: list[tuple[str, float, float]]  # (name, start, end)


def newest(directory: str) -> str:
    paths = sorted(glob.glob(os.path.join(directory, "**", "*.trace.json*"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {directory}")
    return paths[-1]


def load(path: str) -> Trace:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e]
    origin = min((float(e["ts"]) for e in complete), default=0.0)
    kernels, device, host = [], [], []
    for e in complete:
        start = (float(e["ts"]) - origin) * 1e-6
        duration = float(e.get("dur", 0.0)) * 1e-6
        category = e.get("cat", "")
        if category in DEVICE_CATEGORIES:
            device.append((start, start + duration))
            if category == "kernel":
                kernels.append((e.get("name", ""), start, duration))
        elif category in HOST_CATEGORIES:
            host.append((e.get("name", ""), start, start + duration))
    return Trace(kernels=kernels, device=device, host=host)


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The intervals merged where they overlap or touch, in order."""
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_seconds(intervals: list[tuple[float, float]]) -> float:
    return sum(b - a for a, b in union(intervals))


def span(intervals: list[tuple[float, float]]) -> float:
    """Seconds from the first operation's start to the last one's end: the
    traced window, without the profiler's own start and stop."""
    return max(b for _, b in intervals) - min(a for a, _ in intervals)


def gaps(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The idle intervals between the device's first and last operation."""
    merged = union(intervals)
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]


def short(name: str) -> str:
    return name if len(name) <= NAME_LENGTH else name[:NAME_LENGTH - 3] + "..."


def top_kernels(trace: Trace, count: int = 10) -> list[list]:
    """[name, seconds] of the kernels that took the most device time."""
    totals: dict[str, float] = collections.defaultdict(float)
    for name, _, duration in trace.kernels:
        totals[short(name)] += duration
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:count]
    return [[name, seconds] for name, seconds in ranked]


def idle_by_host(trace: Trace, count: int = 10) -> list[list]:
    """[what the host was doing, seconds] over the device's idle gaps: each
    gap goes to the innermost host event that covers its middle (of those,
    the one that started last), or to "host idle" when none does."""
    host = sorted(trace.host, key=lambda e: e[1])
    totals: dict[str, float] = collections.defaultdict(float)
    open_events: list[tuple[float, float, str]] = []  # (-start, end, name)
    i = 0
    for a, b in gaps(trace.device):  # in order, so the middles rise
        middle = 0.5 * (a + b)
        while i < len(host) and host[i][1] <= middle:
            name, begin, end = host[i]
            heapq.heappush(open_events, (-begin, end, name))
            i += 1
        # an event that ended before this middle ends before every later one
        while open_events and open_events[0][1] < middle:
            heapq.heappop(open_events)
        label = short(open_events[0][2]) if open_events else "host idle"
        totals[label] += b - a
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:count]
    return [[name, seconds] for name, seconds in ranked]
