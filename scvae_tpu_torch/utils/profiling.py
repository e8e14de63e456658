"""Tracing and profiling tools (the port of ``scvae_tpu/utils/profiling.py``):

* :func:`trace` — a context manager around ``torch.profiler`` that writes
  a gzip'd Chrome trace where ``jax.profiler`` leaves its own,
  ``<log_dir>/plugins/profile/<run>/<host>.trace.json.gz``;
* :func:`summarize_trace` — the total time and count of each event name
  of the newest such trace, JAX's or the port's;
* :func:`device_memory_stats` — memory in use on each CUDA device;
* :func:`log_spaced_indices` — the epochs that get an intermediate
  analysis.

The loop's own timing is ``utils/tracing.py``'s spans, which :func:`trace`
records into its trace.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import socket
import time
from typing import Iterator

import numpy as np
import torch

from scvae_tpu_torch.utils import tracing
from scvae_tpu_torch.utils.device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[None]:
    """Record the host's operations and, on CUDA (the default unless
    ``device="cpu"``), the device's kernels, graph replays' included.  The
    device is synchronised on entry and exit, so the trace holds the
    kernels of the work queued inside it and no others.  The span recorder
    (``utils/tracing.py``) is on inside, so the program's spans show as
    ``user_annotation`` events; afterwards it is as it was."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    recording = tracing.enabled()
    with torch.profiler.profile(activities=activities) as profiler:
        tracing.enable()
        try:
            yield
        finally:
            if not recording:
                tracing.disable()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    directory = os.path.join(log_dir, "plugins", "profile",
                             time.strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(directory, exist_ok=True)
    profiler.export_chrome_trace(
        os.path.join(directory, socket.gethostname() + ".trace.json.gz"))


def summarize_trace(trace_directory: str, top: int | None = 15) -> list[dict]:
    """The ``top`` event names (None: all) of the newest
    ``*.trace.json.gz`` under ``trace_directory`` by total duration, as
    dictionaries with ``name``, ``total_ms`` and ``count``: every complete
    event (``"ph": "X"``) counts, the host's operations and the device's
    kernels alike."""
    paths = sorted(glob.glob(
        os.path.join(trace_directory, "**", "*.trace.json.gz"),
        recursive=True))
    if not paths:
        raise FileNotFoundError(f"No *.trace.json.gz under {trace_directory}")
    totals: dict[str, float] = collections.defaultdict(float)
    counts: dict[str, int] = collections.defaultdict(int)
    with gzip.open(paths[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    for event in events:
        if event.get("ph") == "X":
            name = event.get("name", "")
            totals[name] += event.get("dur", 0) / 1e3
            counts[name] += 1
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [{"name": name, "total_ms": round(ms, 3), "count": counts[name]}
            for name, ms in ranked]


def log_spaced_indices(n: int, count: int = 11) -> np.ndarray:
    """≤``count`` log-spaced indices in [0, n) — the reference's step-
    duration printing pattern."""
    if n <= 0:
        return np.array([], np.int64)
    raw = np.unique(
        np.round(np.logspace(0, np.log10(max(n, 1)), count)).astype(np.int64)
        - 1
    )
    return raw[(raw >= 0) & (raw < n)]


def device_memory_stats(device=None) -> list[dict]:
    """Memory statistics with the JAX package's keys (``device``,
    ``bytes_in_use``, ``bytes_limit``): with no ``device``, one entry per
    CUDA device (raises without a GPU); on the CPU, as JAX's CPU device,
    ``None`` for both sizes.  ``bytes_in_use`` is what PyTorch's caching
    allocator has handed out, ``bytes_limit`` the device's memory."""
    chosen = resolve_device(device)
    if chosen.type == "cpu":
        return [{"device": str(chosen), "bytes_in_use": None,
                 "bytes_limit": None}]
    indices = (range(torch.cuda.device_count()) if chosen.index is None
               else [chosen.index])
    return [{"device": f"cuda:{index}",
             "bytes_in_use": torch.cuda.memory_stats(index).get(
                 "allocated_bytes.all.current", 0),
             "bytes_limit": torch.cuda.mem_get_info(index)[1]}
            for index in indices]
