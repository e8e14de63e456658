"""The trace arithmetic on hand-made intervals and a hand-written trace."""

import gzip
import json

import pytest

from portbench import trace


def test_union_busy_gaps_span():
    intervals = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (4.0, 4.5), (6.0, 7.0)]
    assert trace.union(intervals) == [(0.0, 2.0), (3.0, 4.5), (6.0, 7.0)]
    assert trace.busy_seconds(intervals) == pytest.approx(4.5)
    assert trace.gaps(intervals) == [(2.0, 3.0), (4.5, 6.0)]
    assert trace.span(intervals) == pytest.approx(7.0)
    # idle share as device.idle_share reads it: 1 - 4.5 / 7
    assert 1 - trace.busy_seconds(intervals) / trace.span(intervals) == \
        pytest.approx(2.5 / 7)


def _write(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_load_and_breakdown(tmp_path):
    events = [  # microseconds, as torch.profiler writes them
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 1000, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 1300, "dur": 50},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1500,
         "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 2000, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 900, "dur": 2000},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 1150, "dur": 120},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]
    path = tmp_path / "host.trace.json.gz"
    _write(path, events)
    t = trace.load(str(path))
    assert [k[0] for k in t.kernels] == ["k_a", "k_b", "k_a"]
    assert trace.busy_seconds(t.device) == pytest.approx(270e-6)
    assert trace.span(t.device) == pytest.approx(1100e-6)
    assert trace.top_kernels(t) == [["k_a", pytest.approx(200e-6)],
                                    ["k_b", pytest.approx(50e-6)]]
    # gaps: 1100-1300 (middle 1200: inside cudaGraphLaunch), 1350-1500 and
    # 1520-2000 (inside "outer" only)
    idle = dict(trace.idle_by_host(t))
    assert idle["cudaGraphLaunch"] == pytest.approx(200e-6)
    assert idle["outer"] == pytest.approx(150e-6 + 480e-6)
    assert trace.newest(str(tmp_path)) == str(path)
