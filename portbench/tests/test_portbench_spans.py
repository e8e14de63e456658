"""The readers of the program's spans on a hand-written trace: device
operations go to the loop phase whose annotation they start in, and a
trace without the spans (a program that lacks them) reads nothing."""

import gzip
import json

import pytest

from portbench import spans, trace
from portbench.harness import Run
from portbench.spec import Benchmark

STEPS = 4


def _trace(tmp_path, events):
    path = tmp_path / "host.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": 10**18}, f)
    return trace.load(str(path))


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# Microseconds: the profiled epoch's training pass (1000-2000), its
# evaluation (2100-3000) and its checkpoint (3100-3200).
EVENTS = [
    _x("user_annotation", "epoch.train", 1000, 1000),
    _x("gpu_user_annotation", "epoch.train", 1010, 980),
    _x("cuda_runtime", "cudaGraphLaunch", 1005, 20),
    _x("kernel", "step_kernel_a", 1030, 300),  # a replay's kernels
    _x("kernel", "step_kernel_b", 1400, 500),
    _x("gpu_memcpy", "Memcpy DtoH", 1950, 10),  # the lower bound's fetch
    _x("user_annotation", "epoch.evaluate", 2100, 900),
    _x("kernel", "eval_kernel", 2200, 700),
    _x("user_annotation", "epoch.checkpoint", 3100, 100),
    _x("gpu_memcpy", "Memcpy DtoH", 3110, 50),
    # launched in the training pass, but it starts after the pass ended:
    # only a pass that ends without waiting for the device leaves one
    _x("kernel", "late_kernel", 2050, 20),
    _x("kernel", "stray_kernel", 500, 40),  # in no span
]


def _run(t):
    return Run(workload="w", spec={}, traffic={}, reference=None, cells=8,
               batch=2, steps_per_epoch=STEPS, setup_seconds=1.0,
               first_epoch_seconds=1.0, window_seconds=1.0, window_epochs=1,
               window_epoch_seconds=[0.5], window_peak_bytes=0, trace=t)


def test_phases_and_the_device_time_inside_them(tmp_path):
    t = _trace(tmp_path, EVENTS)
    origin = 500e-6  # the first event's ts
    (train,) = spans.phases(t, "epoch.train")  # not the device's copy
    assert train == pytest.approx((1000e-6 - origin, 2000e-6 - origin))
    assert spans.device_seconds_in(t, [train]) == pytest.approx(810e-6)
    evaluate = spans.phases(t, "epoch.evaluate")
    assert spans.device_seconds_in(t, evaluate) == pytest.approx(700e-6)
    both = [train, *evaluate, *spans.phases(t, "epoch.checkpoint")]
    everything = sum(b - a for a, b in t.device)
    # what no phase holds: the late and the stray kernel
    assert everything - spans.device_seconds_in(t, both) == pytest.approx(
        60e-6)


def test_readers(tmp_path):
    benchmark = Benchmark()
    run = _run(_trace(tmp_path, EVENTS))
    train = benchmark.reader("train.device_ms_per_step").read(run)
    evaluation = benchmark.reader("eval.device_ms_per_epoch").read(run)
    assert train == pytest.approx(810e-3 / STEPS)
    assert evaluation == pytest.approx(700e-3)
    # the device_ms readers that cover every kernel, against the split
    trunk = benchmark.reader("trunk.device_ms_per_step").read(run)
    kernels = sum(d for _, _, d in run.trace.kernels) * 1e3
    assert trunk * STEPS == pytest.approx(kernels)
    assert train * STEPS + evaluation == pytest.approx(
        kernels + 10e-3 - 20e-3 - 40e-3)  # + the fetch, − late, − stray


def test_two_profiled_epochs_average(tmp_path):
    later = [dict(e, ts=e["ts"] + 5000) for e in EVENTS[:8]]
    run = _run(_trace(tmp_path, EVENTS + later))
    benchmark = Benchmark()
    assert benchmark.reader("train.device_ms_per_step").read(run) == (
        pytest.approx(810e-3 / STEPS))
    assert benchmark.reader("eval.device_ms_per_epoch").read(run) == (
        pytest.approx(700e-3))


@pytest.mark.parametrize("names", [(), ("epoch.evaluate",)])
def test_a_program_without_the_spans_reads_nothing(tmp_path, names):
    kept = [e for e in EVENTS if e["cat"] != "user_annotation"
            or e["name"] in names]
    run = _run(_trace(tmp_path, kept))
    benchmark = Benchmark()
    for metric in ("train.device_ms_per_step", "eval.device_ms_per_epoch"):
        assert benchmark.reader(metric).read(run) is None
        assert benchmark.reader(metric).read(_run(None)) is None
