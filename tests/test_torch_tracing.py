"""The port's span recorder (``utils/tracing.py``) on the CPU:

* off, it records nothing, hands out one shared context and never enters
  ``torch.profiler.record_function``;
* on, it records names, ids, parents on each thread, attributes (given and
  added inside), spans whose ends the caller holds, counters, and spans
  that an exception closes; ``reset`` forgets them;
* inside ``profiling.trace(device="cpu")`` the recorder is on, each span
  lands within 1 ms of its own ``user_annotation`` event once the trace's
  ``ts`` is mapped by ``baseTimeNanoseconds``, and afterwards the recorder
  is as it was;
* a small device-resident VAE ``train`` with a log directory, in both
  fetch modes, records ``train.stage`` with its children and, per epoch,
  ``epoch`` › ``epoch.train``, ``epoch.evaluate``, ``epoch.callback``,
  ``epoch.record``, ``epoch.checkpoint``, with ``checkpoint.write`` and
  ``checkpoint.copy_version`` on the writer thread; Σ ``epoch.train``
  equals ``TrainingResult.epoch_seconds`` within 1 ms an epoch, and the
  counter ``eval.unfused_passes`` counts the CPU's evaluation passes;
* a ``train`` stopped by its callback closes the spans it leaves;
* the same run with the recorder off records nothing.

The graphed steps' spans and capture counter need a card
(``tests/test_torch_cuda.py``).
"""

import gzip
import json
import os
import threading

import numpy as np
import pytest
import torch

from scvae_tpu_torch import VariationalAutoencoder
from scvae_tpu_torch.models import checkpoints, step
from scvae_tpu_torch.utils import profiling, tracing


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts with the recorder off and empty, and leaves it so."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _by_name(spans):
    out = {}
    for span in spans:
        out.setdefault(span.name, []).append(span)
    return out


def test_off_records_nothing_and_never_annotates(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = tracing.span("a", x=1)
    with first as inside:
        with tracing.span("b") as nested:
            nested.annotate(y=2)
        tracing.record("c", 0, 1)
        tracing.count("d", 3)
    assert first is tracing.span("other") is inside
    assert not tracing.enabled()
    assert tracing.spans() == [] and tracing.counters() == {}


def test_on_records_nesting_parents_attributes_and_counters():
    tracing.enable()
    with tracing.span("outer", epoch=3) as outer:
        with tracing.span("inner", split="training") as inner:
            inner.annotate(bytes=10)
        tracing.record("held", 5, 9, epoch=3)
        tracing.count("captures")
        tracing.count("captures", 2)
    with tracing.span("after"):
        pass
    spans = _by_name(tracing.spans())
    (o,), (i,), (h,), (a,) = (spans[n] for n in ("outer", "inner", "held",
                                                 "after"))
    assert o.id == outer.id and i.id == inner.id
    assert o.parent is None and a.parent is None
    assert i.parent == o.id and h.parent == o.id
    assert o.attrs == {"epoch": 3}
    assert i.attrs == {"split": "training", "bytes": 10}
    assert (h.start_ns, h.end_ns, h.attrs) == (5, 9, {"epoch": 3})
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert len({o.id, i.id, h.id, a.id}) == 4
    assert {s.thread for s in (o, i, h, a)} == {"MainThread"}
    assert [s.name for s in tracing.spans()] == ["inner", "held", "outer",
                                                 "after"]
    assert tracing.counters() == {"captures": 3}
    tracing.reset()
    assert tracing.spans() == [] and tracing.counters() == {}


def test_spans_on_other_threads_have_their_own_parents():
    tracing.enable()
    results = []

    def work(name):
        with tracing.span(name):
            with tracing.span(name + ".child"):
                pass
        results.append(name)

    with tracing.span("main"):
        threads = [threading.Thread(target=work, args=(f"t{i}",),
                                    name=f"worker_{i}") for i in range(4)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=10)
        assert not any(thread.is_alive() for thread in threads)
    spans = _by_name(tracing.spans())
    for i in range(4):
        (top,), (child,) = spans[f"t{i}"], spans[f"t{i}.child"]
        assert top.parent is None  # not the main thread's open span
        assert child.parent == top.id
        assert top.thread == child.thread == f"worker_{i}"
    assert sorted(results) == [f"t{i}" for i in range(4)]


def test_the_writer_thread_records_its_spans(tmp_path):
    tracing.enable()
    state = step.create_train_state(
        {"w": torch.ones(3, 4)}, {}, step.make_optimizer(1e-3))
    checkpoints.save_checkpoint(str(tmp_path), state, epoch=2,
                                async_write=True)
    checkpoints.copy_checkpoint_version(
        str(tmp_path), str(tmp_path / "best"), async_write=True)
    checkpoints.wait_for_pending_writes()
    spans = _by_name(tracing.spans())
    (write,), (copy,) = spans["checkpoint.write"], spans[
        "checkpoint.copy_version"]
    assert write.thread == copy.thread != "MainThread"
    assert write.thread.startswith("checkpoints")
    assert write.attrs["epoch"] == 2
    assert write.attrs["bytes"] == os.path.getsize(
        tmp_path / checkpoints.CHECKPOINT_FILE)
    assert copy.attrs == {"version": "best", "bytes": sum(
        os.path.getsize(tmp_path / name) for name in (
            checkpoints.CHECKPOINT_FILE, checkpoints.METADATA_FILE))}
    assert write.end_ns <= copy.start_ns  # one worker, in order


def test_an_exception_closes_the_span():
    tracing.enable()
    with pytest.raises(KeyError):
        with tracing.span("outer"):
            with tracing.span("raises"):
                raise KeyError("stop")
    with tracing.span("next"):
        pass
    spans = _by_name(tracing.spans())
    assert spans["raises"][0].parent == spans["outer"][0].id
    assert spans["next"][0].parent is None  # the stack unwound


def _trace_events(directory):
    (run,) = os.listdir(os.path.join(directory, "plugins", "profile"))
    (name,) = os.listdir(os.path.join(directory, "plugins", "profile", run))
    with gzip.open(os.path.join(directory, "plugins", "profile", run,
                                name), "rt") as f:
        return json.load(f)


@pytest.mark.parametrize("was_on", [False, True])
def test_a_span_lands_on_its_annotation_in_a_trace(tmp_path, was_on):
    if was_on:
        tracing.enable()
    with profiling.trace(str(tmp_path), device="cpu"):
        assert tracing.enabled()
        with tracing.span("warm"):  # the first annotation builds its op
            pass
        with tracing.span("outer"):
            torch.ones(64).sum()
            with tracing.span("inner"):
                torch.ones(8).mul(2.0)
    assert tracing.enabled() == was_on
    trace = _trace_events(str(tmp_path))
    base = int(trace["baseTimeNanoseconds"])
    annotations = {e["name"]: e for e in trace["traceEvents"]
                   if e.get("cat") == "user_annotation"}
    spans = _by_name(tracing.spans())
    for name in ("outer", "inner"):
        (span,) = spans[name]
        event = annotations[name]
        start = float(event["ts"]) * 1e3 + base
        end = start + float(event["dur"]) * 1e3
        assert abs(span.start_ns - start) < 1e6, name
        assert abs(span.end_ns - end) < 1e6, name


def _model(log_directory):
    return VariationalAutoencoder(
        feature_size=12, latent_size=2, hidden_sizes=[8],
        reconstruction_distribution="negative binomial",
        log_directory=str(log_directory))


def _values():
    return np.random.RandomState(0).poisson(2.0, (96, 12)).astype(np.float32)


EPOCHS = 3


@pytest.mark.parametrize("fetch", ["sync", "deferred"])
def test_train_records_each_phase_of_each_epoch(tmp_path, fetch):
    tracing.enable()
    result = _model(tmp_path).train(
        _values(), number_of_epochs=EPOCHS, minibatch_size=32, device="cpu",
        verbose=False, data_placement="device", metrics_fetch=fetch,
        epoch_callback=lambda *args: None)
    tracing.disable()
    spans = tracing.spans()
    by_id = {span.id: span for span in spans}
    named = _by_name(spans)
    (stage,) = named["train.stage"]
    assert {by_id[s.parent].name for n in ("stage.densify", "stage.h2d",
                                           "stage.row_sums",
                                           "stage.batch_dtypes")
            for s in named[n]} == {"train.stage"}
    assert stage.end_ns <= min(s.start_ns for s in named["epoch"])
    epochs = named["epoch"]
    assert [s.attrs["epoch"] for s in epochs] == list(range(EPOCHS))
    children = ("epoch.train", "epoch.evaluate", "epoch.callback",
                "epoch.record", "epoch.checkpoint")
    for name in children:
        assert len(named[name]) == EPOCHS, name
        assert [by_id[s.parent].attrs["epoch"] for s in named[name]] == (
            list(range(EPOCHS))), name
    assert [s.attrs for s in named["epoch.evaluate"]] == (
        [{"split": "training"}] * EPOCHS)
    assert [s.attrs["epoch"] for s in named["epoch.train"]] == (
        list(range(EPOCHS)))
    for epoch in epochs:  # the children in order, after the training pass
        inside = [s for s in spans if s.parent == epoch.id]
        assert [s.name for s in inside] == list(children)
        for before, after in zip(inside, inside[1:]):
            assert before.end_ns <= after.start_ns
        for s in inside[1:]:
            assert epoch.start_ns <= s.start_ns <= s.end_ns <= epoch.end_ns
    trained = [s.seconds for s in named["epoch.train"]]
    assert len(result.epoch_seconds) == EPOCHS
    for got, want in zip(trained, result.epoch_seconds):
        assert abs(got - want) <= 1e-3
    writes = named["checkpoint.write"]
    assert [s.attrs["epoch"] for s in writes] == list(range(1, EPOCHS + 1))
    assert len(named["checkpoint.copy_version"]) == EPOCHS
    for s in writes + named["checkpoint.copy_version"]:
        assert s.thread.startswith("checkpoints") and s.parent is None
    assert "step.eager" not in named  # the CPU's steps are not graphed
    # the CPU's evaluation passes keep the unfused path
    assert tracing.counters() == {"eval.unfused_passes": EPOCHS}


def test_a_stopped_train_closes_its_spans(tmp_path):
    class Stop(Exception):
        pass

    def callback(epoch, train_state, epoch_metrics):
        if epoch == 1:
            raise Stop

    tracing.enable()
    with pytest.raises(Stop):
        _model(tmp_path).train(_values(), number_of_epochs=EPOCHS,
                               minibatch_size=32, device="cpu",
                               verbose=False, epoch_callback=callback)
    checkpoints.wait_for_pending_writes()
    named = _by_name(tracing.spans())
    assert [s.attrs["epoch"] for s in named["epoch"]] == [0, 1]
    assert len(named["epoch.callback"]) == 2
    assert len(named["epoch.record"]) == 1  # the stop came before it
    assert len(named["checkpoint.write"]) == 1


def test_train_records_nothing_while_off(tmp_path):
    result = _model(tmp_path).train(
        _values(), number_of_epochs=2, minibatch_size=32, device="cpu",
        verbose=False, epoch_callback=lambda *args: None)
    checkpoints.wait_for_pending_writes()
    assert len(result.epoch_seconds) == 2
    assert tracing.spans() == [] and tracing.counters() == {}
