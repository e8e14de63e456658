"""Spans and counters inside the port, kept in memory until the caller
reads them.

A span is a named interval of work with its id, the id of the span that
encloses it on the same thread, the thread's name, its start and end in
``time.time_ns()`` and its attributes.  The program opens them where the
work happens:

* ``train.stage`` (``models/api.py``; children ``stage.densify`` and
  ``stage.h2d`` in ``data/pipeline.py``, ``stage.row_sums`` and
  ``stage.batch_dtypes``): the training set densified, copied to the
  device, its lgamma row sums and the check of its values that lets the
  row gather write bf16;
* ``step.eager`` and ``step.capture`` (``models/step.py``, attribute
  ``kind``, "train" or "eval"): a graphed body's eager first call and its
  capture; the counter ``step.graph_captures`` counts the captures;
* ``epoch`` (``models/training.py``, attribute ``epoch``) with children
  ``epoch.train`` (the interval of ``TrainingResult.epoch_seconds``: the
  training pass up to the fetch of its lower bound), ``epoch.evaluate``
  (attribute ``split``), ``epoch.callback``, ``epoch.record`` (the
  learning curves) and ``epoch.checkpoint`` (the host copy and the queued
  writes);
* ``checkpoint.write`` and ``checkpoint.copy_version``
  (``models/checkpoints.py``, on the writer thread);
* the counters ``eval.fused_passes`` and ``eval.unfused_passes``
  (``models/api.py``): each per-epoch evaluation pass of a set, by whether
  its log p(x|z) comes from the float32 fused forward.

No span is opened per training step: a step is one graph replay, and the
step's time is the epoch's training span over its steps.  The spans end
where the host already waits for the device; none adds a synchronise,
except ``stage.row_sums`` while the recorder is on.

Off (the default) :func:`span` returns one shared context that does
nothing and :func:`count` returns at once.  On (:func:`enable`), each span
also enters ``torch.profiler.record_function``, so inside a running
``utils.profiling.trace`` it shows on the trace's own timeline as a
``user_annotation`` event; ``profiling.trace`` turns the recorder on for
its own duration.  The Chrome trace's ``ts`` × 1000 +
``baseTimeNanoseconds`` is on the spans' clock.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    id: int
    parent: int | None  # the enclosing span on the same thread
    thread: str
    start_ns: int  # time.time_ns()
    end_ns: int
    attrs: dict[str, Any]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_enabled = False
_lock = threading.Lock()  # the writer thread records too
_spans: list[Span] = []
_counters: dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()  # each thread's stack of open span ids


def _stack() -> list[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(span: Span) -> None:
    with _lock:
        _spans.append(span)


class _Off:
    """The span of a recorder that is off: one shared object."""

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def annotate(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Open:
    """A span being recorded: kept when it closes, by an exception too."""

    def __init__(self, name: str, attrs: dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> _Open:
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.time_ns()
        try:
            self._annotation.__exit__(*exc)
        finally:
            _stack().pop()
            _keep(Span(self.name, self.id, self.parent,
                       threading.current_thread().name, self.start_ns,
                       end_ns, self.attrs))
        return False

    def annotate(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)


def span(name: str, **attrs) -> _Open | _Off:
    """A context manager that records the work inside it as a span."""
    if not _enabled:
        return _OFF
    return _Open(name, attrs)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Record a span whose ends (``time.time_ns()``) the caller holds; its
    parent is the span open on this thread now."""
    if not _enabled:
        return
    stack = _stack()
    _keep(Span(name, next(_ids), stack[-1] if stack else None,
               threading.current_thread().name, start_ns, end_ns, attrs))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording; spans open now are still kept when they close."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Forget the recorded spans and counters."""
    with _lock:
        _spans.clear()
        _counters.clear()


def spans() -> list[Span]:
    """The closed spans, in the order they closed."""
    with _lock:
        return list(_spans)


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)
