"""The program's spans on the profiled epoch's timeline.

``scvae_tpu_torch/utils/tracing.py`` records the training loop's phases as
spans (``epoch.train``, ``epoch.evaluate``, ...), and inside the program's
``utils.profiling.trace`` each span is also a ``user_annotation`` event of
the trace, which ``trace.load`` keeps among the host's events.  A device
operation belongs to a phase when it starts inside one of the phase's
annotations.  The loop's phases end where the host waits for the device
(the fetch of the training pass's lower bound, the evaluation's fetches),
so what a phase launches runs inside it.  A program without the spans (the
parent of the change that added them) leaves no annotation: the readers
then find nothing.
"""

from __future__ import annotations

from portbench.trace import Trace


def phases(trace: Trace, name: str) -> list[tuple[float, float]]:
    """The (start, end) of every annotation ``name`` in the trace."""
    return [(start, end) for label, start, end in trace.host
            if label == name]


def device_seconds_in(trace: Trace,
                      intervals: list[tuple[float, float]]) -> float:
    """Device time of the operations (kernels, copies, sets) that start
    inside one of ``intervals``."""
    return sum(end - start for start, end in trace.device
               if any(a <= start < b for a, b in intervals))
