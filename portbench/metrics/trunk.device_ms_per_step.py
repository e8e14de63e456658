"""Device milliseconds a training step spends in every kernel that is not
the port's own (``models/vae.py``, ``models/gmvae.py``, ``models/
networks.py``, ``models/objectives.py``: PyTorch's and cuBLAS's kernels,
clipping and Adam), over the profiled epoch's training steps, its
evaluation pass included."""

import os

from portbench.spec import _module

MOVES = "train_cells_per_s"

_port = _module(os.path.join(os.path.dirname(__file__),
                             "kernels.device_ms_per_step.py"),
                "portbench_metric_port_kernels")


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    seconds = sum(d for name, _, d in run.trace.kernels
                  if not _port.is_port_kernel(name))
    return seconds / run.steps_per_epoch * 1e3
