"""The reference's training epoch and its evaluation pass, for any
configuration whose plain reference (``configs/<name>.py``) gives ``init``,
``noise_shape``, ``loss`` and ``evaluate``.

Everything is worked out again from the run's seed and the counts that the
benchmark made, as scVAE's training loop orders it (a later epoch from the
state that the program reached before it): the weights from a CPU
generator seeded with the seed; epoch e's minibatches from
``numpy.random.RandomState(seed + e).permutation`` (the remainder dropped);
the training steps' standard-normal draws from a generator on the counts'
device seeded with the seed, one draw of ``noise_shape`` a step, on from
one epoch to the next; the evaluation of epoch e from a generator seeded with
``SeedSequence((seed, e, 0))``, over the rows in order in full batches and
then the remainder, each batch's mean weighted by its rows.  So the
reference draws the numbers the program draws, and follows the same
minibatches.

Imports torch and numpy only: nothing of the program.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from portbench import plain


def epoch_rows(n: int, batch: int, seed: int, epoch: int) -> np.ndarray:
    """(steps, batch) row indices of epoch ``epoch``."""
    perm = np.random.RandomState(seed + epoch).permutation(n)
    steps = n // batch
    return perm[:steps * batch].reshape(steps, batch)


def evaluation_seed(seed: int, epoch: int) -> int:
    return int(np.random.SeedSequence((seed, epoch, 0)).generate_state(
        1, np.uint64)[0])


def train_epoch(model, spec: dict, counts: torch.Tensor, seed: int,
                batch: int, *, learning_rate: float, epoch: int = 0,
                start: dict | None = None, precision: str = "float32",
                fault: str | None = None) -> dict[str, Any]:
    """Epoch ``epoch`` (from 0), from ``start`` (``params``, ``state``,
    ``mu``, ``nu`` and ``count`` after epoch ``epoch`` − 1) or, for the
    first epoch, from the seed's weights.  Returns the parameters, the
    batch-norm statistics, Adam's moments and step count after it, the
    state it started from (``initial``), each leaf's norm of its first
    clipped gradient and the mean of its steps' lower bounds.  The draws of
    the epochs before it are made and thrown away, so each step draws what
    the program's does.  ``fault`` plants one of the faults the check has
    to catch: "unchanged" (no step changes the state), "half_batch" (each
    step on the first half of its rows) or "statistics_unchanged" (the
    batch-norm statistics never updated)."""
    device = counts.device
    if start is None:
        params, state = model.init(spec, seed)
        start = {"params": params, "state": state,
                 "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                 "nu": {k: torch.zeros_like(v) for k, v in params.items()},
                 "count": 0}
    copy = lambda tree: {k: v.to(device, torch.float32, copy=True)  # noqa: E731
                         for k, v in tree.items()}
    params, state = copy(start["params"]), copy(start["state"])
    mu, nu = copy(start["mu"]), copy(start["nu"])
    initial = {"params": copy(params), "state": copy(state)}
    count = int(start["count"])
    rows = torch.from_numpy(
        epoch_rows(counts.shape[0], batch, seed, epoch).astype(np.int64)
    ).to(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    take = batch // 2 if fault == "half_batch" else batch
    for _ in range(epoch * rows.shape[0]):
        torch.randn(model.noise_shape(spec, take), generator=generator,
                    dtype=torch.float32, device=device)
    first_gradient = None
    bounds = torch.zeros((), dtype=torch.float64, device=device)
    for step in range(rows.shape[0]):
        x = counts.index_select(0, rows[step, :take]).float()
        noise = torch.randn(model.noise_shape(spec, take),
                            generator=generator, dtype=torch.float32,
                            device=device)
        for leaf in params.values():
            leaf.requires_grad_(True)
        loss, new_state = model.loss(spec, params, state, x, noise,
                                     precision=precision)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names])))
        bounds -= loss.detach().double()
        for leaf in params.values():
            leaf.requires_grad_(False)
        if first_gradient is None:
            first_gradient = {k: float(torch.linalg.vector_norm(
                torch.clamp(g, -plain.CLIP, plain.CLIP)))
                for k, g in grads.items()}
        if fault == "unchanged":
            continue
        count += 1
        plain.clip_adam_(params, grads, mu, nu, count, learning_rate)
        if fault != "statistics_unchanged":
            state = {k: v.detach() for k, v in new_state.items()}
    return {"params": params, "state": state, "mu": mu, "nu": nu,
            "count": count, "initial": initial,
            "first_gradient": first_gradient,
            "train_lower_bound": float(bounds) / rows.shape[0]}


@torch.no_grad()
def evaluate(model, spec: dict, params: dict, state: dict,
             counts: torch.Tensor, seed: int, epoch: int, batch: int, *,
             precision: str = "float32") -> float:
    """The lower bound of the whole set at the end of epoch ``epoch`` (from
    0), as the per-epoch evaluation of the training set computes it."""
    device = counts.device
    n = counts.shape[0]
    generator = torch.Generator(device=device).manual_seed(
        evaluation_seed(seed, epoch))
    total = torch.zeros((), dtype=torch.float64, device=device)
    starts = list(range(0, n - n % batch, batch))
    for start in starts:
        x = counts[start:start + batch].float()
        noise = torch.randn(model.noise_shape(spec, batch),
                            generator=generator, dtype=torch.float32,
                            device=device)
        total += model.evaluate(spec, params, state, x, noise,
                                precision=precision).double() * batch
    tail = n % batch
    if tail:
        x = counts[n - tail:].float()
        noise = torch.randn(model.noise_shape(spec, tail),
                            generator=generator, dtype=torch.float32,
                            device=device)
        total += model.evaluate(spec, params, state, x, noise,
                                precision=precision).double() * tail
    return float(total) / n
