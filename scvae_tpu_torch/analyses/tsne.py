"""t-SNE on a device: scikit-learn 1.9.0's ``TSNE`` with the arguments the
JAX package passes (``scvae_tpu/analyses/decomposition.py:85-94``:
``TSNE(n_components, method="barnes_hut" if n_components < 4 else
"exact", random_state=…)`` and every other argument at its default),
written with PyTorch (CUDA unless ``device="cpu"``).

What it keeps of scikit-learn's algorithm:

* perplexity 30: each row's conditional Gaussian over its k = min(N − 1,
  91) nearest other rows (Barnes–Hut) or over every other row (exact), on
  squared Euclidean distances rounded to float32; the binary search for
  each row's precision in float64 (at most 100 steps, to 1e-5 of the
  entropy), all rows at once;
* P symmetrised and normalised (P + Pᵀ over its sum; the exact method
  floors every pair at the float64 epsilon);
* ``init="pca"``: a 2-component PCA of the values (exact, or randomised
  where scikit-learn's solver choice is, drawn from ``RandomState(seed)``),
  in float32, scaled so that the first column's standard deviation is
  1e-4;
* ``learning_rate="auto"`` = max(N / 12 / 4, 50); early exaggeration 12
  with momentum 0.5 for 250 iterations, then momentum 0.8 to 1,000; gains
  +0.2 / ×0.8 with a floor of 0.01; the error and the gradient's norm
  checked every 50 iterations, stopping after 300 iterations without
  progress (250 in the exaggerated phase) or at a norm of 1e-7;
  ``degrees_of_freedom = max(n_components − 1, 1)``; the positions in
  float32 and the update in float64, as scikit-learn's dtypes make them.

Where it parts from scikit-learn: below four components scikit-learn
approximates the repulsive forces with a Barnes–Hut tree (θ = 0.5); here
they are summed exactly over every pair (the squared distances from the
positions' differences), in chunks of rows that bound the memory, in
float32.  The attractive forces run over the sparse P.  The
embedding therefore follows the exact objective, and its values part from
scikit-learn's beyond rounding.  The exact method (four or more
components) computes its gradient in float64 over the dense N × N
matrices, as scikit-learn does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from scvae_tpu_torch.utils.device import resolve_device

PERPLEXITY = 30.0
EARLY_EXAGGERATION = 12.0
MAXIMUM_ITERATIONS = 1_000
EXPLORATION_ITERATIONS = 250
CHECK_EVERY = 50
ITERATIONS_WITHOUT_PROGRESS = 300
MINIMUM_GRADIENT_NORM = 1e-7
MINIMUM_GAIN = 0.01
BINARY_SEARCH_STEPS = 100
MACHINE_EPSILON = float(np.finfo(np.float64).eps)
FLOAT32_TINY = float(np.finfo(np.float32).tiny)
# scikit-learn's Cython constants are C floats
_EPSILON_DBL = float(np.float32(1e-8))
_PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
# Bytes of one chunk of pair values (rows × rows × components).
CHUNK_BYTES = 1 << 28


def _row_chunks(n_rows: int, row_bytes: int):
    step = max(1, CHUNK_BYTES // max(1, row_bytes))
    for start in range(0, n_rows, step):
        yield start, min(start + step, n_rows)


def _squared_distances(x: torch.Tensor, rows: slice) -> torch.Tensor:
    """Squared Euclidean distances (rows, N) from direct differences."""
    difference = x[rows, None, :] - x[None, :, :]
    return (difference * difference).sum(-1)


def nearest_neighbours(x: torch.Tensor,
                       k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's ``k`` nearest other rows of ``x`` (N, D), float64: their
    indices (N, k) in rising distance and the squared distances (N, k),
    exact from the rows' differences.  The candidates come from chunks of
    ‖x‖² − 2xxᵀ + ‖x‖² through ``torch.topk``."""
    n = x.shape[0]
    norms = (x * x).sum(1)
    indices = torch.empty((n, k), dtype=torch.int64, device=x.device)
    squared = torch.empty((n, k), dtype=x.dtype, device=x.device)
    for start, stop in _row_chunks(n, n * x.element_size()):
        block = norms[start:stop, None] - 2.0 * x[start:stop] @ x.T
        block += norms[None, :]
        rows = torch.arange(stop - start, device=x.device)
        block[rows, rows + start] = float("inf")
        candidates = torch.topk(block, k, dim=1, largest=False).indices
        difference = x[start:stop, None, :] - x[candidates]
        distances = (difference * difference).sum(-1)
        order = torch.argsort(distances, dim=1, stable=True)
        indices[start:stop] = torch.gather(candidates, 1, order)
        squared[start:stop] = torch.gather(distances, 1, order)
    return indices, squared


def conditional_probabilities(squared: torch.Tensor, perplexity: float,
                              exclude_diagonal: bool) -> torch.Tensor:
    """scikit-learn's ``_binary_search_perplexity`` on the float32 squared
    distances (N, k), for every row at once in float64: each row's
    p(j|i) ∝ exp(−β d²) with β bisected until the entropy is within 1e-5 of
    ln(perplexity).  ``exclude_diagonal`` for the exact method's (N, N)
    matrix, whose diagonal takes no probability."""
    d = squared.to(torch.float32).to(torch.float64)
    n = d.shape[0]
    device = d.device
    beta = torch.ones(n, dtype=torch.float64, device=device)
    beta_min = torch.full_like(beta, -float("inf"))
    beta_max = torch.full_like(beta, float("inf"))
    active = torch.ones(n, dtype=torch.bool, device=device)
    probabilities = torch.zeros_like(d)
    desired_entropy = math.log(float(np.float32(perplexity)))
    diagonal = None
    if exclude_diagonal:
        diagonal = torch.eye(n, dtype=torch.bool, device=device)
    for _ in range(BINARY_SEARCH_STEPS):
        p = torch.exp(-d * beta[:, None])
        if diagonal is not None:
            p.masked_fill_(diagonal, 0.0)
        sum_p = p.sum(1)
        sum_p = torch.where(sum_p == 0.0, _EPSILON_DBL, sum_p)
        p /= sum_p[:, None]
        entropy = torch.log(sum_p) + beta * (d * p).sum(1)
        difference = entropy - desired_entropy
        probabilities = torch.where(active[:, None], p, probabilities)
        active &= difference.abs() > _PERPLEXITY_TOLERANCE
        if not bool(active.any()):
            break
        up = difference > 0.0
        new_beta = torch.where(
            up,
            torch.where(torch.isinf(beta_max), beta * 2.0,
                        (beta + beta_max) / 2.0),
            torch.where(torch.isinf(beta_min), beta / 2.0,
                        (beta + beta_min) / 2.0))
        beta_min = torch.where(active & up, beta, beta_min)
        beta_max = torch.where(active & ~up, beta, beta_max)
        beta = torch.where(active, new_beta, beta)
    return probabilities


def joint_probabilities_nn(indices: torch.Tensor,
                           squared: torch.Tensor,
                           perplexity: float = PERPLEXITY) -> torch.Tensor:
    """scikit-learn's ``_joint_probabilities_nn``: the conditional
    probabilities over each row's neighbours, P + Pᵀ over its sum, as a
    coalesced sparse (N, N) float64 tensor."""
    n, k = indices.shape
    conditional = conditional_probabilities(squared, perplexity, False)
    rows = torch.arange(n, device=indices.device).repeat_interleave(k)
    # the indices are in range by construction: no invariant checks (an
    # explicit choice, which also keeps PyTorch from warning of one)
    with torch.sparse.check_sparse_tensor_invariants(enable=False):
        p = torch.sparse_coo_tensor(
            torch.stack([rows, indices.reshape(-1)]), conditional.reshape(-1),
            (n, n))
        p = (p + p.t()).coalesce()
        total = max(float(p.values().sum()), MACHINE_EPSILON)
        return torch.sparse_coo_tensor(p.indices(), p.values() / total,
                                       (n, n)).coalesce()


def joint_probabilities(squared: torch.Tensor,
                        perplexity: float = PERPLEXITY) -> torch.Tensor:
    """scikit-learn's ``_joint_probabilities`` as a dense (N, N) float64
    matrix: P + Pᵀ over its sum, every pair floored at the float64
    epsilon, the diagonal 0."""
    conditional = conditional_probabilities(squared, perplexity, True)
    p = conditional + conditional.T
    total = max(float(p.sum()), MACHINE_EPSILON)
    p = torch.clamp(p / total, min=MACHINE_EPSILON)
    return p.fill_diagonal_(0.0)


class _Objective:
    """The error and float32 gradient of the embedding's positions;
    ``scale`` multiplies P by the early exaggeration and ``unscale``
    divides it again, as scikit-learn does."""

    def __init__(self, p, degrees_of_freedom: int):
        self.p = p
        self.degrees_of_freedom = degrees_of_freedom
        self.factor = 2.0 * (degrees_of_freedom + 1.0) / degrees_of_freedom


class _SparseObjective(_Objective):
    """Below four components: the attractive forces over the sparse P (as
    scikit-learn's ``compute_gradient_positive``), the repulsive forces and
    their normaliser summed exactly over every pair, all in float32."""

    def __init__(self, p: torch.Tensor, degrees_of_freedom: int):
        super().__init__(p, degrees_of_freedom)
        self.rows, self.columns = p.indices()
        self.values64 = p.values()
        self.values = self.values64.float()

    def scale(self, factor: float) -> None:
        # scikit-learn scales its float64 P and rounds it at each call
        self.values64 = self.values64 * factor
        self.values = self.values64.float()

    def unscale(self, factor: float) -> None:
        self.values64 = self.values64 / factor
        self.values = self.values64.float()

    def _kernel(self, squared: torch.Tensor) -> torch.Tensor:
        """dof / (dof + d²), to the power (dof + 1) / 2 unless dof is 1;
        in place on ``squared``."""
        if self.degrees_of_freedom == 1:
            return squared.add_(1.0).reciprocal_()
        dof = float(self.degrees_of_freedom)
        q = squared.add_(dof).reciprocal_().mul_(dof)
        return q.pow_((dof + 1.0) / 2.0)

    def __call__(self, y: torch.Tensor, compute_error: bool):
        n, c = y.shape
        difference = y[self.rows] - y[self.columns]
        q_attractive = self._kernel((difference * difference).sum(1))
        attractive = torch.zeros_like(y).index_add_(
            0, self.rows, (self.values * q_attractive)[:, None] * difference)
        repulsive = torch.empty_like(y)
        sum_q = torch.zeros((), dtype=torch.float64, device=y.device)
        for start, stop in _row_chunks(n, n * y.element_size()):
            # d² from the differences, a component at a time (a (rows, N)
            # block each); Σ_j q_ij² (y_i − y_j) as y_i Σ_j q_ij² −
            # Σ_j q_ij² y_j
            squared = None
            for a in range(c):
                difference = y[start:stop, a, None] - y[None, :, a]
                if squared is None:
                    squared = difference.square_()
                else:
                    squared.addcmul_(difference, difference)
            q = self._kernel(squared)
            rows = torch.arange(stop - start, device=y.device)
            q[rows, rows + start] = 0.0
            sum_q += q.sum(dtype=torch.float64)
            weights = q.square_()
            repulsive[start:stop] = (y[start:stop] * weights.sum(1, True)
                                     - weights @ y)
        gradient = (attractive - repulsive / sum_q.float()) * self.factor
        error = float("nan")
        if compute_error:
            q = q_attractive.double() / sum_q
            error = float(torch.sum(self.values.double() * torch.log(
                torch.clamp(self.values.double(), min=FLOAT32_TINY)
                / torch.clamp(q, min=FLOAT32_TINY))))
        return error, gradient


class _DenseObjective(_Objective):
    """Four or more components: scikit-learn's ``_kl_divergence`` over the
    dense P in float64, the gradient rounded to float32."""

    def scale(self, factor: float) -> None:
        self.p = self.p * factor

    def unscale(self, factor: float) -> None:
        self.p = self.p / factor

    def __call__(self, y: torch.Tensor, compute_error: bool):
        y64 = y.double()
        dof = float(self.degrees_of_freedom)
        distances = _squared_distances(y64, slice(None)) / dof + 1.0
        distances = distances ** ((dof + 1.0) / -2.0)
        distances.fill_diagonal_(0.0)
        q = torch.clamp(distances / distances.sum(), min=MACHINE_EPSILON)
        error = float("nan")
        if compute_error:
            off_diagonal = ~torch.eye(y.shape[0], dtype=torch.bool,
                                      device=y.device)
            p = self.p[off_diagonal]
            error = float(torch.sum(p * torch.log(
                torch.clamp(p, min=MACHINE_EPSILON) / q[off_diagonal])))
        weights = ((self.p - q) * distances).fill_diagonal_(0.0)
        # scikit-learn takes the positions' differences in float32
        difference = (y[:, None, :] - y[None, :, :]).double()
        gradient = (weights[..., None] * difference).sum(1)
        # rounded to float32 before the factor, as scikit-learn's array
        return error, gradient.float() * self.factor


def _gradient_descent(objective, y: torch.Tensor, iteration: int,
                      maximum_iterations: int, momentum: float,
                      learning_rate: np.float64,
                      iterations_without_progress: int):
    """scikit-learn's ``_gradient_descent`` with fresh updates and gains:
    (positions, last error, last iteration)."""
    shape = y.shape
    p = y.reshape(-1).clone()
    update = torch.zeros_like(p)
    gains = torch.ones_like(p)
    error = best_error = float(np.finfo(float).max)
    best_iteration = i = iteration
    for i in range(iteration, maximum_iterations):
        check = (i + 1) % CHECK_EVERY == 0
        error, gradient = objective(p.reshape(shape),
                                    check or i == maximum_iterations - 1)
        gradient = gradient.reshape(-1)
        increase = update * gradient < 0.0
        gains = torch.where(increase, gains + 0.2, gains * 0.8)
        gains.clamp_(min=MINIMUM_GAIN)
        gradient = gradient * gains
        update = momentum * update - float(learning_rate) * gradient.double()
        p = (p.double() + update).float()
        if check:
            gradient_norm = float(torch.linalg.norm(gradient))
            if error < best_error:
                best_error, best_iteration = error, i
            elif i - best_iteration > iterations_without_progress:
                break
            if gradient_norm <= MINIMUM_GRADIENT_NORM:
                break
    return p.reshape(shape), error, i


class TSNE:
    """scikit-learn's ``TSNE(n_components, method="barnes_hut" if
    n_components < 4 else "exact", random_state=seed)`` on ``device``:
    below four components the sparse P and the objective of
    ``_SparseObjective``, from four on the dense P and scikit-learn's exact
    objective.  ``fit_transform`` gives the float32 embedding, and
    ``kl_divergence_`` / ``n_iter_`` are set as scikit-learn sets them;
    ``p_`` keeps the fit's P."""

    def __init__(self, n_components: int = 2, seed=None, device=None):
        self.n_components = n_components
        self.exact = n_components >= 4
        self.seed = seed
        self.device = resolve_device(device)

    def _values(self, values) -> torch.Tensor:
        import scipy.sparse

        if scipy.sparse.issparse(values):
            values = values.toarray()
        values = np.asarray(values)
        if values.dtype != np.float32:
            values = values.astype(np.float64)
        return torch.from_numpy(values).to(self.device)

    def joint_probabilities(self, x: torch.Tensor):
        """P of the rows of ``x`` (float64): sparse over the neighbours
        below four components, dense for the exact method."""
        x = x.double()
        n = x.shape[0]
        if self.exact:
            squared = torch.empty((n, n), dtype=torch.float64,
                                  device=x.device)
            for start, stop in _row_chunks(n, n * x.shape[1] * 8):
                squared[start:stop] = _squared_distances(
                    x, slice(start, stop))
            return joint_probabilities(squared)
        k = min(n - 1, int(3.0 * PERPLEXITY + 1))
        indices, squared = nearest_neighbours(x, k)
        # scikit-learn squares the Euclidean distances it finds
        squared = torch.sqrt(squared) ** 2
        return joint_probabilities_nn(indices, squared)

    def initial_embedding(self, x: torch.Tensor) -> torch.Tensor:
        """``init="pca"``: the PCA scikit-learn's ``PCA(n_components,
        random_state)`` would fit (exact, or randomised where its "auto"
        solver is), in float32, its first column's standard deviation
        scaled to 1e-4 (on the host, with numpy's float32 arithmetic)."""
        from scvae_tpu_torch.analyses.decomposition import PCA, RandomisedPCA

        n, d = x.shape
        k = self.n_components
        exact = (d <= 1_000 and n >= 10 * d) or max(n, d) <= 500 or not (
            1 <= k < 0.8 * min(n, d))
        values = x.cpu().numpy()
        model = (PCA(k, self.device) if exact
                 else RandomisedPCA(k, self.seed, self.device))
        embedding = model.fit_transform(values).astype(np.float32)
        embedding = embedding / np.std(embedding[:, 0]) * 1e-4
        return torch.from_numpy(embedding).to(self.device)

    def fit_transform(self, values) -> np.ndarray:
        x = self._values(values)
        n = x.shape[0]
        if PERPLEXITY >= n:
            raise ValueError(f"perplexity ({PERPLEXITY}) must be less than "
                             f"n_samples ({n})")
        learning_rate = np.maximum(n / EARLY_EXAGGERATION / 4, 50)
        p = self.joint_probabilities(x)
        embedding = self.initial_embedding(x)
        degrees_of_freedom = max(self.n_components - 1, 1)
        objective = (_DenseObjective if self.exact
                     else _SparseObjective)(p, degrees_of_freedom)
        self.p_ = p
        objective.scale(EARLY_EXAGGERATION)
        embedding, error, iteration = _gradient_descent(
            objective, embedding, 0, EXPLORATION_ITERATIONS, 0.5,
            learning_rate, EXPLORATION_ITERATIONS)
        objective.unscale(EARLY_EXAGGERATION)
        embedding, error, iteration = _gradient_descent(
            objective, embedding, iteration + 1, MAXIMUM_ITERATIONS, 0.8,
            learning_rate, ITERATIONS_WITHOUT_PROGRESS)
        self.n_iter_ = iteration
        self.kl_divergence_ = error
        self.embedding_ = embedding
        return embedding.cpu().numpy()
