"""k-means and mini-batch k-means on a device: scikit-learn 1.9.0's
``KMeans`` (Lloyd's algorithm) and ``MiniBatchKMeans`` with their defaults,
which the JAX package calls (``scvae_tpu/analyses/prediction.py:84-105``),
written with PyTorch (CUDA unless ``device="cpu"``).

Every distance, sum and update runs on the device in float64; squared
distances are ‖x‖² − 2xcᵀ + ‖c‖² with ``torch.matmul`` for the product.
The random draws (the k-means++ seeds and candidates, the mini-batches,
the reassignments) come from ``numpy.random.RandomState(seed)`` on the
host, in scikit-learn's order and with its calls: with the same seed the
two make the same draws.  ``seed=None`` is a fresh generator, as the JAX
package's unseeded estimators are.

* ``KMeans``: the data centred on its mean; per initialisation greedy
  k-means++ (2 + ⌊ln k⌋ local trials), then Lloyd's iterations (at most
  300) until the labels repeat or the centres move by at most 1e-4 times
  the mean feature variance; an empty cluster takes the example farthest
  from its centre; of 10 runs the one of least inertia that is not the
  same partition as the best so far.
* ``MiniBatchKMeans``: 3 k-means++ seedings on 300 random examples, the
  one of least inertia on a random validation sample kept; then steps on
  100 examples drawn with replacement, each centre moved to the mean of
  all examples it has been given (per-centre counts), centres of low count
  (under 0.01 of the largest) reassigned to random examples of the batch
  every 10·k examples, until the smoothed batch inertia has not improved
  for 10 steps or 100 passes over the data are done.
* ``predict``: each row's nearest centre (int32, as scikit-learn's).
"""

from __future__ import annotations

import numpy as np
import torch

from scvae_tpu_torch.utils.device import (
    float64_tensor,
    random_state,
    resolve_device,
)


def _squared_distances(x: torch.Tensor, centers: torch.Tensor,
                       x_squared_norms: torch.Tensor) -> torch.Tensor:
    """scikit-learn's ``_euclidean_distances(centers, x, squared=True)``:
    (centers, examples), clipped at 0."""
    distances = (-2.0 * centers @ x.T + (centers * centers).sum(1)[:, None]
                 + x_squared_norms[None, :])
    return distances.clamp_(min=0.0)


def _nearest(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Each row's nearest centre, as scikit-learn's Lloyd step finds it:
    argmin of ‖c‖² − 2xcᵀ (the first on a tie)."""
    return torch.argmin((centers * centers).sum(1)[None, :]
                        - 2.0 * x @ centers.T, dim=1)


def _inertia(x: torch.Tensor, centers: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    difference = x - centers[labels]
    return (difference * difference).sum()


def _kmeans_plusplus(x: torch.Tensor, n_clusters: int,
                     x_squared_norms: torch.Tensor,
                     generator: np.random.RandomState) -> torch.Tensor:
    """scikit-learn's ``_kmeans_plusplus`` with unit sample weights."""
    n = x.shape[0]
    n_local_trials = 2 + int(np.log(n_clusters))
    center_id = generator.choice(n, p=np.ones(n) / n)
    indices = [torch.tensor([center_id], device=x.device)]
    closest = _squared_distances(x, x[center_id:center_id + 1],
                                 x_squared_norms)[0]
    potential = closest.sum()
    for _ in range(1, n_clusters):
        draws = torch.from_numpy(
            generator.uniform(size=n_local_trials)).to(x.device)
        candidates = torch.searchsorted(torch.cumsum(closest, 0),
                                        draws * potential)
        candidates.clamp_(max=n - 1)
        distances = torch.minimum(
            closest[None, :],
            _squared_distances(x, x[candidates], x_squared_norms))
        potentials = distances.sum(1)
        best = torch.argmin(potentials)
        potential = potentials[best]
        closest = distances[best]
        indices.append(candidates[best:best + 1])
    return x[torch.cat(indices)]


def _lloyd(x: torch.Tensor, centers: torch.Tensor, max_iter: int,
           tol: float) -> tuple[torch.Tensor, float, torch.Tensor]:
    """scikit-learn's ``_kmeans_single_lloyd``: (labels, inertia,
    centres)."""
    n_clusters = centers.shape[0]
    labels_old = None
    strict_convergence = False
    for _ in range(max_iter):
        labels = _nearest(x, centers)
        counts = torch.bincount(labels, minlength=n_clusters).double()
        sums = torch.zeros_like(centers).index_add_(0, labels, x)
        empty = torch.nonzero(counts == 0).flatten().tolist()
        if empty:
            _relocate_empty_clusters(x, centers, labels, sums, counts, empty)
        new_centers = torch.where(
            counts[:, None] > 0, sums * (1.0 / counts)[:, None],
            sums[torch.argmax(counts)][None, :])
        shift = (((new_centers - centers) ** 2).sum(1).sqrt() ** 2).sum()
        centers = new_centers
        if labels_old is not None and torch.equal(labels, labels_old):
            strict_convergence = True
            break
        if float(shift) <= tol:
            break
        labels_old = labels
    if not strict_convergence:
        labels = _nearest(x, centers)
    return labels, float(_inertia(x, centers, labels)), centers


def _relocate_empty_clusters(x, centers, labels, sums, counts, empty):
    """scikit-learn's ``_relocate_empty_clusters_dense``: the examples
    farthest from their centres seed the empty clusters (in place on the
    sums and counts), unless every example sits on its centre."""
    distances = ((x - centers[labels]) ** 2).sum(1)
    if float(distances.max()) == 0:
        return
    far = torch.topk(distances, len(empty)).indices.tolist()
    for new, index in zip(empty, far):
        old = int(labels[index])
        sums[old] -= x[index]
        sums[new] = x[index]
        counts[new] = 1.0
        counts[old] -= 1.0


def _is_same_clustering(labels: torch.Tensor, other: torch.Tensor,
                        n_clusters: int) -> bool:
    """scikit-learn's ``_is_same_clustering``: every cluster of ``labels``
    holds one cluster of ``other``."""
    low = torch.full((n_clusters,), n_clusters, dtype=other.dtype,
                     device=other.device).scatter_reduce(
                         0, labels, other, "amin")
    high = torch.full((n_clusters,), -1, dtype=other.dtype,
                      device=other.device).scatter_reduce(
                          0, labels, other, "amax")
    present = torch.bincount(labels, minlength=n_clusters) > 0
    return bool(torch.all((low == high) | ~present))


class _KMeansBase:
    def __init__(self, n_clusters: int, seed=None, device=None):
        self.n_clusters = n_clusters
        self.seed = seed
        self.device = resolve_device(device)

    def _data(self, values) -> torch.Tensor:
        x = float64_tensor(values, self.device)
        if x.shape[0] < self.n_clusters:
            raise ValueError(f"n_samples={x.shape[0]} should be >= "
                             f"n_clusters={self.n_clusters}.")
        return x

    def predict(self, values) -> np.ndarray:
        """The index of each row's nearest centre (int32)."""
        x = float64_tensor(values, self.device)
        return _nearest(x, self.cluster_centers).cpu().numpy().astype(
            np.int32)

    @property
    def cluster_centers_(self) -> np.ndarray:
        return self.cluster_centers.cpu().numpy()


class KMeans(_KMeansBase):
    """scikit-learn's ``KMeans(n_clusters, n_init=10)`` (Lloyd, its other
    defaults) on a device."""

    N_INIT = 10
    MAX_ITER = 300
    TOL = 1e-4

    def fit(self, values) -> "KMeans":
        x = self._data(values)
        tol = float(x.var(0, unbiased=False).mean()) * self.TOL
        mean = x.mean(0)
        x = x - mean
        x_squared_norms = (x * x).sum(1)
        generator = random_state(self.seed)
        best = None
        for _ in range(self.N_INIT):
            centers = _kmeans_plusplus(x, self.n_clusters, x_squared_norms,
                                       generator)
            labels, inertia, centers = _lloyd(x, centers, self.MAX_ITER, tol)
            if best is None or (inertia < best[1] and not _is_same_clustering(
                    labels, best[0], self.n_clusters)):
                best = (labels, inertia, centers)
        labels, self.inertia_, centers = best
        self.cluster_centers = centers + mean
        self.labels_ = labels.cpu().numpy().astype(np.int32)
        return self


class MiniBatchKMeans(_KMeansBase):
    """scikit-learn's ``MiniBatchKMeans(n_clusters, batch_size=100,
    n_init=3)`` (the JAX package's arguments, its other defaults) on a
    device."""

    BATCH_SIZE = 100
    N_INIT = 3
    MAX_ITER = 100
    MAX_NO_IMPROVEMENT = 10
    REASSIGNMENT_RATIO = 0.01

    def fit(self, values) -> "MiniBatchKMeans":
        x = self._data(values)
        n = x.shape[0]
        k = self.n_clusters
        batch_size = min(self.BATCH_SIZE, n)
        init_size = 3 * batch_size
        if init_size < k:
            init_size = 3 * k
        init_size = min(init_size, n)
        generator = random_state(self.seed)
        x_squared_norms = (x * x).sum(1)
        validation = x[torch.from_numpy(
            generator.randint(0, n, init_size)).to(self.device)]

        best_inertia = None
        for _ in range(self.N_INIT):
            if init_size < n:
                subset = torch.from_numpy(
                    generator.randint(0, n, init_size)).to(self.device)
                centers = _kmeans_plusplus(x[subset], k,
                                           x_squared_norms[subset],
                                           generator)
            else:
                centers = _kmeans_plusplus(x, k, x_squared_norms, generator)
            inertia = float(_inertia(validation, centers,
                                     _nearest(validation, centers)))
            if best_inertia is None or inertia < best_inertia:
                init_centers, best_inertia = centers, inertia
        centers = init_centers

        counts = torch.zeros(k, dtype=torch.float64, device=self.device)
        host_counts = np.zeros(k)
        smoothed = _SmoothedInertia(n, batch_size, self.MAX_NO_IMPROVEMENT)
        since_last_reassign = 0
        probabilities = np.ones(n) / n
        n_steps = (self.MAX_ITER * n) // batch_size
        for step in range(n_steps):
            indices = generator.choice(n, batch_size, p=probabilities,
                                       replace=True)
            since_last_reassign += batch_size
            reassign = bool((host_counts == 0).any()
                            or since_last_reassign >= 10 * k)
            if reassign:
                since_last_reassign = 0
            batch = x[torch.from_numpy(indices).to(self.device)]
            labels = _nearest(batch, centers)
            batch_inertia = _inertia(batch, centers, labels)
            batch_counts = torch.bincount(labels, minlength=k).double()
            sums = torch.zeros_like(centers).index_add_(0, labels, batch)
            new_counts = counts + batch_counts
            centers = torch.where(
                batch_counts[:, None] > 0,
                (centers * counts[:, None] + sums)
                * (1.0 / new_counts.clamp(min=1.0))[:, None],
                centers)
            counts = new_counts
            fetched = torch.cat([batch_inertia[None], counts]).cpu().numpy()
            batch_inertia, host_counts = float(fetched[0]), fetched[1:]
            if reassign:
                centers, counts, host_counts = self._reassign(
                    batch, centers, host_counts, generator)
            if smoothed.converged(step, batch_inertia / batch_size):
                break
        self.cluster_centers = centers
        self.n_steps_ = step + 1
        labels = _nearest(x, centers)
        self.labels_ = labels.cpu().numpy().astype(np.int32)
        self.inertia_ = float(_inertia(x, centers, labels))
        return self

    def _reassign(self, batch, centers, host_counts, generator):
        """scikit-learn's reassignment of centres of low count to random
        examples of the batch (``_mini_batch_step``)."""
        to_reassign = host_counts < self.REASSIGNMENT_RATIO * host_counts.max()
        if to_reassign.sum() > 0.5 * batch.shape[0]:
            keep = np.argsort(host_counts)[int(0.5 * batch.shape[0]):]
            to_reassign[keep] = False
        n_reassigns = int(to_reassign.sum())
        if n_reassigns:
            new_centers = generator.choice(batch.shape[0], replace=False,
                                           size=n_reassigns)
            centers = centers.clone()
            centers[torch.from_numpy(np.nonzero(to_reassign)[0]).to(
                centers.device)] = batch[torch.from_numpy(new_centers).to(
                    centers.device)]
        host_counts = host_counts.copy()
        host_counts[to_reassign] = np.min(host_counts[~to_reassign])
        return (centers, torch.from_numpy(host_counts).to(centers.device),
                host_counts)


class _SmoothedInertia:
    """scikit-learn's ``_mini_batch_convergence`` with ``tol`` 0: converged
    when the exponentially weighted mean of the batch inertia has not
    improved for ``max_no_improvement`` steps."""

    def __init__(self, n: int, batch_size: int, max_no_improvement: int):
        self.alpha = min(batch_size * 2.0 / (n + 1), 1)
        self.max_no_improvement = max_no_improvement
        self.inertia = None
        self.minimum = None
        self.no_improvement = 0

    def converged(self, step: int, batch_inertia: float) -> bool:
        if step == 0:
            return False
        if self.inertia is None:
            self.inertia = batch_inertia
        else:
            self.inertia = (self.inertia * (1 - self.alpha)
                            + batch_inertia * self.alpha)
        if self.minimum is None or self.inertia < self.minimum:
            self.no_improvement = 0
            self.minimum = self.inertia
        else:
            self.no_improvement += 1
        return self.no_improvement >= self.max_no_improvement
