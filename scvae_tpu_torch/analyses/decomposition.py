"""Decompositions of latent and data values: the port of
``scvae_tpu/analyses/decomposition.py`` (the reference's
``scvae/analyses/decomposition/``), with its method names, registry,
transforms of other value sets and projection of Gaussian-mixture centroids
(means through the fitted components, covariances by C Σ Cᵀ).

The JAX package calls scikit-learn; these are scikit-learn 1.9.0's
estimators computed with PyTorch on a device (CUDA unless ``"cpu"``), in
float64 (ICA and t-SNE as below), with its sign convention (``svd_flip``:
the largest |entry| of each component is positive):

* PCA of a dense set of at most 2,000 features: exact, from the SVD of the
  centred values;
* IncrementalPCA (more features, or a sparse set): batches of 100 rows
  (the last one merged into the one before when shorter than the number
  of components), each folded into the running components with
  scikit-learn's update;
* SVD: ``TruncatedSVD``'s randomised algorithm (10 oversamples, 5 power
  iterations normalised by LU, the smaller side first), its Gaussian test
  matrix drawn from ``numpy.random.RandomState(seed)`` (None: a fresh
  generator, as the JAX package's is unseeded);
* ICA: ``FastICA(n_components, random_state)`` with its defaults (the
  parallel algorithm, log cosh, at most 200 iterations to 1e-4,
  unit-variance whitening by the SVD with scikit-learn's sign convention
  on u, symmetric decorrelation by ``torch.linalg.eigh``), its initial
  unmixing matrix drawn as ``RandomState(seed).normal(size=(k, k))``, in
  the dtype scikit-learn computes in (float32 for float32 inputs, else
  float64);
* t-SNE: ``TSNE(n_components, method="barnes_hut" if n_components < 4
  else "exact", random_state)`` (``tsne.py``); it transforms no other value set, as in the JAX package.

ICA and t-SNE draw from seed 42, as the JAX package's ``random_state=42``,
or from ``seed`` with ``random=True`` (the JAX package's unseeded switch).
Results come back as numpy arrays of the float dtype scikit-learn gives
(float32 from PCA, SVD and ICA of float32 inputs and from t-SNE, else
float64).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.sparse
import torch

from scvae_tpu_torch.analyses.tsne import TSNE
from scvae_tpu_torch.defaults import get_default
from scvae_tpu_torch.utils.device import (
    float64_tensor,
    random_state,
    resolve_device,
)
from scvae_tpu_torch.utils.strings import normalise_string, proper_string

DECOMPOSITION_METHOD_NAMES = {
    "PCA": ["pca"],
    "SVD": ["svd"],
    "ICA": ["ica"],
    "t-SNE": ["t_sne", "tsne"],
}

MAXIMUM_FEATURE_SIZE_FOR_NORMAL_PCA = 2000
DECOMPOSITION_RANDOM_SEED = 42


def _output_dtype(*arrays) -> np.dtype:
    """The float dtype that scikit-learn's estimators give back for these
    inputs: float32 when every input is float32, else float64."""
    dtypes = [a.dtype if scipy.sparse.issparse(a) else np.asarray(a).dtype
              for a in arrays]
    if all(dtype == np.float32 for dtype in dtypes):
        return np.dtype(np.float32)
    return np.dtype(np.float64)


def _svd_flip(u: torch.Tensor | None,
              vt: torch.Tensor) -> tuple[torch.Tensor | None, torch.Tensor]:
    """scikit-learn's ``svd_flip(u, vt, u_based_decision=False)``."""
    largest = torch.argmax(vt.abs(), dim=1)
    signs = torch.sign(vt[torch.arange(vt.shape[0], device=vt.device),
                          largest])
    if u is not None:
        u = u * signs[None, :]
    return u, vt * signs[:, None]


class _Projection:
    """A fitted linear decomposition: ``transform`` is (x − mean) Cᵀ."""

    components: torch.Tensor
    mean: torch.Tensor | None = None
    dtype: np.dtype

    def __init__(self, n_components: int, device):
        self.n_components = n_components
        self.device = resolve_device(device)

    def _transform(self, values) -> torch.Tensor:
        x = float64_tensor(values, self.device)
        if self.mean is not None:
            x = x - self.mean
        return x @ self.components.T

    def transform(self, values) -> np.ndarray:
        return self._transform(values).cpu().numpy().astype(
            np.result_type(_output_dtype(values), self.dtype))

    @property
    def components_(self) -> np.ndarray:
        return self.components.cpu().numpy().astype(self.dtype)


class PCA(_Projection):
    """scikit-learn's ``PCA(n_components)``, exact."""

    def fit_transform(self, values) -> np.ndarray:
        self.dtype = _output_dtype(values)
        x = float64_tensor(values, self.device)
        self.mean = x.mean(0)
        _, _, vt = torch.linalg.svd(x - self.mean, full_matrices=False)
        _, vt = _svd_flip(None, vt)
        self.components = vt[:self.n_components]
        return self.transform(values)


class IncrementalPCA(_Projection):
    """scikit-learn's ``IncrementalPCA(n_components, batch_size=100)``."""

    BATCH_SIZE = 100

    def _batches(self, n: int):
        """scikit-learn's ``gen_batches(n, batch_size,
        min_batch_size=n_components)``."""
        start = 0
        for _ in range(n // self.BATCH_SIZE):
            end = start + self.BATCH_SIZE
            if end + self.n_components > n:
                continue
            yield slice(start, end)
            start = end
        if start < n:
            yield slice(start, n)

    def fit_transform(self, values) -> np.ndarray:
        # scikit-learn's running mean is float64, and so its components
        self.dtype = np.dtype(np.float64)
        if scipy.sparse.issparse(values):
            values = values.tocsr()
        n_seen = 0
        singular_values = None
        for rows in self._batches(values.shape[0]):
            x = float64_tensor(values[rows], self.device)
            n_batch = x.shape[0]
            n_total = n_seen + n_batch
            if n_seen == 0:
                mean = x.sum(0) / n_total
                x = x - mean
            else:
                mean = (self.mean * n_seen + x.sum(0)) / n_total
                batch_mean = x.mean(0)
                x = torch.cat([
                    singular_values[:, None] * self.components,
                    x - batch_mean,
                    (np.sqrt((n_seen / n_total) * n_batch)
                     * (self.mean - batch_mean))[None, :],
                ])
            _, s, vt = torch.linalg.svd(x, full_matrices=False)
            _, vt = _svd_flip(None, vt)
            n_seen = n_total
            self.components = vt[:self.n_components]
            singular_values = s[:self.n_components]
            self.mean = mean
        return self.transform(values)


def _randomised_svd(m: torch.Tensor, n_components: int, n_iter: int,
                    seed) -> tuple[torch.Tensor, torch.Tensor]:
    """scikit-learn's ``_randomized_svd`` (10 oversamples, power iterations
    normalised by LU, the smaller side first, no sign flip): (u, vt)."""
    transpose = m.shape[0] < m.shape[1]
    if transpose:
        m = m.T
    q = torch.from_numpy(random_state(seed).normal(
        size=(m.shape[1], n_components + 10))).to(m.device)
    for _ in range(n_iter):
        permutation, lower, _ = torch.linalg.lu(m @ q)
        q = permutation @ lower
        permutation, lower, _ = torch.linalg.lu(m.T @ q)
        q = permutation @ lower
    q, _ = torch.linalg.qr(m @ q)
    u_hat, _, vt = torch.linalg.svd(q.T @ m, full_matrices=False)
    u = q @ u_hat
    if transpose:
        return vt[:n_components].T, u[:, :n_components].T
    return u[:, :n_components], vt[:n_components]


class TruncatedSVD(_Projection):
    """scikit-learn's ``TruncatedSVD(n_components)`` (randomised, 5
    iterations, 10 oversamples); no centring."""

    def __init__(self, n_components: int, seed, device):
        super().__init__(n_components, device)
        self.seed = seed

    def fit_transform(self, values) -> np.ndarray:
        self.dtype = _output_dtype(values)
        u, vt = _randomised_svd(float64_tensor(values, self.device),
                                self.n_components, 5, self.seed)
        _, self.components = _svd_flip(u, vt)
        return self.transform(values)


class RandomisedPCA(_Projection):
    """scikit-learn's ``PCA(n_components, random_state=seed)`` where its
    "auto" solver is the randomised one: the centred values' randomised
    SVD (7 power iterations below a tenth of the smaller side, else 4)."""

    def __init__(self, n_components: int, seed, device):
        super().__init__(n_components, device)
        self.seed = seed

    def fit_transform(self, values) -> np.ndarray:
        self.dtype = _output_dtype(values)
        x = float64_tensor(values, self.device)
        self.mean = x.mean(0)
        n_iter = 7 if self.n_components < 0.1 * min(x.shape) else 4
        u, vt = _randomised_svd(x - self.mean, self.n_components, n_iter,
                                self.seed)
        _, self.components = _svd_flip(u, vt)
        return self.transform(values)


def _symmetric_decorrelation(w: torch.Tensor) -> torch.Tensor:
    """(W Wᵀ)^(-1/2) W through ``torch.linalg.eigh``."""
    s, u = torch.linalg.eigh(w @ w.T)
    s = torch.clamp(s, min=torch.finfo(w.dtype).tiny)
    return (u * (1.0 / torch.sqrt(s))) @ u.T @ w


class FastICA(_Projection):
    """scikit-learn's ``FastICA(n_components, random_state=seed)``;
    ``n_iter_`` is the number of fixed-point steps taken."""

    MAXIMUM_ITERATIONS = 200
    TOLERANCE = 1e-4

    def __init__(self, n_components: int, seed, device):
        super().__init__(n_components, device)
        self.seed = seed

    def fit_transform(self, values) -> np.ndarray:
        if scipy.sparse.issparse(values):
            values = values.toarray()
        values = np.asarray(values)
        self.dtype = np.dtype(np.float32 if values.dtype == np.float32
                              else np.float64)
        xt = torch.from_numpy(values.astype(self.dtype)).to(self.device).T
        n_features, n_samples = xt.shape
        k = min(self.n_components, n_samples, n_features)
        mean = xt.mean(-1)
        xt = xt - mean[:, None]
        u, d = torch.linalg.svd(xt, full_matrices=False)[:2]
        u = u * torch.sign(u[0])
        whitening = (u / d).T[:k]
        x1 = whitening @ xt * np.sqrt(n_samples)
        w = _symmetric_decorrelation(torch.from_numpy(
            random_state(self.seed).normal(size=(k, k)).astype(self.dtype)
        ).to(self.device))
        for self.n_iter_ in range(1, self.MAXIMUM_ITERATIONS + 1):
            gwtx = torch.tanh(w @ x1)
            g_wtx = (1.0 - gwtx * gwtx).mean(-1)
            w1 = _symmetric_decorrelation(gwtx @ x1.T / float(n_samples)
                                          - g_wtx[:, None] * w)
            limit = float(torch.max(torch.abs(
                torch.abs((w1 * w).sum(1)) - 1.0)))
            w = w1
            if limit < self.TOLERANCE:
                break
        sources = (w @ whitening @ xt).T
        deviations = sources.std(0, correction=0, keepdim=True)
        sources = sources / deviations
        w = w / deviations.T
        self.components = (w @ whitening).double()
        self.mean = mean.double()
        return sources.cpu().numpy()


def decompose(
    values,
    other_value_sets: dict[str, Any] | None = None,
    centroids: dict[str, Any] | None = None,
    method: str | None = None,
    number_of_components: int | None = None,
    random: bool = False,
    seed=None,
    device=None,
):
    """Fit a decomposition on ``values`` on ``device`` and transform the
    other value sets and centroids (reference ``decomposition.py:44-167``).

    Returns ``values_decomposed``, plus the transformed ``other_value_sets``
    and/or ``centroids`` when those were given.  ``seed`` seeds the SVD's
    randomised range finder; ICA and t-SNE draw from seed 42, or from
    ``seed`` with ``random`` (the JAX package's switch of that fixed
    seed)."""
    if method is None:
        method = get_default("analyses", "decomposition_method")
    method = proper_string(normalise_string(method),
                           DECOMPOSITION_METHOD_NAMES)
    if number_of_components is None:
        number_of_components = get_default(
            "analyses", "decomposition_dimensionality"
        )
    method_seed = seed if random else DECOMPOSITION_RANDOM_SEED

    if method == "PCA":
        if (
            values.shape[1] <= MAXIMUM_FEATURE_SIZE_FOR_NORMAL_PCA
            and not scipy.sparse.issparse(values)
        ):
            model = PCA(number_of_components, device)
        else:
            model = IncrementalPCA(number_of_components, device)
    elif method == "SVD":
        model = TruncatedSVD(number_of_components, seed, device)
    elif method == "ICA":
        model = FastICA(number_of_components, method_seed, device)
    elif method == "t-SNE":
        model = TSNE(number_of_components, method_seed, device)
    else:
        raise ValueError(f"Method `{method}` not found.")

    values_decomposed = model.fit_transform(values)

    other_sets_given = other_value_sets is not None
    wrapped_other = False
    if other_sets_given and not isinstance(other_value_sets, dict):
        other_value_sets = {"unknown": other_value_sets}
        wrapped_other = True

    if other_sets_given and other_value_sets and method != "t-SNE":
        other_decomposed = {
            name: (model.transform(vals) if vals is not None else None)
            for name, vals in other_value_sets.items()
        }
        if wrapped_other:
            other_decomposed = other_decomposed["unknown"]
    else:
        other_decomposed = None

    centroids_given = centroids is not None
    centroids_decomposed = None
    if centroids_given and centroids and method == "PCA":
        wrapped = "means" in centroids
        centroid_sets = {"unknown": centroids} if wrapped else centroids
        components = model.components
        centroids_decomposed = {}
        for distribution, dist_centroids in centroid_sets.items():
            if not dist_centroids:
                centroids_decomposed[distribution] = None
                continue
            decomposed = {}
            for parameter, parameter_values in dist_centroids.items():
                parameter_values = np.asarray(parameter_values)
                if parameter == "means":
                    shape = np.array(parameter_values.shape)
                    reshaped = parameter_values.reshape(-1, shape[-1])
                    transformed = model.transform(reshaped)
                    shape[-1] = number_of_components
                    decomposed[parameter] = transformed.reshape(shape)
                elif parameter == "covariance_matrices":
                    shape = np.array(parameter_values.shape)
                    dim = shape[-1]
                    reshaped = float64_tensor(
                        parameter_values.reshape(-1, dim, dim),
                        model.device)
                    projected = torch.einsum(
                        "cd,nde,fe->ncf", components, reshaped, components)
                    shape[-2:] = number_of_components
                    decomposed[parameter] = projected.cpu().numpy().astype(
                        np.result_type(_output_dtype(parameter_values),
                                       model.dtype)).reshape(shape)
                else:
                    decomposed[parameter] = parameter_values
            centroids_decomposed[distribution] = decomposed
        if wrapped:
            centroids_decomposed = centroids_decomposed["unknown"]

    output = [values_decomposed]
    if other_sets_given:
        output.append(other_decomposed)
    if centroids_given:
        output.append(centroids_decomposed)
    if len(output) == 1:
        return output[0]
    return tuple(output)
