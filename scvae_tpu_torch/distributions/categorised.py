"""The categorical distribution and the piecewise-categorical
("categorised") count distribution (counterparts of ``Categorical`` in
``scvae_tpu/distributions/counts.py`` and of
``scvae_tpu/distributions/categorised.py``).

Counts below ``K = number of classes − 1`` come from a categorical over
``{0, …, K}``; counts ≥ K take the categorical's mass at class K times a
base count distribution shifted by K:

* ``log_prob(x) = cat.log_prob(min(x, K))``                  for x < K
* ``log_prob(x) = cat.log_prob(K) + dist.log_prob(x − K)``   for x ≥ K
* ``mean = Σ_{k<K} k·π_k + π_K·(dist.mean() + K)``
* ``variance`` from the matching second moment.
"""

from __future__ import annotations

import dataclasses

import torch

from scvae_tpu_torch.distributions.base import Distribution


@dataclasses.dataclass(frozen=True)
class Categorical(Distribution):
    """Categorical over ``{0, …, K−1}``; the trailing axis of ``logits`` is
    K."""

    logits: torch.Tensor

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    def log_probs(self) -> torch.Tensor:
        return torch.log_softmax(self.logits, dim=-1)

    def num_categories(self) -> int:
        return self.logits.shape[-1]

    def parameters(self):
        return (self.logits,)

    def log_prob(self, x):
        """log p at class ``clip(int(x), 0, K−1)`` (truncation toward zero,
        as the JAX package's ``astype(int32)``)."""
        idx = torch.clamp(x.to(torch.int64), 0, self.num_categories() - 1)
        shape = torch.broadcast_shapes(idx.shape, self.logits.shape[:-1])
        log_p = self.log_probs().expand(shape + self.logits.shape[-1:])
        return torch.gather(log_p, -1, idx.expand(shape)[..., None])[..., 0]

    def mean(self):
        k = torch.arange(self.num_categories(), dtype=self.logits.dtype,
                         device=self.logits.device)
        return torch.sum(self.probs * k, dim=-1)

    def variance(self):
        k = torch.arange(self.num_categories(), dtype=self.logits.dtype,
                         device=self.logits.device)
        second_moment = torch.sum(self.probs * torch.square(k), dim=-1)
        return second_moment - torch.square(self.mean())


@dataclasses.dataclass(frozen=True)
class Categorised(Distribution):
    dist: Distribution
    cat: Categorical

    @property
    def event_size(self) -> int:
        """The shift K = number of categorical classes − 1."""
        return self.cat.num_categories() - 1

    def log_prob(self, x):
        k = self.event_size
        cat_lp = self.cat.log_prob(torch.clamp(x, 0, k))
        shifted = torch.clamp(x - k, min=0.0)
        return torch.where(x < k, cat_lp, cat_lp + self.dist.log_prob(shifted))

    def mean(self):
        k = self.event_size
        probs = self.cat.probs
        ks = torch.arange(k, dtype=probs.dtype, device=probs.device)
        cat_mean = torch.sum(probs[..., :k] * ks, dim=-1)
        return cat_mean + probs[..., -1] * (self.dist.mean() + k)

    def variance(self):
        k = self.event_size
        probs = self.cat.probs
        ks = torch.arange(k, dtype=probs.dtype, device=probs.device)
        cat_m2 = torch.sum(probs[..., :k] * torch.square(ks), dim=-1)
        base_mean = self.dist.mean()
        dist_m2 = probs[..., -1] * (
            2.0 * k * base_mean + self.dist.variance()
            + torch.square(base_mean) + float(k) ** 2
        )
        return cat_m2 + dist_m2 - torch.square(self.mean())
