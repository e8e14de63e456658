"""The counts: the same seed gives the same counts, another seed others,
and the law is Poisson(mean) + 1 at the density asked for."""

import numpy as np

from portbench.counts import make_counts, poisson_cdf

SEED = 2**31 + 7  # more than 32 signed bits hold, as a run's seed may be


def test_same_seed_same_counts():
    a = make_counts(3000, 64, 0.07, 3.0, SEED, "cpu")
    b = make_counts(3000, 64, 0.07, 3.0, SEED, "cpu")
    assert a.dtype == np.int16 and a.shape == (3000, 64)
    assert np.array_equal(a, b)


def test_other_seed_other_counts():
    a = make_counts(3000, 64, 0.07, 3.0, SEED, "cpu")
    b = make_counts(3000, 64, 0.07, 3.0, SEED + 1, "cpu")
    assert (a != b).mean() > 0.1


def test_law():
    counts = make_counts(40_000, 256, 0.07, 3.0, SEED, "cpu")
    nonzero = counts[counts > 0].astype(np.float64)
    assert abs((counts > 0).mean() - 0.07) < 2e-3
    assert abs(nonzero.mean() - 4.0) < 0.02  # Poisson(3) + 1
    assert abs(nonzero.var() - 3.0) < 0.05
    assert counts.min() == 0


def test_poisson_table_sums_to_one():
    assert abs(poisson_cdf(3.0)[-1] - 1.0) < 1e-12
