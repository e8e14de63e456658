"""Operation and byte counts against numbers worked by hand at the
configuration's widths (hidden [100], latent 2) and brain1m3's 27,998
genes."""

import pytest

from portbench import roofline
from portbench.configs import vae_nb

VAE = {"feature_size": 27998, "hidden_sizes": [100], "latent_size": 2}


def test_vae_operations():
    # m·k·n of the step's products at 2,048 rows: the encoder's layer
    # 2048·27998·100 = 5,733,990,400 (it reads the counts: no input
    # gradient); the others 2·2048·100·2 + 2048·2·100 + 2·2048·100·27998 =
    # 11,469,209,600.
    first, rest = 5_733_990_400, 11_469_209_600
    assert vae_nb.train_flops(VAE, 2048) == 2 * (2 * first + 3 * rest)
    assert vae_nb.train_flops(VAE, 2048) == 91_751_219_200
    assert vae_nb.eval_flops(VAE, 2048) == 2 * (first + rest)


def test_likelihood_least_time():
    # NB at 2,048 decoder rows against 2,048 targets: three products of
    # 2·2·2048·100·27998 = 22,935,961,600 operations, 68,807,884,800 in
    # all (69.57 us at 989 TFLOP/s).  Bytes: h 819,200 + heads 2·(100 +
    # 1)·27998·4 = 22,622,384 + t (bf16) 114,679,808 read; row sums 8,192 +
    # dh 819,200 + the heads' gradients 22,622,384 written: 161,571,168
    # (48.23 us at 3.35 TB/s).  Bound by its operations.
    got = roofline.likelihood_least_seconds(rows=2048, targets=2048,
                                            hidden=100, genes=27998, heads=2)
    assert got == pytest.approx(68_807_884_800 / 989e12, rel=1e-12)
    assert 161_571_168 / 3.35e12 < got
    assert roofline.likelihood_least_seconds(
        rows=100, targets=100, hidden=100, genes=32738, heads=2) \
        == pytest.approx((100 * 100 * 4 * 2 + 100 * 32738 * 2 + 100 * 4
                          + 2 * 2 * 101 * 32738 * 4) / 3.35e12, rel=1e-12)
    assert vae_nb.likelihood_calls(VAE, 2048) == [
        {"rows": 2048, "targets": 2048, "hidden": 100, "genes": 27998,
         "heads": 2}]
