"""The CUDA kernels against their plain versions on the card, at small odd
shapes the headline run does not reach (rows, hidden width and genes not
multiples of the tiles, rows cycling over shared targets, float32 targets
and sources).  CUDA kernels have no CPU mode: these tests are marked
``cuda`` and skip without a GPU; on the GPU machine run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which these tests
do not use).

Tolerances: the gather is bit-exact; the likelihood kernels are held to the
same bounds as ``chip_smoke.py`` (max abs error over max |plain| of 2e-5
forward, 4e-4 backward with bf16 rounding, 2e-5 in float32 and against
autograd).
"""

import pytest
import torch

from scvae_tpu_torch import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol):
    """Max abs error at most ``rtol`` times the largest |value| of ``want``."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("f", [13, 16, 2000])
@pytest.mark.parametrize("src_dtype", [torch.int16, torch.int32, torch.float32])
def test_gather_bit_exact(device, f, src_dtype):
    gen = torch.Generator(device=device).manual_seed(f)
    src = torch.randint(0, 300, (97, f), generator=gen, device=device).to(src_dtype)
    idx = torch.randperm(97, generator=gen, device=device)[:41].to(torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        got = ops.gather_rows(src, idx, dtype)
        want = ops.reference_gather(src, idx, dtype)
        assert got.dtype == want.dtype == dtype and torch.equal(got, want)


def _case(device, m, m_t, hidden, f, t_dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.relu(torch.randn(m, hidden, generator=gen, device=device))
    limit = 3 * (6.0 / (hidden + f)) ** 0.5
    w_p, w_r = ((torch.rand(hidden, f, generator=gen, device=device) * 2 - 1) * limit
                for _ in range(2))
    b_p, b_r = (0.3 * torch.randn(f, generator=gen, device=device) for _ in range(2))
    t = torch.poisson(torch.full((m_t, f), 2.0, device=device), generator=gen)
    g = torch.randn(m, generator=gen, device=device)
    return (h, w_p, b_p, w_r, b_r), t.to(t_dtype), g


SHAPES = [(37, 37, 21, 301), (64, 32, 256, 100), (5, 5, 3, 40)]


@pytest.mark.parametrize("m,m_t,hidden,f", SHAPES)
@pytest.mark.parametrize("t_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("compute", [None, torch.bfloat16])
def test_nb_kernels_match_plain(device, m, m_t, hidden, f, t_dtype, compute):
    heads, t, g = _case(device, m, m_t, hidden, f, t_dtype)
    for const in (True, False):
        _close(ops.nb_forward(*heads, t, compute_dtype=compute,
                              include_lgamma_const=const),
               ops.reference_nb_log_likelihood(
                   *heads, t, compute_dtype=compute,
                   include_lgamma_const=const), 2e-5)
    got = ops.nb_backward(g, *heads, t, compute_dtype=compute)
    want = ops.reference_nb_backward(g, *heads, t, compute_dtype=compute)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, 4e-4 if compute is not None else 2e-5)


@pytest.mark.parametrize("m,m_t,hidden,f", SHAPES)
def test_nb_backward_matches_autograd(device, m, m_t, hidden, f):
    heads, t, g = _case(device, m, m_t, hidden, f, torch.float32, seed=1)
    leaves = [x.clone().requires_grad_(True) for x in heads]
    ll = ops.reference_nb_log_likelihood(*leaves, t)
    want = torch.autograd.grad(ll, leaves, grad_outputs=g)
    for a, b in zip(ops.nb_backward(g, *heads, t), want):
        _close(a, b, 2e-5)


def test_fused_function_and_counts(device):
    heads, t, g = _case(device, 48, 16, 32, 70, torch.bfloat16, seed=2)
    h = heads[0].reshape(3, 16, 32).clone().requires_grad_(True)
    names = {"p": heads[1:3], "log_r": heads[3:5]}
    params = {k: {"kernel": w.clone().requires_grad_(True),
                  "bias": b.clone().requires_grad_(True)}
              for k, (w, b) in names.items()}
    ops.reset_launch_counts()
    out = ops.fused_log_likelihood("negative binomial", h, params, t,
                                   compute_dtype=torch.bfloat16)
    assert out.shape == (3, 16)
    out.backward(g.reshape(3, 16))
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"gather_rows": 0, "nb_forward": 1,
                                   "nb_backward_dh": 1, "nb_backward_dw": 1}
    assert torch.isfinite(h.grad).all()
    with pytest.raises(ValueError):
        ops.nb_forward(heads[0], *heads[1:], t[:5])  # 48 rows over 5 targets
