"""The grouped float32 K4/K5 design on the tensor cores
(``ops/csrc/grouped_likelihood_tc.cu`` with ``SEG = kSplitPairs``, then the
products of ``tc_product.cu``) on the CPU, through its plain versions: h, W
and da as ``SPLIT_TERMS`` bf16 terms over the G·M group-major rows, the
heads' products over the pairs of terms.  The split-layout plain forward
and gradient (with the products of its scratch) against the JAX package's
``_grouped_forward`` / ``_grouped_backward`` with float32 compute (Pallas
in interpret mode), at the headline width and at a ragged width and gene
count off the 64-gene tiles, for G = 1, 3 and 17 (past the cap of 16); the
scratch's layout, the plan's resident W slots, and the CPU wrappers, which
run the float32 plain versions and launch nothing.

Tolerances: rtol 2e-5 against the JAX package, with an absolute floor of
the same fraction of the largest |reference| value, as
``tests/test_torch_f32_tc.py`` holds the flat float32 design: three bf16
terms leave at most 2⁻²⁴ of each value, the rest is float32 summation
order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu.ops import fused_likelihood as jfl
from scvae_tpu_torch import ops
from scvae_tpu_torch.ops import fused_likelihood as fl

FAMILIES = list(ops.FAMILIES)
M = 20
RTOL = 2e-5
# (G, H, F): the headline width with one and three groups, a ragged width
# and gene count, and 17 groups past the cap
CASES = [(1, 256, 128), (3, 256, 128), (3, 37, 301), (17, 37, 301)]


def _case(name, n_groups, hidden, f, seed, m=M):
    """ReLU h (G, M, H), heads three times Glorot-uniform (activations that
    reach the exponentials' clip), Poisson(2) targets (M, F) shared by the
    groups, and row cotangents (G, M)."""
    rng = np.random.RandomState(seed)
    h = np.maximum(rng.randn(n_groups, m, hidden), 0.0).astype(np.float32)
    limit = 3 * (6.0 / (hidden + f)) ** 0.5
    k = len(ops.FAMILIES[name].heads)
    ws = [rng.uniform(-limit, limit, (hidden, f)).astype(np.float32)
          for _ in range(k)]
    bs = [(0.3 * rng.randn(f)).astype(np.float32) for _ in range(k)]
    t = rng.poisson(2.0, (m, f)).astype(np.float32)
    g = rng.randn(n_groups, m).astype(np.float32)
    return h, ws, bs, t, g


def _torch(h, ws, bs, t, g):
    return (torch.from_numpy(h), [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(b) for b in bs], torch.from_numpy(t),
            torch.from_numpy(g))


def assert_close(ours, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        ours.detach().float().numpy(), ref, rtol=rtol,
        atol=rtol * float(np.abs(ref).max()),
    )


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("n_groups,hidden,f", CASES)
def test_plain_forward_matches_jax_interpret(name, n_groups, hidden, f):
    """The split design's row sums (``reference_grouped_f32_tc_forward``)
    against the JAX kernel K4 with float32 compute, lgamma(1 + t)
    subtracted as K4 always does."""
    h, ws, bs, t, _ = _case(name, n_groups, hidden, f, seed=n_groups)
    with pltpu.force_tpu_interpret_mode():
        ref = jfl._grouped_forward(
            jfl._BASE_LL[name], jnp.asarray(h), tuple(map(jnp.asarray, ws)),
            tuple(map(jnp.asarray, bs)), jnp.asarray(t),
            subtract_lgamma_const=True, compute_dtype=None)
    hh, wt, bt, tt, _ = _torch(h, ws, bs, t, np.zeros(1, np.float32))
    got = fl.reference_grouped_f32_tc_forward(name, hh, wt, bt, tt)
    assert tuple(got.shape) == (n_groups, M)
    assert_close(got, ref)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("n_groups,hidden,f", CASES)
def test_plain_gradient_matches_jax_interpret(name, n_groups, hidden, f):
    """dh, dW and db from the grouped split design's gradient scratch
    (``reference_grouped_f32_tc_gradient``, then the plain products of its
    layout) against the JAX kernel K5 with float32 compute."""
    h, ws, bs, t, g = _case(name, n_groups, hidden, f, seed=10 + n_groups)
    with pltpu.force_tpu_interpret_mode():
        ref_dh, ref_dws, ref_dbs = jfl._grouped_backward(
            jfl._BASE_GRADS[name], jnp.asarray(h),
            tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
            jnp.asarray(t), jnp.asarray(g), compute_dtype=None)
    hh, wt, bt, tt, gt = _torch(h, ws, bs, t, g)
    grad = fl.reference_grouped_f32_tc_gradient(name, gt, hh, wt, bt, tt)
    assert (grad.prefix, grad.suffix) == (
        f"{ops.FAMILIES[name].prefix}_grouped", "_float32")
    assert_close(fl.reference_tc_dh(grad).reshape(hh.shape), ref_dh)
    got = fl.reference_tc_dw(grad)
    assert len(got) == 2 * len(ws)
    for k, (dw, db) in enumerate(zip(ref_dws, ref_dbs)):
        assert_close(got[2 * k], dw)
        assert_close(got[2 * k + 1], db)


@pytest.mark.parametrize("m", [64, 130])
def test_scratch_layout(m):
    """The scratch (G·M, P·NH·Fp): group-major rows, slot p of each row
    holding term i of pair p of g·∂ll/∂a from the split design's
    activations, zero past F; db_parts (ceil(M / 64), NH·Fp): the column
    sums of every group's unrounded da over each 64 target rows; h's terms
    per pair as the dW product reads them (P·G·M, Hp)."""
    name, n_groups, hidden, f = "negative binomial", 3, 37, 301
    h, ws, bs, t, g = _torch(*_case(name, n_groups, hidden, f, seed=3, m=m))
    grad = fl.reference_grouped_f32_tc_gradient(name, g, h, ws, bs, t)
    pairs, fp, hp = len(fl.SPLIT_PAIRS), fl.tc_padded(f), fl.tc_padded(hidden)
    rows = n_groups * m
    assert grad.da.dtype == torch.bfloat16
    assert tuple(grad.da.shape) == (rows, pairs * 2 * fp)
    assert tuple(grad.db_parts.shape) == (-(-m // 64), 2 * fp)
    assert tuple(grad.h.shape) == (pairs * rows, hp)
    h2 = h.reshape(rows, hidden)
    acts = fl._f32_tc_activations(h2, ws, bs)
    want = torch.stack(ops.FAMILIES[name].grads(
        *acts, fl._cycle_rows(t, rows)), 1) * g.reshape(-1)[:, None, None]
    terms = fl.split_bf16(want, fl.SPLIT_TERMS)
    da = grad.da.reshape(rows, pairs, 2, fp)
    for p, (i, _) in enumerate(fl.SPLIT_PAIRS):
        assert torch.equal(da[:, p, :, :f], terms[i])
        assert not da[:, p, :, f:].any()
    over_groups = want.reshape(n_groups, m, 2 * f).sum(0)
    for tile in range(grad.db_parts.shape[0]):
        sums = over_groups[64 * tile:64 * (tile + 1)].sum(0)
        got = grad.db_parts[tile].reshape(2, fp)[:, :f].reshape(-1)
        assert_close(got, sums.numpy(), rtol=1e-5)  # float32 sum order
    h_terms = fl.split_bf16(h2, fl.SPLIT_TERMS)
    packed = grad.h.reshape(rows, pairs, hp)
    for p, (_, j) in enumerate(fl.SPLIT_PAIRS):
        assert torch.equal(packed[:, p, :hidden], h_terms[j])
        assert not packed[:, p, hidden:].any()
    plan = fl.grouped_tc_plan(n_groups, m, hidden, f, 2, float32=True)
    assert plan == grad.plan
    assert plan["da"] == tuple(grad.da.shape)
    assert plan["db_parts"] == tuple(grad.db_parts.shape)
    assert plan["grid"] == (-(-m // fl.GROUPED_TC_ROWS), -(-f // 64))


@pytest.mark.parametrize("n_heads,hidden,chunk,slots", [
    (1, 256, 256, 3), (2, 256, 256, 1), (3, 256, 256, 1),
    (1, 1024, 768, 1), (2, 1024, 384, 1), (3, 37, 64, 3)])
def test_plan_keeps_w_terms_resident(n_heads, hidden, chunk, slots):
    """The float32 plan keeps W's three terms in slots of all of Hp while
    they fit (Poisson at the headline width: all three; NB and ZINB one,
    restaged as the ring reaches each term), else one slot of as many
    64-row chunks as fit; the products as f32_tc_plan plans them over the
    G·M rows, db's sums per 64 target rows."""
    plan = fl.grouped_tc_plan(10, 2048, hidden, 2048, n_heads, float32=True)
    assert (plan["w_chunk"], plan["w_slots"]) == (chunk, slots)
    assert chunk % 64 == 0
    assert plan["smem_bytes"] <= fl.GROUPED_TC_SMEM
    flat = fl.f32_tc_plan(20480, hidden, 2048, n_heads)
    for key in ("hp", "fp", "da", "dh_splits", "dw_splits"):
        assert plan[key] == flat[key]
    assert plan["db_parts"] == (32, n_heads * 2048)
    bf16 = fl.grouped_tc_plan(10, 2048, hidden, 2048, n_heads)
    assert bf16["w_slots"] == 1


@pytest.mark.parametrize("name", FAMILIES)
def test_cpu_wrappers_run_the_float32_plain_versions(name):
    """On CPU tensors the grouped float32 forward and backward return the
    float32 plain versions exactly and launch no kernel; the split design
    is within the checks' 2e-5 of them."""
    h, ws, bs, t, g = _torch(*_case(name, 3, 37, 301, seed=7))
    ops.reset_launch_counts()
    got = ops.grouped_forward(name, h, ws, bs, t)
    want = ops.reference_grouped_forward(name, h, ws, bs, t)
    assert torch.equal(got, want)
    assert_close(fl.reference_grouped_f32_tc_forward(name, h, ws, bs, t),
                 want.numpy())
    got = ops.grouped_backward(name, g, h, ws, bs, t)
    want = (ops.reference_grouped_dh(name, g, h, ws, bs, t),
            *ops.reference_grouped_dw(name, g, h, ws, bs, t))
    assert len(got) == len(want) == 1 + 2 * len(ws)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    grad = fl.reference_grouped_f32_tc_gradient(name, g, h, ws, bs, t)
    split = (fl.reference_tc_dh(grad).reshape(h.shape),
             *fl.reference_tc_dw(grad))
    for a, b in zip(split, want, strict=True):
        assert_close(a, b.numpy())
    assert not any(ops.launch_counts().values())
