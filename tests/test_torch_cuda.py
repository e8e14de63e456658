"""The CUDA kernels against their plain versions on the card, at small odd
shapes the headline run does not reach (rows, hidden width and genes not
multiples of the tiles, rows cycling over shared targets, float32 targets
and sources, decoder widths above one 256-unit hidden chunk).  CUDA kernels
have no CPU mode: these tests are marked ``cuda`` and skip without a GPU; on
the GPU machine run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which these tests
do not use).

The base families' K2/K3 run on the tensor cores
(``count_likelihood_tc.cu``, then the products of ``tc_product.cu``), bf16
on bf16 operands and float32 on three bf16 terms of each operand; both are
held at the odd shapes, and also at the main path's width with full and
ragged tiles.  There each of the backward's three kernels is
held on its own: the gradient kernel's bf16(da) within one bf16 step of the
plain bf16(da) (a float32 sum in another order puts a value on the other
side of a rounding boundary now and then), with few such flips; the dh and
dW products against the plain products of the kernel's own da at 2e-5.
The float32 instance is held the same way against its plain version in the
split layout (``reference_f32_tc_gradient``): da's first term within one
bf16 step, the sum of its terms at 2e-5, and every output against the
float32 plain versions at 2e-5.  The categorised bf16 backward
(``categorised_likelihood_tc.cu`` and the same products) is held the same
way at 14 and 32 heads for every base, and its float32 forward and backward
(the same kernels on three bf16 terms of h, W and da) kernel by kernel
against their split plain versions, also with a scratch past 32-bit
offsets, and
the product kernel alone at full and ragged tiles in both layouts, with and
without promoted sums, and bit for bit over two runs; the categorised bf16
forward (``categorised_likelihood_tc.cu``) at 32 heads for every base, its
row sums, lse and row-sum partials, and bit for bit over two runs.  The
constrained Poisson's bf16 kernels (``cp_likelihood_tc.cu``, h as a bf16
tensor, W and da split into bf16 terms) are held kernel by kernel the same
way, and against the float32 plain versions, at the main path's width, odd
shapes, ragged F, cycled rows and decoder widths of 580, 584 and 1,024; its
float32 kernels (the same kernels on three bf16 terms of h, W and da) kernel
by kernel against their split plain versions, at the main path's width
with full and ragged tiles, cycled rows and a decoder width of 584.

Tolerances: the gather is bit-exact; the likelihood kernels are held to the
same bounds as ``chip_smoke.py`` (max abs error over max |plain| of 2e-5
forward, 4e-4 backward with bf16 rounding, 2e-5 in float32 and against
autograd; the constrained Poisson never rounds, so 2e-5 throughout).  The
categorised kernels are checked with 14 heads (ZINB, K = 10) and the
largest case of 32 (Poisson, K = 30), at odd shapes, ragged F and decoder
widths past one hidden chunk.  The grouped kernels (K4/K5, bf16 and
float32: ``grouped_likelihood_tc.cu``, then the same products) are checked
at group counts of 1, 3 and 17 (past the 16 of
``supports_grouped_likelihood``), rows and genes off the tiles and decoder
widths of 584 and 1,024, against their plain versions and against the flat
kernels over the same group-major rows with cycled targets; and kernel by
kernel, past one block of target rows, with W resident in several chunks
and (float32) restaged term by term.  The row gather is bit-exact on both of its paths (16-byte units,
single elements), and an index outside the matrix traps.

The data engine on the card: the GMVAE's per-epoch accuracy callback
against the same callback on the CPU from the same parameters and set
(equal cluster ids, apart from ties within 1e-5 of the q(y|x) logits), and
a training step on log-preprocessed values, which the model stages as
float32 and K1 gathers from a float32 source.

The analyses on the card (``analyses/``) against the same functions on
the CPU: ARI equal, AMI within 1e-12; the silhouette, summary statistics
and correlations within 1e-9; k-means and mini-batch k-means from the same
seed the same partition; PCA, IncrementalPCA and the randomised SVD within
1e-6.

The compiled epoch (``models/step.py``): a small NB VAE and GMVAE trained
for two epochs as CUDA graph replays against the same steps run eagerly
from the same state and generator (parameters within 2e-5 of the largest,
metrics and generator state equal), also with the second epoch's
permutation one the capture never saw; the full-batch evaluation epoch
likewise, also on parameters other than those it was captured with; the
launch counters count each replay's launches; a step that a capture
refuses raises.

The profiling tools (``utils/profiling.py``): ``trace`` around two
epochs of that NB VAE, the second all replays; ``summarize_trace`` finds
the heads kernel, the products and K1 by name, each as often as the launch
counters count them, and ``device_memory_stats`` reads 0 < bytes in use ≤
the card's memory.  The span recorder (``utils/tracing.py``) through an
NB VAE's ``train``: one eager call and one capture of each graphed epoch,
all in the first epoch, the capture counter as their count, the training
spans equal to ``epoch_seconds``, and in a trace each span within 1 ms of
its ``user_annotation`` and the epoch's kernels inside its spans.

Data parallel (``parallel/``) on a world of one NCCL rank: that NB VAE's
two graphed epochs with the mesh against the same epochs without it (the
curves within 1e-6 relative, the parameters within the small step's
bound), and NCCL's reduction kernel found in the trace of the mesh's
replayed epoch as often as the step's all-reduces were counted.

The gene split's launches (``ops.sharded``) on one card: two gene blocks
through the split Functions with a ``GeneSplit`` of no group, summed and
put together, against the whole-F kernels.

The per-epoch evaluation on the float32 fused forward (``models/api.py``
``_device_evaluator``): against the unfused evaluation of the same state,
NB at the brain cell's widths (2,048 rows a batch and a remainder over
27,998 genes, hidden 100) and every likelihood with a kernel at 2,000
genes, the lower bound within 1e-6 relative, the float32 forward launched
once a batch and the passes counted; and the fused evaluation of two gene
blocks with no group against the whole-F one.
"""

import contextlib

import pytest
import torch

from scvae_tpu_torch import ops

pytestmark = pytest.mark.cuda

FAMILIES = list(ops.FAMILIES)
# (M, M_t, H, F)
SHAPES = [(37, 37, 21, 301), (64, 32, 256, 100), (5, 5, 3, 40),
          (26, 13, 3, 13)]


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


@pytest.mark.parametrize("f", [1, 8, 13, 16, 2000, 2048, 4100, 4104])
@pytest.mark.parametrize("src_dtype", [torch.int16, torch.int32, torch.float32])
def test_gather_bit_exact(device, f, src_dtype):
    """Both paths of K1 (16-byte units for rows of whole units, F = 8,
    16, 2,000, 2,048 and 4,104; the element path for F = 1, 13 and 4,100),
    one row, a permuted batch and 2,049 indices with repeats."""
    gen = torch.Generator(device=device).manual_seed(f)
    src = torch.randint(0, 300, (3000, f), generator=gen,
                        device=device).to(src_dtype)
    batches = [
        torch.tensor([2999], dtype=torch.int32, device=device),
        torch.randperm(3000, generator=gen, device=device)[:41].to(torch.int32),
        torch.randint(0, 3000, (2049,), generator=gen, device=device,
                      dtype=torch.int32),
    ]
    for idx in batches:
        for dtype in (torch.bfloat16, torch.float32):
            want = ops.reference_gather(src, idx, dtype)
            got = ops.gather_rows(src, idx, dtype)
            assert got.dtype == want.dtype == dtype
            assert torch.equal(got, want), (idx.shape[0], dtype)


def test_gather_out_of_range_index_traps(device):
    """An index outside the matrix stops the kernel (in a child process:
    a trap leaves the CUDA context unusable)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for bad, f in (("[3, 10]", 2048), ("[-1]", 2048), ("[0, 10]", 1)):
        code = (
            "import torch\n"
            "from scvae_tpu_torch import ops\n"
            f"src = torch.zeros((10, {f}), dtype=torch.int16, device='cuda')\n"
            f"idx = torch.tensor({bad}, dtype=torch.int32, device='cuda')\n"
            "ops.gather_rows(src, idx, torch.bfloat16)\n"
            "torch.cuda.synchronize()\n"
            "print('no trap')\n")
        run = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True, timeout=600)
        assert run.returncode != 0 and "no trap" not in run.stdout, (
            bad, f, run.stdout, run.stderr[-2000:])


def _case(device, n_heads, m, m_t, hidden, f, t_dtype, seed=0):
    """h, n_heads (W, b) pairs, Poisson(2) targets (13% zeros) and row
    cotangents."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.relu(torch.randn(m, hidden, generator=gen, device=device))
    limit = 3 * (6.0 / (hidden + f)) ** 0.5
    weights = [(torch.rand(hidden, f, generator=gen, device=device) * 2 - 1) * limit
               for _ in range(n_heads)]
    biases = [0.3 * torch.randn(f, generator=gen, device=device)
              for _ in range(n_heads)]
    t = torch.poisson(torch.full((m_t, f), 2.0, device=device), generator=gen)
    g = torch.randn(m, generator=gen, device=device)
    return h, weights, biases, t.to(t_dtype), g


def _family_case(device, name, *shape, seed=0):
    return _case(device, len(ops.FAMILIES[name].heads), *shape, seed=seed)


def _check_family(name, h, weights, biases, t, g, compute):
    for const in (True, False):
        _close(ops.fused_forward(name, h, weights, biases, t,
                                 compute_dtype=compute,
                                 include_lgamma_const=const),
               ops.reference_forward(name, h, weights, biases, t,
                                     compute_dtype=compute,
                                     include_lgamma_const=const), 2e-5)
    got = ops.fused_backward(name, g, h, weights, biases, t,
                             compute_dtype=compute)
    want = ops.reference_backward(name, g, h, weights, biases, t,
                                  compute_dtype=compute)
    assert len(got) == len(want) == 1 + 2 * len(weights)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, 4e-4 if compute is not None else 2e-5)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("m,m_t,hidden,f", SHAPES)
@pytest.mark.parametrize("t_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("compute", [None, torch.bfloat16])
def test_count_kernels_match_plain(device, name, m, m_t, hidden, f, t_dtype,
                                   compute):
    h, weights, biases, t, g = _family_case(device, name, m, m_t, hidden, f,
                                            t_dtype)
    _check_family(name, h, weights, biases, t, g, compute)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("m,m_t,hidden,f", SHAPES)
def test_count_backward_matches_autograd(device, name, m, m_t, hidden, f):
    h, weights, biases, t, g = _family_case(device, name, m, m_t, hidden, f,
                                            torch.float32, seed=1)
    leaves = [x.clone().requires_grad_(True) for x in (h, *weights, *biases)]
    k = len(weights)
    ll = ops.reference_forward(name, leaves[0], leaves[1:1 + k],
                               leaves[1 + k:], t)
    want = torch.autograd.grad(ll, leaves, grad_outputs=g)
    got = ops.fused_backward(name, g, h, weights, biases, t)
    # got: dh, dW_0, db_0, dW_1, …; want: dh, dW_0, dW_1, …, db_0, db_1, …
    order = [0] + [x for i in range(k) for x in (1 + i, 1 + k + i)]
    for a, i in zip(got, order):
        _close(a, want[i], 2e-5)


def _cp_case(device, m, m_t, hidden, f, t_dtype, round_h, seed=0):
    h, (w,), (b,), t, g = _case(device, 1, m, m_t, hidden, f, t_dtype,
                                seed=seed)
    if round_h:
        h = h.to(torch.bfloat16).float()
    n = t.float().sum(-1).repeat(m // m_t) + 3.0
    return h, w, b, t, n, g


@pytest.mark.parametrize("m,m_t,hidden,f", SHAPES)
@pytest.mark.parametrize("t_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("round_h", [False, True])
def test_cp_kernels_match_plain(device, m, m_t, hidden, f, t_dtype, round_h):
    h, w, b, t, n, g = _cp_case(device, m, m_t, hidden, f, t_dtype, round_h)
    ll, lse = ops.cp_forward(h, w, b, t, n)
    ll_ref, lse_ref = ops.reference_cp_forward(h, w, b, t, n)
    _close(ll, ll_ref, 2e-5)
    _close(lse, lse_ref, 2e-5)
    for a, b_ in zip(ops.cp_backward(g, h, w, b, t, lse),
                     (ops.reference_cp_dh(g, h, w, b, t, lse_ref),
                      *ops.reference_cp_dw(g, h, w, b, t, lse_ref)),
                     strict=True):
        _close(a, b_, 2e-5)


@pytest.mark.parametrize("m,m_t,hidden,f", SHAPES)
def test_cp_backward_matches_autograd(device, m, m_t, hidden, f):
    h, w, b, t, n, g = _cp_case(device, m, m_t, hidden, f, torch.float32,
                                False, seed=1)
    leaves = [x.clone().requires_grad_(True) for x in (h, w, b)]
    ll, _ = ops.reference_cp_forward(*leaves, t, n)
    want = torch.autograd.grad(ll, leaves, grad_outputs=g)
    _, lse = ops.cp_forward(h, w, b, t, n)
    got = ops.cp_backward(g, h, w, b, t, lse)
    for a, b_ in zip(got, want):
        _close(a, b_, 2e-5)


# (M, M_t, H, F) of the constrained Poisson's bf16 kernels: the main path's
# width with full and ragged gene tiles, rows off the row tile cycling over
# a tenth as many targets, and odd small shapes
CP_TC_SHAPES = [(2048, 2048, 256, 2048), (2048, 2048, 256, 2000),
                (300, 30, 256, 2048), (300, 30, 256, 2000), (37, 37, 21, 301),
                (64, 32, 256, 100)]


def _check_cp_tensor_cores(h, w, b, t, n, g):
    """The constrained Poisson's bf16 kernels (h a bf16 tensor) one by one
    against their plain versions: the forward's ll, lse and partials per
    gene tile, bit for bit over two runs; the gradient kernel's da terms
    (da_0 within one bf16 step of the plain da_0, few flips; da_0 + da_1
    and the row-tile sums within 2e-5); the dh and dW products of its own
    scratch at 2e-5, bit for bit over two runs; the public calls are these
    kernels; and all of it within 2e-5 of the float32 plain versions, which
    multiply the unrounded W and da."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    assert h.dtype == torch.bfloat16
    ll, lse, part = fl.cp_tc_forward(h, w, b, t, n)
    ll_p, lse_p, part_p = fl.reference_cp_tc_forward(h, w, b, t, n)
    _close(ll, ll_p, 2e-5)
    _close(lse, lse_p, 2e-5)
    for q in range(part.shape[0]):
        _close(part[q], part_p[q], 2e-5)
    again = fl.cp_tc_forward(h, w, b, t, n)
    assert torch.equal(ll, again[0]) and torch.equal(lse, again[1])
    public = ops.cp_forward(h, w, b, t, n)
    assert torch.equal(public[0], ll) and torch.equal(public[1], lse)
    ll32, lse32 = ops.reference_cp_forward(h.float(), w, b, t, n)
    _close(ll, ll32, 2e-5)
    _close(lse, lse32, 2e-5)

    grad = fl.cp_tc_gradient(g, h, w, b, t, lse)
    plain = fl.reference_cp_tc_gradient(g, h, w, b, t, lse)
    m = h.shape[0]
    got, want = (x.da.reshape(m, 3, -1) for x in (grad, plain))
    assert torch.equal(got[:, 0], got[:, 1])
    _within_one_bf16_step(got[:, 0], want[:, 0])
    _close(got[:, 0].float() + got[:, 2].float(),
           want[:, 0].float() + want[:, 2].float(), 2e-5)
    _close(grad.db_parts, plain.db_parts, 2e-5)
    assert torch.equal(grad.h, plain.h) and torch.equal(grad.w, plain.w)
    dh = fl.tc_dh(grad)
    assert torch.equal(dh, fl.tc_dh(grad))
    _close(dh, fl.reference_tc_dh(grad), 2e-5)
    dw, db = fl.tc_dw(grad)
    dw2, db2 = fl.tc_dw(grad)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    for a, b_ in zip((dw, db), fl.reference_tc_dw(grad), strict=True):
        _close(a, b_, 2e-5)
    for a, b_ in zip(ops.cp_backward(g, h, w, b, t, lse), (dh, dw, db),
                     strict=True):
        assert torch.equal(a, b_)
    hf = h.float()
    want32 = (ops.reference_cp_dh(g, hf, w, b, t, lse32),
              *ops.reference_cp_dw(g, hf, w, b, t, lse32))
    for a, b_ in zip((dh, dw, db), want32, strict=True):
        assert a.shape == b_.shape
        _close(a, b_, 2e-5)


@pytest.mark.parametrize("m,m_t,hidden,f", CP_TC_SHAPES)
@pytest.mark.parametrize("t_dtype", [torch.bfloat16, torch.float32])
def test_cp_tensor_core_kernels(device, m, m_t, hidden, f, t_dtype):
    h, w, b, t, n, g = _cp_case(device, m, m_t, hidden, f, t_dtype, True,
                                seed=6)
    _check_cp_tensor_cores(h.to(torch.bfloat16), w, b, t, n, g)


@pytest.mark.parametrize("hidden", [580, 584, 1024])
def test_cp_tensor_core_wide_decoder(device, hidden):
    """The constrained Poisson's bf16 kernels past one ring of hidden units
    (the widths of the float32 kernels' width test)."""
    h, w, b, t, n, g = _cp_case(device, 40, 40, hidden, 301, torch.bfloat16,
                                True, seed=3)
    _check_cp_tensor_cores(h.to(torch.bfloat16), w, b, t, n, g)


def test_cp_float32_and_bf16_launches_count_apart(device):
    """bf16 h and float32 h launch the constrained Poisson's tensor-core
    kernels (the forward, the gradient kernel, the dh and dW products) each
    under its own counter, float32 with the "_float32" suffix."""
    h, w, b, t, n, g = _cp_case(device, 48, 16, 32, 70, torch.bfloat16, True,
                                seed=2)
    for hv, suffix in ((h, "_float32"), (h.to(torch.bfloat16), "")):
        ops.reset_launch_counts()
        _, lse = ops.cp_forward(hv, w, b, t, n)
        ops.cp_backward(g, hv, w, b, t, lse)
        torch.cuda.synchronize()
        kernels = ["forward", "backward_gradient", "backward_dh",
                   "backward_dw"]
        assert {k: v for k, v in ops.launch_counts().items() if v} == {
            f"cp_{kernel}{suffix}": 1 for kernel in kernels}


# (M, M_t, H, F) of the constrained Poisson's float32 kernels: the main
# path's width with full and ragged gene tiles, rows off the row tile
# cycling over a tenth as many targets, odd small shapes and a decoder
# width past two rings of hidden units
CP_F32_TC_SHAPES = CP_TC_SHAPES + [(64, 32, 584, 100)]


@pytest.mark.parametrize("m,m_t,hidden,f", CP_F32_TC_SHAPES)
def test_cp_float32_tensor_core_kernels(device, m, m_t, hidden, f):
    """The constrained Poisson's float32 kernels one by one against their
    split plain versions: the forward's ll, lse and partials per gene tile,
    bit for bit over two runs; the entries' split of h and W bit for bit,
    da's terms (``_check_split_scratch``) and the row-tile sums at 2e-5;
    the dh and dW products of the kernel's own scratch at 2e-5, bit for bit
    over two runs; the public calls are these kernels, and within 2e-5 of
    the float32 plain versions."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    h, w, b, t, n, g = _cp_case(device, m, m_t, hidden, f, torch.bfloat16,
                                False, seed=7)
    ll, lse, part = fl.cp_f32_tc_forward(h, w, b, t, n)
    ll_p, lse_p, part_p = fl.reference_cp_f32_tc_forward(h, w, b, t, n)
    _close(ll, ll_p, 2e-5)
    _close(lse, lse_p, 2e-5)
    for q in range(part.shape[0]):
        _close(part[q], part_p[q], 2e-5)
    again = fl.cp_f32_tc_forward(h, w, b, t, n)
    assert torch.equal(ll, again[0]) and torch.equal(lse, again[1])
    public = ops.cp_forward(h, w, b, t, n)
    assert torch.equal(public[0], ll) and torch.equal(public[1], lse)
    ll32, lse32 = ops.reference_cp_forward(h, w, b, t, n)
    _close(ll, ll32, 2e-5)
    _close(lse, lse32, 2e-5)

    grad = fl.cp_f32_tc_gradient(g, h, w, b, t, lse)
    plain = fl.reference_cp_f32_tc_gradient(g, h, w, b, t, lse)
    _check_split_scratch(grad, plain)
    _close(grad.db_parts, plain.db_parts, 2e-5)
    dh = fl.tc_dh(grad)
    assert torch.equal(dh, fl.tc_dh(grad))
    _close(dh, fl.reference_tc_dh(grad), 2e-5)
    dw, db = fl.tc_dw(grad)
    dw2, db2 = fl.tc_dw(grad)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    for a, b_ in zip((dw, db), fl.reference_tc_dw(grad), strict=True):
        _close(a, b_, 2e-5)
    for a, b_ in zip(ops.cp_backward(g, h, w, b, t, lse), (dh, dw, db),
                     strict=True):
        assert torch.equal(a, b_)
    want32 = (ops.reference_cp_dh(g, h, w, b, t, lse32),
              *ops.reference_cp_dw(g, h, w, b, t, lse32))
    for a, b_ in zip((dh, dw, db), want32, strict=True):
        assert a.shape == b_.shape
        _close(a, b_, 2e-5)


@pytest.mark.parametrize("hidden", [580, 584, 1024])
@pytest.mark.parametrize("name", ["negative binomial",
                                  "zero-inflated negative binomial",
                                  "constrained poisson"])
@pytest.mark.parametrize("compute", [None, torch.bfloat16])
def test_wide_decoder(device, name, hidden, compute):
    """Decoder widths past one hidden chunk: the kernels' shared memory does
    not grow with H (the first NB kernels were refused from H = 584)."""
    if name == "constrained poisson":
        h, w, b, t, n, g = _cp_case(device, 40, 40, hidden, 301,
                                    torch.bfloat16, compute is not None,
                                    seed=3)
        ll, lse = ops.cp_forward(h, w, b, t, n)
        ll_ref, lse_ref = ops.reference_cp_forward(h, w, b, t, n)
        _close(ll, ll_ref, 2e-5)
        got = ops.cp_backward(g, h, w, b, t, lse)
        want = (ops.reference_cp_dh(g, h, w, b, t, lse_ref),
                *ops.reference_cp_dw(g, h, w, b, t, lse_ref))
        for a, b_ in zip(got, want):
            _close(a, b_, 2e-5)
        return
    h, weights, biases, t, g = _family_case(device, name, 40, 40, hidden, 301,
                                            torch.bfloat16, seed=3)
    _check_family(name, h, weights, biases, t, g, compute)


@pytest.mark.parametrize("name", FAMILIES + ["constrained poisson"])
def test_fused_function_and_counts(device, name):
    heads_names = ("lambda",) if name == "constrained poisson" else (
        ops.FAMILIES[name].heads)
    h, weights, biases, t, g = _case(device, len(heads_names), 48, 16, 32, 70,
                                     torch.bfloat16, seed=2)
    h = h.reshape(3, 16, 32).clone().requires_grad_(True)
    params = {k: {"kernel": w.clone().requires_grad_(True),
                  "bias": b.clone().requires_grad_(True)}
              for k, w, b in zip(heads_names, weights, biases)}
    count_sum = t.float().sum(-1, keepdim=True) + 1.0
    ops.reset_launch_counts()
    out = ops.fused_log_likelihood(name, h, params, t, count_sum=count_sum,
                                   compute_dtype=torch.bfloat16)
    assert out.shape == (3, 16)
    out.backward(g.reshape(3, 16))
    torch.cuda.synchronize()
    prefix = "cp" if name == "constrained poisson" else ops.FAMILIES[name].prefix
    counts = ops.launch_counts()
    launched = {k for k, v in counts.items() if v}
    # the bf16 backward: a gradient kernel, then the dh and dW products
    kernels = ["forward", "backward_gradient", "backward_dh", "backward_dw"]
    assert launched == {f"{prefix}_{kernel}" for kernel in kernels}
    assert all(counts[k] == 1 for k in launched)
    assert torch.isfinite(h.grad).all()
    h2 = h.detach().reshape(48, 32)
    with pytest.raises(ValueError):  # 48 rows over 5 targets
        if name == "constrained poisson":
            ops.cp_forward(h2, weights[0], biases[0], t[:5],
                           count_sum.repeat(3, 1)[:, 0])
        else:
            ops.fused_forward(name, h2, weights, biases, t[:5])


@pytest.mark.parametrize("m,m_t,hidden,f", [(160, 16, 32, 77), (96, 32, 21, 45)])
def test_nb_cycled_rows(device, m, m_t, hidden, f):
    """K2/K3 over K·S·B decoder rows against B shared target rows, as the
    GMVAE's one launch over all clusters."""
    h, weights, biases, t, g = _family_case(device, "negative binomial", m,
                                            m_t, hidden, f, torch.bfloat16,
                                            seed=4)
    _check_family("negative binomial", h, weights, biases, t, g,
                  torch.bfloat16)


# (M, M_t, H, F) of the bf16 tensor-core K2/K3 at the main path's width: a
# full tile of rows and genes, a ragged gene edge, rows off the row tile
# cycling over a tenth as many targets
TC_SHAPES = [(2048, 2048, 256, 2048), (2048, 2048, 256, 2000),
             (300, 30, 256, 2048), (300, 30, 256, 2000)]


# Flips of bf16(da) to the neighbouring bf16 value, as a share of its
# elements: a kernel that rounds otherwise, or not at all, flips about half.
MAX_FLIP_SHARE = 1e-3


def _within_one_bf16_step(got, want, rtol=2e-5):
    """bf16 ``got`` equals bf16 ``want`` but for a few values one bf16 step
    away, or within ``rtol`` of the largest |want| (values near zero, which
    the order of a float32 sum moves by more than their step)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    _, exponent = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.ldexp(torch.ones_like(diff), exponent - 8)
    floor = rtol * float(want.abs().max())
    assert bool((diff <= torch.clamp(step, min=floor)).all())
    flips = int((diff > 0).sum())
    assert flips <= MAX_FLIP_SHARE * diff.numel(), (flips, diff.numel())


def _check_split_scratch(grad, plain):
    """The float32 gradient kernel's scratch: the entries' split of h and W
    bit for bit, the copies of each term of da equal, its first term within
    one bf16 step of the plain one, the sum of its terms within 2e-5."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    assert torch.equal(grad.h, plain.h) and torch.equal(grad.w, plain.w)
    m = grad.da.shape[0]
    got_da, want_da = (z.da.reshape(m, len(fl.SPLIT_PAIRS), -1)
                       for z in (grad, plain))
    # slot p holds da's term i of pair p; the first pair of term i is
    # (i, 0)
    first = [fl.SPLIT_PAIRS.index((i, 0)) for i in range(fl.SPLIT_TERMS)]
    for p, (i, _) in enumerate(fl.SPLIT_PAIRS):
        assert torch.equal(got_da[:, p], got_da[:, first[i]])
    _within_one_bf16_step(got_da[:, 0], want_da[:, 0])
    _close(sum(got_da[:, p].float() for p in first),
           sum(want_da[:, p].float() for p in first), 2e-5)


def _check_tensor_core_kernels(name, h, weights, biases, t, g, float32):
    """The tensor-core K2 and the backward's three kernels of family
    ``name``, bf16 or (``float32``) h, W and da as bf16 terms, each against
    its plain version; the public backward is these kernels.  float32 also
    holds the split design's scratch (``_check_split_scratch``) and the
    public calls against the float32 plain versions."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    args = (name, h, weights, biases, t)
    bargs = (name, g, h, weights, biases, t)
    cdt = None if float32 else torch.bfloat16
    for const in (True, False):
        got = ops.fused_forward(*args, compute_dtype=cdt,
                                include_lgamma_const=const)
        _close(got, ops.reference_forward(*args, compute_dtype=cdt,
                                          include_lgamma_const=const), 2e-5)
        if float32:
            _close(got, fl.reference_f32_tc_forward(
                *args, include_lgamma_const=const), 2e-5)
            assert torch.equal(got, fl.f32_tc_forward(
                *args, include_lgamma_const=const))
    if float32:
        grad = fl.f32_tc_gradient(*bargs)
        plain = fl.reference_f32_tc_gradient(*bargs)
        _check_split_scratch(grad, plain)
    else:
        grad = fl.tc_gradient(*bargs)
        plain = fl.reference_tc_gradient(*bargs)
        _within_one_bf16_step(grad.da, plain.da)
    _close(grad.db_parts, plain.db_parts, 2e-5)
    dh = fl.tc_dh(grad)
    _close(dh, fl.reference_tc_dh(grad), 2e-5)
    dws = fl.tc_dw(grad)
    for a, b in zip(dws, fl.reference_tc_dw(grad), strict=True):
        _close(a, b, 2e-5)
    public = ops.fused_backward(*bargs, compute_dtype=cdt)
    for a, b in zip(public, (dh, *dws), strict=True):
        assert torch.equal(a, b)
    if float32:
        for a, b in zip(public, ops.reference_backward(*bargs), strict=True):
            _close(a, b, 2e-5)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("m,m_t,hidden,f", TC_SHAPES)
def test_tensor_core_kernels_full_and_ragged_tiles(device, name, m, m_t,
                                                   hidden, f):
    _check_tensor_core_kernels(name, *_family_case(
        device, name, m, m_t, hidden, f, torch.bfloat16, seed=5),
        float32=False)


def test_float32_and_bf16_launches_count_apart(device):
    """bf16 calls and float32 calls launch the tensor-core kernels (the
    forward, the gradient kernel, the dh and dW products) each under its
    own counter, float32 with the "_float32" suffix."""
    name = "negative binomial"
    h, ws, bs, t, g = _family_case(device, name, 48, 16, 32, 70,
                                   torch.float32, seed=2)
    for compute, suffix in ((None, "_float32"), (torch.bfloat16, "")):
        ops.reset_launch_counts()
        ops.fused_forward(name, h, ws, bs, t, compute_dtype=compute)
        ops.fused_backward(name, g, h, ws, bs, t, compute_dtype=compute)
        torch.cuda.synchronize()
        kernels = ["forward", "backward_gradient", "backward_dh",
                   "backward_dw"]
        assert {k: v for k, v in ops.launch_counts().items() if v} == {
            f"nb_{kernel}{suffix}": 1 for kernel in kernels}


# (M, M_t, H, F) of the float32 K2/K3: the main path's width with full and
# ragged tiles, rows cycling, and odd shapes off every tile
F32_TC_SHAPES = TC_SHAPES + [(37, 37, 21, 301), (26, 13, 3, 13),
                             (64, 32, 584, 100)]


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("m,m_t,hidden,f", F32_TC_SHAPES)
def test_float32_tensor_core_kernels(device, name, m, m_t, hidden, f):
    """The float32 K2 and the backward's three kernels, each against its
    plain version in the split layout, and against the float32 plain
    versions; the public calls are these kernels."""
    _check_tensor_core_kernels(name, *_family_case(
        device, name, m, m_t, hidden, f, torch.bfloat16, seed=6),
        float32=True)


# (base, K, M, M_t, H, F): 14 heads; 32 heads with cycled rows; NB with two
# classes at width 256; ZIP past one hidden chunk
CAT_CASES = [
    ("zero-inflated negative binomial", 10, 37, 37, 21, 301),
    ("poisson", 30, 26, 13, 3, 45),
    ("negative binomial", 1, 64, 32, 256, 100),
    ("zero-inflated poisson", 4, 5, 5, 300, 40),
]


def _cat_case(device, name, k_max, m, m_t, hidden, f, t_dtype, seed=0):
    """A family case plus class heads (K+1, H, F), (K+1, F) and targets
    spread over the classes and past K."""
    h, weights, biases, _, g = _family_case(device, name, m, m_t, hidden, f,
                                            t_dtype, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed + 100)
    limit = 3 * (6.0 / (hidden + f)) ** 0.5
    cat_w = (torch.rand(k_max + 1, hidden, f, generator=gen, device=device)
             * 2 - 1) * limit
    cat_b = 0.3 * torch.randn(k_max + 1, f, generator=gen, device=device)
    t = torch.poisson(torch.full((m_t, f), float(k_max), device=device),
                      generator=gen)
    return h, weights, biases, cat_w, cat_b, t.to(t_dtype), g


@pytest.mark.parametrize("name,k_max,m,m_t,hidden,f", CAT_CASES)
@pytest.mark.parametrize("t_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("compute", [None, torch.bfloat16])
def test_categorised_kernels_match_plain(device, name, k_max, m, m_t, hidden,
                                         f, t_dtype, compute):
    h, ws, bs, cw, cb, t, g = _cat_case(device, name, k_max, m, m_t, hidden,
                                        f, t_dtype)
    args = (h, ws, bs, cw, cb, t)
    ll, lse = ops.categorised_forward(name, *args, compute_dtype=compute)
    ll_ref, lse_ref = ops.reference_categorised_forward(
        name, *args, compute_dtype=compute)
    _close(ll, ll_ref, 2e-5)
    _close(lse, lse_ref, 2e-5)
    # the backward on the same inputs, the kernel forward's lse among them
    rtol = 4e-4 if compute is not None else 2e-5
    got = ops.categorised_backward(name, g, *args, lse, compute_dtype=compute)
    want = (ops.reference_categorised_dh(name, g, *args, lse,
                                         compute_dtype=compute),
            *ops.reference_categorised_dw(name, g, *args, lse,
                                          compute_dtype=compute))
    assert len(got) == len(want) == 2 * len(ws) + 3
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, rtol)


@pytest.mark.parametrize("name,k_max,m,m_t,hidden,f", CAT_CASES)
def test_categorised_backward_matches_autograd(device, name, k_max, m, m_t,
                                               hidden, f):
    h, ws, bs, cw, cb, t, g = _cat_case(device, name, k_max, m, m_t, hidden,
                                        f, torch.float32, seed=1)
    k = len(ws)
    leaves = [x.clone().requires_grad_(True) for x in (h, *ws, *bs, cw, cb)]
    ll, _ = ops.reference_categorised_forward(
        name, leaves[0], leaves[1:1 + k], leaves[1 + k:1 + 2 * k],
        leaves[-2], leaves[-1], t)
    want = torch.autograd.grad(ll, leaves, grad_outputs=g)
    _, lse = ops.categorised_forward(name, h, ws, bs, cw, cb, t)
    got = ops.categorised_backward(name, g, h, ws, bs, cw, cb, t, lse)
    # got: dh, dW_0, db_0, …, dW_classes, db_classes;
    # want: dh, dW_0, …, db_0, …, dW_classes, db_classes
    order = ([0] + [x for i in range(k) for x in (1 + i, 1 + k + i)]
             + [1 + 2 * k, 2 + 2 * k])
    for a, i in zip(got, order):
        _close(a, want[i], 2e-5)


def test_categorised_function_and_counts(device):
    """The autograd Function launches each categorised kernel once per
    forward and backward, over rows cycling on shared targets: the
    tensor-core forward, gradient kernel and products, in float32 under
    their own counters with the "_float32" suffix."""
    name = "zero-inflated negative binomial"
    h0, ws, bs, cw0, cb0, t, g = _cat_case(device, name, 10, 48, 16, 32, 70,
                                           torch.bfloat16, seed=2)
    for compute, suffix in ((torch.bfloat16, ""), (None, "_float32")):
        kernels = [f"{kernel}{suffix}" for kernel in (
            "forward", "backward_gradient", "backward_dh", "backward_dw")]
        h = h0.reshape(3, 16, 32).clone().requires_grad_(True)
        heads = {p: {"kernel": w.clone().requires_grad_(True),
                     "bias": b.clone().requires_grad_(True)}
                 for p, w, b in zip(ops.FAMILIES[name].heads, ws, bs)}
        cw = cw0.clone().requires_grad_(True)
        cb = cb0.clone().requires_grad_(True)
        ops.reset_launch_counts()
        out = ops.fused_categorised_log_likelihood(name, h, heads, cw, cb, t,
                                                   compute_dtype=compute)
        assert out.shape == (3, 16)
        out.backward(g.reshape(3, 16))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert {k for k, v in counts.items() if v} == {
            f"cat_zinb_{kernel}" for kernel in kernels}
        assert all(v in (0, 1) for v in counts.values())
        assert all(torch.isfinite(x.grad).all() for x in (h, cw, cb))
    for compute in (None, torch.bfloat16):
        with pytest.raises(ValueError):  # 3 + 30 = 33 heads
            ops.categorised_forward(name, h0, ws, bs, cw0.repeat(3, 1, 1)[:30],
                                    cb0.repeat(3, 1)[:30], t,
                                    compute_dtype=compute)


# (M, M_t, H, F) of the tensor-core categorised forward: M, H and F off
# the tiles and the 8-wide padding, rows cycling over shared targets; the
# main path's width with a ragged F; a width past one hidden chunk
CAT_FORWARD_SHAPES = [(37, 37, 21, 301), (26, 13, 3, 45),
                      (300, 30, 256, 2000), (130, 65, 584, 100)]


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("m,m_t,hidden,f", CAT_FORWARD_SHAPES)
@pytest.mark.parametrize("t_dtype", [torch.bfloat16, torch.float32])
def test_categorised_tensor_core_forward(device, name, m, m_t, hidden, f,
                                         t_dtype):
    """The bf16 categorised forward kernel at 32 heads: its row sums, lse
    and row-sum partials per gene tile within 2e-5 of the largest value of
    the plain versions', on targets spread over the classes and past K; bit
    for bit over two runs; and the public forward is this kernel."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    k_max = 32 - len(ops.FAMILIES[name].heads) - 1
    h, ws, bs, cw, cb, t, _ = _cat_case(device, name, k_max, m, m_t, hidden,
                                        f, t_dtype, seed=8)
    t[1::2] = torch.floor(t[1::2] / 3)  # below K as well
    args = (name, h, ws, bs, cw, cb, t)
    out, lse, part = fl.cat_tc_forward(*args)
    want_part, want_lse = fl.reference_cat_tc_forward(*args)
    want_out, _ = ops.reference_categorised_forward(
        *args, compute_dtype=torch.bfloat16)
    assert part.shape == want_part.shape == fl.tc_plan(m, hidden, f,
                                                       32)["row_sums"]
    _close(out, want_out, 2e-5)
    _close(lse, want_lse, 2e-5)
    _close(part, want_part, 2e-5)
    for a, b in zip((out, lse, part), fl.cat_tc_forward(*args), strict=True):
        assert torch.equal(a, b)
    got = ops.categorised_forward(*args, compute_dtype=torch.bfloat16)
    assert torch.equal(got[0], out) and torch.equal(got[1], lse)


def _product_case(device, m, hidden, f, n_heads, promote, seed):
    """The products' operands of a tensor-core gradient in its layout (bf16
    h (M, Hp), W (Hp, NH, Fp) and da (M, NH·Fp), zero in the padding, and
    float32 row-tile sums), real-valued, with the plan's splits and the
    given promotion."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    gen = torch.Generator(device=device).manual_seed(seed)
    plan = fl.tc_plan(m, hidden, f, n_heads)
    for key in ("dh_splits", "dw_splits"):
        plan[key] = (*plan[key][:2], promote)
    hp, fp = plan["hp"], plan["fp"]
    bf16 = torch.bfloat16
    hb = torch.zeros(m, hp, dtype=bf16, device=device)
    hb[:, :hidden] = torch.randn(m, hidden, generator=gen, device=device)
    w = torch.zeros(hp, n_heads, fp, dtype=bf16, device=device)
    w[:hidden, :, :f] = torch.randn(hidden, n_heads, f, generator=gen,
                                    device=device)
    da = torch.zeros(m, n_heads, fp, dtype=bf16, device=device)
    da[:, :, :f] = torch.randn(m, n_heads, f, generator=gen, device=device)
    db_parts = torch.randn(plan["db_parts"], generator=gen, device=device)
    return fl.TcGradient("nb", plan, hidden, f, hb, w, da.reshape(m, -1),
                         db_parts)


# (M, H, F, heads) of the products: full tiles and cluster splits at the
# main path's width; H, F and the rows off every tile; a width past one
# 256-column tile with one head; 14 heads of a short depth for dW
PRODUCT_SHAPES = [(2048, 256, 2048, 2), (300, 21, 301, 3), (37, 584, 45, 1),
                  (130, 200, 100, 14)]


@pytest.mark.parametrize("m,hidden,f,n_heads", PRODUCT_SHAPES)
@pytest.mark.parametrize("promote", [False, True])
def test_product_kernel_repeats_and_matches_plain(device, m, hidden, f,
                                                  n_heads, promote):
    """The wgmma product kernel in both layouts (dh: K-major operands; dW:
    both transposed), with and without promoted sums: bit-identical over
    two runs (the cluster's splits add in rank order), and within 2e-5 of
    the largest value of the float32 product of the same bf16 operands."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    grad = _product_case(device, m, hidden, f, n_heads, promote, seed=m)
    dh = fl.tc_dh(grad)
    assert torch.equal(dh, fl.tc_dh(grad))
    _close(dh, fl.reference_tc_dh(grad), 2e-5)
    dw, db = fl.tc_dw_stacked(grad)
    again = fl.tc_dw_stacked(grad)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])
    want = fl.reference_tc_dw_stacked(grad)
    assert dw.shape == want[0].shape and db.shape == want[1].shape
    _close(dw, want[0], 2e-5)
    _close(db, want[1], 2e-5)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("n_heads", [14, 32])
def test_categorised_tensor_core_kernels(device, name, n_heads):
    """The bf16 categorised backward kernel by kernel on real-valued inputs
    (300 rows over 30 cycled targets, width 256, a ragged F of 2,000): the
    gradient kernel's bf16(da) within one bf16 step of the plain bf16(da)
    from the same lse, with few flips; its row-tile sums; the dh and dW
    products of its own da against the plain products at 2e-5; and the
    public backward is these three kernels."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    k_max = n_heads - len(ops.FAMILIES[name].heads) - 1
    h, ws, bs, cw, cb, t, g = _cat_case(device, name, k_max, 300, 30, 256,
                                        2000, torch.bfloat16, seed=7)
    _, lse = ops.categorised_forward(name, h, ws, bs, cw, cb, t,
                                     compute_dtype=torch.bfloat16)
    args = (name, g, h, ws, bs, cw, cb, t, lse)
    plain = fl.reference_cat_tc_gradient(*args)
    grad = fl.cat_tc_gradient(*args)
    assert grad.da.shape == plain.da.shape == (300, n_heads * 2000)
    _within_one_bf16_step(grad.da, plain.da)
    _close(grad.db_parts, plain.db_parts, 2e-5)
    dh = fl.tc_dh(grad)
    _close(dh, fl.reference_tc_dh(grad), 2e-5)
    dw, db = fl.tc_dw_stacked(grad)
    want = fl.reference_tc_dw_stacked(grad)
    _close(dw, want[0], 2e-5)
    _close(db, want[1], 2e-5)
    n_base = len(ws)
    got = ops.categorised_backward(*args, compute_dtype=torch.bfloat16)
    assert len(got) == 2 * n_base + 3
    for a, b in zip(got, (dh, *(x for k in range(n_base)
                                for x in (dw[k], db[k])),
                          dw[n_base:], db[n_base:]), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("n_heads", [14, 32])
@pytest.mark.parametrize("m,m_t,hidden,f", [(300, 30, 256, 2000),
                                            (37, 37, 21, 301)])
def test_categorised_float32_tensor_core_kernels(device, name, n_heads, m,
                                                 m_t, hidden, f):
    """The categorised float32 design kernel by kernel against its plain
    versions in the split layout, on targets spread over the classes and
    past K: the forward's row sums, lse and row-sum partials at 2e-5, bit
    for bit over two runs; the pack of h and of every head's W (the
    class-major weights at a stride) bit for bit; the gradient kernel's
    scratch (``_check_split_scratch``) and row-tile sums; the dh and dW
    products of its own scratch at 2e-5; the public calls are these kernels,
    and lie within 2e-5 of the float32 plain versions."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    k_max = n_heads - len(ops.FAMILIES[name].heads) - 1
    h, ws, bs, cw, cb, t, g = _cat_case(device, name, k_max, m, m_t, hidden,
                                        f, torch.bfloat16, seed=9)
    t[1::2] = torch.floor(t[1::2] / 3)  # below K as well
    args = (name, h, ws, bs, cw, cb, t)
    out, lse, part = fl.cat_f32_tc_forward(*args)
    want_out, want_lse, want_part = fl.reference_cat_f32_tc_forward(*args)
    assert part.shape == want_part.shape == fl.f32_tc_plan(
        m, hidden, f, n_heads)["row_sums"]
    for a, b in ((out, want_out), (lse, want_lse), (part, want_part)):
        _close(a, b, 2e-5)
    for a, b in zip((out, lse, part), fl.cat_f32_tc_forward(*args),
                    strict=True):
        assert torch.equal(a, b)
    got = ops.categorised_forward(*args)
    assert torch.equal(got[0], out) and torch.equal(got[1], lse)
    ref_out, ref_lse = ops.reference_categorised_forward(*args)
    _close(out, ref_out, 2e-5)
    _close(lse, ref_lse, 2e-5)

    bargs = (name, g, h, ws, bs, cw, cb, t, lse)
    grad = fl.cat_f32_tc_gradient(*bargs)
    plain = fl.reference_cat_f32_tc_gradient(*bargs)
    assert grad.da.shape == plain.da.shape
    _check_split_scratch(grad, plain)
    _close(grad.db_parts, plain.db_parts, 2e-5)
    dh = fl.tc_dh(grad)
    _close(dh, fl.reference_tc_dh(grad), 2e-5)
    dw, db = fl.tc_dw_stacked(grad)
    want = fl.reference_tc_dw_stacked(grad)
    _close(dw, want[0], 2e-5)
    _close(db, want[1], 2e-5)
    n_base = len(ws)
    public = ops.categorised_backward(*bargs)
    for a, b in zip(public, (dh, *(x for k in range(n_base)
                                   for x in (dw[k], db[k])),
                             dw[n_base:], db[n_base:]), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(public, (ops.reference_categorised_dh(*bargs),
                             *ops.reference_categorised_dw(*bargs)),
                    strict=True):
        _close(a, b, 2e-5)


def test_categorised_float32_scratch_past_32_bit(device):
    """Poisson-cat (32 heads) over 6,144 rows: the float32 gradient's
    scratch holds 6 x 32 x 2,048 bf16 a row, 2.4e9 elements in all, past
    32-bit offsets.  The public float32 forward and backward against the
    float32 plain versions at 2e-5, and the scratch's last row, which lies
    past 2^31, against the plain scratch's (da's first term within one bf16
    step, the sum of its terms at 2e-5)."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    name, m = "poisson", 6144
    h, ws, bs, cw, cb, t, g = _cat_case(device, name, 30, m, 2048, 256, 2048,
                                        torch.bfloat16, seed=10)
    g = g / m
    args = (name, h, ws, bs, cw, cb, t)
    out, lse = ops.categorised_forward(*args)
    ref_out, ref_lse = ops.reference_categorised_forward(*args)
    _close(out, ref_out, 2e-5)
    _close(lse, ref_lse, 2e-5)
    bargs = (name, g, h, ws, bs, cw, cb, t, lse)
    grad = fl.cat_f32_tc_gradient(*bargs)
    assert grad.da.numel() > 2 ** 31
    last = fl.reference_cat_f32_tc_gradient(
        name, g[-64:], h[-64:], ws, bs, cw, cb, t[-64:], lse[-64:])
    # slot p holds da's term i of pair p; the first pair of term i is (i, 0)
    got, want = (z.da[-1].reshape(len(fl.SPLIT_PAIRS), -1)
                 for z in (grad, last))
    first = [fl.SPLIT_PAIRS.index((i, 0)) for i in range(fl.SPLIT_TERMS)]
    _within_one_bf16_step(got[0], want[0])
    _close(sum(got[p].float() for p in first),
           sum(want[p].float() for p in first), 2e-5)
    del grad, last, got, want
    got = ops.categorised_backward(*bargs)
    want = (ops.reference_categorised_dh(*bargs),
            *ops.reference_categorised_dw(*bargs))
    for a, b in zip(got, want, strict=True):
        _close(a, b, 2e-5)


# (G, M, H, F) of the grouped kernels
GROUPED_SHAPES = [(1, 37, 21, 301), (3, 20, 584, 45), (17, 9, 1024, 70),
                  (3, 64, 256, 100)]


def _grouped_case(device, name, n_groups, m, hidden, f, t_dtype, seed=0):
    h, weights, biases, t, g = _family_case(device, name, n_groups * m, m,
                                            hidden, f, t_dtype, seed=seed)
    return (h.reshape(n_groups, m, hidden), weights, biases, t,
            g.reshape(n_groups, m))


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("n_groups,m,hidden,f", GROUPED_SHAPES)
@pytest.mark.parametrize("compute", [None, torch.bfloat16])
def test_grouped_kernels_match_plain_and_flat(device, name, n_groups, m,
                                              hidden, f, compute):
    t_dtype = torch.float32 if compute is None else torch.bfloat16
    h, ws, bs, t, g = _grouped_case(device, name, n_groups, m, hidden, f,
                                    t_dtype)
    rtol = 2e-5 if compute is None else 4e-4
    kw = dict(compute_dtype=compute)
    out = ops.grouped_forward(name, h, ws, bs, t, **kw)
    _close(out, ops.reference_grouped_forward(name, h, ws, bs, t, **kw), 2e-5)
    # the gradient kernel and the products, bf16 or on bf16 terms
    dh, *dws = ops.grouped_backward(name, g, h, ws, bs, t, **kw)
    _close(dh, ops.reference_grouped_dh(name, g, h, ws, bs, t, **kw), rtol)
    want = ops.reference_grouped_dw(name, g, h, ws, bs, t, **kw)
    assert len(dws) == len(want) == 2 * len(ws)
    for a, b in zip(dws, want):
        assert a.shape == b.shape
        _close(a, b, rtol)
    # the flat kernels over the G·M group-major rows, targets cycling
    h2, g2 = h.reshape(-1, hidden), g.reshape(-1)
    _close(out.reshape(-1), ops.fused_forward(name, h2, ws, bs, t, **kw),
           2e-5)
    flat = ops.fused_backward(name, g2, h2, ws, bs, t, **kw)
    _close(dh.reshape(-1, hidden), flat[0], rtol)
    for a, b in zip(dws, flat[1:], strict=True):
        _close(a, b, rtol)


def test_grouped_function_and_counts(device):
    """The autograd Function launches K4 and each of the bf16 K5's three
    kernels once, with the leading axes folded into the groups; the t
    gradient is zero."""
    name = "negative binomial"
    h, ws, bs, t, g = _grouped_case(device, name, 6, 16, 32, 70,
                                    torch.float32, seed=2)
    h = h.reshape(2, 3, 16, 32).clone().requires_grad_(True)
    t = t.clone().requires_grad_(True)
    heads = {p: {"kernel": w.clone().requires_grad_(True),
                 "bias": b.clone().requires_grad_(True)}
             for p, w, b in zip(ops.FAMILIES[name].heads, ws, bs)}
    ops.reset_launch_counts()
    out = ops.fused_grouped_log_likelihood(name, h, heads, t,
                                           compute_dtype=torch.bfloat16)
    assert out.shape == (2, 3, 16)
    out.backward(g.reshape(2, 3, 16))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        f"nb_grouped_{kernel}": 1
        for kernel in ("forward", "backward_gradient", "backward_dh",
                       "backward_dw")}
    assert torch.isfinite(h.grad).all() and not t.grad.any()
    with pytest.raises(ValueError):  # t rows must equal h's rows
        ops.grouped_forward(name, h.detach().reshape(6, 16, 32), ws, bs,
                            t.detach()[:8])


def test_grouped_float32_and_bf16_launches_count_apart(device):
    """bf16 and float32 calls launch the grouped tensor-core kernels (K4,
    the gradient kernel, the dh and dW products) each under its own
    counter, float32 with the "_float32" suffix."""
    name = "zero-inflated poisson"
    h, ws, bs, t, g = _grouped_case(device, name, 4, 24, 40, 77,
                                    torch.bfloat16, seed=4)
    for compute, suffix in ((None, "_float32"), (torch.bfloat16, "")):
        ops.reset_launch_counts()
        ops.grouped_forward(name, h, ws, bs, t, compute_dtype=compute)
        ops.grouped_backward(name, g, h, ws, bs, t, compute_dtype=compute)
        torch.cuda.synchronize()
        assert {k: v for k, v in ops.launch_counts().items() if v} == {
            f"zip_grouped_{kernel}{suffix}": 1
            for kernel in ("forward", "backward_gradient", "backward_dh",
                           "backward_dw")}


# (G, M, H, F) of the grouped kernels kernel by kernel: one group, rows off
# the 128-row block and past one block, a ragged F, decoder widths that take
# W in several resident chunks (bf16 ZINB past 256 rows, NB past 384;
# float32 restages W term by term for every family but Poisson at H = 256),
# and G = 17 past the JAX cap
GROUPED_TC_SHAPES = [(1, 37, 21, 301), (3, 300, 256, 2000), (17, 9, 584, 70),
                     (3, 130, 1024, 100), (10, 256, 256, 512)]


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("n_groups,m,hidden,f", GROUPED_TC_SHAPES)
def test_grouped_tensor_core_kernels(device, name, n_groups, m, hidden, f):
    """The bf16 grouped backward kernel by kernel: the gradient kernel's
    bf16(da) within one bf16 step of the plain bf16(da), with few flips,
    bit for bit over two runs; its column sums per 64 target rows over
    every group; the dh and dW products of its own da against the plain
    products at 2e-5, bit for bit over two runs; the public backward is
    these three kernels.  Each kernel is held alone, as the flat kernels
    are: at these activations one legitimate flip of a bf16(da) moves a dW
    entry by more than the end-to-end bound (4.4e-4 of the largest at
    300 rows, ZIP), which test_grouped_kernels_match_plain_and_flat and
    chip_smoke.py hold at their shapes."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    h, ws, bs, t, g = _grouped_case(device, name, n_groups, m, hidden, f,
                                    torch.bfloat16, seed=5)
    args = (name, g, h, ws, bs, t)
    grad = fl.grouped_tc_gradient(*args)
    plain = fl.reference_grouped_tc_gradient(*args)
    width = len(ws) * fl.tc_padded(f)
    assert grad.da.shape == plain.da.shape == (n_groups * m, width)
    assert grad.db_parts.shape == plain.db_parts.shape == (-(-m // 64), width)
    _within_one_bf16_step(grad.da, plain.da)
    _close(grad.db_parts, plain.db_parts, 2e-5)
    again = fl.grouped_tc_gradient(*args)
    assert torch.equal(grad.da, again.da)
    assert torch.equal(grad.db_parts, again.db_parts)
    dh = fl.tc_dh(grad)
    assert torch.equal(dh, fl.tc_dh(grad))
    _close(dh, fl.reference_tc_dh(grad), 2e-5)
    dw, db = fl.tc_dw_stacked(grad)
    dw2, db2 = fl.tc_dw_stacked(grad)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    want = fl.reference_tc_dw_stacked(grad)
    _close(dw, want[0], 2e-5)
    _close(db, want[1], 2e-5)
    got = ops.grouped_backward(*args, compute_dtype=torch.bfloat16)
    assert len(got) == 1 + 2 * len(ws)
    assert torch.equal(got[0], dh.reshape(h.shape))
    for k in range(len(ws)):
        assert torch.equal(got[1 + 2 * k], dw[k])
        assert torch.equal(got[2 + 2 * k], db[k])


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("n_groups,m,hidden,f", GROUPED_TC_SHAPES)
def test_grouped_float32_tensor_core_kernels(device, name, n_groups, m,
                                             hidden, f):
    """The float32 grouped K4 and K5 kernel by kernel, at the bf16 kernels'
    shapes (one group, rows off the tiles, H = 584, ZINB's W restaged term
    by term and, at H = 1,024, chunk by chunk): the forward against the
    split design's plain version and the float32 plain version at 2e-5,
    bit for bit over two runs; the gradient kernel's scratch
    (``_check_split_scratch``) and column sums per 64 target rows; the dh
    and dW products of its own scratch at 2e-5, bit for bit over two runs;
    the public backward is these three kernels, within 2e-5 of the float32
    plain versions."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    h, ws, bs, t, g = _grouped_case(device, name, n_groups, m, hidden, f,
                                    torch.bfloat16, seed=7)
    fargs = (name, h, ws, bs, t)
    out = fl.grouped_f32_tc_forward(*fargs)
    _close(out, fl.reference_grouped_f32_tc_forward(*fargs), 2e-5)
    _close(out, ops.reference_grouped_forward(*fargs), 2e-5)
    assert torch.equal(out, fl.grouped_f32_tc_forward(*fargs))
    assert torch.equal(out, ops.grouped_forward(*fargs))
    args = (name, g, h, ws, bs, t)
    grad = fl.grouped_f32_tc_gradient(*args)
    plain = fl.reference_grouped_f32_tc_gradient(*args)
    assert grad.da.shape == plain.da.shape == (
        n_groups * m, len(fl.SPLIT_PAIRS) * len(ws) * fl.tc_padded(f))
    assert grad.db_parts.shape == plain.db_parts.shape == (
        -(-m // 64), len(ws) * fl.tc_padded(f))
    _check_split_scratch(grad, plain)
    _close(grad.db_parts, plain.db_parts, 2e-5)
    again = fl.grouped_f32_tc_gradient(*args)
    assert torch.equal(grad.da, again.da)
    assert torch.equal(grad.db_parts, again.db_parts)
    dh = fl.tc_dh(grad)
    assert torch.equal(dh, fl.tc_dh(grad))
    _close(dh, fl.reference_tc_dh(grad), 2e-5)
    dws = fl.tc_dw(grad)
    assert all(torch.equal(a, b) for a, b in zip(dws, fl.tc_dw(grad)))
    for a, b in zip(dws, fl.reference_tc_dw(grad), strict=True):
        _close(a, b, 2e-5)
    got = ops.grouped_backward(*args)
    assert torch.equal(got[0], dh.reshape(h.shape))
    for a, b in zip(got[1:], dws, strict=True):
        assert torch.equal(a, b)
    want = (ops.reference_grouped_dh(*args),
            *ops.reference_grouped_dw(*args))
    for a, b in zip(got, want, strict=True):
        _close(a, b, 2e-5)


# --------------------------------------------------------------------------
# The compiled epoch: training and evaluation steps as CUDA graph replays
# (models/step.py), against the same steps run eagerly
# --------------------------------------------------------------------------

GRAPH_CELLS, GRAPH_BATCH = 256, 64


def _graph_case(device, kind):
    """A small NB VAE or GMVAE on the card: the staged data, the bf16
    batch dtypes, the optimiser, the loss and evaluation functions, and a
    fresh train state from one seed on every call."""
    import numpy as np

    from scvae_tpu_torch.data.dataset import DataSet
    from scvae_tpu_torch.data.pipeline import (
        build_model_arrays,
        device_resident_data,
    )
    from scvae_tpu_torch.models import api, gmvae, step, vae

    x = np.random.RandomState(0).poisson(
        2.0, (GRAPH_CELLS, 300)).astype(np.float32)
    kwargs = dict(feature_size=300, latent_size=8, hidden_sizes=(32, 32),
                  reconstruction_distribution="negative binomial")
    if kind == "gmvae":
        module = gmvae
        config = gmvae.GMVAEConfig(number_of_latent_clusters=4, **kwargs)
    else:
        module, config = vae, vae.VAEConfig(**kwargs)
    arrays = build_model_arrays(DataSet("in-memory", values=x))
    data = api._append_lgamma_rowsum(
        device_resident_data(arrays, device=device), config)
    optimizer = step.make_optimizer(1e-3)
    params, state = module.init(config, torch.Generator().manual_seed(0))

    def loss(params, model_state, batch, generator, warm_up_weight,
             shard=None):
        return module.loss_fn(config, params, model_state, batch, generator,
                              warm_up_weight=warm_up_weight, shard=shard)

    def evaluate(params, model_state, batch, generator, shard=None):
        return module.elbo_terms(config, params, model_state, batch,
                                 generator, training=False, shard=shard)[0]

    def fresh():
        return step.create_train_state(
            step.tree_map(lambda a: a.to(device), params),
            step.tree_map(lambda a: a.to(device), state), optimizer)

    return (data, api._bf16_batch_dtypes(arrays, config, device), optimizer,
            loss, evaluate, fresh)


def _perm(device, seed):
    import numpy as np

    from scvae_tpu_torch.models import step

    return torch.from_numpy(step.epoch_permutation(
        GRAPH_CELLS, GRAPH_BATCH, np.random.RandomState(seed))).to(device)


def _train(device, kind, capture, perms):
    """Epochs over ``perms`` from the case's seed: (train state, each
    epoch's metrics as floats, the generator's state, the launches)."""
    from scvae_tpu_torch.models import step

    data, dtypes, optimizer, loss, _, fresh = _graph_case(device, kind)
    ts = fresh()
    train_epoch = step.make_train_epoch(loss, optimizer, batch_dtypes=dtypes,
                                        capture=capture)
    generator = torch.Generator(device=device).manual_seed(0)
    ops.reset_launch_counts()
    curves = []
    for epoch, perm in enumerate(perms):
        ts, metrics = train_epoch(ts, data, perm, generator, 0.5 + epoch / 4)
        curves.append({k: float(v) for k, v in metrics.items()})
    torch.cuda.synchronize()
    return ts, curves, generator.get_state(), ops.launch_counts()


def _assert_same_training(got, want):
    """Parameters and batch-norm state within 2e-5 of the largest
    |parameter| (the small step's bound: only a kernel whose result
    depends on when it runs may differ), metrics and generator equal."""
    from scvae_tpu_torch.models import step

    (ts, curves, gen_state, _), (ts_e, curves_e, gen_state_e, _) = got, want
    pairs = [(a, b) for part in ("params", "model_state")
             for a, b in zip(step.tree_leaves(getattr(ts, part)),
                             step.tree_leaves(getattr(ts_e, part)))]
    largest = max(float(b.abs().max()) for _, b in pairs)
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    assert diff <= 2e-5 * largest, (diff, largest)
    assert curves == curves_e
    assert torch.equal(gen_state, gen_state_e)
    assert int(ts.opt_state["count"]) == int(ts_e.opt_state["count"]) == ts.step


@pytest.mark.parametrize("kind", ["vae", "gmvae"])
def test_graphed_epochs_match_eager(device, kind):
    perms = [_perm(device, seed) for seed in (0, 1)]
    _assert_same_training(_train(device, kind, True, perms),
                          _train(device, kind, False, perms))


@pytest.mark.parametrize("kind", ["vae", "gmvae"])
def test_replay_on_new_permutation_matches_eager(device, kind):
    """The graph is captured in the first epoch; the second runs replays
    only, on a permutation (and warm-up weight) the capture never saw: a
    launch that escaped the capture, or an input it froze, would leave the
    replay's result stale."""
    first = _perm(device, 0)
    perms = [first, first.flip(0).flip(1).contiguous()]
    _assert_same_training(_train(device, kind, True, perms),
                          _train(device, kind, False, perms))


def test_graphed_eval_epoch_matches_eager(device):
    from scvae_tpu_torch.models import step

    data, _, _, _, evaluate, fresh = _graph_case(device, "gmvae")
    ts = fresh()
    # other parameters, which the graph reads through its own copies
    scaled = step.tree_map(lambda a: a * 1.01, ts.params)
    idx = torch.from_numpy(step.sequential_batches(GRAPH_CELLS, 32)).to(device)
    results = {}
    for capture in (False, True):
        eval_epoch = step.make_eval_epoch(evaluate, capture=capture)
        generator = torch.Generator(device=device).manual_seed(3)
        results[capture] = [eval_epoch(params, ts.model_state, data, idx,
                                       generator)
                            for params in (ts.params, ts.params, scaled)]
    for got, want in zip(results[True], results[False]):
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert not torch.equal(results[True][0]["lower_bound"],
                           results[True][2]["lower_bound"])


def test_launch_counters_count_replays(device):
    perms = [_perm(device, seed) for seed in (0, 1)]
    graphed = _train(device, "vae", True, perms)[3]
    eager = _train(device, "vae", False, perms)[3]
    steps = GRAPH_CELLS // GRAPH_BATCH * len(perms)
    assert graphed == eager
    for kernel in ("forward", "backward_gradient", "backward_dh",
                   "backward_dw"):
        assert graphed[f"nb_{kernel}"] == steps, kernel
    assert graphed["gather_rows"] == steps


def test_failed_capture_raises(device):
    """A step that a capture refuses (here a host read of the loss) raises
    at the capture, the second step of the epoch's life; nothing retries
    it eagerly."""
    from scvae_tpu_torch.models import step

    data, dtypes, optimizer, loss, _, fresh = _graph_case(device, "vae")
    calls = []

    def reads_the_loss(*args, **kwargs):
        value, aux = loss(*args, **kwargs)
        calls.append(float(value.detach()))  # a device-to-host copy
        return value, aux

    train_epoch = step.make_train_epoch(reads_the_loss, optimizer,
                                        batch_dtypes=dtypes)
    ts = fresh()
    generator = torch.Generator(device=device).manual_seed(0)
    with pytest.raises(RuntimeError):
        train_epoch(ts, data, _perm(device, 0), generator, 1.0)
    torch.cuda.synchronize()
    assert len(calls) == 1 and ts.step == 1


def test_capture_survives_garbage_graphs(device):
    """A graph that only a reference cycle keeps (an earlier ``train``
    call's) is not destroyed while another is captured, which would
    invalidate the capture: the capture collects such garbage first and
    keeps the collector off meanwhile.  Here the cycle becomes garbage
    inside the captured body, which then collects as the interpreter does
    on its own whenever collection is on."""
    import gc

    from scvae_tpu_torch.models import step

    x = torch.zeros(8, device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    old = step._GraphedBody(lambda: x.add_(1.0), generator, "train")
    for _ in range(3):  # eager, captured, replayed
        old()
    keep = []

    def body():
        keep.clear()  # the old graph's cycle is garbage from here on
        if gc.isenabled():
            gc.collect()
        x.mul_(2.0)

    new = step._GraphedBody(body, generator, "train")
    new()  # eager
    cycle = [old]
    cycle.append(cycle)
    keep.append(cycle)
    del old, cycle
    new()  # captured, replayed
    new()
    torch.cuda.synchronize()
    assert torch.all(x == 24.0)  # (3 + 0) · 2 · 2 · 2


def _labelled_case():
    """A small labelled set (4 classes, one excluded) and a GMVAE whose
    batch-norm statistics are not the initial ones."""
    import numpy as np

    from scvae_tpu_torch import DataSet, GaussianMixtureVariationalAutoencoder
    from scvae_tpu_torch.models import gmvae

    rng = np.random.RandomState(5)
    x = rng.poisson(2.0, (700, 300)).astype(np.float32)
    labels = np.array(["A", "B", "C", "No class"])[rng.randint(0, 4, 700)]
    data_set = DataSet("in-memory", values=x, labels=labels)
    model = GaussianMixtureVariationalAutoencoder(
        feature_size=300, latent_size=8, hidden_sizes=[64, 32],
        reconstruction_distribution="negative binomial",
        number_of_latent_clusters=5)
    params, state = gmvae.init(model.config,
                               torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    for layer in state["q_y"]["batch_norm"]:
        layer["mean"] = torch.randn(layer["mean"].shape, generator=gen)
        layer["var"] = 1.0 + torch.rand(layer["var"].shape, generator=gen)
    return data_set, model, params, state


def test_accuracy_callback_matches_cpu(device):
    """The callback's cluster ids and accuracy on the card against the CPU
    from the same parameters and set: equal ids, apart from rows whose two
    largest q(y|x) logits lie within 1e-5 of each other."""
    import numpy as np

    from scvae_tpu_torch.models import gmvae, networks, step

    data_set, model, params, state = _labelled_case()
    results = []
    for where in (torch.device("cpu"), device):
        moved = step.TrainState(
            params=step.tree_map(lambda a: a.to(where), params),
            model_state=step.tree_map(lambda a: a.to(where), state),
            opt_state={}, step=0)
        metrics = {}
        model._make_accuracy_callback({"training": data_set}, where)(
            0, moved, metrics)
        x = torch.from_numpy(data_set.values).to(where)
        ids = gmvae.cluster_ids(moved.params, moved.model_state, x)
        h_y, _ = networks.apply_mlp(moved.params["q_y"]["encoder"],
                                    moved.model_state["q_y"], x,
                                    training=False)
        logits = networks.apply_dense(moved.params["q_y"]["logits"], h_y)
        results.append((metrics["training"]["accuracy"], ids.cpu().numpy(),
                        logits.cpu().numpy()))
    (accuracy_cpu, ids_cpu, logits), (accuracy, ids, _) = results
    top2 = np.sort(logits, axis=-1)[:, -2:]
    ties = top2[:, 1] - top2[:, 0] <= 1e-5
    assert np.array_equal(ids[~ties], ids_cpu[~ties])
    if not ties.any():
        assert accuracy == accuracy_cpu
    assert 0.0 <= accuracy <= 1.0


def test_training_on_float32_values(device, tmp_path, monkeypatch):
    """Log-preprocessed values are staged as float32, and the training step
    gathers them with K1 from that float32 source."""
    import numpy as np

    from scvae_tpu_torch import DataSet, VariationalAutoencoder
    from scvae_tpu_torch.data import processing
    from scvae_tpu_torch.data.pipeline import (
        build_model_arrays,
        device_resident_data,
    )

    monkeypatch.chdir(tmp_path)
    counts = np.random.RandomState(6).poisson(2.0, (640, 300)).astype(
        np.float32)
    data_set = DataSet("in-memory", values=counts)
    data_set.update(preprocessed_values=processing.build_preprocessor(
        ["log"])(counts))
    staged = device_resident_data(build_model_arrays(data_set),
                                  device=device)
    assert staged["x"].dtype == torch.float32 and staged["x"] is staged["t"]
    idx = torch.arange(0, 640, 5, dtype=torch.int32, device=device)
    assert torch.equal(ops.gather_rows(staged["x"], idx, torch.float32),
                       ops.reference_gather(staged["x"], idx, torch.float32))
    model = VariationalAutoencoder(
        feature_size=300, latent_size=8, hidden_sizes=[32],
        reconstruction_distribution="negative binomial")
    ops.reset_launch_counts()
    result = model.train(data_set, number_of_epochs=1, minibatch_size=64,
                         device=device, verbose=False)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    steps = result.steps_per_epoch
    assert steps == 10 and launches["nb_forward"] == steps
    assert launches["gather_rows"] >= steps
    assert np.all(np.isfinite(result.history["training"]["lower_bound"]))


@pytest.mark.parametrize("hidden", [100, 101, 105])
@pytest.mark.parametrize("float32", [False, True])
def test_tensor_core_kernels_at_lfm_widths(device, hidden, float32):
    """NB's K2/K3 at the LFM decoder's widths (latent 100, with the count
    sum and with 4 batch one-hots as well), which the kernels pad to a
    multiple of 8; h is not a ReLU's output there."""
    name = "negative binomial"
    h, weights, biases, t, g = _family_case(device, name, 160, 160, hidden,
                                            300, torch.bfloat16, seed=7)
    h = h - h.mean()
    _check_tensor_core_kernels(name, h, weights, biases, t, g,
                               float32=float32)


def _options_step(name, model, options, device, precision):
    """One training loss and its gradients of a small configuration with
    ``options`` on ``device``: the same parameters, batch and z noise on
    every device."""
    import numpy as np

    from scvae_tpu_torch.models import gmvae, step, vae

    kwargs = dict(feature_size=24, latent_size=5, hidden_sizes=(16, 12),
                  reconstruction_distribution=name, precision=precision,
                  **options)
    rng = np.random.RandomState(0)
    x = rng.poisson(2.0, (40, 24)).astype(np.float32)
    if model == "gmvae":
        module = gmvae
        config = gmvae.GMVAEConfig(number_of_latent_clusters=3, **kwargs)
        noise = rng.standard_normal((1, 3, 40, 5)).astype(np.float32)
    else:
        module, config = vae, vae.VAEConfig(**kwargs)
        noise = rng.standard_normal((1, 40, 5)).astype(np.float32)
    indices = rng.randint(0, 3, (40, 1)).astype(np.float32)
    params, state = module.init(config, torch.Generator().manual_seed(0))
    p = step.tree_map(lambda a: a.to(device).requires_grad_(True), params)
    s = step.tree_map(lambda a: a.to(device), state)
    xt = torch.from_numpy(x).to(device)
    count_sum = xt.sum(-1, keepdim=True)
    batch = {"x": xt, "t": xt, "count_sum_feature": count_sum / count_sum.max(),
             "batch_indices": torch.from_numpy(indices).to(device)}
    loss, _ = module.loss_fn(config, p, s, batch, None,
                             noise=torch.from_numpy(noise).to(device))
    grads = torch.autograd.grad(loss, step.tree_leaves(p))
    return [loss.detach().cpu()] + [gr.cpu() for gr in grads]


def test_fused_step_matches_unfused(device):
    """VAE-NB's training loss and gradients on the fused kernels against the
    unfused path on the card: float32, the loss and every gradient within
    2e-5 of the largest; bf16 matmul inputs, the loss within 4e-4 and the
    gradient in norm within 5e-3 (a dense kernel's gradient is a bf16
    number there, as in JAX, so a float32 sum taken in another order moves
    a value by a whole bf16 step: the bound of the CPU bf16 tests against
    JAX)."""
    for precision in ("float32", "bfloat16"):
        fused = _options_step("negative binomial", "vae", {}, device,
                              precision)
        unfused = _options_step("negative binomial", "vae",
                                {"fused_likelihood": False}, device, precision)
        got, want = torch.cat([g.ravel() for g in fused[1:]]), torch.cat(
            [g.ravel() for g in unfused[1:]])
        if precision == "float32":
            _close(fused[0], unfused[0], 2e-5)
            _close(got, want, 2e-5)
        else:
            _close(fused[0], unfused[0], 4e-4)
            assert float(torch.linalg.vector_norm(got - want)
                         / torch.linalg.vector_norm(want)) <= 5e-3


@pytest.mark.parametrize("name,model,options", [
    ("negative binomial", "vae", {"inference_architecture": "LFM",
                                  "generative_architecture": "LFM",
                                  "batch_correction": True,
                                  "number_of_batches": 3, "count_sum": True}),
    ("negative binomial", "gmvae", {
        "latent_distribution": "full-covariance gaussian mixture"}),
    ("multivariate gaussian", "vae", {}),
    ("gaussian mixture", "vae", {}),
    ("exponentially_modified_gaussian", "vae", {}),
])
def test_options_step_matches_cpu(device, name, model, options):
    """A configuration of the options on the card (the fused kernels or the
    unfused path, the triangular solves of the full-covariance Gaussians)
    against the same step on the CPU, float32: 2e-5 of the largest
    gradient."""
    got = _options_step(name, model, options, device, "float32")
    want = _options_step(name, model, options, "cpu", "float32")
    _close(got[0], want[0], 2e-5)
    largest = max(float(gr.abs().max()) for gr in want[1:])
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 2e-5 * largest


@pytest.mark.parametrize("float32", [False, True])
def test_nb_kernels_at_4096_genes(device, float32):
    """NB's K2 and K3's three kernels at the over-budget set's 4,096 genes
    (twice the headline's), a 2,048-row minibatch and decoder width 256,
    kernel by kernel against their plain versions."""
    _check_tensor_core_kernels("negative binomial", *_family_case(
        device, "negative binomial", 2048, 2048, 256, 4096, torch.bfloat16,
        seed=7), float32=float32)


def _stream_counts(n):
    """(n, 200) counts: 16 full rows first, then rows of about 3 stored
    entries.  In order, batches of 16 ship the CSR wire at a capacity of
    1,024 entries, but the first (3,200 entries) overflows it and goes
    dense."""
    import numpy as np
    import scipy.sparse

    rng = np.random.RandomState(0)
    dense = (rng.poisson(3.0, (n, 200)) + 1) * (
        rng.uniform(size=(n, 200)) < 0.015)
    dense[:16] = 1 + rng.poisson(3.0, (16, 200))
    return scipy.sparse.csr_matrix(dense.astype(np.float32))


def test_pinned_buffers_reused_after_their_copies(device):
    """Prefetch 2 over 20 batches, with the copy stream held back before
    every copy so that the host runs ahead of it: each batch, dense (the
    first, which overflows the wire) or on the wire, materialized on the
    card equals its rows densified on the host."""
    import numpy as np

    from scvae_tpu_torch.data import pipeline
    from scvae_tpu_torch.models import step

    values = _stream_counts(320)
    rows = np.arange(320, dtype=np.int32)[:, None]

    class HeldBack(pipeline.BatchPipeline):
        def _to_device(self, host, number):
            if self._copy_stream is not None:
                with torch.cuda.stream(self._copy_stream):
                    torch.cuda._sleep(2_000_000)
            return super()._to_device(host, number)

    stream = HeldBack({"x": values, "t": values, "row": rows}, 16,
                      shuffle=False, prefetch=2,
                      count_dtype=(np.int16, np.int32), wire_format="csr",
                      device=device)
    assert stream._csr_wire["x"]["capacity"] == 1024
    kinds, got = [], []
    for batch in stream.epoch():
        kinds.append(type(batch["x"]).__name__)
        dense = step.materialize_batch(batch)
        got.append((dense["x"].clone(), batch["row"].clone()))
    torch.cuda.synchronize()
    assert kinds == ["Tensor"] + ["CSRWire"] * 19
    for i, (x, row) in enumerate(got):
        idx = np.arange(i * 16, (i + 1) * 16)
        np.testing.assert_array_equal(row.cpu().numpy()[:, 0], idx)
        np.testing.assert_array_equal(x.float().cpu().numpy(),
                                      values[idx].toarray())


def _streamed_run(device, capture):
    """Two epochs of a small VAE-NB streamed from the host in order, in
    batches of 16 (the first dense, having overflowed the wire, then the
    wire, and a shorter last batch), from one seed: (train state, the
    steps' metrics, the generator's state, the launches)."""
    import numpy as np

    from scvae_tpu_torch.data import pipeline
    from scvae_tpu_torch.models import step, vae

    values = _stream_counts(270)
    config = vae.VAEConfig(feature_size=200, latent_size=8,
                           hidden_sizes=(32, 32),
                           reconstruction_distribution="negative binomial")
    params, state = vae.init(config, torch.Generator().manual_seed(0))
    optimizer = step.make_optimizer(1e-3)
    ts = step.create_train_state(
        step.tree_map(lambda a: a.to(device), params),
        step.tree_map(lambda a: a.to(device), state), optimizer)

    def loss(params, model_state, batch, generator, warm_up_weight,
             shard=None):
        return vae.loss_fn(config, params, model_state, batch, generator,
                           warm_up_weight=warm_up_weight, shard=shard)

    train_step = step.make_train_step(loss, optimizer, capture=capture)
    generator = torch.Generator(device=device).manual_seed(0)
    ops.reset_launch_counts()
    metrics, kinds = [], set()
    for epoch in range(2):
        stream = pipeline.BatchPipeline(
            {"x": values, "t": values}, 16, shuffle=False,
            count_dtype=(np.int16, np.int32), wire_format="csr",
            device=device)
        for batch in stream.epoch():
            kinds.add((type(batch["x"]).__name__, batch["x"].shape[0]))
            ts, out = train_step(ts, batch, generator, 0.5 + epoch / 4)
            metrics.append({k: v.clone() for k, v in out.items()})
    torch.cuda.synchronize()
    assert kinds == {("Tensor", 16), ("CSRWire", 16), ("CSRWire", 14)}
    return ts, metrics, generator.get_state(), ops.launch_counts()


def test_streamed_step_graphed_matches_eager(device):
    """The streamed VAE-NB steps as graph replays, one graph per batch
    signature (the wire, the dense batch of an overflow, the shorter last
    batch), against the same steps run eagerly: bit for bit."""
    from scvae_tpu_torch.models import step

    (ts, metrics, gen, launches), (ts_e, metrics_e, gen_e, launches_e) = (
        _streamed_run(device, True), _streamed_run(device, False))
    for part in ("params", "model_state"):
        for a, b in zip(step.tree_leaves(getattr(ts, part)),
                        step.tree_leaves(getattr(ts_e, part)), strict=True):
            assert torch.equal(a, b), part
    assert torch.equal(ts.opt_state["count"], ts_e.opt_state["count"])
    assert ts.step == ts_e.step == len(metrics)
    for got, want in zip(metrics, metrics_e, strict=True):
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert torch.equal(gen, gen_e)
    assert launches == launches_e
    assert launches["nb_forward"] == len(metrics)
    assert launches.get("gather_rows", 0) == 0


# -- the analyses on the card against the CPU -----------------------------------


def _analysis_blobs(seed, n, k, features, spread=6.0):
    import numpy as np

    rs = np.random.RandomState(seed)
    centres = rs.randn(k, features) * spread
    ids = rs.randint(0, k, n)
    return centres[ids] + rs.randn(n, features), ids


def test_clustering_metrics_match_cpu(device):
    """ARI equal, AMI within 1e-12; the silhouette (float64 on both),
    summary statistics and correlations within 1e-9 relative."""
    import numpy as np
    import scipy.sparse

    from scvae_tpu_torch.analyses import metrics

    values, ids = _analysis_blobs(0, 3_001, 7, 33)
    labels = np.array([f"type {i}" for i in ids])
    rs = np.random.RandomState(1)
    predicted = np.where(rs.rand(len(ids)) < 0.7, ids, rs.randint(0, 9,
                                                                  len(ids)))
    assert metrics.adjusted_rand_index(
        labels, predicted, ["type 2"], device=device) == (
            metrics.adjusted_rand_index(labels, predicted, ["type 2"],
                                        device="cpu"))
    # float64 sums in another order
    assert abs(metrics.adjusted_mutual_information(
        labels, predicted, ["type 2"], device=device)
        - metrics.adjusted_mutual_information(
            labels, predicted, ["type 2"], device="cpu")) <= 1e-12
    got = metrics.silhouette_score(values, predicted, device=device)
    want = metrics.silhouette_score(values, predicted, device="cpu")
    assert abs(got - want) <= 1e-9 * abs(want)
    for x in (values, scipy.sparse.csr_matrix(np.where(values > 2, values,
                                                       0))):
        got = metrics.summary_statistics(x, tolerance=0.5, device=device)
        want = metrics.summary_statistics(x, tolerance=0.5, device="cpu")
        for key, value in want.items():
            if key != "name":
                assert abs(got[key] - value) <= 1e-9 * abs(value), key
    got = metrics.correlation_matrix(values, axis="features", device=device)
    want = metrics.correlation_matrix(values, axis="features", device="cpu")
    assert np.abs(got - want).max() <= 1e-9


@pytest.mark.parametrize("rows", [2_000, 12_000])
def test_kmeans_matches_cpu(device, rows):
    """k-means (up to 10,000 rows) and mini-batch k-means (above): the
    same seed gives the same draws on both devices, so the same
    partition (ARI ≥ 0.999) and inertia within 1e-9."""
    import numpy as np

    from scvae_tpu_torch.analyses import metrics
    from scvae_tpu_torch.analyses.kmeans import KMeans, MiniBatchKMeans

    values, _ = _analysis_blobs(2, rows, 10, 16)
    estimator = KMeans if rows <= 10_000 else MiniBatchKMeans
    got = estimator(10, seed=3, device=device).fit(values)
    want = estimator(10, seed=3, device="cpu").fit(values)
    assert metrics.adjusted_rand_index(got.labels_, want.labels_,
                                       device="cpu") >= 0.999
    assert abs(got.inertia_ - want.inertia_) <= 1e-9 * want.inertia_
    np.testing.assert_array_equal(got.predict(values[:100]),
                                  want.predict(values[:100]))


@pytest.mark.parametrize("method,features", [("PCA", 40), ("PCA", 2_100),
                                             ("SVD", 40)])
def test_decompositions_match_cpu(device, method, features):
    """PCA (exact), IncrementalPCA (over 2,000 features) and the
    randomised SVD: transforms within 1e-6 relative (the SVD's by
    absolute value)."""
    import numpy as np

    from scvae_tpu_torch.analyses import decompose

    values, _ = _analysis_blobs(4, 500, 5, features)
    got = decompose(values, method=method, seed=5, device=device)
    want = decompose(values, method=method, seed=5, device="cpu")
    if method == "SVD":
        got, want = np.abs(got), np.abs(want)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("method,components", [("ICA", 2), ("t-SNE", 2),
                                               ("t-SNE", 4)])
def test_ica_and_tsne_match_cpu(device, method, components):
    """ICA (float64) within 1e-6 relative; t-SNE's P and first gradient
    within 1e-6 and 1e-4 (float32 sums in another order), the descent's
    final KL(P ‖ Q) (``kl_divergence_``) within 1% and its 10-nearest-
    neighbour preservation within 0.02, in 2-D and by the exact method
    (four components)."""
    import numpy as np

    from chip_smoke import neighbour_preservation
    from scvae_tpu_torch.analyses import decompose
    from scvae_tpu_torch.analyses.tsne import TSNE, _SparseObjective

    values, _ = _analysis_blobs(6, 600, 5, 12)
    if method == "ICA":
        got = decompose(values, method=method, device=device)
        want = decompose(values, method=method, device="cpu")
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        return
    if components == 4:
        values = values[:200]
    parts = {}
    for where in (device, "cpu"):
        model = TSNE(components, 42, where)
        x = torch.from_numpy(values).to(where)
        p = model.joint_probabilities(x)
        gradient = torch.zeros(())
        if p.is_sparse:
            _, gradient = _SparseObjective(p, 1)(
                model.initial_embedding(x), False)
            p = p.to_dense()
        embedding = model.fit_transform(values)
        parts[where] = (p.cpu(), gradient.cpu(),
                        model.kl_divergence_,
                        neighbour_preservation(values, embedding, 10, where))
    _close(parts[device][0], parts["cpu"][0], 1e-6)
    if components == 2:
        _close(parts[device][1], parts["cpu"][1], 1e-4)
    assert abs(parts[device][2] - parts["cpu"][2]) <= 0.01 * parts["cpu"][2]
    assert abs(parts[device][3] - parts["cpu"][3]) <= 0.02


def test_distances_and_intermediate_latents_match_cpu(device, tmp_path):
    """The distance matrix (``torch.cdist``, float64) within 1e-12
    relative; ``train`` with an intermediate analyser on the card at every
    epoch of three, its last latent values within 2e-5 of the stored
    parameters' on the CPU."""
    import numpy as np

    from scvae_tpu_torch import VariationalAutoencoder
    from scvae_tpu_torch.analyses.subanalyses import pairwise_distances
    from scvae_tpu_torch.models import vae

    values, _ = _analysis_blobs(7, 1_000, 4, 30)
    got = pairwise_distances(values, device)
    want = pairwise_distances(values, "cpu")
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    counts = np.random.RandomState(8).poisson(2.0, (600, 40))
    model = VariationalAutoencoder(feature_size=40, latent_size=3,
                                   hidden_sizes=[16],
                                   log_directory=str(tmp_path))
    calls = []
    model.train(counts, number_of_epochs=3, minibatch_size=100,
                device=device, verbose=False,
                intermediate_analyser=lambda **call: calls.append(call))
    assert [call["epoch"] for call in calls] == [0, 1, 2]
    state, _ = model._restore(None, False, False, torch.device("cpu"))
    x = torch.from_numpy(counts.astype(np.float32))
    _close(torch.from_numpy(calls[-1]["latent_values"]),
           vae.latent_means(model.config, state.params, state.model_state,
                            x), 2e-5)


def test_trace_finds_the_graphed_kernels(device, tmp_path):
    """``utils.profiling.trace`` around two epochs of a small NB VAE (the
    second all graph replays): ``summarize_trace`` finds K2's and K3's
    heads kernel, the products and K1 by name, each as often as the launch
    counters count them; ``device_memory_stats`` reads 0 < bytes in use ≤
    the limit, as ``chip_smoke.py`` phase 4a holds at the headline."""
    from scvae_tpu_torch.utils.profiling import (
        device_memory_stats,
        summarize_trace,
        trace,
    )

    perms = [_perm(device, seed) for seed in (0, 1)]
    with trace(str(tmp_path)):
        launches = _train(device, "vae", True, perms)[3]
    entries = summarize_trace(str(tmp_path), top=None)

    def events(*parts):
        return sum(entry["count"] for entry in entries
                   if any(part in entry["name"] for part in parts))

    steps = GRAPH_CELLS // GRAPH_BATCH * len(perms)
    assert launches["nb_forward"] == steps
    assert events("tc_heads_kernel") == (
        launches["nb_forward"] + launches["nb_backward_gradient"])
    assert events("tc_product_kernel") == (
        launches["nb_backward_dh"] + launches["nb_backward_dw"])
    assert events("gather_vector_kernel", "gather_element_kernel") == (
        launches["gather_rows"]) == steps
    (memory,) = device_memory_stats()
    assert memory["device"] == "cuda:0"
    assert 0 < memory["bytes_in_use"] <= memory["bytes_limit"]


def test_spans_of_a_graphed_train(device, tmp_path):
    """Three epochs of a small NB VAE through ``train`` with the recorder
    on, epoch 2 under ``trace``: the training and the evaluation epoch each
    run eagerly once and are captured once, in the first epoch (the counter
    ``step.graph_captures`` 2, none later), and each epoch's evaluation
    takes the fused forward (``eval.fused_passes`` 3); Σ ``epoch.train``
    equals ``epoch_seconds`` within 1 ms an epoch; in the trace each of epoch 2's
    spans lies within 1 ms of its ``user_annotation`` (``ts`` × 1000 +
    ``baseTimeNanoseconds``), every kernel starts inside an annotation of
    an epoch's phase, and most inside ``epoch.train`` or
    ``epoch.evaluate``."""
    import gzip
    import json
    import os

    import numpy as np

    from scvae_tpu_torch import VariationalAutoencoder
    from scvae_tpu_torch.utils import tracing
    from scvae_tpu_torch.utils.profiling import trace

    counts = np.random.RandomState(0).poisson(
        2.0, (GRAPH_CELLS, 300)).astype(np.float32)
    model = VariationalAutoencoder(
        feature_size=300, latent_size=4, hidden_sizes=[32],
        reconstruction_distribution="negative binomial",
        log_directory=str(tmp_path / "model"))
    profiled = contextlib.ExitStack()

    def callback(epoch, train_state, metrics):
        if epoch == 0:
            profiled.enter_context(trace(str(tmp_path / "trace")))
        elif epoch == 1:
            profiled.close()

    tracing.reset()
    tracing.enable()
    try:
        with profiled:
            result = model.train(counts, number_of_epochs=3,
                                 minibatch_size=GRAPH_BATCH, device=device,
                                 verbose=False, epoch_callback=callback)
    finally:
        tracing.disable()
    spans = tracing.spans()
    named = {}
    for span in spans:
        named.setdefault(span.name, []).append(span)
    assert sorted(s.attrs["kind"] for s in named["step.eager"]) == [
        "eval", "train"]
    assert sorted(s.attrs["kind"] for s in named["step.capture"]) == [
        "eval", "train"]
    assert tracing.counters() == {"step.graph_captures": 2,
                                  "eval.fused_passes": 3}
    first_epoch = named["epoch"][0]
    for s in named["step.eager"] + named["step.capture"]:
        assert s.end_ns <= first_epoch.end_ns
    trained = [s.seconds for s in named["epoch.train"]]
    assert len(trained) == len(result.epoch_seconds) == 3
    for got, want in zip(trained, result.epoch_seconds):
        assert abs(got - want) <= 1e-3

    (run,) = os.listdir(tmp_path / "trace" / "plugins" / "profile")
    (name,) = os.listdir(tmp_path / "trace" / "plugins" / "profile" / run)
    with gzip.open(tmp_path / "trace" / "plugins" / "profile" / run / name,
                   "rt") as f:
        events = json.load(f)
    base = int(events["baseTimeNanoseconds"])
    events = [e for e in events["traceEvents"] if e.get("ph") == "X"]
    annotations = {e["name"]: e for e in events
                   if e.get("cat") == "user_annotation"}
    window = {}
    for phase in ("epoch.train", "epoch.evaluate"):
        span = named[phase][1]
        event = annotations[phase]
        start = float(event["ts"]) * 1e3 + base
        end = start + float(event["dur"]) * 1e3
        assert abs(span.start_ns - start) < 1e6, phase
        assert abs(span.end_ns - end) < 1e6, phase
        window[phase] = (float(event["ts"]),
                         float(event["ts"]) + float(event["dur"]))
    phases = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("epoch.")]
    kernels = [float(e["ts"]) for e in events if e.get("cat") == "kernel"]
    assert kernels
    assert all(any(a <= ts <= b for a, b in phases) for ts in kernels)
    inside = [ts for ts in kernels
              if any(a <= ts <= b for a, b in window.values())]
    assert len(inside) >= 0.9 * len(kernels)


def test_mesh_of_one_matches_no_mesh_and_traces_the_all_reduce(device,
                                                                tmp_path):
    """Data parallel on a world of one NCCL rank: the small NB VAE's two
    graphed epochs through ``make_train_epoch(mesh=…)`` against the same
    epochs without a mesh (on one rank the mesh changes no value: the
    curves within 1e-6 relative, the parameters within the small step's
    bound), and ``trace`` around the mesh's second epoch, all replays,
    finds NCCL's reduction kernel as often as the step's collectives were
    counted: 17 a step (each of the four batch norms averages its mean
    and its variance, and the backward each again, then one average of
    the gradients and the metrics)."""
    import torch.distributed as dist

    from scvae_tpu_torch.models import step, vae
    from scvae_tpu_torch.parallel import mesh as parallel
    from scvae_tpu_torch.utils.profiling import summarize_trace, trace

    data, dtypes, optimizer, _, _, fresh = _graph_case(device, "vae")
    config = vae.VAEConfig(feature_size=300, latent_size=8,
                           hidden_sizes=(32, 32),
                           reconstruction_distribution="negative binomial")

    def loss(params, model_state, batch, generator, warm_up_weight,
             shard=None):
        return vae.loss_fn(config, params, model_state, batch, generator,
                           warm_up_weight=warm_up_weight, shard=shard)

    perms = [_perm(device, seed) for seed in (0, 1)]
    steps = GRAPH_CELLS // GRAPH_BATCH
    parallel.distributed_initialize(
        device="cuda", store=dist.FileStore(str(tmp_path / "store"), 1),
        world_size=1, rank=0)
    try:
        mesh = parallel.create_mesh(device="cuda")
        runs = {}
        for name, on in (("single", None), ("mesh", mesh)):
            ts = fresh()
            train_epoch = step.make_train_epoch(loss, optimizer,
                                                batch_dtypes=dtypes, mesh=on)
            generator = torch.Generator(device=device).manual_seed(0)
            curves = []
            for epoch, perm in enumerate(perms):
                tracing = (trace(str(tmp_path / "trace"))
                           if on is not None and epoch == 1
                           else contextlib.nullcontext())
                before = parallel.collective_counts()["all_reduce"]
                with tracing:
                    ts, metrics = train_epoch(ts, data, perm, generator, 1.0)
                    torch.cuda.synchronize()
                counted = parallel.collective_counts()["all_reduce"] - before
                curves.append({k: float(v) for k, v in metrics.items()})
            runs[name] = (ts, curves)
    finally:
        dist.destroy_process_group()
    (ts, curves), (ts_m, curves_m) = runs["single"], runs["mesh"]
    for got, want in zip(curves_m, curves):
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-6 * abs(want[key]), key
    pairs = [(a, b) for part in ("params", "model_state")
             for a, b in zip(step.tree_leaves(getattr(ts_m, part)),
                             step.tree_leaves(getattr(ts, part)))]
    largest = max(float(b.abs().max()) for _, b in pairs)
    assert max(float((a - b).abs().max()) for a, b in pairs) <= 2e-5 * largest
    assert counted == steps * 17
    reductions = sum(entry["count"]
                     for entry in summarize_trace(str(tmp_path / "trace"),
                                                  top=None)
                     if any(part in entry["name"]
                            for part in ("oneRankReduce", "AllReduce")))
    assert reductions == counted


@pytest.mark.parametrize("name,k_max,m,m_t,f", [
    ("negative binomial", 0, 111, 37, 302),
    ("negative binomial", 0, 192, 64, 2048),
    ("poisson", 0, 26, 13, 14),
    ("zero-inflated negative binomial", 10, 37, 37, 302),
])
@pytest.mark.parametrize("compute", [torch.bfloat16, None])
def test_gene_blocks_match_whole_kernels(device, name, k_max, m, m_t, f,
                                         compute):
    """The gene split's launches on one card: each of two gene blocks of
    F/2 through ``ops.sharded``'s split Functions with a ``GeneSplit`` of
    no group, forward and backward, the row sums and dh summed over the
    blocks and the heads' gradients put together, against the whole-F
    kernels on the same inputs (rows cycling over the targets for the base
    families): 2e-5 forward and in float32, 4e-4 backward in bf16."""
    from scvae_tpu_torch.parallel import GeneSplit

    heads_of = ops.FAMILIES[name].heads
    n_base = len(heads_of)
    h, weights, biases, t, g = _case(
        device, n_base + (k_max + 1 if k_max else 0), m, m_t, 64, f,
        torch.float32)
    if k_max:  # targets that reach K
        t = torch.poisson(torch.full_like(t, float(k_max)))
    classes = ([torch.stack(weights[n_base:]), torch.stack(biases[n_base:])]
               if k_max else [])
    weights, biases = weights[:n_base], biases[:n_base]
    if k_max:
        ll, lse = ops.categorised_forward(name, h, weights, biases, *classes,
                                          t, compute_dtype=compute)
        want = [ll, *ops.categorised_backward(name, g, h, weights, biases,
                                              *classes, t, lse,
                                              compute_dtype=compute)]
    else:
        want = [ops.fused_forward(name, h, weights, biases, t,
                                  compute_dtype=compute,
                                  include_lgamma_const=False),
                *ops.fused_backward(name, g, h, weights, biases, t,
                                    compute_dtype=compute)]
    rows = dh = 0
    parts = [[] for _ in range(2 * n_base + len(classes))]
    for split in (GeneSplit(0, 2), GeneSplit(1, 2)):
        hv = h.clone().requires_grad_(True)
        leaves = [split.block(a).contiguous().requires_grad_(True)
                  for w, b in zip(weights, biases) for a in (w, b)]
        cut = [split.block(c).contiguous().requires_grad_(True)
               for c in classes]
        heads = {p: {"kernel": leaves[2 * j], "bias": leaves[2 * j + 1]}
                 for j, p in enumerate(heads_of)}
        if k_max:
            out = ops.sharded_fused_categorised_log_likelihood(
                name, hv, heads, *cut, t, genes=split, compute_dtype=compute)
        else:
            out = ops.sharded_fused_log_likelihood(
                name, hv, heads, t, genes=split, compute_dtype=compute,
                include_lgamma_const=False)
        grads = torch.autograd.grad(out, [hv, *leaves, *cut],
                                    grad_outputs=g)
        rows, dh = rows + out.detach(), dh + grads[0]
        for part, grad in zip(parts, grads[1:]):
            part.append(grad)
    got = [rows, dh, *(torch.cat(part, -1) for part in parts)]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, 2e-5 if i == 0 or compute is None else 4e-4)


# --------------------------------------------------------------------------
# The per-epoch evaluation on the float32 fused forward
# --------------------------------------------------------------------------

# (likelihood, classes, genes, rows, batch): NB at the brain cell's widths
# (27,998 genes, minibatch 2,048 and its remainder of 1,800, hidden 100,
# latent 2), then every likelihood with a kernel at a smaller F
EVALUATOR_CASES = [
    ("negative binomial", 0, 27_998, 2 * 2_048 + 1_800, 2_048),
    ("poisson", 0, 2_000, 2 * 256 + 100, 256),
    ("negative binomial", 0, 2_000, 2 * 256 + 100, 256),
    ("zero-inflated poisson", 0, 2_000, 2 * 256 + 100, 256),
    ("zero-inflated negative binomial", 0, 2_000, 2 * 256 + 100, 256),
    ("constrained poisson", 0, 2_000, 2 * 256 + 100, 256),
    ("poisson", 10, 2_000, 2 * 256 + 100, 256),
]


def _evaluator_case(device, name, k_max, f, rows, seed=0):
    """A VAE of scVAE's widths (hidden [100], latent 2) with likelihood
    ``name``, its training set of ``rows`` × ``f`` counts (Poisson(3) + 1
    at density 0.07; with classes every other row Poisson(K)) staged on
    the card as ``train`` stages it, and a train state from ``seed``."""
    import numpy as np

    from scvae_tpu_torch import VariationalAutoencoder
    from scvae_tpu_torch.data.dataset import DataSet
    from scvae_tpu_torch.models import api, step

    rng = np.random.RandomState(seed)
    counts = ((rng.random_sample((rows, f)) < 0.07)
              * (rng.poisson(3.0, (rows, f)) + 1)).astype(np.float32)
    if k_max:
        counts[1::2] = rng.poisson(k_max, (len(counts[1::2]), f))
    model = VariationalAutoencoder(
        feature_size=f, latent_size=2, hidden_sizes=[100],
        reconstruction_distribution=name,
        number_of_reconstruction_classes=k_max)
    arrays = model._model_arrays(DataSet("in-memory", values=counts))
    data = api._append_lgamma_rowsum(model._stage(arrays, device),
                                     model.config)
    ts = model._init_state(torch.Generator().manual_seed(seed),
                           step.make_optimizer(1e-4), device)
    return model, data, ts


@pytest.mark.parametrize("name,k_max,f,rows,batch", EVALUATOR_CASES)
def test_fused_device_evaluator_matches_unfused(device, monkeypatch, name,
                                                k_max, f, rows, batch):
    """``_device_evaluator`` of the training set (its full batches as graph
    replays, then the remainder eagerly) on the float32 fused forward
    against the same evaluator on the unfused path, twice from the same
    generator seed: the lower bound and the reconstruction term within
    1e-6 relative, the KL within 1e-6; each call counts one
    ``eval.fused_passes``, and launches the float32 forward once a batch,
    remainder included, and no other likelihood kernel."""
    import math

    import numpy as np

    from scvae_tpu_torch import VariationalAutoencoder
    from scvae_tpu_torch.utils import tracing

    model, data, ts = _evaluator_case(device, name, k_max, f, rows)
    prefix = ("cp" if name == "constrained poisson"
              else ops.FAMILIES[name].prefix)
    prefix = f"cat_{prefix}" if k_max else prefix
    results = {}
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(VariationalAutoencoder, "_fused_evaluation",
                                lambda self, device: False)
        evaluate = model._device_evaluator(data, rows, batch, 1, 1)
        ops.reset_launch_counts()
        tracing.reset()
        tracing.enable()
        try:
            results[fused] = [
                evaluate(ts, torch.Generator(device=device).manual_seed(5))
                for _ in range(2)]
        finally:
            tracing.disable()
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items()
                    if v and k != "gather_rows"}
        passes = "eval.fused_passes" if fused else "eval.unfused_passes"
        assert tracing.counters().get(passes) == 2
        want = {f"{prefix}_forward_float32": 2 * math.ceil(rows / batch)}
        assert launches == (want if fused else {}), launches
    tracing.reset()
    for got, want in zip(results[True], results[False]):
        for key in ("lower_bound", "reconstruction_error", "kl_divergence"):
            gap = abs(got[key] - want[key]) / abs(want[key])
            assert gap <= 1e-6, (key, gap)
    first, second = results[True]
    for key in first:  # a replay of the same state and draws: the same
        assert np.array_equal(first[key], second[key]), key


@pytest.mark.parametrize("name", ["negative binomial",
                                  "zero-inflated negative binomial"])
def test_fused_evaluation_gene_blocks_match_whole(device, name):
    """The fused evaluation under a gene split of two blocks of 1,024 with
    no group (each block's row sums on the block's heads, less the whole
    row constant): the blocks' reconstruction terms and the row constant's
    mean add up to the whole-F fused evaluation's within 1e-6, and each
    block's KL is the whole one's."""
    from scvae_tpu_torch.models import step, vae
    from scvae_tpu_torch.parallel import GeneSplit

    model, data, ts = _evaluator_case(device, name, 0, 2_048, 512)
    idx = torch.arange(512, dtype=torch.int32, device=device)
    batch = step.cast_batch_to_f32(step.gather_batch(data, idx))

    def evaluate(params, genes=None):
        with torch.no_grad():
            return vae.elbo_terms(
                model.config, params, ts.model_state, batch,
                torch.Generator(device=device).manual_seed(5),
                training=False, genes=genes, fused_evaluation=True)[0]

    whole = evaluate(ts.params)
    total = torch.mean(batch["t_lgamma_rowsum"])
    for split in (GeneSplit(0, 2), GeneSplit(1, 2)):
        cut = {**ts.params, "reconstruction": {
            head: {k: split.block(v).contiguous() for k, v in leaf.items()}
            for head, leaf in ts.params["reconstruction"].items()}}
        block = evaluate(cut, split)
        assert torch.equal(block["kl_divergence"], whole["kl_divergence"])
        total = total + block["reconstruction_error"]
    gap = abs(float(total) - float(whole["reconstruction_error"]))
    assert gap <= 1e-6 * abs(float(whole["reconstruction_error"])), gap
