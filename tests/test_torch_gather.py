"""The row gather (kernel K1's plain version, which the CPU runs) against the
JAX package's gather: the Pallas kernel in interpret mode where its packed
layout applies, and its ``jnp.take`` path for an F the TPU layout cannot
pack.  Both copy and cast the same values: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu.models import step as jax_step
from scvae_tpu.ops.gather import gather_rows as jax_gather_rows
from scvae_tpu.ops.gather import pack_rows
from scvae_tpu_torch import ops
from scvae_tpu_torch.models import step
from scvae_tpu_torch.ops import gather


def _source(n, f, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return rng.poisson(3.0, size=(n, f)).astype(dtype)


def _idx(n, b, seed=1):
    return np.random.RandomState(seed).permutation(n)[:b].astype(np.int32)


def _bits(x):
    """Raw bits of a bf16/f32 array (numpy from JAX, or a torch tensor)."""
    if isinstance(x, torch.Tensor):
        width = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        return x.view(width).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_matches_jax_kernel_interpret(dtype):
    src = _source(64, 2048, dtype)
    idx = _idx(64, 32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_gather_rows(
            pack_rows(src), jnp.asarray(idx), (jnp.float32, jnp.bfloat16)
        )
    got = [ops.gather_rows(torch.from_numpy(src), torch.from_numpy(idx), dtype)
           for dtype in (torch.float32, torch.bfloat16)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("f", [300, 1000])
def test_ragged_width_matches_jax_take(f):
    """F not a multiple of 1,024: the JAX package gathers with ``jnp.take``
    and casts; the port's gather takes any F."""
    src = _source(50, f, np.int16, seed=f)
    idx = _idx(50, 16)
    want = jax_step.gather_batch({"x": jnp.asarray(src)}, jnp.asarray(idx))["x"]
    got = ops.gather_rows(torch.from_numpy(src), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    got_bf16 = ops.gather_rows(
        torch.from_numpy(src), torch.from_numpy(idx), torch.bfloat16
    )
    np.testing.assert_array_equal(
        _bits(got_bf16), _bits(np.asarray(jnp.asarray(want).astype(jnp.bfloat16)))
    )


def test_gather_batch_shares_one_gather_for_aliased_fields():
    """x and t are one device tensor: one gather when they ask for one dtype
    (the training path), one per dtype otherwise; 1-D fields use
    index_select."""
    src = torch.from_numpy(_source(40, 24, np.int16))
    rowsum = torch.arange(40, dtype=torch.float32)
    idx = torch.from_numpy(_idx(40, 8))
    expected = src.index_select(0, idx.long())
    original = ops.gather_rows
    for overrides, dtypes in (
        ({"x": torch.bfloat16, "t": torch.bfloat16}, [torch.bfloat16]),
        (None, [torch.float32]),
        ({"x": torch.bfloat16}, [torch.bfloat16, torch.float32]),
    ):
        calls = []

        def spy(*args):
            calls.append(args[2] if len(args) > 2 else torch.float32)
            return original(*args)

        ops.gather_rows = spy
        try:
            batch = step.gather_batch(
                {"x": src, "t": src, "t_lgamma_rowsum": rowsum}, idx,
                dtype_overrides=overrides,
            )
        finally:
            ops.gather_rows = original
        assert calls == dtypes
        for name in ("x", "t"):
            assert batch[name].dtype == (overrides or {}).get(name, torch.float32)
            assert torch.equal(batch[name].float(), expected.float())
        assert torch.equal(batch["t_lgamma_rowsum"], rowsum[idx.long()])


def test_cpu_wrapper_is_the_plain_version():
    src = torch.from_numpy(_source(30, 20, np.float32))
    idx = torch.from_numpy(_idx(30, 5))
    before = ops.launch_counts()["gather_rows"]
    got = ops.gather_rows(src, idx, torch.bfloat16)
    want = ops.reference_gather(src, idx, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert ops.launch_counts()["gather_rows"] == before  # no kernel launched


@pytest.mark.parametrize("b,f,aligned,path", [
    (2048, 2048, True, "vector"),    # the headline: int16 rows of 4,096 B
    (2048, 2000, True, "vector"),    # int16 rows of 4,000 B: whole units
    (1, 8, True, "vector"),
    (68579, 2048, True, "vector"),   # more units than one step of the grid
    (2048, 2048, False, "element"),  # a pointer off 16 bytes
    (2048, 1, True, "element"),      # the constrained Poisson's count sums
    (2048, 2001, True, "element"),
    (2048, 2004, True, "element"),   # int16 rows of 4,008 B
    (2049, 4100, True, "element"),
])
def test_plan_takes_the_vector_path_only_for_aligned_rows(b, f, aligned,
                                                          path):
    """K1's plan: 16-byte units in flight only for rows of whole 16-byte
    units at 16-byte aligned pointers; every other shape the element path.
    The grid covers the work in one step of every thread up to the path's
    most blocks, and no block is left without work."""
    plan = gather.gather_plan(b, f, aligned)
    assert plan["path"] == path
    if path == "vector":
        work, per_block = b * f // gather.GATHER_UNIT, (
            gather.GATHER_THREADS * gather.GATHER_UNROLL)
    else:
        work, per_block = b * f, gather.GATHER_THREADS
    most = gather.GATHER_MAX_BLOCKS[path]
    assert 1 <= plan["grid"] <= most
    assert plan["grid"] * per_block >= min(work, most * per_block)
    assert (plan["grid"] - 1) * per_block < work


def test_plan_covers_the_headline_in_one_step():
    """B = F = 2,048: 524,288 units, four a thread, 512 blocks of 256
    threads, all resident at once on the H100 (132 SMs x 8 blocks)."""
    assert gather.gather_plan(2048, 2048, True) == {"path": "vector",
                                                    "grid": 512}
    assert gather.GATHER_MAX_BLOCKS["vector"] == gather.GATHER_SMS * 8
    assert gather.gather_plan(0, 2048, True)["grid"] == 1
