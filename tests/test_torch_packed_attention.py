"""K3 (packed masked attention over precomputed q, k, v) and the edges/s
bench path: the port's plain version and wrapper on the CPU against the JAX
package; the Hopper kernel is held against the plain version on the card by
tests/test_torch_kernels_cuda.py.

* plain K3 vs the JAX Pallas kernel in interpret mode: atol 2e-5, the
  kernel's own bound against its reference (tests/test_pallas_attention.py
  :15-26), at that test's shapes and at A = 50 (10-50 human crowds), and at
  the shapes the Hopper kernel now takes: A = 300 and A = 1, head dims 256,
  96 and 320 (past 256: split into column chunks on the card), and bf16 q,
  k, v (both sides compute on their f32 casts). The
  JAX kernel returns NaN when num_heads < 128 // head dim (its heads per
  call exceed the heads), so no case here has such a shape;
* plain K3 vs the JAX XLA reference: atol 1e-5 (same math in f32, sums in
  another order);
* a row with no valid key gives 0, and no other row changes (the JAX
  einsum reference gives NaN there, the Pallas kernel spreads the row over
  its packing strip, so the JAX side is not asked);
* masked keys do not leak: their v set to 1e6 leaves the output unchanged
  to 1e-5 (tests/test_pallas_attention.py:206-218);
* on the CPU the wrapper is the plain version (bf16 in, f32 out; mixed
  dtypes raise), and it raises where autograd would need a backward (the
  JAX K3 has no VJP);
* ``ops.bench_edges`` at a tiny size on the CPU: finite, positive rates,
  keyed as the JAX package's output is.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from crowdnav_prediction_attngraph_tpu.ops import bench_edges as j_bench
from crowdnav_prediction_attngraph_tpu.ops.masked_attention import (
    packed_masked_attention as j_packed_masked_attention,
    reference_masked_attention as j_reference_masked_attention)
from crowdnav_prediction_attngraph_tpu_torch.ops import bench_edges
from crowdnav_prediction_attngraph_tpu_torch.ops.masked_attention import (
    packed_masked_attention, reference_masked_attention)
from crowdnav_prediction_attngraph_tpu_torch.utils import profiling

D, H = 512, 8
SHAPES = [(13, 20), (32, 6), (7, 32), (5, 50)]


def inputs(rows, A, seed, d=D):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(rows, A, d).astype(np.float32) for _ in range(3))
    det = rng.randint(1, A + 1, rows)
    mask = np.arange(A)[None, :] < det[:, None]
    return q, k, v, mask


def torch_args(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("rows,A", SHAPES)
def test_plain_matches_jax_kernel_interpret(rows, A):
    arrs = inputs(rows, A, seed=rows + A)
    expect = np.asarray(j_packed_masked_attention(
        *[jnp.asarray(a) for a in arrs], H, interpret=True))
    got = reference_masked_attention(*torch_args(arrs), H)
    np.testing.assert_allclose(got.numpy(), expect, atol=2e-5)


# (rows, A, D, heads, dtype): several of the JAX kernel's 32-row tiles, one
# agent, head dims 256 and 96, and bf16 inputs
WIDE = [(2, 300, 512, 8, "float32"), (3, 70, 512, 2, "float32"),
        (2, 5, 96, 1, "float32"), (4, 1, 512, 8, "float32"),
        (3, 20, 512, 8, "bfloat16")]


@pytest.mark.parametrize("rows,A,d,heads,dtype", WIDE)
def test_plain_matches_jax_kernel_interpret_wide(rows, A, d, heads, dtype):
    q, k, v, mask = inputs(rows, A, seed=rows + A + d, d=d)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    # the same values on both sides: the bf16 ones exactly, as f32 arrays
    jq, jk, jv = (jnp.asarray(t.float().numpy(), dtype=getattr(jnp, dtype))
                  for t in (tq, tk, tv))
    expect = np.asarray(j_packed_masked_attention(
        jq, jk, jv, jnp.asarray(mask), heads, interpret=True))
    got = reference_masked_attention(tq, tk, tv, torch.from_numpy(mask),
                                     heads)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expect, atol=2e-5)


# head dims past 256, which the Hopper kernel splits into column chunks
@pytest.mark.parametrize("rows,A,d,heads", [(3, 20, 1280, 4)])
def test_plain_matches_jax_kernel_interpret_split_head_dim(rows, A, d, heads):
    arrs = inputs(rows, A, seed=rows + A + d, d=d)
    expect = np.asarray(j_packed_masked_attention(
        *[jnp.asarray(a) for a in arrs], heads, interpret=True))
    got = reference_masked_attention(*torch_args(arrs), heads)
    np.testing.assert_allclose(got.numpy(), expect, atol=2e-5)


@pytest.mark.parametrize("rows,A", SHAPES)
def test_plain_matches_jax_reference(rows, A):
    arrs = inputs(rows, A, seed=rows * A)
    expect = np.asarray(j_reference_masked_attention(
        *[jnp.asarray(a) for a in arrs], H))
    got = reference_masked_attention(*torch_args(arrs), H)
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-5)


def test_all_masked_row_is_zero_and_isolated():
    q, k, v, mask = inputs(6, 20, seed=2)
    base = reference_masked_attention(*torch_args((q, k, v, mask)), H)
    mask[2] = False
    out = reference_masked_attention(*torch_args((q, k, v, mask)), H)
    assert torch.count_nonzero(out[2]) == 0
    keep = [i for i in range(6) if i != 2]
    torch.testing.assert_close(out[keep], base[keep], rtol=0, atol=0)


def test_masked_keys_do_not_leak():
    rows, A = 8, 8
    q, k, v, _ = inputs(rows, A, seed=0)
    mask = np.repeat(np.arange(A)[None, :] < 4, rows, axis=0)
    out0 = reference_masked_attention(*torch_args((q, k, v, mask)), H)
    v1 = v.copy()
    v1[:, 4:] = 1e6
    out1 = reference_masked_attention(*torch_args((q, k, v1, mask)), H)
    torch.testing.assert_close(out1, out0, rtol=0, atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version():
    args = torch_args(inputs(4, 20, seed=5))
    before = profiling.launches()
    torch.testing.assert_close(packed_masked_attention(*args, H),
                               reference_masked_attention(*args, H),
                               rtol=0, atol=0)
    assert profiling.launches() == before


def test_wrapper_takes_bf16_and_refuses_mixed_dtypes():
    q, k, v, mask = torch_args(inputs(4, 20, seed=6))
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    out = packed_masked_attention(*bf, mask, H)
    assert out.dtype == torch.float32
    torch.testing.assert_close(
        out, reference_masked_attention(*[t.float() for t in bf], mask, H),
        rtol=0, atol=0)
    # f32 inputs keep every bit of the f32 plain version
    torch.testing.assert_close(packed_masked_attention(q, k, v, mask, H),
                               reference_masked_attention(q, k, v, mask, H),
                               rtol=0, atol=0)
    for mixed in ((bf[0], k, v), (q, bf[1], v), (q, k, bf[2])):
        with pytest.raises(TypeError):
            packed_masked_attention(*mixed, mask, H)


def test_wrapper_raises_under_grad():
    q, k, v, mask = torch_args(inputs(3, 5, seed=1))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        packed_masked_attention(q, k, v, mask, H)
    with torch.no_grad():
        out = packed_masked_attention(q, k, v, mask, H)
    assert not out.requires_grad


def test_wrapper_checks_its_inputs():
    q, k, v, mask = torch_args(inputs(3, 5, seed=1))
    with pytest.raises(ValueError):
        packed_masked_attention(q, k[:2], v, mask, H)
    with pytest.raises(TypeError):
        packed_masked_attention(q, k, v, mask.int(), H)
    with pytest.raises(TypeError):
        packed_masked_attention(q.double(), k, v, mask, H)


def test_bench_edges_on_cpu_matches_jax_keys():
    shape = dict(A=5, D=64, H=2)
    got = bench_edges.single_device(rows=8, device="cpu", **shape)
    jax_res = j_bench.single_device(rows=8, **shape)
    # JAX names its kernel's rate "pallas" ("pallas_error" off the TPU)
    assert set(jax_res) - {"pallas", "pallas_error"} == {"einsum"}
    assert set(got) == {"einsum", "kernel"}
    assert all(math.isfinite(r) and r > 0 for r in got.values())

    rows_list = (8, 16)
    sweep = bench_edges.fused_sweep(rows_list=rows_list, iters=2,
                                    device="cpu", **shape)
    jax_sweep = j_bench.fused_sweep(rows_list=rows_list, strips=(1,),
                                    iters=1, **shape)
    # the TPU's strip axis becomes one kernel time per row count
    assert list(sweep) == list(jax_sweep) == list(rows_list)
    for rows in rows_list:
        assert set(jax_sweep[rows]) == {"einsum_ms", "strip1_ms"}
        assert set(sweep[rows]) == {"einsum_ms", "kernel_ms"}
        assert all(math.isfinite(t) and t > 0 for t in sweep[rows].values())
