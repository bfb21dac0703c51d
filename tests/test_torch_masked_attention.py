"""K1 (fused graph attention) and K2 (its backward): the port's plain
versions against the JAX package; the Hopper kernels are held against the
plain versions on the card by tests/test_torch_kernels_cuda.py.

* plain K1 vs the JAX XLA reference, f32: atol 1e-5 (same math, float32
  sums in another order);
* plain K1 vs the JAX Pallas kernel in interpret mode, f32: atol 3e-4, the
  kernel's own bound (tests/test_pallas_attention.py:49);
* the same at (rows, A) = (5, 50), the widest crowd of the repo's configs
  (10-50 humans), and, K1 and K2 in f32, at the shapes the card's kernels
  newly took in PR 7: (3, 80) past their single-chunk attention (A <= 64)
  and (3, 20) at D = 1024 / 8 heads (head dim 128); and at what they take
  since their limits went: A = 257, head dim 136 (D = 1088) and D = 100
  with 4 heads (head dim 25);
* plain K1 in bf16 vs the JAX Pallas kernel in bf16 (interpret mode), same
  rounding points: atol 2e-2 (bf16 has 8 mantissa bits; sums are ordered
  differently, so a rounding may land one bf16 ulp apart);
* an all-masked row outputs b_out and leaves every other row unchanged;
* plain K2 vs the JAX backward kernel ``_fused_backward`` in interpret
  mode at the shapes of tests/test_pallas_attention.py:220-246, f32: all
  five gradients to atol 5e-3 / rtol 1e-3, that test's own bound, and the
  same at (5, 50) (in bf16 too, to the bound below);
* plain K2 in bf16 vs the same kernel run in bf16 (interpret mode runs it
  on the CPU), same rounding points: max abs error <= 1e-2 x the largest
  entry of each gradient (bf16 keeps 8 significant bits, 3.9e-3 relative
  per ulp; sums in another order move a rounding by one ulp, and a dqkv or
  dS entry one ulp off feeds every product after it);
* K1 and K2 under scattered masks (the policy's ``sort_humans=False``
  hands them the env's visibility: about half the keys valid, in no prefix
  order, and rows with only column 0 valid), plain against the JAX Pallas
  kernels in interpret mode, f32 and bf16, at the bounds above;
* the autograd.Function on the CPU: its backward (plain K2) equals
  autograd through the plain K1 in f32 to 1e-5 (same math, sums in another
  order), with an all-masked row, whose dx must be exactly 0. The JAX
  kernel is not asked about all-masked rows: it spreads such a row's
  attention over its whole packing strip, other rows' tokens included
  (its callers never send one), where the port defines a zero attention
  output.

The kernels themselves run only on the card (no jax there).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from crowdnav_prediction_attngraph_tpu.ops.masked_attention import (
    _fused_backward as j_fused_backward,
    fused_graph_attention as j_fused_graph_attention,
    reference_fused_graph_attention as j_reference)
from crowdnav_prediction_attngraph_tpu_torch.ops.masked_attention import (
    fused_graph_attention, reference_fused_graph_attention,
    reference_fused_graph_attention_backward)
from crowdnav_prediction_attngraph_tpu_torch.utils import profiling

GRADS = ("dx", "dw_qkv", "db_qkv", "dw_out", "db_out")


def inputs(rows, A, D=512, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, A, D) * 0.3).astype(np.float32)
    w_qkv = (rng.randn(D, 3 * D) / np.sqrt(D)).astype(np.float32)
    b_qkv = (rng.randn(3 * D) * 0.01).astype(np.float32)
    w_out = (rng.randn(D, D) / np.sqrt(D)).astype(np.float32)
    b_out = (rng.randn(D) * 0.01).astype(np.float32)
    det = rng.randint(1, A + 1, rows)
    mask = np.arange(A)[None, :] < det[:, None]
    return x, mask, w_qkv, b_qkv, w_out, b_out


def scattered(rows, A, seed):
    """A seeded key mask with about half the keys valid in no prefix order,
    rows 0 and 1 with only column 0 valid (the policy's fallback for rows
    that see nobody)."""
    mask = np.random.RandomState(seed).rand(rows, A) < 0.5
    mask[:2] = False
    mask[~mask.any(-1), 0] = True
    prefix = np.arange(A)[None] < mask.sum(-1)[:, None]
    assert (mask != prefix).any(-1).mean() > 0.5
    return mask


def torch_args(arrs, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrs]


@pytest.mark.parametrize("rows,A", [(13, 20), (7, 32), (5, 3)])
def test_plain_matches_jax_reference_f32(rows, A):
    arrs = inputs(rows, A, seed=rows)
    expect = np.asarray(j_reference(*[jnp.asarray(a) for a in arrs], 8))
    got = reference_fused_graph_attention(*torch_args(arrs), 8)
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-5)


@pytest.mark.parametrize("dtype,jdtype,atol", [
    (torch.float32, jnp.float32, 3e-4), (torch.bfloat16, jnp.bfloat16, 2e-2)])
def test_plain_matches_jax_kernel_interpret(dtype, jdtype, atol):
    arrs = inputs(16, 20, seed=3)
    expect = np.asarray(j_fused_graph_attention(
        *[jnp.asarray(a) for a in arrs], 8, compute_dtype=jdtype,
        interpret=True))
    got = fused_graph_attention(*torch_args(arrs), 8, compute_dtype=dtype)
    np.testing.assert_allclose(got.numpy(), expect, atol=atol)


@pytest.mark.parametrize("dtype,jdtype,atol", [
    (torch.float32, jnp.float32, 3e-4), (torch.bfloat16, jnp.bfloat16, 2e-2)])
def test_plain_matches_jax_kernel_interpret_scattered_mask(dtype, jdtype,
                                                           atol):
    arrs = list(inputs(16, 20, seed=4))
    arrs[1] = scattered(16, 20, seed=4)
    expect = np.asarray(j_fused_graph_attention(
        *[jnp.asarray(a) for a in arrs], 8, compute_dtype=jdtype,
        interpret=True))
    got = fused_graph_attention(*torch_args(arrs), 8, compute_dtype=dtype)
    np.testing.assert_allclose(got.numpy(), expect, atol=atol)


def test_plain_matches_jax_kernel_interpret_a50():
    arrs = inputs(5, 50, seed=50)
    expect = np.asarray(j_fused_graph_attention(
        *[jnp.asarray(a) for a in arrs], 8, compute_dtype=jnp.float32,
        interpret=True))
    got = fused_graph_attention(*torch_args(arrs), 8,
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), expect, atol=3e-4)


@pytest.mark.parametrize("rows,A,D", [(3, 80, 512), (3, 20, 1024)])
def test_plain_matches_jax_kernel_interpret_wide(rows, A, D):
    """The shapes the card's kernels newly take: A past 64, and head dim
    128 at D > 512."""
    arrs = inputs(rows, A, D, seed=A + D)
    expect = np.asarray(j_fused_graph_attention(
        *[jnp.asarray(a) for a in arrs], 8, compute_dtype=jnp.float32,
        interpret=True))
    got = fused_graph_attention(*torch_args(arrs), 8,
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), expect, atol=3e-4)


# (rows, A, D, heads): the shapes the card's kernels take since their
# limits went (the tiled attention past A = 256, head dim 136 past 128 with
# a ragged column chunk, and head dim 25 at D = 100, whose rows are not a
# multiple of 16 bytes in bf16)
ANY_SHAPE = [(2, 257, 512, 8), (3, 20, 1088, 8), (3, 20, 100, 4)]


@pytest.mark.parametrize("rows,A,D,heads", ANY_SHAPE)
def test_plain_matches_jax_kernel_interpret_any_shape(rows, A, D, heads):
    arrs = inputs(rows, A, D, seed=A + D)
    expect = np.asarray(j_fused_graph_attention(
        *[jnp.asarray(a) for a in arrs], heads, compute_dtype=jnp.float32,
        interpret=True))
    got = fused_graph_attention(*torch_args(arrs), heads,
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), expect, atol=3e-4)


def test_wrapper_on_cpu_is_the_plain_version():
    args = torch_args(inputs(4, 20, seed=5))
    before = profiling.launches()
    for dtype in (torch.float32, torch.bfloat16):
        torch.testing.assert_close(
            fused_graph_attention(*args, 8, compute_dtype=dtype),
            reference_fused_graph_attention(*args, 8, compute_dtype=dtype),
            rtol=0, atol=0)
    assert profiling.launches() == before


def isolation(fn, device, dtype):
    x, mask, w_qkv, b_qkv, w_out, b_out = inputs(8, 20, seed=1)
    mask[3] = False                        # one all-masked row
    args = torch_args((x, mask, w_qkv, b_qkv, w_out, b_out), device)
    out0 = fn(*args, 8, compute_dtype=dtype)
    # the all-masked row's attention output is zero: its result is b_out
    torch.testing.assert_close(out0[3], args[5].expand(20, -1), rtol=0, atol=0)
    assert torch.isfinite(out0).all()
    # perturb the masked row's inputs: no other row may change
    x1 = x.copy()
    x1[3] = 1e4
    args[0] = torch.from_numpy(x1).to(device)
    out1 = fn(*args, 8, compute_dtype=dtype)
    keep = [i for i in range(8) if i != 3]
    torch.testing.assert_close(out1[keep], out0[keep], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_masked_row_isolation_plain(dtype):
    isolation(reference_fused_graph_attention, "cpu", dtype)


def cotangent(rows, A, D=512, seed=0):
    return np.random.RandomState(seed + 100).randn(rows, A, D).astype(
        np.float32)


@pytest.mark.parametrize("rows,A,r_blk", [(13, 20, None), (33, 20, 16),
                                          (5, 50, None)])
@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, "f32"),
                                          (torch.bfloat16, "bf16")])
def test_plain_backward_matches_jax_kernel_interpret(rows, A, r_blk, dtype,
                                                     jdtype):
    x, mask, w_qkv, b_qkv, w_out, b_out = inputs(rows, A, seed=rows)
    g = cotangent(rows, A, seed=rows)
    expect = j_fused_backward(
        *[jnp.asarray(a) for a in (x, mask, w_qkv, b_qkv, w_out, b_out, g)],
        8, r_blk, jdtype, None, True)
    got = reference_fused_graph_attention_backward(
        *torch_args((x, mask, w_qkv, b_qkv, w_out, g)), 8, dtype)
    for name, t, e in zip(GRADS, got, expect):
        e = np.asarray(e)
        if dtype == torch.float32:
            np.testing.assert_allclose(t.numpy(), e, atol=5e-3, rtol=1e-3,
                                       err_msg=name)
        else:
            assert np.abs(t.numpy() - e).max() <= 1e-2 * np.abs(e).max(), name


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, "f32"),
                                          (torch.bfloat16, "bf16")])
def test_plain_backward_matches_jax_kernel_interpret_scattered_mask(dtype,
                                                                    jdtype):
    x, _, w_qkv, b_qkv, w_out, b_out = inputs(16, 20, seed=5)
    mask = scattered(16, 20, seed=5)
    g = cotangent(16, 20, seed=5)
    expect = j_fused_backward(
        *[jnp.asarray(a) for a in (x, mask, w_qkv, b_qkv, w_out, b_out, g)],
        8, None, jdtype, None, True)
    got = reference_fused_graph_attention_backward(
        *torch_args((x, mask, w_qkv, b_qkv, w_out, g)), 8, dtype)
    for name, t, e in zip(GRADS, got, expect):
        e = np.asarray(e)
        if dtype == torch.float32:
            np.testing.assert_allclose(t.numpy(), e, atol=5e-3, rtol=1e-3,
                                       err_msg=name)
        else:
            assert np.abs(t.numpy() - e).max() <= 1e-2 * np.abs(e).max(), name


@pytest.mark.parametrize("rows,A,D", [(3, 80, 512), (3, 20, 1024)])
def test_plain_backward_matches_jax_kernel_interpret_wide(rows, A, D):
    """K2's plain version at the shapes the card's kernels newly take, f32,
    at the file's backward bound."""
    x, mask, w_qkv, b_qkv, w_out, b_out = inputs(rows, A, D, seed=A + D)
    g = cotangent(rows, A, D, seed=A + D)
    expect = j_fused_backward(
        *[jnp.asarray(a) for a in (x, mask, w_qkv, b_qkv, w_out, b_out, g)],
        8, None, "f32", None, True)
    got = reference_fused_graph_attention_backward(
        *torch_args((x, mask, w_qkv, b_qkv, w_out, g)), 8, torch.float32)
    for name, t, e in zip(GRADS, got, expect):
        np.testing.assert_allclose(t.numpy(), np.asarray(e), atol=5e-3,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("rows,A,D,heads", ANY_SHAPE)
def test_plain_backward_matches_jax_kernel_interpret_any_shape(rows, A, D,
                                                               heads):
    """K2's plain version at the shapes of ANY_SHAPE, f32, at the file's
    backward bound."""
    x, mask, w_qkv, b_qkv, w_out, b_out = inputs(rows, A, D, seed=A + D)
    g = cotangent(rows, A, D, seed=A + D)
    expect = j_fused_backward(
        *[jnp.asarray(a) for a in (x, mask, w_qkv, b_qkv, w_out, b_out, g)],
        heads, None, "f32", None, True)
    got = reference_fused_graph_attention_backward(
        *torch_args((x, mask, w_qkv, b_qkv, w_out, g)), heads, torch.float32)
    for name, t, e in zip(GRADS, got, expect):
        np.testing.assert_allclose(t.numpy(), np.asarray(e), atol=5e-3,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_backward_is_plain_k2_and_autograd_f32(dtype):
    x, mask, w_qkv, b_qkv, w_out, b_out = inputs(8, 20, seed=4)
    mask[3] = False                        # one all-masked row
    args = torch_args((x, mask, w_qkv, b_qkv, w_out, b_out))
    g = torch.from_numpy(cotangent(8, 20, seed=4))
    leaves = [args[i].clone().requires_grad_(True) for i in (0, 2, 3, 4, 5)]
    before = profiling.launches()
    out = fused_graph_attention(leaves[0], args[1], *leaves[1:], 8,
                                compute_dtype=dtype)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, g)
    assert profiling.launches() == before
    plain = reference_fused_graph_attention_backward(
        *args[:5], g, 8, dtype)
    for name, t, e in zip(GRADS, got, plain):
        torch.testing.assert_close(t, e, rtol=0, atol=0, msg=name)
    assert torch.count_nonzero(got[0][3]) == 0
    assert torch.isfinite(torch.cat([t.flatten() for t in got])).all()
    if dtype == torch.float32:
        ref_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
        ref_out = reference_fused_graph_attention(
            ref_leaves[0], args[1], *ref_leaves[1:], 8)
        ref = torch.autograd.grad(ref_out, ref_leaves, g)
        for name, t, e in zip(GRADS, got, ref):
            torch.testing.assert_close(t, e, rtol=1e-5, atol=1e-5, msg=name)
