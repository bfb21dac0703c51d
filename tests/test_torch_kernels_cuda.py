"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where torch.cuda.is_available()
is False. This file imports no jax (the card's machine has none); run it
there with

  python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

K1 tolerances: f32 atol 3e-4 (the JAX kernel's own bound,
tests/test_pallas_attention.py:49); bf16 atol 3e-2 at unit-scale inputs
(both versions round at the same points, sums are ordered differently, so a
value may land one bf16 rounding apart); the all-masked row is exact.

K2 tolerances: f32 atol 5e-3 / rtol 1e-3 (the JAX backward kernel's bound,
tests/test_pallas_attention.py:245-246); bf16 max abs error <= 1e-2 x the
largest entry of each gradient (tests/test_torch_masked_attention.py says
why); an all-masked row's dx is exactly 0. Two runs give the same bits:
the weight gradients are reduced in a fixed order, without atomics.

K1 and K2 are held at A = 50, 64, 80 (past the single-chunk attention)
and 256, at D = 1024 / 8 heads (head dim 128, D > 512), and at head dims
65 and 48 (bf16 attention on CUDA cores and on the tensor cores off the
paths' head dim); and, since their limits went, at A = 257 and 300 (the
tiled attention), head dims 136 and 256 (column chunks of 128), and D = 100
with 4 heads and D = 99 with 3 heads (rows that are not a multiple of 16
bytes: the products' element loads). They take every shape the JAX kernels
take; a non-contiguous input gives the contiguous one's bits. K1,
like K2, gives the same bits on two runs: every sum runs in a fixed order,
without atomics.

K1 and K2 are also held under scattered masks (the policy's
``sort_humans=False`` masks: about half the keys valid in no prefix order,
a row with only column 0 valid) at the paths' shapes (64 and 960 rows x A
= 20, and 32 x 10), at A = 80 and 257 (the tiled attention, where whole
key chunks can be masked), to the same tolerances, with two runs giving
the same bits.

K3 tolerance: atol 2e-5 (the JAX kernel's own bound against its reference,
tests/test_pallas_attention.py:15-26), for f32 and for bf16 q, k, v (read as
bf16, computed in f32, as the plain version computes on their f32 casts); an
all-masked row is exactly 0 and leaves the other rows' bits alone, also in
a row whose first key tiles (keys 0-63, more than three tiles of 20) are all
masked; masked keys' v at 1e6 changes no bit (they are skipped); two runs
give the same bits. K3 is held at A = 1 to 300 (several key tiles, an online
softmax), at head dims 48, 65 (the plain-load path, in f32 and bf16), 12
(bf16 plain loads), 128 and 256, and past 256, where it splits the head
into column chunks of 256: 257 (plain loads), 320 (f32 and bf16) and 512,
also over several key tiles and with an all-masked row.

The ORCA solve (``env/orca.py``'s ``orca_velocity_batch``, one launch of
``csrc/orca_solve.cu``) is held to its plain version on the card bit for
bit (``torch.equal``), in float32 and float64: at the paths' shapes (1,280
egos x 21 lines and 12,800 x 51 for the humans of the flagship and config
5, 64 x 120 and 500 x 300 for the scripted ORCA robot's truth rollout) in
crowds where a fifth to a quarter of the egos fail LP2 and run LP3, and in
degenerate scenes (coincident agents, every neighbour masked or out of
neighbor_dist, N = 1, parallel and antiparallel lines). Two runs give the
same bits; the launch tally's ``orca`` rises by one a call; a call makes no host sync
(``torch.cuda.set_sync_debug_mode("error")``), with the spans off and on;
``orca.lp3_egos`` equals the number of egos whose plain LP2 failed.

The spawn passes (``env/spawn.py``'s ``batched_circle_spawn`` and
``batched_goal_resample``, one launch each of ``csrc/human_spawn.cu``) are
held to their plain versions bit for bit at A = 5, 20, 50 and 300 slots
and B = 1, 64 and 256 envs, with no slot, every active slot or a random
third in need (``utils/spawn_scenes``); with the placed slots of a
respawn, a reset and a human count change; with the unicycle's robot
distance; with standing humans (v_pref 0) in the goal resample; and where
every round is rejected, so the fallback proposal is kept. The launch
tally's ``spawn`` rises by one a call and ``spawn.slots`` counts the slots in need. A whole
``vec_step`` with auto-reset, for the flagship's and config 5's
configurations, gives the same bits as the benchmark's frozen plain copy
(``benchmark/reference/crowd_sim.py``, only read here) over 40 steps from
the same state and generators; and a train-phase env step, its events
firing, makes no host sync (``torch.cuda.set_sync_debug_mode("error")``).
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import frozen_reference
from frozen_reference import BENCH, assert_same_tree, copy_tree

from crowdnav_prediction_attngraph_tpu_torch.config import (
    config_from_snapshot)
from crowdnav_prediction_attngraph_tpu_torch.env import (
    crowd_sim, spawn, vector)
from crowdnav_prediction_attngraph_tpu_torch.env.orca import (
    orca_velocity_batch)
from crowdnav_prediction_attngraph_tpu_torch.ops.masked_attention import (
    fused_graph_attention, fused_graph_attention_backward,
    packed_masked_attention, reference_fused_graph_attention,
    reference_fused_graph_attention_backward, reference_masked_attention)
from crowdnav_prediction_attngraph_tpu_torch.utils import profiling
from crowdnav_prediction_attngraph_tpu_torch.utils.orca_oracle import (
    SCENE_SHAPES, SCENE_TIME_HORIZON, SCENE_TIME_STEP, lp2_failures,
    plain_solve, scene_tensors)
from crowdnav_prediction_attngraph_tpu_torch.utils.spawn_scenes import (
    NEEDS, PLACED, circle_spawn_args, goal_resample_args)

A, D, HEADS = 20, 512, 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def k1_inputs(rows, a, seed, device, d=D):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, a, d, generator=g)
    w_qkv = torch.randn(d, 3 * d, generator=g) / math.sqrt(d)
    b_qkv = torch.randn(3 * d, generator=g) * 0.01
    w_out = torch.randn(d, d, generator=g) / math.sqrt(d)
    b_out = torch.randn(d, generator=g) * 0.01
    det = torch.randint(1, a + 1, (rows,), generator=g)
    mask = torch.arange(a)[None, :] < det[:, None]
    return [t.to(device) for t in (x, mask, w_qkv, b_qkv, w_out, b_out)]


# (rows, A, D): the paths' shapes, the A <= 64 single-chunk attention, A
# past it (3, 80) and at the limit (2, 256), head dim 128 at D = 1024, and
# head dims 65 (CUDA-core attention in bf16 too, a ragged float4 row) and 48
SHAPES = [(100, 20, D), (64, 20, D), (32, 20, D), (7, 32, D), (3, 5, D),
          (7, 50, D), (3, 64, D), (3, 80, D), (2, 256, D), (3, 20, 1024),
          (3, 20, 520), (5, 33, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,a,d", SHAPES)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 3e-4),
                                        (torch.bfloat16, 3e-2)])
def test_k1_matches_plain(cuda_device, rows, a, d, dtype, atol):
    args = k1_inputs(rows, a, rows + a, cuda_device, d)
    before = profiling.launches()["k1"]
    got = fused_graph_attention(*args, HEADS, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert profiling.launches()["k1"] == before + 1
    expect = reference_fused_graph_attention(*args, HEADS, compute_dtype=dtype)
    torch.testing.assert_close(got, expect, rtol=0, atol=atol)
    again = fused_graph_attention(*args, HEADS, compute_dtype=dtype)
    assert torch.equal(got, again)


# (rows, A, D, heads): what the kernels take since their limits went
ANY_SHAPES = [(2, 257, D, HEADS), (2, 300, 256, 4), (3, 20, 1088, HEADS),
              (3, 20, 1024, 4), (4, 70, 1088, HEADS), (3, 20, 100, 4),
              (3, 20, 99, 3), (2, 257, 100, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,a,d,heads", ANY_SHAPES)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 3e-4),
                                        (torch.bfloat16, 3e-2)])
def test_k1_matches_plain_any_shape(cuda_device, rows, a, d, heads, dtype,
                                    atol):
    args = k1_inputs(rows, a, rows + a + d, cuda_device, d)
    before = profiling.launches()["k1"]
    got = fused_graph_attention(*args, heads, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert profiling.launches()["k1"] == before + 1
    expect = reference_fused_graph_attention(*args, heads, compute_dtype=dtype)
    torch.testing.assert_close(got, expect, rtol=0, atol=atol)
    assert torch.equal(got, fused_graph_attention(*args, heads,
                                                  compute_dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("a", [A, 80, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_all_masked_row_isolation(cuda_device, dtype, a):
    args = k1_inputs(8, a, 1, cuda_device)
    args[1][3] = False
    out0 = fused_graph_attention(*args, HEADS, compute_dtype=dtype)
    torch.testing.assert_close(out0[3], args[5].expand(a, D), rtol=0, atol=0)
    x1 = args[0].clone()
    x1[3] = 1e4
    out1 = fused_graph_attention(x1, *args[1:], HEADS, compute_dtype=dtype)
    keep = torch.arange(8, device=cuda_device) != 3
    torch.testing.assert_close(out1[keep], out0[keep], rtol=0, atol=0)


@pytest.mark.cuda
def test_k1_rejects_what_it_does_not_take(cuda_device):
    """A = 257 and head dim 136, refused before the limits went, now hold
    their result; a non-contiguous x, refused before the launches had one
    seam, gives the contiguous x's bits."""
    for a, d in ((257, D), (A, 1088)):
        args = k1_inputs(2, a, 0, cuda_device, d)
        torch.testing.assert_close(
            fused_graph_attention(*args, HEADS),
            reference_fused_graph_attention(*args, HEADS,
                                            compute_dtype=torch.bfloat16),
            rtol=0, atol=3e-2)
    args = k1_inputs(2, A, 0, cuda_device)
    assert torch.equal(
        fused_graph_attention(args[0].transpose(0, 1).contiguous()
                              .transpose(0, 1), *args[1:], HEADS),
        fused_graph_attention(*args, HEADS))


def scattered_mask(rows, a, seed, device):
    """About half the keys valid in no prefix order; row 0 with only column
    0 valid; rows 1 and 2 with their first 64 keys masked (whole key chunks
    of the tiled attention past A = 64)."""
    mask = torch.rand(rows, a, generator=torch.Generator().manual_seed(
        seed)) < 0.5
    mask[0] = False
    if a > 64:
        mask[1:3, :64] = False
    mask[~mask.any(-1), 0] = True
    return mask.to(device)


SCATTERED = [(64, 20), (960, 20), (32, 10), (3, 80), (2, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,a", SCATTERED)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 3e-4),
                                        (torch.bfloat16, 3e-2)])
def test_k1_matches_plain_scattered_mask(cuda_device, rows, a, dtype, atol):
    args = k1_inputs(rows, a, rows + a + 1, cuda_device)
    args[1] = scattered_mask(rows, a, rows + a, cuda_device)
    got = fused_graph_attention(*args, HEADS, compute_dtype=dtype)
    torch.cuda.synchronize()
    expect = reference_fused_graph_attention(*args, HEADS, compute_dtype=dtype)
    torch.testing.assert_close(got, expect, rtol=0, atol=atol)
    assert torch.equal(got, fused_graph_attention(*args, HEADS,
                                                  compute_dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,a", SCATTERED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain_scattered_mask(cuda_device, rows, a, dtype):
    x, _, w_qkv, b_qkv, w_out, _ = k1_inputs(rows, a, rows + a + 2,
                                             cuda_device)
    mask = scattered_mask(rows, a, rows + a + 3, cuda_device)
    g = torch.randn(rows, a, D, generator=torch.Generator().manual_seed(
        rows + a)).to(cuda_device)
    args = (x, mask, w_qkv, b_qkv, w_out, g)
    got = fused_graph_attention_backward(*args, HEADS, compute_dtype=dtype)
    torch.cuda.synchronize()
    expect = reference_fused_graph_attention_backward(*args, HEADS,
                                                      compute_dtype=dtype)
    assert_k2_close(got, expect, dtype)
    again = fused_graph_attention_backward(*args, HEADS, compute_dtype=dtype)
    for t, u in zip(got, again):
        assert torch.equal(t, u)


def k2_inputs(rows, a, seed, device, d=D):
    """K1's inputs with row 1 all-masked, and a cotangent g."""
    x, mask, w_qkv, b_qkv, w_out, _ = k1_inputs(rows, a, seed, device, d)
    mask[min(1, rows - 1)] = False
    g = torch.randn(rows, a, d, generator=torch.Generator().manual_seed(
        seed + 1)).to(device)
    return [x, mask, w_qkv, b_qkv, w_out, g]


def assert_k2_close(got, expect, dtype):
    for name, t, e in zip(("dx", "dw_qkv", "db_qkv", "dw_out", "db_out"),
                          got, expect):
        if dtype == torch.float32:
            torch.testing.assert_close(t, e, rtol=1e-3, atol=5e-3, msg=name)
        else:
            err = (t - e).abs().max().item()
            assert err <= 1e-2 * e.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,a,d", [(100, 20, D), (7, 32, D), (3, 5, D),
                                      (7, 50, D), (3, 64, D), (3, 80, D),
                                      (2, 256, D), (3, 20, 1024), (3, 20, 520),
                                      (5, 33, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain(cuda_device, rows, a, d, dtype):
    args = k2_inputs(rows, a, rows + a, cuda_device, d)
    before = profiling.launches()["k2"]
    got = fused_graph_attention_backward(*args, HEADS, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert profiling.launches()["k2"] == before + 1
    expect = reference_fused_graph_attention_backward(*args, HEADS,
                                                      compute_dtype=dtype)
    assert_k2_close(got, expect, dtype)
    assert torch.count_nonzero(got[0][1]) == 0
    again = fused_graph_attention_backward(*args, HEADS, compute_dtype=dtype)
    for t, u in zip(got, again):
        assert torch.equal(t, u)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,a,d,heads", ANY_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain_any_shape(cuda_device, rows, a, d, heads, dtype):
    args = k2_inputs(rows, a, rows + a + d, cuda_device, d)
    before = profiling.launches()["k2"]
    got = fused_graph_attention_backward(*args, heads, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert profiling.launches()["k2"] == before + 1
    expect = reference_fused_graph_attention_backward(*args, heads,
                                                      compute_dtype=dtype)
    assert_k2_close(got, expect, dtype)
    assert torch.count_nonzero(got[0][1]) == 0
    again = fused_graph_attention_backward(*args, heads, compute_dtype=dtype)
    for t, u in zip(got, again):
        assert torch.equal(t, u)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_launches_k1_and_k2(cuda_device, dtype):
    x, mask, w_qkv, b_qkv, w_out, b_out = k1_inputs(40, A, 9, cuda_device)
    leaves = [t.clone().requires_grad_(True)
              for t in (x, w_qkv, b_qkv, w_out, b_out)]
    before = profiling.launches()
    out = fused_graph_attention(leaves[0], mask, *leaves[1:], HEADS,
                                compute_dtype=dtype)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert profiling.launches() == {**before, "k1": before["k1"] + 1,
                                    "k2": before["k2"] + 1}
    expect = reference_fused_graph_attention_backward(
        x, mask, w_qkv, b_qkv, w_out, g, HEADS, compute_dtype=dtype)
    assert_k2_close(got, expect, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w_out_as_a_linear_weight_view(cuda_device, dtype):
    """The policy passes nn.Linear's (out, in) weight as its ``.t()`` view:
    K1 and K2 give the same bits as with a contiguous (in, out) copy."""
    x, mask, w_qkv, b_qkv, w_out, b_out = k1_inputs(16, A, 5, cuda_device)
    view = w_out.t().contiguous().t()
    assert not view.is_contiguous()
    assert torch.equal(
        fused_graph_attention(x, mask, w_qkv, b_qkv, view, b_out, HEADS,
                              compute_dtype=dtype),
        fused_graph_attention(x, mask, w_qkv, b_qkv, w_out, b_out, HEADS,
                              compute_dtype=dtype))
    g = torch.randn_like(x)
    for t, u in zip(
            fused_graph_attention_backward(x, mask, w_qkv, b_qkv, view, g,
                                           HEADS, compute_dtype=dtype),
            fused_graph_attention_backward(x, mask, w_qkv, b_qkv, w_out, g,
                                           HEADS, compute_dtype=dtype)):
        assert torch.equal(t, u)


@pytest.mark.cuda
def test_k2_rejects_what_it_does_not_take(cuda_device):
    """A = 257 and head dim 136, refused before the limits went, now hold
    their result; a non-contiguous g, refused before the launches had one
    seam, gives the contiguous g's bits."""
    for a, d in ((257, D), (A, 1088)):
        args = k2_inputs(2, a, 0, cuda_device, d)
        assert_k2_close(
            fused_graph_attention_backward(*args, HEADS),
            reference_fused_graph_attention_backward(
                *args, HEADS, compute_dtype=torch.bfloat16), torch.bfloat16)
    args = k2_inputs(2, A, 0, cuda_device)
    for t, u in zip(
            fused_graph_attention_backward(*args[:5], args[5].transpose(0, 1)
                                           .contiguous().transpose(0, 1),
                                           HEADS),
            fused_graph_attention_backward(*args, HEADS)):
        assert torch.equal(t, u)


def k3_inputs(rows, a, seed, device, d=D, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(rows, a, d, generator=g).to(dtype)
               for _ in range(3))
    det = torch.randint(1, a + 1, (rows,), generator=g)
    mask = torch.arange(a)[None, :] < det[:, None]
    return [t.to(device) for t in (q, k, v, mask)]


# (rows, A, D, heads, dtype): the bench's A and the old limits, A = 1, past
# one key tile (65, 80), several tiles (256, 300), head dims 48, 65 (not a
# multiple of 4: the plain-load path), 128 and 256, and bf16 inputs, by
# 16-byte copies (head dim 64) and by plain loads (head dims 65 and 12)
K3_CASES = [(100, 20, D, HEADS, torch.float32), (7, 64, D, HEADS, torch.float32),
            (3, 5, D, HEADS, torch.float32), (9, 1, D, HEADS, torch.float32),
            (5, 65, D, HEADS, torch.float32), (7, 80, D, HEADS, torch.float32),
            (3, 256, D, HEADS, torch.float32),
            (2, 300, D, HEADS, torch.float32),
            (5, 33, 384, HEADS, torch.float32),
            (3, 20, 520, HEADS, torch.float32), (4, 20, D, 4, torch.float32),
            (3, 70, D, 2, torch.float32), (100, 20, D, HEADS, torch.bfloat16),
            (7, 80, D, HEADS, torch.bfloat16), (3, 20, 520, HEADS, torch.bfloat16),
            (3, 20, 96, HEADS, torch.bfloat16),
            # head dims past 256, split into column chunks of 256: 320, 512,
            # 257 (plain loads), bf16 320, several key tiles
            (4, 20, 1280, 4, torch.float32), (3, 20, 2048, 4, torch.float32),
            (2, 20, 514, 2, torch.float32), (4, 20, 1280, 4, torch.bfloat16),
            (3, 70, 1280, 4, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,a,d,heads,dtype", K3_CASES)
def test_k3_matches_plain(cuda_device, rows, a, d, heads, dtype):
    args = k3_inputs(rows, a, rows + a, cuda_device, d, dtype)
    before = profiling.launches()["k3"]
    got = packed_masked_attention(*args, heads)
    torch.cuda.synchronize()
    assert profiling.launches()["k3"] == before + 1
    assert got.dtype == torch.float32
    expect = reference_masked_attention(*args, heads)
    torch.testing.assert_close(got, expect, rtol=0, atol=2e-5)
    assert torch.equal(got, packed_masked_attention(*args, heads))


@pytest.mark.cuda
@pytest.mark.parametrize("a", [A, 80])
def test_k3_all_masked_row_and_masked_keys(cuda_device, a):
    q, k, v, mask = k3_inputs(8, a, 3, cuda_device)
    if a > 64:
        # a row whose first key tiles (keys 0-63, more than three tiles of
        # 20) are all masked
        mask[5] = torch.arange(a, device=cuda_device) >= 64
    out0 = packed_masked_attention(q, k, v, mask, HEADS)
    torch.testing.assert_close(out0, reference_masked_attention(
        q, k, v, mask, HEADS), rtol=0, atol=2e-5)
    mask1 = mask.clone()
    mask1[3] = False
    out1 = packed_masked_attention(q, k, v, mask1, HEADS)
    assert torch.count_nonzero(out1[3]) == 0
    keep = torch.arange(8, device=cuda_device) != 3
    assert torch.equal(out1[keep], out0[keep])
    v1 = torch.where(mask[..., None], v, torch.full_like(v, 1e6))
    assert torch.equal(packed_masked_attention(q, k, v1, mask, HEADS), out0)


@pytest.mark.cuda
@pytest.mark.parametrize("a", [A, 80])
def test_k3_split_head_dim_masked_rows_and_keys(cuda_device, a):
    """Head dim 320 (two column chunks): an all-masked row is 0 and leaves
    the other rows' bits alone; masked keys' v at 1e6 changes no bit."""
    q, k, v, mask = k3_inputs(6, a, 11, cuda_device, 1280)
    out0 = packed_masked_attention(q, k, v, mask, 4)
    torch.testing.assert_close(out0, reference_masked_attention(
        q, k, v, mask, 4), rtol=0, atol=2e-5)
    mask1 = mask.clone()
    mask1[2] = False
    out1 = packed_masked_attention(q, k, v, mask1, 4)
    assert torch.count_nonzero(out1[2]) == 0
    keep = torch.arange(6, device=cuda_device) != 2
    assert torch.equal(out1[keep], out0[keep])
    v1 = torch.where(mask[..., None], v, torch.full_like(v, 1e6))
    assert torch.equal(packed_masked_attention(q, k, v1, mask, 4), out0)


@pytest.mark.cuda
def test_k3_rejects_what_it_does_not_take(cuda_device):
    """Head dim 257, refused before the split, now holds its result; a
    non-contiguous q, refused before the launches had one seam, gives the
    contiguous q's bits; grad mode is still refused."""
    q, k, v, mask = k3_inputs(2, A, 0, cuda_device, 514)
    torch.testing.assert_close(packed_masked_attention(q, k, v, mask, 2),
                               reference_masked_attention(q, k, v, mask, 2),
                               rtol=0, atol=2e-5)
    q, k, v, mask = k3_inputs(2, A, 0, cuda_device)
    assert torch.equal(
        packed_masked_attention(q.transpose(0, 1).contiguous()
                                .transpose(0, 1), k, v, mask, HEADS),
        packed_masked_attention(q, k, v, mask, HEADS))
    with pytest.raises(RuntimeError):
        packed_masked_attention(q.requires_grad_(True), k, v, mask, HEADS)


@pytest.mark.cuda
def test_gst_collect_and_train_step_on_the_card(cuda_device):
    """The GST training stack on the card (no kernel of its own): a collect
    reset and steps give finite records, and one trainer step at full width
    on a batch of collected windows gives a finite loss that agrees with
    the CPU's at 1e-4 relative (f32, no TF32)."""
    from crowdnav_prediction_attngraph_tpu_torch.collect_data import (
        collect_dataset)
    from crowdnav_prediction_attngraph_tpu_torch.config import (
        PredConfig, varnum_config)
    from crowdnav_prediction_attngraph_tpu_torch.models.gst import (
        dataset, trainer)
    from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import (
        load_gst)
    from crowdnav_prediction_attngraph_tpu_torch.models.gst.st_model import (
        init_gst)
    from crowdnav_prediction_attngraph_tpu_torch.utils.params import (
        state_dict_to_tree)

    rows = collect_dataset(varnum_config(human_num=20), 4, 64, seed=0,
                           device=cuda_device)
    assert all(len(r) and np.isfinite(r).all() for r in rows)
    windows = [w for r in rows for w in dataset.build_windows(r, 5, 5, 32)]
    batch = trainer.stack_windows(windows[:64])
    pc = PredConfig()
    tree = state_dict_to_tree(init_gst(pc, torch.Generator().manual_seed(0),
                                       "cpu").state_dict())
    losses = []
    for dev in (cuda_device, torch.device("cpu")):
        model = load_gst(pc, tree, dev).train()
        opt = trainer.make_optimizer(model, 1e-3)
        loss, aux = trainer.train_step(model, opt, 1e-3,
                                       trainer.to_device(batch, dev), 0.5,
                                       None, False, None)
        assert torch.isfinite(aux).all()
        assert all(torch.isfinite(p).all() for p in model.parameters())
        losses.append(loss.item())
    assert math.isfinite(losses[0])
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])


# ------------------------------------------------------------------- ORCA

def orca_kernel(args):
    return orca_velocity_batch(*args[:9], SCENE_TIME_STEP, SCENE_TIME_HORIZON,
                               args[9])


@pytest.mark.cuda
@pytest.mark.parametrize("egos,n", SCENE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_orca_matches_plain_bitwise(cuda_device, egos, n, dtype):
    args = scene_tensors(egos, n, 7, cuda_device, dtype)
    failed = lp2_failures(args)
    assert 0.15 * egos <= failed <= 0.4 * egos
    profiling.enable()
    profiling.reset()
    try:
        got = orca_kernel(args)
        counted = profiling.snapshot()["counters"]["orca.lp3_egos"]
    finally:
        profiling.disable()
        profiling.reset()
    assert counted == failed
    assert torch.equal(got, plain_solve(args))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["coincident", "masked", "far", "parallel"])
@pytest.mark.parametrize("n", [1, 21])
def test_orca_matches_plain_degenerate(cuda_device, kind, n):
    args = scene_tensors(256, n, 3, cuda_device, kind=kind)
    got = orca_kernel(args)
    assert torch.isfinite(got).all()
    assert torch.equal(got, plain_solve(args))


@pytest.mark.cuda
def test_orca_repeats_its_bits_and_counts_launches(cuda_device):
    args = scene_tensors(1280, 21, 11, cuda_device)
    before = profiling.launches()["orca"]
    first, second = orca_kernel(args), orca_kernel(args)
    assert profiling.launches()["orca"] == before + 2
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("spans", [False, True], ids=["off", "on"])
def test_orca_makes_no_host_sync(cuda_device, spans):
    args = scene_tensors(12800, 51, 5, cuda_device)
    orca_kernel(args)           # builds and loads the library
    torch.cuda.synchronize()
    if spans:
        profiling.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = orca_kernel(args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        profiling.disable()
        profiling.reset()
    assert out.shape == (12800, 2)


@pytest.mark.cuda
def test_orca_rejects_what_it_does_not_take(cuda_device):
    args = scene_tensors(8, 5, 0, cuda_device)
    mixed = list(args)
    mixed[2] = mixed[2].double()
    with pytest.raises(TypeError):
        orca_kernel(mixed)
    with pytest.raises(TypeError):
        orca_kernel([t.half() if t.is_floating_point() else t for t in args])
    with pytest.raises(TypeError):
        orca_kernel(args[:8] + [args[8].int(), args[9]])
    with pytest.raises(ValueError):
        orca_kernel(args[:9] + [args[9][:4]])


# ------------------------------------------------------------------ spawn

def spawn_counted(fn, args, **kw):
    """``fn(*args, **kw)`` with the spans on: (its result, ``spawn.slots``,
    the kernel launches it made)."""
    profiling.enable()
    profiling.reset()
    try:
        out = fn(*args, **kw)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    return out, counters.get("spawn.slots", 0), counters["spawn.launches"]


def check_circle_spawn(args, robot_min_dist=None):
    (pos, goal), slots, launches = spawn_counted(
        spawn.batched_circle_spawn, args, robot_min_dist=robot_min_dist)
    want_pos, want_goal = spawn.reference_circle_spawn(
        *args, robot_min_dist=robot_min_dist)
    assert launches == 1 and slots == int(args[1].sum())
    assert torch.equal(pos, want_pos) and torch.equal(goal, want_goal)
    return pos


def check_goal_resample(args):
    goal, slots, launches = spawn_counted(spawn.batched_goal_resample, args)
    assert launches == 1 and slots == int(args[1].sum())
    assert torch.equal(goal, spawn.reference_goal_resample(*args))
    return goal


@pytest.mark.cuda
@pytest.mark.parametrize("need", NEEDS)
@pytest.mark.parametrize("b", [1, 64, 256])
@pytest.mark.parametrize("a", [5, 20, 50, 300])
def test_circle_spawn_matches_plain_bitwise(cuda_device, a, b, need):
    check_circle_spawn(circle_spawn_args(b, a, a + b, cuda_device, need))


@pytest.mark.cuda
@pytest.mark.parametrize("need", NEEDS)
@pytest.mark.parametrize("b", [1, 64, 256])
@pytest.mark.parametrize("a", [5, 20, 50, 300])
def test_goal_resample_matches_plain_bitwise(cuda_device, a, b, need):
    check_goal_resample(goal_resample_args(b, a, a * b + 1, cuda_device, need))


@pytest.mark.cuda
@pytest.mark.parametrize("robot_min_dist", [None, 3.0 * math.sqrt(2.0)],
                         ids=["holonomic", "unicycle"])
@pytest.mark.parametrize("placed", PLACED)
@pytest.mark.parametrize("a,b", [(20, 64), (50, 256)])
def test_circle_spawn_matches_plain_placed_and_robot_distance(
        cuda_device, a, b, placed, robot_min_dist):
    check_circle_spawn(circle_spawn_args(b, a, 5, cuda_device, "random",
                                         placed), robot_min_dist)


@pytest.mark.cuda
@pytest.mark.parametrize("a,b", [(20, 64), (50, 256)])
def test_goal_resample_matches_plain_standing_humans(cuda_device, a, b):
    check_goal_resample(goal_resample_args(b, a, 6, cuda_device, "all",
                                           v_pref_zero=True))


@pytest.mark.cuda
@pytest.mark.parametrize("a", [5, 50])
def test_spawn_keeps_the_fallback_when_every_round_fails(cuda_device, a):
    """At a discomfort distance of 100 m every proposal is rejected: each
    slot in need keeps its first (fallback) proposal."""
    args = circle_spawn_args(64, a, 7, cuda_device, "all",
                             discomfort_dist=100.0)
    pos = check_circle_spawn(args)
    u, need = args[0], args[1]
    first = u.reshape(64, spawn.SPAWN_ROUNDS + 1, 3 * a)[:, 0]
    fallback = spawn._ring(first[:, :a], first[:, a:], args[3], 2.0, 0.0)
    assert need.any() and torch.equal(pos[need], fallback[need])
    args = goal_resample_args(64, a, 8, cuda_device, "all",
                              v_pref_zero=True, discomfort_dist=100.0)
    check_goal_resample(args)


@pytest.mark.cuda
def test_spawn_rejects_what_it_does_not_take(cuda_device):
    args = circle_spawn_args(8, 5, 0, cuda_device)
    with pytest.raises(TypeError):
        spawn.batched_circle_spawn(*args[:2], args[2].double(), *args[3:])
    with pytest.raises(TypeError):
        spawn.batched_circle_spawn(*args[:10], args[10].float(), args[11])
    with pytest.raises(ValueError):
        spawn.batched_circle_spawn(args[0][:, 1:], *args[1:])
    with pytest.raises(ValueError):
        spawn.batched_circle_spawn(*args[:4], args[4][:4], *args[5:])
    goal_args = goal_resample_args(8, 5, 0, cuda_device)
    with pytest.raises(ValueError):
        spawn.batched_goal_resample(goal_args[0].cpu(), *goal_args[1:])


def _events_state(cfg, state, g):
    """``state`` with its envs out of phase: step counts and clocks drawn
    so that every-5 s events and time-outs fall on different steps, and a
    fifth of the humans on their goals (they respawn at the next step)."""
    B, A = state.humans.radius.shape
    steps_per_5s = int(round(5.0 / cfg.env.time_step))
    steps = torch.randint(0, steps_per_5s, (B,), generator=g)
    limit = int(cfg.env.time_limit / cfg.env.time_step)
    clock = torch.randint(limit - 45, limit, (B,), generator=g)
    on_goal = (torch.rand(B, A, generator=g) < 0.2).to(state.humans.pos.device)
    h = state.humans
    return dataclasses.replace(
        state, step_count=steps.to(state.step_count.device),
        global_time=(clock * cfg.env.time_step).to(state.global_time),
        humans=dataclasses.replace(h, goal=torch.where(
            on_goal[..., None], h.pos, h.goal)))


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["flagship_gst_h20", "config5_gst_h10-50"])
def test_vec_step_matches_frozen_reference(cuda_device, config, monkeypatch):
    """40 train-phase ``vec_step`` calls (auto-reset included; the GST
    pretext, which is not under test, left out) against the reference's
    ``step`` and reset of the done envs, from the same reset, state and
    generators: every tensor and generator state equal at every step."""
    rconfig, rsim, rtypes = frozen_reference.modules()
    path = os.path.join(BENCH, "configs", f"{config}.json")
    cfg, rcfg = config_from_snapshot(path), rconfig.config_from_snapshot(path)
    B = cfg.ppo.num_processes
    g = torch.Generator().manual_seed(22)
    gens = [torch.Generator().manual_seed(1000 + i) for i in range(B)]
    state, obs = crowd_sim.reset(cfg, copy_tree(gens), cuda_device)
    r_state, r_obs = rsim.reset(rcfg, copy_tree(gens), cuda_device)
    assert_same_tree(state, r_state, "reset state")
    assert_same_tree(obs, r_obs, "reset obs")
    state = _events_state(cfg, state, g)
    r_state = copy_tree(state, rtypes)
    monkeypatch.setattr(vector, "pretext_process",
                        lambda cfg, gst, s, o, r: (s, o, r, torch.zeros_like(r)))
    before = profiling.launches()["spawn"]
    resets = 0
    for t in range(40):
        action = (torch.rand(B, 2, generator=g) * 2.0 - 1.0).to(cuda_device)
        state, obs, rew, done, info, _ = vector.vec_step(
            cfg, state, action, "train", None)
        r_state, r_obs, r_rew, r_done, r_info = rsim.step(
            rcfg, r_state, action, "train")
        idx = r_done.nonzero()[:, 0]
        resets += int(idx.numel() > 0)
        if idx.numel():
            fresh, fresh_obs = rsim.reset(
                rcfg, [r_state.gens[i] for i in idx.tolist()], cuda_device)
            r_state = rtypes.tree_scatter(idx, fresh, r_state)
            r_obs = rtypes.tree_scatter(idx, fresh_obs, r_obs)
        assert_same_tree(state, r_state, f"step {t} state")
        assert_same_tree(obs, r_obs, f"step {t} obs")
        assert_same_tree([rew, done, info.outcome],
                          [r_rew, r_done, r_info.outcome], f"step {t} out")
    # one launch a step for each event pass, one for each auto-reset
    events = int(cfg.humans.random_goal_changing) + int(
        cfg.humans.end_goal_changing) + int(cfg.sim.human_num_range > 0)
    assert resets > 0
    assert profiling.launches()["spawn"] - before == 40 * events + resets


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["flagship_gst_h20", "config5_gst_h10-50"])
def test_env_step_events_make_no_host_sync(cuda_device, config):
    cfg = config_from_snapshot(os.path.join(BENCH, "configs",
                                            f"{config}.json"))
    B = cfg.ppo.num_processes
    gens = [torch.Generator().manual_seed(i) for i in range(B)]
    state, _ = crowd_sim.reset(cfg, gens, cuda_device)
    state = _events_state(cfg, state, torch.Generator().manual_seed(3))
    # every env at the 5 s mark after this step
    steps_per_5s = int(round(5.0 / cfg.env.time_step))
    state = dataclasses.replace(state, step_count=torch.full_like(
        state.step_count, steps_per_5s - 1))
    action = torch.zeros(B, 2, device=cuda_device)
    crowd_sim.step(cfg, copy_tree(state), action, "train")   # builds, caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = crowd_sim.step(cfg, state, action, "train")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out[0].step_count.eq(steps_per_5s).all()
