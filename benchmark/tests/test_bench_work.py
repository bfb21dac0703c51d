"""The work counts behind the rooflines and mfu, against counts made by
hand."""

import json
import os

import pytest

from conftest import BENCH
from harness import work

# K1 at rows x A, D 512. FLOPs: QKV 2*T*D*3D + QK^T and PV 2*2*rows*A*A*D +
# out 2*T*D*D (T = rows*A tokens). Bytes: x and out in f32 (4*T*D each),
# the mask (T), the f32 weights and biases 4*(D*3D + 3D + D*D + D).
K1 = {(64, 20): (2_013_265_920 + 52_428_800 + 671_088_640,
                 2_621_440 + 1_280 + 4_202_496 + 2_621_440),
      (960, 50): (75_497_472_000 + 4_915_200_000 + 25_165_824_000,
                  98_304_000 + 48_000 + 4_202_496 + 98_304_000)}
# K2: 22*T*D*D + 12*rows*A*A*D FLOPs; x and g, the mask, the weights, dx
# and the four weight gradients.
K2 = {(64, 20): (7_381_975_040 + 157_286_400,
                 5_242_880 + 1_280 + 4_200_448 + 2_621_440 + 4_202_496),
      (960, 50): (276_824_064_000 + 14_745_600_000,
                  196_608_000 + 48_000 + 4_200_448 + 98_304_000
                  + 4_202_496)}


@pytest.mark.parametrize("shape", sorted(K1))
def test_k1_counts(shape):
    assert work.k1_work(*shape, 512) == K1[shape]


@pytest.mark.parametrize("shape", sorted(K2))
def test_k2_counts(shape):
    assert work.k2_work(*shape, 512) == K2[shape]


def test_bounds_pick_the_larger_term():
    flops, nbytes = K1[(960, 50)]
    assert work.k1_bound_s(960, 50, 512, "bf16") == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    assert work.k1_bound_s(960, 50, 512, "f32") == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12))


def _flagship():
    with open(os.path.join(BENCH, "configs", "flagship_gst_h20.json")) as f:
        return json.load(f)


def test_policy_row_flops_at_the_flagship_shapes():
    # one env at one step, A 20 humans, spatial edges of 12, D 512
    items = [2 * 9 * 256,                       # robot_linear
             20 * 2 * 12 * 128, 20 * 2 * 128 * 512,   # embed_0, embed_1
             20 * 2 * 512 * 1536,               # folded q/k/v
             2 * 2 * 20 * 20 * 512,             # QK^T, PV
             20 * 2 * 512 * 512,                # out projection
             20 * 2 * 512 * 256,                # spatial_linear
             2 * 256 * 64, 20 * 2 * 256 * 64,   # robot-human edge layers
             2 * 20 * 64, 2 * 20 * 256,         # scores, weighted sum
             2 * 256 * 64, 2 * 256 * 64,        # EndRNN embeddings
             2 * 128 * 384, 2 * 128 * 384,      # GRU input, hidden
             2 * 128 * 256,                     # output_linear
             4 * 2 * 256 * 256, 2 * 256,        # critic, actor, value
             2 * 256 * 2]                       # fc_mean
    assert work.policy_row_flops(_flagship()) == sum(items) == 52_247_040


def test_gst_env_flops_at_the_flagship_shapes():
    # per human and time: node embedding 2*2*64, in_proj 2*64*192,
    # attention 4*20*64, out 2*64*64, FFN 2*64*128*2, LSTM 2*64*256*2;
    # 5 observed + 4 fed-back times, and 5 Gaussian heads 2*64*5
    per_time = 256 + 24_576 + 5_120 + 8_192 + 32_768 + 65_536
    assert work.gst_env_flops(_flagship()) == 20 * (9 * per_time
                                                    + 5 * 640) == 24_624_640
