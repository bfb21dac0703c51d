"""The work counts behind the rooflines and mfu, against counts made by
hand, each policy base's by its own file."""

import json
import os
import time

import pytest
import torch

from conftest import BENCH
from harness import runner, work

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


def _snapshot(name):
    path = os.path.join(BENCH, "configs", f"{name}.json")
    if not os.path.exists(path):
        path = os.path.join(BENCH, "tests", f"{name}.json")
    with open(path) as f:
        return json.load(f)


def _flagship():
    return _snapshot("flagship_gst_h20")


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


# (policy_row_flops, gst_env_flops) of each configuration: the accepted two
# as the benchmark has counted them since it was defined, and the DS-RNN
# fixture (no GST)
PINNED = {"flagship_gst_h20": (52_247_040, 24_624_640),
          "config5_gst_h10-50": (132_353_280, 65_017_600),
          "srnn_varnum_h20": (11_882_154, 0)}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_model_flops_pinned(name):
    s = _snapshot(name)
    assert (work.policy_row_flops(s), work.gst_env_flops(s)) == PINNED[name]


def test_policy_row_flops_of_ds_rnn():
    # A 20 humans, spatial edges of 2; a GRU dense(in, 3H) + dense(H, 3H)
    def d(i, o):
        return 2 * i * o
    a, e = 20, 2
    items = [d(2, 64) + d(64, 768) + d(256, 768),             # temporal edge
             a * (d(e, 64) + d(64, 768) + d(256, 768)),       # spatial edges
             d(256, 64) + a * d(256, 64) + 2 * a * 64 + 2 * a * 256,  # attn
             d(7, 3) + d(3, 64) + d(512, 64) + d(128, 384) + d(128, 384)
             + d(128, 256),                                   # node
             4 * d(256, 256) + d(256, 1) + d(256, 2)]         # heads
    assert work.policy_row_flops(_snapshot("srnn_varnum_h20")) \
        == sum(items) == 11_882_154


def test_a_base_without_a_count_stops_the_run(tmp_path):
    s = _flagship()
    s["robot"]["policy"] = "uncounted_base"
    with pytest.raises(SystemExit, match="no flops file"):
        work.policy_row_flops(s)
    path = tmp_path / "uncounted.json"
    path.write_text(json.dumps(s))
    with pytest.raises(SystemExit, match="no flops file"):
        runner.execute("flagship-train", 1, 0.5, False, torch.device("cpu"),
                       time.perf_counter(), config_path=str(path))
