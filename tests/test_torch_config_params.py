"""The port's config and weight bridge against the JAX package.

* every config field and default, and every derived quantity, equals the
  JAX package's; ``config_from_snapshot`` reads the r5 snapshot to the same
  values;
* flax tree -> torch state_dict -> flax tree is bit-exact, also through a
  loaded model's own state_dict;
* the committed .npz weights equal a templated orbax restore of the
  checkpoints they were exported from, bit for bit, and hold params only.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

from crowdnav_prediction_attngraph_tpu import config as jconfig
from crowdnav_prediction_attngraph_tpu_torch import config as tconfig
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import load_gst
from crowdnav_prediction_attngraph_tpu_torch.models.policy import load_policy
from crowdnav_prediction_attngraph_tpu_torch.utils.params import (
    flatten_tree, load_npz, state_dict_to_tree, tree_to_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "crowdnav_prediction_attngraph_tpu_torch",
                       "weights")
MODEL_DIR = os.path.join(REPO, "trained_models",
                         "GST_predictor_rand_tpu_r5_selfgst")
POLICY_NPZ = os.path.join(WEIGHTS, "r5_selfgst_10250_policy.npz")
GST_NPZ = os.path.join(WEIGHTS, "gst_sj_tpu_r5_b64_epoch100.npz")
DERIVED = ("pred_interval", "buffer_len", "obs_buffer_len", "spatial_edge_dim",
           "max_episode_steps")


def _same(jc, tc):
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    for name in DERIVED:
        assert getattr(jc, name) == getattr(tc, name), name
    assert jc.sim.max_human_num == tc.sim.max_human_num


@pytest.mark.parametrize("builder,kw", [
    ("Config", {}), ("gst_config", {}), ("gst_config", {"human_num": 3}),
    ("varnum_config", {"human_num": 5, "human_num_range": 2}),
    ("pred_config", {"predict_method": "truth"})])
def test_config_defaults_match_jax(builder, kw):
    _same(getattr(jconfig, builder)(**kw), getattr(tconfig, builder)(**kw))


def test_config_from_snapshot_matches_jax():
    from crowdnav_prediction_attngraph_tpu.test import (
        config_from_snapshot as j_from_snapshot)
    path = os.path.join(MODEL_DIR, "config.json")
    tc = tconfig.config_from_snapshot(path)
    _same(j_from_snapshot(path), tc)
    assert tc.pred.matmul_dtype == "bf16"
    assert tc.network.use_pallas_attention and tc.network.attn_size == 512


def _assert_trees_equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("npz", [POLICY_NPZ, GST_NPZ])
def test_flax_torch_round_trip_is_bit_exact(npz):
    tree = load_npz(npz)
    _assert_trees_equal(state_dict_to_tree(tree_to_state_dict(tree)), tree)


def test_round_trip_through_loaded_models():
    cfg = tconfig.config_from_snapshot(os.path.join(MODEL_DIR, "config.json"))
    pol_tree = load_npz(POLICY_NPZ)["params"]
    _assert_trees_equal(
        state_dict_to_tree(load_policy(cfg, POLICY_NPZ, "cpu").state_dict()),
        pol_tree)
    gst_tree = load_npz(GST_NPZ)["params"]
    _assert_trees_equal(
        state_dict_to_tree(load_gst(cfg.pred, GST_NPZ, "cpu").state_dict()), gst_tree)


def _export_tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights",
        os.path.join(REPO, "tools", "export_torch_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["r5_selfgst_10250_policy.npz",
                                  "gst_sj_tpu_r5_b64_epoch100.npz"])
def test_committed_npz_equals_orbax_restore(name):
    tool = _export_tool()
    if not os.path.isdir(tool.EXPORTS[name]):
        # .gitattributes marks the legacy checkpoints export-ignore
        pytest.skip(f"{tool.EXPORTS[name]} is not in this checkout")
    restored = flatten_tree(tool.restore_params(tool.EXPORTS[name]))
    with np.load(os.path.join(WEIGHTS, name)) as z:
        committed = {k: z[k] for k in z.files}
    assert committed.keys() == restored.keys()
    assert not any("opt_state" in k for k in committed)
    for k, v in restored.items():
        assert committed[k].dtype == np.float32
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
