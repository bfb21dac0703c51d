"""The port's small utilities against the JAX package:

* ``running_mean_std``: ``rms_update`` / ``normalize_obs`` /
  ``normalize_reward`` against the JAX functions to 1e-6 over three batches;
* ``profiling``: ``PhaseTimer`` and ``trace`` on the CPU;
* ``torch_import`` on synthetic reference ``state_dict``s: a JAX
  ``init_params`` tree from a seed, mapped back to the reference's key names
  and torch layouts (the inverse of the JAX ``utils/torch_import.py``),
  imported by both packages. The port's import must give the seed tree
  back exactly, and the JAX import + JAX forward must agree with the port's
  import + port forward: policy ``act`` to 2e-5 (tests/test_torch_policy.py,
  einsum branch in f32), ``gst_predict`` with and without the edge selector
  to 5e-4 (tests/test_torch_gst.py's bound for the wrapper; the edge
  selector's Gumbel uniforms are the JAX model's own draws for ``key(0)``,
  fed through ``gst_predict``'s ``noise``);
* a reference ``.pt`` through ``load_gst`` (as a file and as the
  reference's ``<dir>/checkpoint/epoch_100.pt`` layout), the eval CLI's
  ``--torch-ckpt`` (stored val metrics printed) and the test and train
  CLIs' ``--gst-params`` on it.
"""

import dataclasses
import os
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crowdnav_prediction_attngraph_tpu.config import PredConfig as JPredConfig
from crowdnav_prediction_attngraph_tpu.models import policy as j_policy
from crowdnav_prediction_attngraph_tpu.models.gst import trainer as jtrainer
from crowdnav_prediction_attngraph_tpu.models.gst.predictor import (
    gst_predict as j_gst_predict)
from crowdnav_prediction_attngraph_tpu.models.policy_net import (
    init_hidden as j_init_hidden)
from crowdnav_prediction_attngraph_tpu.utils import running_mean_std as jrms
from crowdnav_prediction_attngraph_tpu.utils import torch_import as j_import
from crowdnav_prediction_attngraph_tpu_torch import test as test_cli
from crowdnav_prediction_attngraph_tpu_torch import train as train_cli
from crowdnav_prediction_attngraph_tpu_torch.config import PredConfig
from crowdnav_prediction_attngraph_tpu_torch.models import policy as t_policy
from crowdnav_prediction_attngraph_tpu_torch.models.gst import eval as teval
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import (
    gst_predict, load_gst)
from crowdnav_prediction_attngraph_tpu_torch.models.policy_net import (
    init_hidden)
from crowdnav_prediction_attngraph_tpu_torch.utils import profiling
from crowdnav_prediction_attngraph_tpu_torch.utils import running_mean_std as rms
from crowdnav_prediction_attngraph_tpu_torch.utils import torch_import
from crowdnav_prediction_attngraph_tpu_torch.utils.params import (
    flatten_tree, load_npz)
from test_torch_gst import make_history
from test_torch_gst_model import jax_noise
from test_torch_gst_training import write_records
from test_torch_gym_adapter import GST_NPZ
from test_torch_policy import N, _cfgs, _obs

STORED = {"val_loss_epoch": 1.25, "val_aoe_epoch": 0.5, "val_foe_epoch": 0.75}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ running mean/std

def test_running_mean_std_matches_jax():
    rng = np.random.RandomState(0)
    js, ts = jrms.rms_init((7,)), rms.rms_init((7,))
    for scale in (1.0, 3.0, 0.2):
        batch = (rng.randn(64, 7) * scale + 1.5).astype(np.float32)
        js = jrms.rms_update(js, jnp.asarray(batch))
        ts = rms.rms_update(ts, torch.from_numpy(batch))
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    obs = (rng.randn(5, 7) * 40).astype(np.float32)
    np.testing.assert_allclose(
        rms.normalize_obs(ts, torch.from_numpy(obs)).numpy(),
        np.asarray(jrms.normalize_obs(js, jnp.asarray(obs))), atol=1e-6)
    rew = (rng.randn(5, 7) * 40).astype(np.float32)
    got = rms.normalize_reward(ts, torch.from_numpy(rew)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jrms.normalize_reward(js, jnp.asarray(rew))),
        atol=1e-6)
    assert np.abs(got).max() == 10.0               # the clip was reached
    assert float(ts.count) == pytest.approx(192 + 1e-4)


# ------------------------------------------------------------------ profiling

def test_phase_timer_trace_and_rates(tmp_path):
    timer = profiling.PhaseTimer()
    for _ in range(2):
        with timer.phase("rollout", sync="cpu"):
            time.sleep(0.01)
    with timer.phase("update"):
        pass
    assert timer.counts == {"rollout": 2, "update": 1}
    assert timer.totals["rollout"] >= 0.02
    report = timer.report().splitlines()
    assert report[0].strip().startswith("rollout:") and "x2" in report[0]
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.name == "aten::matmul" for e in prof.events())
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


# ------------------------------------------------- reference state_dicts

def _w(a):
    return torch.from_numpy(np.array(np.asarray(a).T, order="C"))


def _b(a):
    return torch.from_numpy(np.array(a, order="C"))


def _dense(sd, prefix, node):
    sd[prefix + ".weight"] = _w(node["kernel"])
    sd[prefix + ".bias"] = _b(node["bias"])


def _layernorm(sd, prefix, node):
    sd[prefix + ".weight"] = _b(node["scale"])
    sd[prefix + ".bias"] = _b(node["bias"])


def reference_policy_state_dict(tree):
    """The reference Policy's state_dict for a flax policy tree: the inverse
    of the JAX ``policy_params_from_torch`` (torch_import.py:25-74)."""
    base, dist = tree["params"]["base"], tree["params"]["dist"]
    sd = {}
    _dense(sd, "base.robot_linear.0", base["robot_linear"])
    _dense(sd, "base.spatial_linear.0", base["spatial_linear"])
    sa, p = base["spatial_attn"], "base.spatial_attn"
    _dense(sd, p + ".embedding_layer.0", sa["embed_0"])
    _dense(sd, p + ".embedding_layer.2", sa["embed_1"])
    for name in ("q_linear", "k_linear", "v_linear"):
        _dense(sd, f"{p}.{name}", sa[name])
    sd[p + ".multihead_attn.in_proj_weight"] = _w(sa["mha_in_proj_weight"])
    sd[p + ".multihead_attn.in_proj_bias"] = _b(sa["mha_in_proj_bias"])
    _dense(sd, p + ".multihead_attn.out_proj", sa["mha_out_proj"])
    _dense(sd, "base.attn.temporal_edge_layer.0",
           base["attn"]["temporal_edge_layer"])
    _dense(sd, "base.attn.spatial_edge_layer.0",
           base["attn"]["spatial_edge_layer"])
    rnn, p = base["humanNodeRNN"], "base.humanNodeRNN"
    for name in ("encoder_linear", "edge_attention_embed", "output_linear"):
        _dense(sd, f"{p}.{name}", rnn[name])
    for leaf, name in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0")):
        sd[f"{p}.gru.{name}"] = _w(rnn["gru"][leaf])
    for leaf, name in (("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
        sd[f"{p}.gru.{name}"] = _b(rnn["gru"][leaf])
    for node, name in (("actor_0", "actor.0"), ("actor_1", "actor.2"),
                       ("critic_0", "critic.0"), ("critic_1", "critic.2"),
                       ("critic_linear", "critic_linear")):
        _dense(sd, "base." + name, base[node])
    _dense(sd, "dist.fc_mean", dist["fc_mean"])
    # AddBias stores (num_outputs, 1) (network_utils.py:28-36)
    sd["dist.logstd._bias"] = _b(dist["logstd"]).reshape(-1, 1)
    return sd


def reference_gst_state_dict(tree, num_layers=1):
    """The reference st_model's state_dict for a flax STModel tree: the
    inverse of the JAX ``gst_params_from_torch`` (torch_import.py:77-122)."""
    p = tree["params"] if set(tree) == {"params"} else tree
    g, pre = p["gst"], "gumbel_social_transformer"
    sd = {}
    _dense(sd, pre + ".node_embedding", g["node_embedding"])
    for i in range(num_layers):
        layer, q = g[f"layer_{i}"], f"{pre}.node_encoder_layers.{i}"
        sd[q + ".self_attn.in_proj_weight"] = _w(layer["in_proj_weight"])
        sd[q + ".self_attn.in_proj_bias"] = _b(layer["in_proj_bias"])
        _dense(sd, q + ".self_attn.out_proj", layer["out_proj"])
        _layernorm(sd, q + ".norm_node", layer["norm_node"])
        _layernorm(sd, q + ".norm1_node", layer["norm1_node"])
        _dense(sd, q + ".linear1", layer["linear1"])
        _dense(sd, q + ".linear2", layer["linear2"])
    if "edge_selector" in g:
        e, q = g["edge_selector"], pre + ".edge_selector"
        _dense(sd, q + ".augmented_edge_embedding",
               e["augmented_edge_embedding"])
        _layernorm(sd, q + ".norm_augmented_edge", e["norm_augmented_edge"])
        sd[q + ".self_attn.in_proj_weight"] = _w(e["in_proj_weight"])
        sd[q + ".self_attn.in_proj_bias"] = _b(e["in_proj_bias"])
        _dense(sd, q + ".self_attn.out_proj", e["out_proj"])
        _dense(sd, q + ".linear1", e["linear1"])
        _dense(sd, q + ".linear2", e["linear2"])
    sd["lstm.weight_ih_l0"] = _w(p["lstm_w_ih"])
    sd["lstm.weight_hh_l0"] = _w(p["lstm_w_hh"])
    sd["lstm.bias_ih_l0"] = _b(p["lstm_b_ih"])
    sd["lstm.bias_hh_l0"] = _b(p["lstm_b_hh"])
    _dense(sd, "hidden2pos", p["hidden2pos"])
    return sd


def save_reference_checkpoint(path, tree):
    """A reference-style epoch_*.pt for a flax STModel tree."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": 100, "model_state_dict": reference_gst_state_dict(tree),
                **STORED}, path)


def _assert_same_tree(got, expect):
    got, expect = flatten_tree(got), flatten_tree(expect)
    assert set(got) == set(expect)
    for k in expect:
        np.testing.assert_array_equal(got[k], expect[k], err_msg=k)


def test_policy_import_matches_jax():
    jc, tc = _cfgs()
    example = {k: jnp.asarray(v) for k, v in
               _obs(np.random.RandomState(0), (N,)).items()}
    tree = jax.tree.map(np.asarray, j_policy.init_params(
        jc, jax.random.key(1), example))
    rng = np.random.RandomState(2)
    tree = jax.tree.map(     # non-zero biases and logstd
        lambda x: x + rng.randn(*x.shape).astype(np.float32) * 0.05, tree)
    sd = reference_policy_state_dict(tree)
    t_tree = torch_import.policy_params_from_torch(sd)
    _assert_same_tree(t_tree, tree)
    j_tree = j_import.policy_params_from_torch(sd)

    obs = _obs(np.random.RandomState(3), (N,))
    jv, ja, _, jh = jax.jit(lambda o, h, m: j_policy.act(
        jc, j_tree, o, h, m, jax.random.key(0), deterministic=True))(
        {k: jnp.asarray(v) for k, v in obs.items()}, j_init_hidden(jc, N),
        jnp.ones((N,)))
    model = t_policy.load_policy(tc, t_tree, "cpu")
    tv, ta, _, th = t_policy.act(
        model, {k: torch.from_numpy(v) for k, v in obs.items()},
        init_hidden(tc, N, "cpu"), torch.ones(N))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-5)
    np.testing.assert_allclose(th["human_node_rnn"].numpy(),
                               np.asarray(jh["human_node_rnn"]), atol=2e-5)


@pytest.mark.parametrize("edge_heads", [0, 2])
def test_gst_import_matches_jax(edge_heads):
    B, A, L = 3, 6, 5
    jc = dataclasses.replace(JPredConfig(), spatial_num_heads_edges=edge_heads)
    tc = dataclasses.replace(PredConfig(), spatial_num_heads_edges=edge_heads)
    tree = jax.tree.map(np.asarray,
                        jtrainer.init_params(jc, jax.random.key(0), A))
    sd = reference_gst_state_dict(tree)
    assert any("edge_selector" in k for k in sd) == bool(edge_heads)
    t_tree = torch_import.gst_params_from_torch(sd)
    _assert_same_tree(t_tree, tree)
    j_tree = j_import.gst_params_from_torch(sd)

    pos, mask = make_history(np.random.RandomState(1), B, A, L)
    out_j, mask_j = jax.jit(jax.vmap(lambda t, m: j_gst_predict(
        jc, j_tree, t, m)))(jnp.asarray(pos), jnp.asarray(mask))
    noise = None
    if edge_heads:
        # every env of the JAX vmap draws from key(0)
        one = jax_noise(jc, jax.random.key(0), 1, A)
        noise = {"gumbel_obs": one["gumbel_obs"].repeat(B, 1, 1, 1),
                 "gumbel_dec": one["gumbel_dec"].repeat(1, B, 1, 1, 1)}
    out, out_mask = gst_predict(load_gst(tc, t_tree, "cpu"),
                                torch.from_numpy(pos), torch.from_numpy(mask),
                                noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=5e-4)
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(mask_j))


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    """The committed predictor as a reference results dir
    (``<dir>/checkpoint/epoch_100.pt``)."""
    root = tmp_path_factory.mktemp("reference_gst")
    save_reference_checkpoint(str(root / "checkpoint" / "epoch_100.pt"),
                              load_npz(GST_NPZ))
    return root


def test_pt_round_trip_through_load_gst(reference_dir):
    cfg = PredConfig()
    expect = load_gst(cfg, GST_NPZ, "cpu").state_dict()
    pt = str(reference_dir / "checkpoint" / "epoch_100.pt")
    for source in (pt, str(reference_dir)):
        got = load_gst(cfg, source, "cpu").state_dict()
        assert set(got) == set(expect)
        for k in expect:
            assert torch.equal(got[k], expect[k]), k
    # a bare state_dict, as the JAX loader also takes
    bare = str(reference_dir / "bare.pt")
    torch.save(torch.load(pt, weights_only=True)["model_state_dict"], bare)
    _assert_same_tree(torch_import.load_gst_checkpoint(bare),
                      load_npz(GST_NPZ))


def test_eval_torch_ckpt(reference_dir, tmp_path, capsys):
    data = tmp_path / "data"
    os.makedirs(data)
    for i in range(2):
        write_records(str(data / f"{i}.txt"), i, frames=30)
    pt = str(reference_dir / "checkpoint" / "epoch_100.pt")
    flags = ["--data-dir", str(data), "--mode", "val", "--max-windows", "6",
             "--batch-size", "4", "--device", "cpu"]
    m = teval.main(flags + ["--torch-ckpt", pt])
    out = capsys.readouterr().out
    assert ("Stored in checkpoint: val_loss_epoch 1.2500 | "
            "val_aoe_epoch 0.5000 | val_foe_epoch 0.7500") in out
    assert set(m) == {"loss", "aoe", "foe"}
    assert all(np.isfinite(v) for v in m.values())
    # the same weights as the committed export
    expect = teval.evaluate_dataset(
        load_gst(PredConfig(), GST_NPZ, "cpu"),
        teval.ds.load_dataset(str(data), 5, 5, 32, max_windows=6),
        batch_size=4)
    assert m == expect


def test_gst_params_pt_in_test_and_train_clis(reference_dir, tmp_path):
    res = test_cli.main(["--env-name", "CrowdSimPredRealGST",
                         "--robot-policy", "orca", "--human-num", "3",
                         "--test-case-size", "1", "--gst-params",
                         str(reference_dir), "--device", "cpu",
                         "--out-dir", str(tmp_path / "eval")])
    assert np.isfinite(res["success_rate"])
    train_cli.main(["--human-num", "3", "--num-processes", "2",
                    "--num-steps", "2", "--num-env-steps", "4",
                    "--gst-params",
                    str(reference_dir / "checkpoint" / "epoch_100.pt"),
                    "--output-dir", str(tmp_path / "ppo"), "--device", "cpu"])
    assert os.path.exists(tmp_path / "ppo" / "config.json")
