"""The sparse Gumbel Social Transformer on the port's normal path: the GST's
edge selector (4 heads) with its ghost node, in float32.

Against the benchmark's frozen plain reference (``benchmark/reference``
``predictor.py`` and ``st_model.py``, loaded as ``frozen_reference`` loads
the env) on seeded weights at 3 envs x 7 humans: ``gst_predict`` and
``gst_forward`` give the reference's predictions within 1e-5 (f32
reduction order is the only difference) and the same multinomials and hard
samples at every edge-selector call; one ``pretext_process`` inside a
``vec_step`` gives the reference's ``pretext_parts`` on the same inputs.
Also: the ``--gst-edge-heads`` / ``--gst-ghost`` flags of ``train`` and
``test`` through ``build_config`` and back from a run's ``config.json``;
the committed seeded weights load strictly (and only into the sparse GST);
the GST trainer's ``--ghost`` step; and the ``gst.edge_rows`` counter and
the ``gst.edge_selector`` / ``gst.node_encoder`` spans. This file imports no
jax.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import frozen_reference
from test_torch_gst_graph import history

from crowdnav_prediction_attngraph_tpu_torch import test as test_cli
from crowdnav_prediction_attngraph_tpu_torch import train as train_cli
from crowdnav_prediction_attngraph_tpu_torch.config import (
    PredConfig, build_config, config_from_snapshot, gst_config)
from crowdnav_prediction_attngraph_tpu_torch.env import vector
from crowdnav_prediction_attngraph_tpu_torch.models.gst import trainer
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import (
    edge_rows, gst_forward, gst_predict, load_gst)
from crowdnav_prediction_attngraph_tpu_torch.models.gst.st_model import init_gst
from crowdnav_prediction_attngraph_tpu_torch.utils import profiling
from crowdnav_prediction_attngraph_tpu_torch.utils.params import (
    load_npz, state_dict_to_tree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPARSE = os.path.join(ROOT, "crowdnav_prediction_attngraph_tpu_torch",
                      "weights", "gst_sparse_ghost_e4_seed2022.npz")
B, A = 3, 7
FRAMES = 9                      # obs_len 5 + pred_len 5 - 1


def sparse_cfg(**kw) -> PredConfig:
    return dataclasses.replace(PredConfig(), spatial_num_heads_edges=4,
                               ghost=True, matmul_dtype="f32", **kw)


def seeded_tree(seed: int) -> dict:
    model = init_gst(sparse_cfg(), torch.Generator().manual_seed(seed),
                     "cpu")
    return state_dict_to_tree(model.state_dict())


@pytest.fixture(autouse=True)
def registry_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def ref():
    return frozen_reference.gst_modules()


def selector_calls(model):
    """The edge selector's (multinomial, sample) of every call, kept by a
    forward hook; returns (the list, the hook's handle)."""
    calls = []
    handle = model.gst.edge_selector.register_forward_hook(
        lambda mod, args, out: calls.append(out))
    return calls, handle


def both_models(ref, tree):
    rconfig, rpred = ref[0], ref[1]
    cfg = sparse_cfg()
    port = load_gst(cfg, tree, "cpu")
    reference = rpred.load_gst(rconfig.PredConfig(**dataclasses.asdict(cfg)),
                               tree, "cpu")
    return port, reference


# --- the GST against the plain reference ---------------------------------

@pytest.mark.parametrize("seed,entry", [(1, "predict"), (2, "forward"),
                                        (3, "predict")])
def test_sparse_gst_matches_the_plain_reference(ref, seed, entry):
    port, reference = both_models(ref, seeded_tree(seed))
    traj, mask = history(B, A, 40 + seed, "cpu")
    got_calls, h1 = selector_calls(port)
    want_calls, h2 = selector_calls(reference)
    call = gst_predict if entry == "predict" else gst_forward
    got = call(port, traj, mask)
    want = ref[1].gst_predict(reference, traj, mask)
    h1.remove()
    h2.remove()
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0.0)
    assert torch.equal(got[1], want[1])
    # the observation period's call, then one a fed-back frame
    assert len(got_calls) == len(want_calls) == 5
    for i, ((pm, ps), (rm, rs)) in enumerate(zip(got_calls, want_calls)):
        assert torch.equal(pm, rm), i
        assert torch.equal(ps, rs), i
        # hard samples (straight through: the one-hot plus y - y): one
        # neighbour, or the ghost, a target and head
        assert bool(((ps > 0.5).sum(-1) == 1).all()), i
    # the seeded selector picks real neighbours and the ghost alike
    first = got_calls[0][1] > 0.5
    assert first[..., -1].any() and first[..., :-1].any()


def test_pretext_in_vec_step_matches_reference_pretext_parts(ref, tmp_path,
                                                             monkeypatch):
    rconfig, rpred, rpretext, rtypes = ref
    cfg = gst_config(human_num=5, human_num_range=2)
    cfg = cfg.replace(pred=sparse_cfg(),
                      ppo=dataclasses.replace(cfg.ppo, num_processes=B))
    snapshot = tmp_path / "config.json"
    snapshot.write_text(json.dumps(dataclasses.asdict(cfg)))
    rcfg = rconfig.config_from_snapshot(str(snapshot))
    tree = seeded_tree(7)
    gst = load_gst(cfg.pred, tree, "cpu")
    rgst = rpred.load_gst(rcfg.pred, tree, "cpu")
    gens = [torch.Generator().manual_seed(100 + i) for i in range(B)]
    states, _ = vector.vec_reset_with_pretext(cfg, gens, gst, "cpu")
    seen = {}
    original = vector.pretext_process

    def recorded(cfg_, gst_, state, obs, rew):
        seen["in"] = frozen_reference.copy_tree([state, obs, rew], rtypes)
        seen["out"] = original(cfg_, gst_, state, obs, rew)
        return seen["out"]
    monkeypatch.setattr(vector, "pretext_process", recorded)
    action = torch.linspace(-1.0, 1.0, 2 * B).reshape(B, 2)
    vector.vec_step(cfg, states, action, "train", gst)
    st, ob, rew, pen = seen["out"]
    r_st, r_ob, r_rew, r_pen, r_mask = rpretext.pretext_parts(
        rcfg, rgst, *seen["in"])
    torch.testing.assert_close(ob.spatial_edges, r_ob.spatial_edges,
                               atol=1e-5, rtol=0.0)
    assert r_mask.any()
    for a, b in ((st.traj_buffer, r_st.traj_buffer),
                 (st.mask_buffer, r_st.mask_buffer), (rew, r_rew),
                 (pen, r_pen), (ob.visible_masks, r_ob.visible_masks)):
        assert torch.equal(a, b)


# --- the flags and the snapshot ------------------------------------------

COMMON = ["--env-name", "CrowdSimPredRealGST", "--human-num", "30",
          "--human-num-range", "20", "--num-processes", "256"]


@pytest.mark.parametrize("cli", [train_cli, test_cli])
@pytest.mark.parametrize("flags,heads,ghost", [
    ([], 0, False),
    (["--gst-edge-heads", "4"], 4, False),
    (["--gst-edge-heads", "4", "--gst-ghost"], 4, True)])
def test_flags_round_trip_through_the_snapshot(cli, flags, heads, ghost,
                                               tmp_path):
    args = cli._parser().parse_args(COMMON + flags)
    cfg = build_config(args)
    assert (cfg.pred.spatial_num_heads_edges, cfg.pred.ghost) == (heads,
                                                                  ghost)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(dataclasses.asdict(cfg), default=str))
    assert config_from_snapshot(str(path)) == cfg


@pytest.mark.parametrize("flags", [["--gst-edge-heads", "4"],
                                   ["--gst-edge-heads", "4", "--gst-ghost"]])
def test_test_cli_refuses_the_flags_beside_a_snapshot(flags, tmp_path):
    cfg = build_config(train_cli._parser().parse_args(COMMON))
    (tmp_path / "config.json").write_text(
        json.dumps(dataclasses.asdict(cfg), default=str))
    args = test_cli._parser().parse_args(
        ["--model-dir", str(tmp_path)] + flags)
    with pytest.raises(SystemExit, match="edge selector"):
        test_cli.load_config(args)
    args = test_cli._parser().parse_args(["--model-dir", str(tmp_path)])
    assert test_cli.load_config(args) == (cfg, True)


def test_ghost_without_edge_heads_is_refused():
    args = train_cli._parser().parse_args(COMMON + ["--gst-ghost"])
    cfg = build_config(args)
    with pytest.raises(ValueError, match="ghost"):
        load_gst(cfg.pred, SPARSE, "cpu")


# --- the committed seeded weights ----------------------------------------

def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_sparse_gst_weights",
        os.path.join(ROOT, "tools", "make_sparse_gst_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_committed_weights_load_strictly_into_the_sparse_gst_only():
    model = load_gst(sparse_cfg(), SPARSE, "cpu")
    assert model.gst.edge_selector.nhead == 4 and model.cfg.ghost
    assert sum(p.numel() for p in model.parameters()) == 84774
    with pytest.raises(RuntimeError, match="edge_selector"):
        load_gst(PredConfig(), SPARSE, "cpu")
    with pytest.raises(RuntimeError, match="edge_selector"):
        load_gst(sparse_cfg(), test_cli.DEFAULT_GST_PARAMS, "cpu")


def test_tool_draws_the_committed_weights(tmp_path):
    tool = _tool()
    out = str(tmp_path / "w.npz")
    flat = tool.write(out)
    committed = np.load(SPARSE)
    assert sorted(flat) == sorted(committed.files)
    for k in committed.files:
        np.testing.assert_allclose(flat[k], committed[k], rtol=0, atol=1e-6)
    assert load_npz(out).keys() == {"params"}


# --- the GST trainer -----------------------------------------------------

def _write_records(path, seed, frames=40, peds=6):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-5, 5, (peds, 2))
    vel = rng.uniform(-0.3, 0.3, (peds, 2))
    with open(path, "w") as fh:
        for f in range(frames):
            pos = pos + vel + rng.normal(0, 0.02, pos.shape)
            for p in range(peds):
                if rng.uniform() < 0.85:
                    fh.write(f"{float(f)}\t{float(p)}\t{pos[p, 0]:.6f}\t"
                             f"{pos[p, 1]:.6f}\n")


def test_trainer_takes_a_ghost_step(tmp_path):
    for split, seeds in (("train", (0, 1)), ("test", (2,))):
        os.makedirs(tmp_path / "data" / split)
        for i, s in enumerate(seeds):
            _write_records(str(tmp_path / "data" / split / f"{i}.txt"), s)
    out = str(tmp_path / "run")
    hist = trainer.main(["--data-dir", str(tmp_path / "data"), "--out", out,
                         "--epochs", "1", "--batch-size", "4",
                         "--max-windows", "4", "--max-val-windows", "4",
                         "--max-peds", "8", "--edge-heads", "4", "--ghost",
                         "--device", "cpu"])
    assert all(np.isfinite(v[0]) for v in hist.values())
    params = os.path.join(out, "epoch_1", "params.npz")
    model = load_gst(sparse_cfg(), params, "cpu")
    drawn = init_gst(sparse_cfg(), torch.Generator().manual_seed(1000), "cpu")
    # the Adam step moved the edge selector
    w = "gst.edge_selector.in_proj_weight"
    assert not torch.equal(model.state_dict()[w], drawn.state_dict()[w])
    traj, mask = gst_predict(model, *history(2, 8, 5, "cpu"))
    assert torch.isfinite(traj).all() and traj.shape == (2, 8, 5, 5)


# --- the counter and the spans -------------------------------------------

@pytest.mark.parametrize("heads", [0, 4])
def test_edge_rows_counted_from_the_shapes(heads):
    cfg = (sparse_cfg() if heads else PredConfig())
    assert edge_rows(cfg, B, A) == (B * A * FRAMES if heads else 0)
    model = (load_gst(cfg, SPARSE, "cpu") if heads
             else load_gst(cfg, test_cli.DEFAULT_GST_PARAMS, "cpu"))
    profiling.enable()
    for seed in range(2):
        gst_predict(model, *history(B, A, seed, "cpu"))
    profiling.disable()
    snap = profiling.snapshot()
    assert snap["counters"]["gst.edge_rows"] == 2 * edge_rows(cfg, B, A)
    totals = snap["totals"]
    # one span a spatial call: the observation period's, then 4 fed back
    assert totals["gst.node_encoder"]["count"] == 2 * 5
    assert totals.get("gst.edge_selector", {}).get("count", 0) == (
        2 * 5 if heads else 0)


def test_spans_nest_in_the_pretext_and_readings_report_edge_rows():
    cfg = gst_config(human_num=5, human_num_range=2)
    cfg = cfg.replace(pred=sparse_cfg(),
                      ppo=dataclasses.replace(cfg.ppo, num_processes=B))
    gst = load_gst(cfg.pred, SPARSE, "cpu")
    gens = [torch.Generator().manual_seed(200 + i) for i in range(B)]
    states, _ = vector.vec_reset_with_pretext(cfg, gens, gst, "cpu")
    action = torch.zeros(B, 2)
    profiling.enable()
    vector.vec_step(cfg, states, action, "train", gst)
    profiling.disable()
    snap = profiling.snapshot()
    ids = {s["id"]: s for s in snap["spans"]}

    def path(s):
        out = []
        while s is not None:
            out.append(s["name"])
            s = ids.get(s["parent"])
        return tuple(out)
    paths = {path(s) for s in snap["spans"]}
    for name in ("gst.edge_selector", "gst.node_encoder"):
        assert (name, "gst.pretext", "vec.step") in paths
    r = profiling.readings(snap)
    rows = B * cfg.sim.max_human_num * FRAMES
    assert r["gst_edge_rows"] == rows
    assert f"{rows:.1f} edge rows a pretext call" in \
        profiling.per_step_table(snap)


def test_off_the_sparse_gst_leaves_the_registry_empty():
    model = load_gst(sparse_cfg(), SPARSE, "cpu")
    gst_predict(model, *history(B, A, 0, "cpu"))
    snap = profiling.snapshot()
    assert snap["spans"] == [] and "gst.edge_rows" not in snap["counters"]


def test_cli_spans_print_the_gst_line(tmp_path, capsys):
    train_cli.main(["--device", "cpu", "--output-dir", str(tmp_path / "tr"),
                    "--human-num", "4", "--num-processes", "2",
                    "--num-steps", "2", "--num-env-steps", "4",
                    "--log-interval", "1", "--gst-edge-heads", "4",
                    "--gst-ghost", "--gst-matmul-dtype", "f32",
                    "--gst-params", SPARSE, "--spans"])
    out = capsys.readouterr().out
    assert "gst.edge_selector" in out and "gst.node_encoder" in out
    assert f"{2 * 4 * FRAMES:.1f} edge rows a pretext call" in out
    snap = config_from_snapshot(str(tmp_path / "tr" / "config.json"))
    assert (snap.pred.spatial_num_heads_edges, snap.pred.ghost,
            snap.pred.matmul_dtype) == (4, True, "f32")
