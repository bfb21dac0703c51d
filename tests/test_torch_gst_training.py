"""The port's GST training stack against the JAX package's: the dataset copy,
the schedules, the rotation, one Adam step, whole training runs, resume,
the device-resident epochs against the host batches, the evaluation, the
trainer and eval CLIs, and the PECNet data copy.

Inputs are txt record files the tests write from numpy seeds; no test reads
files outside the repo. The JAX side runs its per-batch train step
(``train(..., fused_epochs=False)``), not the fused epoch scan, which takes
minutes to compile on the CPU. Small shapes: batch 4, 8 pedestrian slots,
embedding 16, 2 heads. Tolerances:

* windows, batch order, the PECNet batches: bit for bit;
* the lr schedule: 1e-7 relative (read back from optax's updates);
  ``rotate_graph``: 1e-6 absolute and relative (edges reach 20 m);
* one Adam step: loss and parameters at 1e-5, gradients at 1e-5 of each
  leaf's largest entry, but for the attention's k bias (see test_one_adam_step_matches_jax); the optimizer
  alone, on the JAX gradients: 1e-7;
* a 2-epoch run from the JAX init on collected windows: parameters (but
  the k bias) at 3e-4 and the history at rtol 2e-3 / atol 2e-4, the JAX
  package's own bounds between two XLA programs
  (tests/test_gst_training.py:141-145);
* resume and resident-vs-host: the same bits (one program, one device);
* ``evaluate_dataset`` in val mode: 1e-4.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from crowdnav_prediction_attngraph_tpu.models.gst import dataset as jds
from crowdnav_prediction_attngraph_tpu.models.gst import eval as jeval
from crowdnav_prediction_attngraph_tpu.models.gst import pecnet_data as jpd
from crowdnav_prediction_attngraph_tpu.models.gst import trainer as jtrainer
from crowdnav_prediction_attngraph_tpu_torch import test as test_cli
from crowdnav_prediction_attngraph_tpu_torch import train as train_cli
from crowdnav_prediction_attngraph_tpu_torch.collect_data import collect_dataset
from crowdnav_prediction_attngraph_tpu_torch.config import (
    PredConfig, varnum_config)
from crowdnav_prediction_attngraph_tpu_torch.models.gst import dataset as tds
from crowdnav_prediction_attngraph_tpu_torch.models.gst import eval as teval
from crowdnav_prediction_attngraph_tpu_torch.models.gst import pecnet_data as tpd
from crowdnav_prediction_attngraph_tpu_torch.models.gst import trainer as ttrainer
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import (
    gst_predict, load_gst)
from crowdnav_prediction_attngraph_tpu_torch.utils.params import (
    flatten_tree, load_npz, state_dict_to_tree, tree_to_state_dict)
from test_torch_gst_model import configs

P = 8                      # pedestrian slots
# the attention's k bias: its gradient is 0 in exact arithmetic (the
# softmax ignores a shift of every logit of a row), so both packages hold
# rounding noise there
K_BIAS = "gst/layer_0/in_proj_bias"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tiny models run their ops on one thread: with the suite's
    workers sharing the cores, torch's intra-op threads only contend (a
    2 s training test took 80 s under load with them, 14 s without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_records(path, seed, frames=60, peds=7):
    """One env's txt stream: peds walking with gaps in their presence, a
    missing frame, and a re-entering id, in the collect format."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-5, 5, (peds, 2))
    vel = rng.uniform(-0.3, 0.3, (peds, 2))
    rows = []
    for f in range(frames):
        if f == 31:
            continue                              # a gap in the frames
        pos = pos + vel + rng.normal(0, 0.02, pos.shape)
        for p in range(peds):
            if rng.uniform() < 0.85:
                rows.append([float(f), float(p + 10 * (f > 40 and p == 0)),
                             float(np.float32(pos[p, 0])),
                             float(np.float32(pos[p, 1]))])
    with open(path, "w") as fh:
        fh.writelines(f"{r[0]}\t{r[1]}\t{r[2]}\t{r[3]}\n" for r in rows)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("gst_data")
    for split, seeds in (("train", (0, 1, 2)), ("test", (3,))):
        os.makedirs(root / split)
        for i, s in enumerate(seeds):
            write_records(str(root / split / f"{i}.txt"), s)
    return root


@pytest.fixture(scope="module")
def windows(data_dir):
    train = tds.load_dataset(str(data_dir / "train"), 5, 5, P, cache=False)
    val = tds.load_dataset(str(data_dir / "test"), 5, 5, P, cache=False)
    return train, val[:5]          # an odd val split: a short last batch


def assert_windows_equal(a, b):
    assert len(a) == len(b) > 0
    for wa, wb in zip(a, b):
        assert set(wa) == set(wb)
        for k in wa:
            assert wa[k].dtype == wb[k].dtype
            np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)


# ------------------------------------------------------------- dataset

@pytest.mark.parametrize("kw", [dict(), dict(stride=2, max_windows=30)])
def test_dataset_copy_matches_jax(data_dir, kw):
    d = str(data_dir / "train")
    got = tds.load_dataset(d, 5, 5, P, cache=False, **kw)
    assert_windows_equal(got, jds.load_dataset(d, 5, 5, P, cache=False, **kw))
    b_t = list(tds.batches(got, 4, np.random.RandomState(3)))
    b_j = list(jds.batches(got, 4, np.random.RandomState(3)))
    assert len(b_t) == len(b_j) == len(got) // 4
    for x, y in zip(b_t, b_j):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_benchmark_readers_match_jax(tmp_path):
    """The reference-rule readers: a flat dir with the 80/20 in-file split
    (``load_benchmark``, ``reference_windows``, ``_repad``), a space
    delimited file, a raw SDD annotation file and a TrajNet++ ndjson."""
    flat = tmp_path / "mine"
    flat.mkdir()
    write_records(str(flat / "a.txt"), 5, frames=40, peds=5)
    write_records(str(flat / "b.txt"), 6, frames=40, peds=9)
    for split in ("train", "val"):
        assert_windows_equal(
            tds.load_benchmark("mine", str(tmp_path), split, 4, 4,
                               cache=False),
            jds.load_benchmark("mine", str(tmp_path), split, 4, 4,
                               cache=False))
    rec = jds.read_txt(str(flat / "a.txt"))
    np.savetxt(tmp_path / "sp.txt", rec, delimiter=" ")
    np.testing.assert_array_equal(tds.read_file(str(tmp_path / "sp.txt"),
                                                "space"),
                                  jds.read_file(str(tmp_path / "sp.txt"),
                                                "space"))
    sdd = tmp_path / "sdd.txt"
    with open(sdd, "w") as f:
        for fr in range(0, 200, 5):
            for tid in range(3):
                f.write(f"{tid} {fr} {2 * fr} {fr + 10} {2 * fr + 10} {fr} "
                        f"{int(fr == 50)} 0 0 "
                        f"\"{'Car' if tid == 2 else 'Pedestrian'}\"\n")
    np.testing.assert_array_equal(tds.read_sdd_file(str(sdd)),
                                  jds.read_sdd_file(str(sdd)))
    nd = tmp_path / "real_scene.ndjson"
    with open(nd, "w") as f:
        for s in range(3):
            f.write(json.dumps({"scene": {"id": s, "s": 10 * s,
                                          "e": 10 * s + 20}}) + "\n")
        for fr in range(0, 60):
            for p in range(3):
                f.write(json.dumps({"track": {"f": fr, "p": p,
                                              "x": 0.1 * fr + p,
                                              "y": 0.05 * fr - p}}) + "\n")
    assert_windows_equal(tds.trajnet_windows(str(nd), 4, 4),
                         jds.trajnet_windows(str(nd), 4, 4))


# --------------------------------------------------- schedules, rotation

def test_temperature_and_lr_schedule_match_jax():
    for args in ((0, 100, 0.5), (37, 100, 0.5), (100, 100, 0.5),
                 (200, 100, 0.5), (3, 8, 0.7)):
        assert ttrainer.temperature(*args) == jtrainer.temperature(*args)
    # temp_epochs 8, 3 steps an epoch: x0.3 at steps 6, 12, 18 and 24. The
    # JAX optimizer's update over plain Adam's on the same gradients is
    # -lr of that step (one f32 product apart)
    tx = jtrainer.make_optimizer(1e-3, 8, 3)
    adam = optax.scale_by_adam()
    params = {"w": jnp.zeros(())}
    state, a_state = tx.init(params), adam.init(params)
    lr_at = ttrainer.lr_schedule(1e-3, 8, 3)
    for step in range(27):
        g = {"w": jnp.asarray(np.cos(step) + 2.0, jnp.float32)}
        upd, state = tx.update(g, state, params)
        a_upd, a_state = adam.update(g, a_state, params)
        np.testing.assert_allclose(
            lr_at(step), -float(upd["w"]) / float(a_upd["w"]), rtol=1e-7,
            err_msg=f"step {step}")
    assert [lr_at(s) for s in (5, 6, 11, 12, 24, 30)] == pytest.approx(
        [1e-3, 3e-4, 3e-4, 9e-5, 8.1e-6, 8.1e-6])


def test_rotate_graph_matches_jax(windows):
    rng = np.random.RandomState(2)
    batch = next(tds.batches(windows[0], 4, rng))
    theta = rng.uniform(0, 2 * np.pi, 4).astype(np.float32)
    v_j, A_j = jtrainer.rotate_graph(jnp.asarray(batch["v"]),
                                     jnp.asarray(batch["A"]),
                                     jnp.asarray(theta))
    v_t, A_t = ttrainer.rotate_graph(torch.from_numpy(batch["v"]),
                                     torch.from_numpy(batch["A"]),
                                     torch.from_numpy(theta))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=1e-6,
                               atol=1e-6)
    out = ttrainer.random_rotate_batch(
        {k: torch.from_numpy(a) for k, a in batch.items()},
        torch.Generator().manual_seed(0), "right_angle")
    np.testing.assert_allclose(np.linalg.norm(out["v"].numpy(), axis=-1),
                               np.linalg.norm(batch["v"], axis=-1), atol=1e-5)


# ------------------------------------------------------- one Adam step

def _jax_init(jc, seed=0):
    return jax.jit(lambda k: jtrainer.init_params(jc, k, P))(
        jax.random.key(seed))


def _flat(tree):
    return flatten_tree(jax.tree.map(np.asarray, tree))


def test_one_adam_step_matches_jax(windows):
    """Loss, gradients and parameters after one Adam step at 1e-5 (each
    gradient leaf at 1e-5 of its largest entry: the node embedding's bias
    gradient reaches 14), from the same parameters and batch. The k bias's gradient is rounding noise in
    both packages (~1e-9), which Adam's first step turns into an update of
    lr * g / (|g| + 1e-8): any value in (-lr, lr). That leaf's update is
    held to that range, and the optimizer alone is held to optax on the
    JAX gradients, every leaf at 1e-7."""
    jc, tc = configs()
    params = _jax_init(jc)
    batch = next(jds.batches(windows[0], 4, np.random.RandomState(0)))
    jb = jax.tree.map(jnp.asarray, batch)
    tx = jtrainer.make_optimizer(1e-3, 100, 1)
    opt_state = tx.init(params)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jtrainer.loss_fn(jc, p, jb, 0.5, jax.random.key(0), False),
        has_aux=True))(params)
    step = jtrainer.make_train_step(jc, tx, deterministic_loss=False)
    new_j, _, _, _ = step(params, opt_state, jb, 0.5, jax.random.key(0))

    model = load_gst(tc, params, "cpu").train()
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    opt = ttrainer.make_optimizer(model, 1e-3)
    loss_t, _ = ttrainer.loss_fn(model, tb, 0.5, False)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-5)
    g_t = _flat(state_dict_to_tree(
        {n: p.grad for n, p in model.named_parameters()}))
    g_j = _flat(grads_j["params"])
    for k in g_j:           # 1e-5 of each leaf's largest entry
        np.testing.assert_allclose(g_t[k], g_j[k], rtol=0, err_msg=k,
                                   atol=1e-5 * np.abs(g_j[k]).max())
    opt.step()
    p0, p_t = _flat(params["params"]), _flat(state_dict_to_tree(
        model.state_dict()))
    p_j = _flat(new_j["params"])
    for k in p_j:
        if k == K_BIAS:
            D = jc.embedding_size
            for new in (p_t[k], p_j[k]):
                step_k = np.abs(new - p0[k])[D:2 * D]
                assert step_k.max() <= 1e-3 * (1 + 1e-6), k
            np.testing.assert_allclose(p_t[k][:D], p_j[k][:D], atol=1e-5)
            np.testing.assert_allclose(p_t[k][2 * D:], p_j[k][2 * D:],
                                       atol=1e-5)
        else:
            np.testing.assert_allclose(p_t[k], p_j[k], atol=1e-5, err_msg=k)

    # the optimizer alone: the port's Adam on the JAX gradients
    model = load_gst(tc, params, "cpu")
    opt = ttrainer.make_optimizer(model, 1e-3)
    sd_g = tree_to_state_dict(jax.tree.map(np.asarray, grads_j["params"]))
    for n, p in model.named_parameters():
        p.grad = sd_g[n].clone()
    opt.step()
    upd, _ = tx.update(grads_j, tx.init(params), params)
    p_j = _flat(optax.apply_updates(params, upd)["params"])
    p_t = _flat(state_dict_to_tree(model.state_dict()))
    for k in p_j:
        np.testing.assert_allclose(p_t[k], p_j[k], atol=1e-7, rtol=0,
                                   err_msg=k)


# ---------------------------------------------------------- whole runs

@pytest.fixture(scope="module")
def collected():
    """Windows of ORCA crowds from the port's collect (4 humans, 2 envs x
    64 steps, 8 slots), as tests/test_gst_training.py trains on."""
    data = collect_dataset(varnum_config(human_num=4), 2, 64, seed=0,
                           chunk=32, device="cpu")
    return [w for rows in data for w in tds.build_windows(rows, 5, 5, P)]


def test_train_matches_jax(collected, tmp_path):
    """Two epochs (30 Adam steps, the lr dropping x0.3 at step 15), no
    rotation, no edge heads, from the JAX init (``fold_in(key(seed), 0)``,
    as the JAX train() draws it), on collected ORCA windows, at lr 1e-4.

    Why 1e-4 and not the recipe's 1e-3: the recipe's f32 gradients are
    ill-conditioned at init in both packages. Every valid pedestrian's
    first-frame displacement is 0, so its embedding is the zero bias and
    the LayerNorm over it scales the gradient by 1 / sqrt(1e-6); the
    cancelling sums that follow leave both packages' f32 gradients 2-4% (of
    each leaf's largest entry) from the float64 gradient on these windows,
    and Adam turns that into parameter drift: at lr 1e-3 the port ends
    30 steps 5.5e-4 from the JAX run. At lr 1e-4 it ends 1.3e-7 away, while
    a wrong shuffle (seed 12) ends 2.6e-3 away and a wrong schedule
    (temp_epochs 8) 1.2e-3, so the check still sees the update sequence.
    The k bias is left out of
    the parameter check: its gradient is rounding noise in both packages
    (see test_one_adam_step_matches_jax) and its value does not change the
    model's output."""
    jc, tc = configs()
    train_w, val_w = collected, collected[:5]
    kw = dict(epochs=2, temp_epochs=4, lr=1e-4, batch_size=4, seed=11,
              save_epochs=10)
    p_j, h_j = jtrainer.train(jc, train_w, val_w, str(tmp_path / "j"),
                              **kw, max_peds=P, fused_epochs=False)
    init = jax.jit(lambda k: jtrainer.init_params(jc, k, P))(
        jax.random.fold_in(jax.random.key(11), 0))
    model, h_t = ttrainer.train(tc, train_w, val_w, str(tmp_path / "t"),
                                **kw, params=init, device="cpu")
    got = _flat(state_dict_to_tree(model.state_dict()))
    D = jc.embedding_size
    for k, v in _flat(p_j["params"]).items():
        if k == K_BIAS:
            got[k], v = np.delete(got[k], np.s_[D:2 * D]), \
                np.delete(v, np.s_[D:2 * D])
        np.testing.assert_allclose(got[k], v, atol=3e-4, err_msg=k)
    for k in h_j:
        np.testing.assert_allclose(h_t[k], h_j[k], rtol=2e-3, atol=2e-4,
                                   err_msg=k)


def _port_run(windows, out, **kw):
    _, tc = configs()
    args = dict(epochs=4, temp_epochs=4, lr=1e-3, batch_size=4, seed=7,
                save_epochs=2, rotation_pattern="random", device="cpu")
    args.update(kw)
    model, hist = ttrainer.train(tc, windows[0], windows[1], str(out), **args)
    return _flat(state_dict_to_tree(model.state_dict())), hist


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resume_reproduces_the_straight_run(windows, tmp_path):
    straight, h_s = _port_run(windows, tmp_path / "a")
    _port_run(windows, tmp_path / "b", epochs=2)
    resumed, h_r = _port_run(windows, tmp_path / "b", resume_epoch=2)
    _assert_same(straight, resumed)
    for k in ttrainer.HIST_KEYS:
        assert h_s[k] == h_r[k], k
    ck = tmp_path / "a" / "epoch_4"
    assert sorted(os.listdir(ck)) == ["opt_state.pt", "params.npz",
                                      "val_metrics.json"]
    with open(tmp_path / "a" / "train_hist.json") as f:
        assert json.load(f)["val_aoe"] == h_s["val_aoe"]


def test_resident_epochs_equal_host_batches(windows, tmp_path):
    resident, h_res = _port_run(windows, tmp_path / "r", epochs=2)
    host, h_host = _port_run(windows, tmp_path / "h", epochs=2,
                             host_batches=True)
    _assert_same(resident, host)
    for k in ttrainer.HIST_KEYS:
        assert h_res[k] == h_host[k], k


def test_evaluate_dataset_matches_jax(windows):
    jc, tc = configs()
    params = _jax_init(jc, 4)
    val = windows[0][:10]
    m_j = jeval.evaluate_dataset(jc, params, val, batch_size=4, mode="val")
    model = load_gst(tc, params, "cpu")
    m_t = teval.evaluate_dataset(model, val, batch_size=4, mode="val")
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k], m_j[k], atol=1e-4, err_msg=k)
    m = teval.evaluate_dataset(model, val, batch_size=4, mode="test",
                               num_samples=3)
    assert set(m) == {"loss", "aoe", "foe", "aoe_std", "foe_std", "aoe_min",
                      "foe_min"}
    assert all(np.isfinite(v) for v in m.values())
    assert m["aoe_min"] <= m["aoe"] and m["foe_min"] <= m["foe"]


# ----------------------------------------------------------------- CLIs

def test_trainer_and_eval_clis(data_dir, tmp_path, monkeypatch):
    """The trainer CLI at full width on a few windows, the written
    params.npz through load_gst, the eval CLI on the checkpoint (its val
    metrics against the ones stored beside it, and the same metrics from
    the weights written as a reference ``.pt`` through ``--torch-ckpt``),
    and the same file as the train and test CLIs' ``--gst-params``."""
    out = str(tmp_path / "run")
    hist = ttrainer.main(["--data-dir", str(data_dir), "--out", out,
                          "--epochs", "1", "--batch-size", "4",
                          "--max-windows", "8", "--max-val-windows", "6",
                          "--device", "cpu"])
    assert all(np.isfinite(v[0]) for v in hist.values())
    params = os.path.join(out, "epoch_1", "params.npz")
    model = load_gst(PredConfig(), params, "cpu")
    pos = torch.randn(2, 32, 5, 2)
    traj, mask = gst_predict(model, pos, torch.ones(2, 32, 5, dtype=bool))
    assert torch.isfinite(traj).all() and traj.shape == (2, 32, 5, 5)

    m = teval.main(["--data-dir", str(data_dir), "--split", "test",
                    "--mode", "val",
                    "--max-windows", "6", "--batch-size", "4",
                    "--ckpt", os.path.join(out, "epoch_1"),
                    "--device", "cpu"])
    with open(os.path.join(out, "epoch_1", "val_metrics.json")) as f:
        stored = json.load(f)
    np.testing.assert_allclose(m["aoe"], stored["val_aoe_epoch"], rtol=1e-5)
    np.testing.assert_allclose(m["foe"], stored["val_foe_epoch"], rtol=1e-5)
    # the same weights as a reference .pt give the same metrics
    from test_torch_utils_misc import save_reference_checkpoint
    pt = str(tmp_path / "reference" / "epoch_1.pt")
    save_reference_checkpoint(pt, load_npz(params))
    m_pt = teval.main(["--data-dir", str(data_dir), "--split", "test",
                       "--mode", "val", "--max-windows", "6",
                       "--batch-size", "4", "--torch-ckpt", pt,
                       "--device", "cpu"])
    assert m_pt == m

    loaded = []

    def record(cfg, path, device):
        loaded.append(path)
        return load_gst(cfg, path, device)
    monkeypatch.setattr(test_cli, "load_gst", record)
    monkeypatch.setattr(train_cli, "load_gst", record)
    res = test_cli.main(["--model-dir", test_cli.DEFAULT_MODEL_DIR,
                         "--test-case-size", "1", "--gst-params", params,
                         "--device", "cpu",
                         "--out-dir", str(tmp_path / "eval")])
    assert np.isfinite(res["success_rate"])
    train_cli.main(["--human-num", "4", "--num-processes", "2",
                    "--num-steps", "2", "--num-env-steps", "4",
                    "--gst-params", params, "--output-dir",
                    str(tmp_path / "ppo"), "--device", "cpu"])
    assert loaded == [params, params]


# ------------------------------------------------------------- PECNet

def test_pecnet_data_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    rows = []
    for pid in range(1, 13):
        x0, y0 = rng.uniform(0, 50, 2) + (pid > 6) * 1000.0
        t0 = rng.choice([0, 12, 600])
        for t in range(20):
            rows.append([t0 + 12 * t, pid, x0 + rng.uniform(-1, 1) * t,
                         y0 + rng.uniform(-1, 1) * t])
    scene = str(tmp_path / "scene.txt")
    np.savetxt(scene, np.asarray(rows), delimiter=" ")
    got = tpd.collect_social_batches([scene], batch_size=8)
    exp = jpd.collect_social_batches([scene], batch_size=8)
    for a, b in zip(got, exp):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    tpd.save_social_pickle(str(tmp_path / "t.pickle"), *got)
    jpd.save_social_pickle(str(tmp_path / "j.pickle"), *exp)
    x = tpd.load_social_pickle(str(tmp_path / "j.pickle"))
    y = jpd.load_social_pickle(str(tmp_path / "t.pickle"))
    assert set(x) == set(y)
    for k in x:
        assert len(x[k]) == len(y[k]) > 0
        for a, b in zip(x[k], y[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    block = np.kron(np.eye(3), np.ones((2, 2)))
    assert tpd.split_square_block_matrix(block) == \
        jpd.split_square_block_matrix(block)
