"""The plain reference held against the port at a tiny size on the CPU
(the port's plain branches in float32: the einsum attention, the GST with
float32 products), for the attention graph with the GST and for DS-RNN
without one, and a fault seeded in the port caught by the check."""

import dataclasses
import json
import os
import time

import pytest
import torch

from conftest import SRNN, tiny_config, tiny_mix
import calibrate
import reference.config as rconfig
import reference.crowd_sim as rsim
import reference.policy as rpolicy
import reference.policy_net as rpolicy_net
import reference.ppo as rppo
import reference.predictor as rpred
from harness import check, models, port, runner
from harness.record import snap
from harness.spec import ROOT

P = port.import_port()


def _cfgs(cell, tmp_path, root):
    path = tiny_config(cell, tmp_path, root)
    pc = P["config"].config_from_snapshot(path)
    rc = rconfig.config_from_snapshot(path)
    # the plain branches: the einsum attention, float32 GST products
    pc = pc.replace(network=dataclasses.replace(
        pc.network, use_pallas_attention=False),
        pred=dataclasses.replace(pc.pred, matmul_dtype="f32"))
    rc = rc.replace(pred=dataclasses.replace(rc.pred, matmul_dtype="f32"))
    return path, pc, rc


@pytest.fixture
def cfgs(tmp_path):
    return _cfgs("flagship-train", tmp_path, ROOT)


# the attention graph in the GST env, and DS-RNN in CrowdSimVarNum
@pytest.fixture(params=["flagship-train", SRNN])
def both_cfgs(request, tmp_path, all_cells):
    return _cfgs(request.param, tmp_path, all_cells)


def _states(pc, rc, n=3):
    gens = [check._seeded(check.case_seed(7, i, "train")) for i in range(n)]
    rgens = [check._seeded(check.case_seed(7, i, "train")) for i in range(n)]
    return (P["crowd_sim"].reset(pc, gens, torch.device("cpu")),
            rsim.reset(rc, rgens, torch.device("cpu")))


def test_reset_and_steps_equal(both_cfgs):
    _, pc, rc = both_cfgs
    (ps, _), (rs, _) = _states(pc, rc)
    g, n = check._gap(snap(ps), snap(rs))
    assert g == 0.0 and n == 0
    action = torch.tensor([[0.5, -0.2], [0.0, 1.0], [-0.7, 0.1]])
    for phase in ("train", "test"):
        out_p = P["crowd_sim"].step(pc, ps, action, phase)
        out_r = rsim.step(rc, rs, action, phase)
        for a, b in zip(out_p, out_r):
            g, n = check._gap(snap(a), snap(b))
            assert g == 0.0 and n == 0, phase


def test_gst_equal(cfgs):
    path, pc, rc = cfgs
    with open(path) as f:
        gst_path = json.load(f)["benchmark"]["gst_weights"]
    gst_path = os.path.join(ROOT, gst_path)
    pg = P["predictor"].load_gst(pc.pred, gst_path, "cpu")
    rg = rpred.load_gst(rc.pred, gst_path, "cpu")
    gen = torch.Generator().manual_seed(3)
    traj = torch.randn(3, 4, 5, 2, generator=gen) * 3.0
    mask = torch.rand(3, 4, 5, generator=gen) > 0.2
    a = P["predictor"].gst_predict(pg, traj, mask)
    b = rpred.gst_predict(rg, traj, mask)
    torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(a[1], b[1])


def _policies(pc, rc):
    shapes = rpolicy.PolicyHead(rc)
    sd = port.draw_policy_state(shapes, 11, "cpu")
    pm = P["policy"].PolicyHead(pc)
    pm.load_state_dict(sd)
    rm = rpolicy.PolicyHead(rc)
    rm.load_state_dict(sd)
    return pm, rm


def test_policy_and_loss_equal(both_cfgs):
    """One set of seeded weights in both: the forward's value, mean, logstd
    and new hiddens, the act's outputs, the PPO loss and every gradient,
    from drawn hiddens with one env's done mask 0. Both sides compute in
    float32 with the same operations in the same order, so they differ by
    float32 rounding alone (1e-5 relative)."""
    _, pc, rc = both_cfgs
    pm, rm = _policies(pc, rc)
    (ps, pobs), _ = _states(pc, rc)
    obs = P["policy_net"].obs_to_dict(pobs)
    gen = torch.Generator().manual_seed(5)
    hxs = {k: torch.randn(v.shape, generator=gen) for k, v in
           P["policy_net"].init_hidden(pc, 3, "cpu").items()}
    assert set(hxs) == set(rpolicy_net.init_hidden(rc, 3, "cpu"))
    masks = torch.tensor([1.0, 0.0, 1.0])
    with torch.no_grad():
        fp = pm({k: v[None] for k, v in obs.items()}, hxs, masks[None])
        fr = rm({k: v[None] for k, v in obs.items()}, hxs, masks[None])
    for x, y in zip(fp[:3], fr[:3]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    assert set(fp[3]) == set(fr[3]) == set(hxs)
    for k in hxs:
        torch.testing.assert_close(fp[3][k], fr[3][k], rtol=1e-5, atol=1e-5)
    a = P["policy"].act(pm, obs, hxs, masks, deterministic=True)
    b = rpolicy.act(rm, obs, hxs, masks, deterministic=True)
    for x, y in zip(a[:3], b[:3]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    # the PPO loss of both on one batch, and its gradients
    T, N = 2, 3
    batch_obs = {k: torch.stack([v] * (T + 1)) for k, v in obs.items()}
    kw = dict(obs=batch_obs, hxs0=hxs,
              actions=torch.randn(T, N, 2, generator=gen),
              log_probs=torch.randn(T, N, 1, generator=gen),
              values=torch.randn(T + 1, N, 1, generator=gen),
              rewards=torch.randn(T, N, generator=gen),
              masks=torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0],
                                  [1.0, 1.0, 1.0]]),
              bad_masks=torch.ones(T + 1, N))
    pb = P["ppo"].RolloutBatch(**kw, done_returns=torch.zeros(T, N),
                               done_returns_env=torch.zeros(T, N))
    rb = rppo.RolloutBatch(**kw)
    idx = torch.tensor([0, 1])
    ret_p, adv_p = P["ppo"].advantages(pc, pb)
    ret_r, adv_r = rppo.advantages(rc, rb)
    torch.testing.assert_close(adv_p, adv_r)
    lp, _ = P["ppo"].ppo_loss(pc, pm, pb, ret_p, adv_p, idx)
    lr, _ = rppo.ppo_loss(rc, rm, rb, ret_r, adv_r, idx)
    torch.testing.assert_close(lp, lr, rtol=1e-5, atol=1e-6)
    lp.backward()
    lr.backward()
    gr = {n: p.grad for n, p in rm.named_parameters()}
    for n, p in pm.named_parameters():
        assert (p.grad is None) == (gr[n] is None), n
        if p.grad is not None:
            torch.testing.assert_close(p.grad, gr[n], rtol=1e-5, atol=1e-6,
                                       msg=n)


def test_the_reference_imports_nothing_of_the_port_or_jax():
    import subprocess
    import sys
    from conftest import BENCH
    code = ("import sys; sys.path.insert(0, %r); import reference.policy, "
            "reference.vector, reference.ppo, reference.crowd_sim; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = eval(out)
    assert not {"jax", "flax", "crowdnav_prediction_attngraph_tpu",
                "crowdnav_prediction_attngraph_tpu_torch"} & set(tops)


def test_a_fault_in_the_port_is_caught(tmp_path, monkeypatch):
    """A step that leaves the humans where they were reads far above the
    sound step's number."""
    path = tiny_config("flagship-train", tmp_path)

    def numbers():
        import time
        res = runner.execute("flagship-train", 4242424242, 0.5, False,
                             torch.device("cpu"), time.perf_counter(),
                             config_path=path,
                             mix_overrides=tiny_mix("flagship-train"))
        return {k: v["value"] for k, v in res["checks"].items()}

    sound = numbers()
    step = P["crowd_sim"].step

    def frozen(cfg, state, action, phase, robot_policy="network",
               spin_coef=None):
        out = step(cfg, state, action, phase, robot_policy, spin_coef)
        st = out[0]
        st = dataclasses.replace(st, humans=dataclasses.replace(
            st.humans, pos=state.humans.pos))
        return (st,) + tuple(out[1:])

    monkeypatch.setattr(P["crowd_sim"], "step", frozen)
    faulty = numbers()
    assert sound["env"] < 1e-3 < faulty["env"]


def test_a_configuration_without_the_gst_is_checked_without_it(tmp_path,
                                                                all_cells):
    """The DS-RNN fixture (no GST) runs through the ``ppo_train`` driver
    and the check, which compares the numbers its limits name and reads no
    ``gst`` number at all (not one read as 0). The numbers are a sound
    run's: the env and the act bit-equal, as on the card; the update's
    within float32 rounding, which at this tiny size (losses near 0) reads
    up to 1e-5, where the card's 64 envs read 1e-7 and its limits are set."""
    path = tiny_config(SRNN, tmp_path, all_cells)
    res = runner.execute(SRNN, 1414213562, 0.5, False, torch.device("cpu"),
                         time.perf_counter(), config_path=path,
                         mix_overrides=tiny_mix(SRNN, all_cells),
                         root=all_cells)
    assert set(res["checks"]) == {"env", "act", "loss", "grad", "update",
                                  "batch"}
    nums = calibrate.readings(SRNN, 1414213562, 0.5, torch.device("cpu"), (),
                              config_path=path,
                              mix_overrides=tiny_mix(SRNN, all_cells),
                              root=all_cells)["program"]
    assert set(nums) == set(res["checks"])
    for k, v in nums.items():
        assert v == res["checks"][k]["value"], k
    assert nums["env"] == nums["act"] == nums["batch"] == 0.0, nums
    assert max(nums["loss"], nums["grad"], nums["update"]) < 1e-4, nums


@pytest.mark.parametrize("weights", ["gst_weights_left_out",
                                     "gst_weights_without_a_gst"])
def test_gst_weights_follow_the_predictor(weights, tmp_path, all_cells):
    """``gst_weights`` is required where the GST runs and refused where it
    does not."""
    cell = "flagship-train" if weights == "gst_weights_left_out" else SRNN
    path = tiny_config(cell, tmp_path, all_cells)
    with open(path) as f:
        d = json.load(f)
    if weights == "gst_weights_left_out":
        del d["benchmark"]["gst_weights"]
    else:
        d["benchmark"]["gst_weights"] = "x.npz"
    with open(path, "w") as f:
        json.dump(d, f)
    with pytest.raises(SystemExit, match="gst_weights"):
        runner.execute(cell, 1, 0.5, False, torch.device("cpu"),
                       time.perf_counter(), config_path=path,
                       mix_overrides=tiny_mix(cell, all_cells),
                       root=all_cells)


def test_reference_bases_are_found_by_name():
    from reference.bases import srnn
    from reference.policy_net import SelfAttnMergeSRNN
    assert rpolicy.base_class("srnn") is srnn.Base
    assert rpolicy.base_class("selfAttn_merge_srnn") is SelfAttnMergeSRNN
    for name in ("no_such_base", "../policy", "policy_net"):
        with pytest.raises(ValueError, match="unknown robot policy"):
            rpolicy.base_class(name)
