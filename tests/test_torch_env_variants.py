"""The BASELINE env variants and the scripted robots: the port's crowd_sim
against the JAX package's, by state injection.

JAX envs are reset (3 envs, 4-6 humans), their EnvState converted to the
port's (tests/test_torch_slice.py's ``to_port_state``) and both packages
run the same function from the same state. Random and end goal changes are
off, so a step draws no random number that matters, and no step lands on a
5 s population event. Bounds:

* 2e-5 on what involves no ORCA solve: the const-vel future, observations
  of the ``none`` / ``const_vel`` envs (relative positions and the 15.0
  fill), social-force velocities of humans and robot (f32 sums in another
  order);
* ORCA velocities (humans, the truth rollout, the scripted ORCA robot):
  2e-4, the bound of tests/test_torch_orca.py for egos whose LP2 is
  feasible, with that file's LP3 near-tie allowance: at most one ego per
  call may sit on another near-tied line, held to 2e-2;
* observations and rewards that went through ORCA, after a step: 1e-3, as
  tests/test_torch_slice.py; done and outcome exactly.

The varying human count draws from torch generators, not threefry, so
``vary_human_num`` is compared by its invariants and by the set of counts
each package reaches from the same state under both max-remove rules.
``evaluate`` runs each scripted robot on 2 cases end to end.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crowdnav_prediction_attngraph_tpu import config as jconfig
from crowdnav_prediction_attngraph_tpu.env import crowd_sim as j_cs
from crowdnav_prediction_attngraph_tpu_torch import config as tconfig
from crowdnav_prediction_attngraph_tpu_torch.algo import evaluation
from crowdnav_prediction_attngraph_tpu_torch.env import crowd_sim as t_cs
from crowdnav_prediction_attngraph_tpu_torch.env.types import tree_where
from test_torch_slice import to_port_state

B = 3


def configs(builder, *args, humans=None, robot=None, orca=None, **kw):
    """The same config in both packages, goal changes off, plus overrides of
    the humans / robot / orca groups."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = getattr(mod, builder)(*args, **kw)
        cfg = cfg.replace(humans=dataclasses.replace(
            cfg.humans, random_goal_changing=False, end_goal_changing=False,
            **(humans or {})))
        if robot:
            cfg = cfg.replace(robot=dataclasses.replace(cfg.robot, **robot))
        if orca:
            cfg = cfg.replace(orca=dataclasses.replace(cfg.orca, **orca))
        out.append(cfg)
    return out


CASES = {
    "varnum": ("varnum_config", (), dict(human_num=4)),
    "const_vel": ("pred_config", ("const_vel",), dict(human_num=4)),
    "truth": ("pred_config", ("truth",), dict(human_num=4)),
    "visible_robot": ("pred_config", ("truth",),
                      dict(human_num=4, robot=dict(visible=True))),
    "social_force": ("varnum_config", (),
                     dict(human_num=4, humans=dict(policy="social_force"))),
    "varying": ("varnum_config", (), dict(human_num=4, human_num_range=2)),
}
_jax_fns = {}


def setup_case(name, seed=0, steps=4):
    """(jc, tc, JAX states after ``steps`` JAX steps of random actions from a
    reset, the vmapped JAX step): mid-episode states with real beliefs,
    velocities and (for the varying case) a drawn human count."""
    builder, args, kw = CASES[name]
    jc, tc = configs(builder, *args, **kw)
    if name not in _jax_fns:
        _jax_fns[name] = (
            jax.jit(jax.vmap(lambda k: j_cs.reset(jc, k))),
            {ph: jax.jit(jax.vmap(lambda s, a, ph=ph: j_cs.step(jc, s, a, ph)))
             for ph in ("train", "test")})
    j_reset, j_step = _jax_fns[name]
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(B))
    js, _ = j_reset(keys)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        js = j_step["train"](js, jnp.asarray(
            rng.uniform(-1, 1, (B, 2)).astype(np.float32)))[0]
    return jc, tc, js, j_step


def port(js):
    return to_port_state(js, [torch.Generator().manual_seed(i)
                              for i in range(B)])


def assert_orca_close(got, expect, what):
    """ORCA velocities: 2e-4, one near-tied LP3 ego allowed up to 2e-2."""
    err = np.abs(np.asarray(got) - np.asarray(expect)).reshape(-1, 2).max(-1)
    assert err.max() <= 2e-2, (what, err.max())
    assert (err > 2e-4).sum() <= 1, (what, err)


def assert_obs_close(got, jo, atol):
    for f in ("robot_node", "temporal_edges", "spatial_edges"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(jo, f)), atol=atol,
                                   err_msg=f)
    np.testing.assert_array_equal(got.visible_masks.numpy(),
                                  np.asarray(jo.visible_masks))
    np.testing.assert_array_equal(got.detected_human_num.numpy(),
                                  np.asarray(jo.detected_human_num))


@pytest.mark.parametrize("name", ["varnum", "const_vel", "truth"])
@pytest.mark.parametrize("sort_humans", [True, False])
def test_generate_ob_matches_jax(name, sort_humans):
    jc, tc, js, _ = setup_case(name)
    jc, tc = (c.replace(network=dataclasses.replace(
        c.network, sort_humans=sort_humans)) for c in (jc, tc))
    jo, js2 = jax.vmap(lambda s: j_cs.generate_ob(jc, s, False))(js)
    to, ts2 = t_cs.generate_ob(tc, port(js), reset=False)
    # the truth future goes through the ORCA rollout
    assert_obs_close(to, jo, 1e-3 if name == "truth" else 2e-5)
    np.testing.assert_allclose(ts2.last_human_states.numpy(),
                               np.asarray(js2.last_human_states), atol=2e-5)
    np.testing.assert_allclose(ts2.prev_human_states.numpy(),
                               np.asarray(js2.prev_human_states), atol=0)
    assert to.spatial_edges.shape[-1] == tc.spatial_edge_dim
    if name != "varnum":
        np.testing.assert_allclose(ts2.human_future_traj.numpy(),
                                   np.asarray(js2.human_future_traj),
                                   atol=1e-3 if name == "truth" else 2e-5)


@pytest.mark.parametrize("name,method", [("const_vel", "const_vel"),
                                         ("visible_robot", "const_vel"),
                                         ("visible_robot", "truth")])
def test_future_traj_matches_jax(name, method):
    jc, tc, js, _ = setup_case(name, seed=1)
    vis = js.visible_masks
    expect = jax.vmap(lambda s, v: j_cs.calc_human_future_traj(
        jc, s, v, method))(js, vis)
    got = t_cs.calc_human_future_traj(tc, port(js), torch.from_numpy(
        np.array(vis)), method)
    if method == "const_vel":
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=2e-5)
    else:   # frames after the first are ORCA positions and velocities
        assert_orca_close(got[:, 1:, ..., 2:], expect[:, 1:, ..., 2:],
                          "truth rollout velocities")
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-3)


@pytest.mark.parametrize("name", ["social_force", "visible_robot", "varying"])
def test_human_actions_match_jax(name):
    """Social-force humans, and ORCA humans with the robot's column (the
    visible robot) or a partly active crowd."""
    jc, tc, js, _ = setup_case(name, seed=2)
    expect = jax.vmap(lambda s: j_cs.get_human_actions(jc, s))(js)
    got = t_cs.get_human_actions(tc, port(js))
    if name == "social_force":
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=2e-5)
    else:
        assert_orca_close(got, expect, name)
    if name == "varying":
        assert int(np.asarray(js.human_num).min()) < tc.sim.max_human_num


@pytest.mark.parametrize("name,policy,stale", [
    ("varnum", "orca", False), ("varnum", "orca", True),
    ("truth", "orca", False), ("const_vel", "orca", False),
    ("varnum", "social_force", False), ("social_force", "social_force", False)])
def test_scripted_robot_action_matches_jax(name, policy, stale):
    builder, args, kw = CASES[name]
    jc, tc, js, _ = setup_case(name, seed=3)
    if stale:
        jc, tc = configs(builder, *args, orca=dict(stale_neighbor_radii=True),
                         **kw)
    expect = jax.vmap(lambda s: j_cs.scripted_robot_action(jc, s, policy))(js)
    got = t_cs.scripted_robot_action(tc, port(js), policy)
    if policy == "orca":
        assert_orca_close(got, expect, name)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=2e-5)


def test_stale_radii_are_the_jax_draws():
    for A in (5, 20):
        np.testing.assert_array_equal(
            t_cs.stale_neighbor_radii(A).numpy(),
            np.asarray(jax.random.uniform(jax.random.key(0), (A,),
                                          minval=0.3, maxval=0.5)))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("phase", ["train", "test"])
def test_state_injected_step_matches_jax(name, phase):
    jc, tc, js, j_step = setup_case(name, seed=4)
    rng = np.random.RandomState(5)
    for _ in range(2):
        action = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
        js2, jo2, jrew, jdone, jinfo = j_step[phase](js, jnp.asarray(action))
        ts2, to2, trew, tdone, tinfo = t_cs.step(
            tc, port(js), torch.from_numpy(action), phase)
        assert_obs_close(to2, jo2, 1e-3)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-3)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tinfo.outcome.numpy(),
                                      np.asarray(jinfo.outcome))
        np.testing.assert_allclose(ts2.humans.pos.numpy(),
                                   np.asarray(js2.humans.pos), atol=1e-3)
        np.testing.assert_array_equal(ts2.human_num.numpy(),
                                      np.asarray(js2.human_num))
        js = js2


@pytest.mark.parametrize("name,policy", [("varnum", "orca"),
                                         ("truth", "orca"),
                                         ("varnum", "social_force")])
def test_scripted_step_matches_jax(name, policy):
    jc, tc, js, _ = setup_case(name, seed=6)
    js2, jo2, jrew, jdone, _ = jax.jit(jax.vmap(
        lambda s: j_cs.step(jc, s, jnp.zeros(2), "test", policy)))(js)
    ts2, to2, trew, tdone, _ = t_cs.step(tc, port(js), torch.zeros(B, 2),
                                         "test", policy)
    assert_orca_close(ts2.robot.vel, js2.robot.vel, "robot velocity") \
        if policy == "orca" else np.testing.assert_allclose(
            ts2.robot.vel.numpy(), np.asarray(js2.robot.vel), atol=2e-5)
    assert_obs_close(to2, jo2, 1e-3)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-3)
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))


def test_calc_reward_social_term_matches_jax():
    """The CrowdSimPred social penalty on a future that hits the robot."""
    jc, tc, js, _ = setup_case("const_vel", seed=7)
    fut = np.array(js.human_future_traj)
    # pull human 0's future frames 1..K onto the robot, at growing offsets
    K = tc.sim.predict_steps
    offs = np.linspace(0.0, 0.8, K)[None, :, None]
    fut[:, 1:, 0, :2] = np.asarray(js.robot.pos)[:, None] + offs
    js = js.replace(human_future_traj=jnp.asarray(fut))
    expect = jax.vmap(lambda s: j_cs.calc_reward(
        jc, s, 0.0, 0.0, s.human_future_traj, "train"))(js)
    got = t_cs.calc_reward(tc, port(js), torch.from_numpy(fut), "train")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(expect[0]),
                               atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(expect[1]))
    assert (got[0].numpy() < -2.0).all()       # the social term bit


@pytest.mark.parametrize("pred_rule", [False, True])
def test_vary_human_num_counts_and_invariants(pred_rule):
    """From the same state, both packages reach the same set of human
    counts over 400 draws; the port keeps every seen human, gives new slots
    fresh beliefs and leaves the humans it keeps untouched."""
    jc, tc, js, _ = setup_case("varying", seed=8)
    A, lo = tc.sim.max_human_num, tc.sim.min_human_num
    n = 400
    one = jax.tree.map(lambda x: x[0], js)
    keys = jax.random.split(jax.random.key(9), n)
    j_nums = set(np.asarray(jax.jit(jax.vmap(lambda k: j_cs.vary_human_num(
        jc, k, one, pred_rule).human_num))(keys)).tolist())
    ts = port(jax.tree.map(lambda x: jnp.repeat(x[:1], n, axis=0), js))
    ts = dataclasses.replace(ts, gens=[torch.Generator() for _ in range(n)])
    u = torch.from_numpy(np.random.RandomState(10).uniform(
        size=(n, t_cs.vary_draws(tc))).astype(np.float32))
    out = t_cs.vary_human_num(tc, u, ts, pred_rule)
    assert set(out.human_num.tolist()) == j_nums
    n0 = int(ts.human_num[0])
    nums = out.human_num
    assert ((nums >= (0 if pred_rule else lo)) & (nums <= A)).all()
    vis = ts.visible_masks[0]
    if vis.any():
        assert (nums > int(vis.nonzero().max())).all()
    idx = torch.arange(A)
    new = (idx[None] >= n0) & (idx[None] < nums[:, None])
    dummy = torch.tensor(t_cs.BELIEF_DUMMY)
    assert torch.equal(out.last_human_states[new],
                       dummy.expand(int(new.sum()), 5))
    kept = idx < n0
    torch.testing.assert_close(out.humans.pos[:, kept], ts.humans.pos[:, kept])
    # a selected env takes the event, the others keep their state
    sel = torch.arange(n) % 2 == 0
    mixed = tree_where(sel, out, ts)
    assert torch.equal(mixed.human_num[~sel], ts.human_num[~sel])


def test_reset_draws_a_varying_human_count():
    _, tc = configs("gst_config", human_num=30, human_num_range=20)
    gens = [evaluation.case_generator(425, i) for i in range(64)]
    state, obs = t_cs.reset(tc, gens, "cpu")
    nums = state.human_num
    assert ((nums >= 10) & (nums <= 50)).all() and len(set(nums.tolist())) > 5
    assert obs.spatial_edges.shape == (64, 50, tc.spatial_edge_dim)
    active = torch.arange(50)[None] < nums[:, None]
    assert (state.humans.pos[~active] == 15.0).all()


@pytest.mark.parametrize("policy", ["orca", "social_force"])
def test_evaluate_scripted_robot_two_cases(policy):
    _, tc = configs("varnum_config", human_num=5)
    res = evaluation.evaluate(tc, None, None, test_size=2, device="cpu",
                              log=lambda m: None, robot_policy=policy)
    rates = [res[k] for k in ("success_rate", "collision_rate",
                              "timeout_rate")]
    assert abs(sum(rates) - 1.0) < 1e-6 and res["env_steps"] > 0
    assert np.isfinite(res["path_length"]) and res["path_length"] > 0
