"""The unicycle robot: the port against the JAX package.

* ``step_unicycle`` and ``clip_unicycle_action`` on seeded batches that hold
  straight steps (|r| < 1e-4, turn radius 0), turns and backward speeds:
  atol 1e-5 (f32 trigonometry of another library). The position of a
  turning step is R (sin(theta + r) - sin(theta)) with R = v dt / r, so a
  one-ulp difference of the two libraries' sines is amplified by R (242 m
  at r = 3e-4): its bound is 1e-5 + 2 ulp(1) x |R|.
* ``crowd_sim.step`` by state injection (tests/test_torch_slice.py's
  ``to_port_state``): JAX envs are reset (3 envs, 4 humans, goal changes
  off, so a step draws no random number that matters), stepped on, and
  each step is compared from the same injected state with the same
  action, in the train and the test phase: rewards and positions 1e-3
  (ORCA humans, tests/test_torch_slice.py's bound), ``desired_velocity``
  and theta 1e-5, done and outcome exactly. The actions drive the speed
  backwards and turn, and the rewards are checked to hold the spin and
  backward terms.
* ``calc_reward`` at spin_coef 0, 2.25 and None: atol 1e-6, as
  tests/test_unicycle.py:67-84.
* The rollout's annealed spin coefficient against the JAX formula
  (``ppo.py:106-114``) at total_steps 0, warmup / 2, warmup and 2 x warmup.
* ``reset`` and ``end_goal_updates`` draw from torch generators, not
  threefry, so they are compared by their invariants in both packages:
  the human count on [1, max_human_num], the robot on the arena circle,
  the goal >= 4 m away, a uniform heading; reached humans are re-goaled,
  not respawned.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crowdnav_prediction_attngraph_tpu import config as jconfig
from crowdnav_prediction_attngraph_tpu.env import crowd_sim as j_cs
from crowdnav_prediction_attngraph_tpu.env import kinematics as j_kin
from crowdnav_prediction_attngraph_tpu_torch import config as tconfig
from crowdnav_prediction_attngraph_tpu_torch.algo import ppo as t_ppo
from crowdnav_prediction_attngraph_tpu_torch.env import crowd_sim as t_cs
from crowdnav_prediction_attngraph_tpu_torch.env import kinematics as t_kin
from crowdnav_prediction_attngraph_tpu_torch.env import vector
from test_torch_slice import to_port_state

B = 3


def configs(builder="varnum_config", goal_changes=False, **kw):
    """The same unicycle config in both packages (4 humans by default),
    goal changes off unless ``goal_changes``."""
    kw.setdefault("human_num", 4)
    out = []
    for mod in (jconfig, tconfig):
        cfg = getattr(mod, builder)(**kw)
        cfg = cfg.replace(action_space=dataclasses.replace(
            cfg.action_space, kinematics="unicycle"))
        if not goal_changes:
            cfg = cfg.replace(humans=dataclasses.replace(
                cfg.humans, random_goal_changing=False,
                end_goal_changing=False))
        out.append(cfg)
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


def port(js, seed=0):
    return to_port_state(js, [torch.Generator().manual_seed(seed + i)
                              for i in range(B)])


def jax_states(jc, seed, steps=3):
    """JAX states ``steps`` train steps after a reset, with speed built up."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(B))
    js, _ = jax.jit(jax.vmap(lambda k: j_cs.reset(jc, k)))(keys)
    step = jax.jit(jax.vmap(lambda s, a: j_cs.step(jc, s, a, "train")))
    for _ in range(steps):
        js = step(js, jnp.tile(jnp.array([[0.08, 0.03]]), (B, 1)))[0]
    return js


def test_step_unicycle_matches_jax():
    rng = np.random.RandomState(0)
    n = 64
    pos = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    v = rng.uniform(-0.6, 1.0, n).astype(np.float32)
    r = rng.uniform(-0.06, 0.06, n).astype(np.float32)
    r[:8] = 0.0                                   # straight: radius 0
    r[8:16] = rng.uniform(-9e-5, 9e-5, 8)         # under the 1e-4 threshold
    r[16:20] = [1e-4, -1e-4, 1.5e-4, -2.5]        # at and past it
    theta[20:24] = [0.0, 2 * np.pi - 1e-3, 6.28, 3.0]
    expect = jax.vmap(lambda p, t, a, b: j_kin.step_unicycle(
        p, t, a, b, 0.25))(*map(jnp.asarray, (pos, theta, v, r)))
    got = t_kin.step_unicycle(*map(torch.from_numpy, (pos, theta, v, r)),
                              0.25)
    radius = np.divide(v * 0.25, r, out=np.zeros_like(r),
                       where=np.abs(r) >= 1e-4)
    pos_err = np.abs(got[0].numpy() - np.asarray(expect[0])).max(-1)
    assert np.all(pos_err <= 1e-5 + 2 * 2.0 ** -23 * np.abs(radius)), pos_err
    for g, e, name in zip(got[1:], expect[1:], ("theta", "vel")):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5,
                                   err_msg=name)
    # a straight step leaves the robot where it was (agent.py:158-165)
    np.testing.assert_array_equal(got[0][:16].numpy(), pos[:16])
    assert float(got[1].min()) >= 0.0 and float(got[1].max()) < 2 * np.pi


def test_clip_unicycle_action_matches_jax():
    raw = np.random.RandomState(1).uniform(-0.3, 0.3, (32, 2)).astype(
        np.float32)
    raw[0] = [5.0, -5.0]
    expect = jax.vmap(j_kin.clip_unicycle_action)(jnp.asarray(raw))
    got = t_kin.clip_unicycle_action(torch.from_numpy(raw))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), [0.087, -0.06], atol=1e-6)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_state_injected_steps_match_jax(phase):
    jc, tc = configs()
    js = jax_states(jc, seed=5)
    j_step = jax.jit(jax.vmap(lambda s, a: j_cs.step(jc, s, a, phase)))
    j_step0 = jax.jit(jax.vmap(lambda s, a: j_cs.step(
        jc, s, a, phase, spin_coef=jnp.float32(0.0))))
    rng = np.random.RandomState(6)
    saw_backward = False
    for t in range(6):
        # push the speed down to negative values, turning both ways
        dv = -0.1 if t < 4 else 0.05
        action = np.stack([np.full(B, dv), rng.uniform(-0.1, 0.1, B)],
                          -1).astype(np.float32)
        js2, jo2, jrew, jdone, jinfo = j_step(js, jnp.asarray(action))
        ts2, to2, trew, tdone, tinfo = t_cs.step(
            tc, port(js), torch.from_numpy(action), phase)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-3)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tinfo.outcome.numpy(),
                                      np.asarray(jinfo.outcome))
        np.testing.assert_allclose(ts2.desired_velocity.numpy(),
                                   np.asarray(js2.desired_velocity), atol=1e-5)
        np.testing.assert_allclose(ts2.robot.theta.numpy(),
                                   np.asarray(js2.robot.theta), atol=1e-5)
        for name in ("pos", "vel"):
            np.testing.assert_allclose(
                getattr(ts2.robot, name).numpy(),
                np.asarray(getattr(js2.robot, name)), atol=1e-3, err_msg=name)
        np.testing.assert_allclose(ts2.humans.pos.numpy(),
                                   np.asarray(js2.humans.pos), atol=1e-3)
        for f in ("robot_node", "temporal_edges", "spatial_edges"):
            np.testing.assert_allclose(getattr(to2, f).numpy(),
                                       np.asarray(getattr(jo2, f)), atol=1e-3,
                                       err_msg=f)
        np.testing.assert_array_equal(to2.visible_masks.numpy(),
                                      np.asarray(jo2.visible_masks))
        # the spin term: the same step at coefficient 0 differs by 4.5 r^2
        _, _, trew0, _, _ = t_cs.step(tc, port(js), torch.from_numpy(action),
                                      phase, spin_coef=0.0)
        _, _, jrew0, _, _ = j_step0(js, jnp.asarray(action))
        r = np.clip(action[:, 1], -0.06, 0.06)
        np.testing.assert_allclose((trew - trew0).numpy(), -4.5 * r ** 2,
                                   atol=1e-6)
        np.testing.assert_allclose((trew - trew0).numpy(),
                                   np.asarray(jrew - jrew0), atol=1e-6)
        saw_backward |= bool((ts2.desired_velocity < 0).any())
        js = js2
    assert saw_backward


@pytest.mark.parametrize("coef", [0.0, 2.25, None])
def test_calc_reward_spin_and_backward_terms_match_jax(coef):
    jc, tc = configs()
    js = jax_states(jc, seed=7)
    rng = np.random.RandomState(8)
    v = np.array([-0.4, 0.3, -0.05], np.float32)
    r = rng.uniform(-0.06, 0.06, B).astype(np.float32)
    fut = np.asarray(js.human_future_traj)
    j_coef = None if coef is None else jnp.float32(coef)
    expect = jax.vmap(lambda s, a, b, f: j_cs.calc_reward(
        jc, s, a, b, f, "train", spin_coef=j_coef))(
            js, jnp.asarray(v), jnp.asarray(r), jnp.asarray(fut))
    got = t_cs.calc_reward(tc, port(js), _t(fut), "train", _t(v), _t(r),
                           coef)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(expect[0]),
                               atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(expect[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(expect[2]),
                               atol=1e-6)
    # the backward term: -2 |v| on the envs driving backwards
    base = t_cs.calc_reward(tc, port(js), _t(fut), "train",
                            torch.zeros(B), torch.zeros(B), coef)[0]
    c = 4.5 if coef is None else coef
    np.testing.assert_allclose((got[0] - base).numpy(),
                               -c * r ** 2 - 2.0 * np.abs(np.minimum(v, 0)),
                               atol=1e-6)


@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0, 2.0])
def test_rollout_spin_coefficient_matches_jax_schedule(frac):
    _, tc = configs()
    warmup = 1000
    tc = tc.replace(reward=dataclasses.replace(
        tc.reward, spin_penalty_warmup_steps=warmup))
    total = int(frac * warmup)
    # ppo.py:110-113
    expect = tc.reward.spin_penalty_factor * jnp.clip(
        jnp.int32(total).astype(jnp.float32) / warmup, 0.0, 1.0)
    got = t_ppo.spin_coefficient(tc, total, "train", "cpu")
    assert got.dtype == torch.float32 and got.dim() == 0
    assert got.item() == float(expect)
    # no annealing outside training, for the holonomic robot, or without
    # a warmup
    assert t_ppo.spin_coefficient(tc, total, "test", "cpu") is None
    holo = tc.replace(action_space=dataclasses.replace(
        tc.action_space, kinematics="holonomic"))
    assert t_ppo.spin_coefficient(holo, total, "train", "cpu") is None
    _, plain = configs()
    assert t_ppo.spin_coefficient(plain, total, "train", "cpu") is None


def test_warmed_up_rollout_matches_the_constant_coefficient():
    """ppo.rollout past the warmup gives the rewards of a run without one;
    at total_steps 0 no step pays a spin penalty (tests/test_unicycle.py
    :87-111 on the JAX side)."""
    _, tc = configs()
    tc = tc.replace(ppo=dataclasses.replace(tc.ppo, num_processes=2,
                                            num_steps=3),
                    network=dataclasses.replace(tc.network, attn_size=64))
    warm = tc.replace(reward=dataclasses.replace(
        tc.reward, spin_penalty_warmup_steps=1000))

    def rewards(cfg, total):
        ts = t_ppo.init_train_state(cfg, None, "cpu")
        ts = dataclasses.replace(ts, total_steps=total)
        return t_ppo.rollout(cfg, ts, None)[1].rewards

    const = rewards(tc, 2000)
    assert torch.equal(rewards(warm, 2000), const)
    assert float(rewards(warm, 0).sum()) >= float(const.sum()) - 1e-6


def test_reset_invariants_match_jax():
    """200 resets in each package: the human count on [1, max_human_num]
    with both ends reached, the robot on the arena circle, its goal at
    least 4 m away (or at -pos), a uniform heading, speed 0."""
    jc, tc = configs(human_num=3, human_num_range=1)
    n = 200
    A = tc.sim.max_human_num
    arena = tc.sim.arena_size
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(9), i))(
        jnp.arange(n))
    js, _ = jax.jit(jax.vmap(lambda k: j_cs.reset(jc, k)))(keys)
    ts, obs = t_cs.reset(tc, [torch.Generator().manual_seed(i)
                              for i in range(n)], "cpu")
    for name, st in (("jax", js), ("port", ts)):
        num = np.asarray(st.human_num)
        assert num.min() == 1 and num.max() == A, name
        counts = np.bincount(num, minlength=A + 1)[1:]
        assert counts.min() >= n / A / 2, (name, counts)
        pos, goal = np.asarray(st.robot.pos), np.asarray(st.robot.goal)
        np.testing.assert_allclose(np.linalg.norm(pos, axis=-1), arena,
                                   atol=1e-4, err_msg=name)
        far = np.linalg.norm(pos - goal, axis=-1) >= 4.0
        assert np.all(far | np.all(np.isclose(goal, -pos), -1)), name
        theta = np.asarray(st.robot.theta)
        assert theta.min() >= 0 and theta.max() < 2 * np.pi, name
        quarter = np.bincount((theta // (np.pi / 2)).astype(int),
                              minlength=4)
        assert quarter.min() >= n / 4 / 2, (name, quarter)
        np.testing.assert_array_equal(np.asarray(st.desired_velocity), 0.0)
        np.testing.assert_array_equal(np.asarray(st.robot.vel), 0.0)
    assert obs.robot_node.shape == (n, 7)
    np.testing.assert_array_equal(obs.robot_node[:, 6].numpy(),
                                  ts.robot.theta.numpy())


def _reached_state(jc, seed):
    """JAX states where human 0 of each env (always active) sits on its
    goal; returns (states, the (B, A) mask of active humans on their
    goals)."""
    js = jax_states(jc, seed, steps=1)
    pos = js.humans.pos.at[:, 0].set(js.humans.goal[:, 0])
    js = js.replace(humans=js.humans.replace(pos=pos))
    h = js.humans
    active = np.arange(pos.shape[1])[None] < np.asarray(js.human_num)[:, None]
    reached = active & (np.linalg.norm(np.asarray(h.goal - h.pos), axis=-1)
                        < np.asarray(h.radius))
    assert reached[:, 0].all()
    return js, reached


def test_end_goal_updates_regoal_instead_of_respawning():
    jc, tc = configs(goal_changes=True)
    js, reached = _reached_state(jc, seed=10)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(11), i))(
        jnp.arange(B))
    j_new = jax.vmap(lambda k, s: j_cs.end_goal_updates(jc, k, s))(keys, js)
    st = port(js)
    u = torch.rand(B, t_cs.end_goal_draws(tc),
                   generator=torch.Generator().manual_seed(12))
    t_new = t_cs.end_goal_updates(tc, u, st)
    for name, new in (("jax", j_new), ("port", t_new)):
        h_old, h = js.humans, new.humans
        # positions, velocities and attributes stay: no respawn
        for f in ("pos", "vel", "radius", "v_pref"):
            np.testing.assert_array_equal(np.asarray(getattr(h, f)),
                                          np.asarray(getattr(h_old, f)),
                                          err_msg=f"{name} {f}")
        # end_goal_change_chance is 1: every reached human gets a new goal,
        # the others keep theirs
        changed = np.any(np.asarray(h.goal) != np.asarray(h_old.goal), -1)
        np.testing.assert_array_equal(changed, reached, err_msg=name)
    # the holonomic robot's env respawns them instead
    holo = tc.replace(action_space=dataclasses.replace(
        tc.action_space, kinematics="holonomic"))
    u = torch.rand(B, t_cs.end_goal_draws(holo),
                   generator=torch.Generator().manual_seed(12))
    moved = (t_cs.end_goal_updates(holo, u, st).humans.pos
             != st.humans.pos).any(-1)
    np.testing.assert_array_equal(moved.numpy(), reached)


def test_unicycle_humans_spawn_half_the_circle_from_the_robot():
    """robot_min_dist = circle_radius / 2 (JAX crowd_sim.py:453-455): in 64
    resets no human of either package starts closer to the robot's position
    or goal, bar the rare fallback proposal."""
    jc, tc = configs()
    n = 64
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(13), i))(
        jnp.arange(n))
    js, _ = jax.jit(jax.vmap(lambda k: j_cs.reset(jc, k)))(keys)
    ts, _ = t_cs.reset(tc, [torch.Generator().manual_seed(i)
                            for i in range(n)], "cpu")
    for name, st in (("jax", js), ("port", ts)):
        active = np.arange(4)[None] < np.asarray(st.human_num)[:, None]
        h = np.asarray(st.humans.pos)
        d = np.minimum(
            np.linalg.norm(h - np.asarray(st.robot.pos)[:, None], axis=-1),
            np.linalg.norm(h - np.asarray(st.robot.goal)[:, None], axis=-1))
        close = active & (d < tc.sim.circle_radius / 2.0)
        assert close.sum() <= 0.02 * active.sum(), (name, close.sum())


def test_auto_reset_zeroes_desired_velocity():
    """vec_step: a done env starts its new episode at speed 0; the others
    keep their accumulated speed."""
    _, tc = configs()
    gens = [torch.Generator().manual_seed(i) for i in range(B)]
    st, _ = t_cs.reset(tc, gens, "cpu")
    st = dataclasses.replace(st, desired_velocity=torch.tensor([0.3, 0.4,
                                                                0.5]))
    # env 0 times out on this step
    st = dataclasses.replace(st, global_time=torch.tensor(
        [tc.env.time_limit - 1.0, 0.0, 0.0]))
    st2, _, _, done, info, _ = vector.vec_step(
        tc, st, torch.tensor([[0.05, 0.0]] * B), "train", None)
    assert done.tolist() == [True, False, False]
    np.testing.assert_allclose(st2.desired_velocity.numpy(),
                               [0.0, 0.45, 0.55], atol=1e-6)
    assert float(st2.global_time[0]) == 0.0


UNICYCLE_FLAGS = ["--env-name", "CrowdSimPredRealGST", "--human-num", "20",
                  "--num-processes", "64", "--kinematics", "unicycle",
                  "--robot-v-pref", "0.6", "--spin-warmup-steps", "8000000",
                  "--use-linear-lr-decay", "--num-env-steps", "40000000"]


def test_unicycle_train_flags_build_the_jax_config():
    """The port's train CLI flags of the unicycle recipe
    (trained_models/GST_predictor_unicycle_scratch_r5) give the config the
    JAX train CLI builds from them (JAX train.py:43-85)."""
    from crowdnav_prediction_attngraph_tpu import train as j_train
    from crowdnav_prediction_attngraph_tpu_torch import train as train_cli
    args = train_cli._parser().parse_args(UNICYCLE_FLAGS)
    got = dataclasses.asdict(tconfig.build_config(args))
    expect = dataclasses.asdict(j_train.build_config(args))
    assert got.keys() == expect.keys()
    for group in expect:
        assert got[group] == expect[group], group
    assert got["action_space"]["kinematics"] == "unicycle"
    assert got["reward"]["spin_penalty_warmup_steps"] == 8_000_000


def test_unicycle_train_and_test_clis(tmp_path, monkeypatch):
    """train --kinematics unicycle --spin-warmup-steps runs (tiny: 4 humans,
    attn_size 64, 4 envs x 5 steps, 2 updates, 2.5 s episodes), test
    --model-dir scores the run's own checkpoint under its config.json, and
    a second run warm-starts from the first (--init-params-from)."""
    from crowdnav_prediction_attngraph_tpu_torch import test as test_cli
    from crowdnav_prediction_attngraph_tpu_torch import train as train_cli
    build = train_cli.build_config

    def build_tiny(args):
        cfg = build(args)
        return cfg.replace(
            env=dataclasses.replace(cfg.env, time_limit=2.5),
            network=dataclasses.replace(cfg.network, attn_size=64))
    monkeypatch.setattr(train_cli, "build_config", build_tiny)
    flags = ["--env-name", "CrowdSimVarNum", "--human-num", "4",
             "--num-processes", "4", "--num-steps", "5",
             "--num-env-steps", "40", "--kinematics", "unicycle",
             "--robot-v-pref", "0.6", "--spin-warmup-steps", "100",
             "--log-interval", "1", "--device", "cpu"]
    run = str(tmp_path / "run")
    ts = train_cli.main(flags + ["--output-dir", run])
    assert ts.total_steps == 40
    assert bool((ts.env_states.desired_velocity.abs() <= 0.6).all())
    res = test_cli.main(["--model-dir", run, "--test-case-size", "2",
                         "--device", "cpu", "--out-dir",
                         str(tmp_path / "eval")])
    assert np.isfinite(res["success_rate"]) and res["env_steps"] > 0
    assert os.listdir(tmp_path / "eval" / "test") == ["test_00001.log"]
    warm = train_cli.main(flags + ["--output-dir", str(tmp_path / "warm"),
                                   "--num-env-steps", "0",
                                   "--init-params-from",
                                   os.path.join(run, "checkpoints")])
    for a, b in zip(warm.model.parameters(), ts.model.parameters()):
        assert torch.equal(a, b)
