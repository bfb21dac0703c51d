"""The evaluation and training slices as a whole: the port's pretext_process,
policy act and crowd_sim.step against the JAX package's, by state
injection, in phase "test" and in phase "train".

The JAX env is reset (3 humans; random and end goal changes off, so a step
draws no random numbers), its EnvState is converted to the port's, and both
packages step 5 times in phase "test". Before every step the JAX state is
injected into the port again, so each step is compared from identical
inputs. Positions and rewards go through ORCA (held to 2e-4 when LP2 is
feasible) and the GST predictor (5e-4 on its absolute-frame output), so
observations and rewards are held to 1e-3; done and outcome must be equal.
The policy runs its einsum attention branch in f32 on both sides, to the
2e-5 bound of tests/test_policy_parity.py:136. The train phase has no
ground-truth rollout; its rewards, potential and observations are held to
the same 1e-3 over 5 steps of random actions, done and outcome exactly.

Also: vec_step's auto-reset against a step without reset, and the port's
evaluate end to end on 2 flagship cases on the CPU.
"""

import dataclasses
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crowdnav_prediction_attngraph_tpu import config as jconfig
from crowdnav_prediction_attngraph_tpu.env import crowd_sim as j_crowd_sim
from crowdnav_prediction_attngraph_tpu.env.pretext import (
    pretext_process as j_pretext)
from crowdnav_prediction_attngraph_tpu.models import policy as j_policy
from crowdnav_prediction_attngraph_tpu.models.policy_net import (
    init_hidden as j_init_hidden, obs_to_dict as j_obs_to_dict)
from crowdnav_prediction_attngraph_tpu_torch import config as tconfig
from crowdnav_prediction_attngraph_tpu_torch.algo import evaluation
from crowdnav_prediction_attngraph_tpu_torch.env import crowd_sim, vector
from crowdnav_prediction_attngraph_tpu_torch.env.pretext import pretext_process
from crowdnav_prediction_attngraph_tpu_torch.env.types import (
    EnvState, HumanState, Observation, RobotState)
from crowdnav_prediction_attngraph_tpu_torch.models import policy as t_policy
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import load_gst
from crowdnav_prediction_attngraph_tpu_torch.models.policy_net import (
    obs_to_dict)
from crowdnav_prediction_attngraph_tpu_torch.utils.params import load_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "crowdnav_prediction_attngraph_tpu_torch",
                       "weights")
MODEL_DIR = os.path.join(REPO, "trained_models",
                         "GST_predictor_rand_tpu_r5_selfgst")
B, STEPS = 4, 5


def _configs():
    kw = dict(human_num=3)
    jc = jconfig.gst_config(**kw)
    jc = jc.replace(
        humans=dataclasses.replace(jc.humans, random_goal_changing=False,
                                   end_goal_changing=False),
        network=dataclasses.replace(jc.network, use_pallas_attention=False))
    tc = tconfig.gst_config(**kw)
    tc = tc.replace(
        humans=dataclasses.replace(tc.humans, random_goal_changing=False,
                                   end_goal_changing=False),
        network=dataclasses.replace(tc.network, use_pallas_attention=False))
    return jc, tc


def _t(x):
    return torch.from_numpy(np.array(x))


def to_port_state(js, gens) -> EnvState:
    r, h = js.robot, js.humans
    return EnvState(
        gens=gens,
        robot=RobotState(pos=_t(r.pos), vel=_t(r.vel), theta=_t(r.theta),
                         goal=_t(r.goal), radius=_t(r.radius),
                         v_pref=_t(r.v_pref)),
        humans=HumanState(pos=_t(h.pos), vel=_t(h.vel), goal=_t(h.goal),
                          radius=_t(h.radius), v_pref=_t(h.v_pref)),
        human_num=_t(js.human_num).long(),
        last_human_states=_t(js.last_human_states),
        prev_human_states=_t(js.prev_human_states),
        visible_masks=_t(js.visible_masks),
        potential=_t(js.potential), global_time=_t(js.global_time),
        step_count=_t(js.step_count).long(),
        desired_velocity=_t(js.desired_velocity),
        orca_neighbor_dist=_t(js.orca_neighbor_dist),
        traj_buffer=_t(js.traj_buffer), mask_buffer=_t(js.mask_buffer),
        human_future_traj=_t(js.human_future_traj))


def to_port_obs(jo) -> Observation:
    return Observation(robot_node=_t(jo.robot_node),
                       temporal_edges=_t(jo.temporal_edges),
                       spatial_edges=_t(jo.spatial_edges),
                       visible_masks=_t(jo.visible_masks),
                       detected_human_num=_t(jo.detected_human_num).long())


def assert_obs_close(got: Observation, jo, atol):
    for f in ("robot_node", "temporal_edges", "spatial_edges"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(jo, f)), atol=atol,
                                   err_msg=f)
    np.testing.assert_array_equal(got.visible_masks.numpy(),
                                  np.asarray(jo.visible_masks))
    np.testing.assert_array_equal(got.detected_human_num.numpy(),
                                  np.asarray(jo.detected_human_num))


@pytest.fixture(scope="module")
def setup():
    jc, tc = _configs()
    gst_tree = load_npz(os.path.join(WEIGHTS, "gst_sj_tpu_r5_b64_epoch100.npz"))
    pol_tree = load_npz(os.path.join(WEIGHTS, "r5_selfgst_10250_policy.npz"))
    j_reset = jax.jit(jax.vmap(lambda k: j_crowd_sim.reset(jc, k)))
    j_pre = jax.jit(jax.vmap(lambda s, o, r: j_pretext(jc, gst_tree, s, o, r)))
    j_step = jax.jit(jax.vmap(lambda s, a: j_crowd_sim.step(jc, s, a, "test")))
    j_step_train = jax.jit(jax.vmap(
        lambda s, a: j_crowd_sim.step(jc, s, a, "train")))
    j_act = jax.jit(lambda o, h, m: j_policy.act(
        jc, pol_tree, o, h, m, jax.random.key(0), deterministic=True))
    return dict(jc=jc, tc=tc, j_reset=j_reset, j_pre=j_pre, j_step=j_step,
                j_step_train=j_step_train, j_act=j_act, gst=load_gst(tc.pred, gst_tree, "cpu"),
                policy=t_policy.load_policy(tc, pol_tree, "cpu"))


def test_state_injected_steps_match_jax(setup):
    s = setup
    jc, tc = s["jc"], s["tc"]
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(
        jnp.arange(B))
    js, jo = s["j_reset"](keys)
    js, jo, _, _ = s["j_pre"](js, jo, jnp.zeros(B))
    gens = [evaluation.case_generator(0, i) for i in range(B)]
    jh = j_init_hidden(jc, B)
    masks = torch.ones(B)
    for t in range(STEPS):
        # policy: same obs and hidden state on both sides
        th = {"human_node_rnn": _t(jh["human_node_rnn"])}
        jv, ja, _, jh_new = s["j_act"](j_obs_to_dict(jo), jh, jnp.ones(B))
        tv, ta, _, th_new = t_policy.act(s["policy"],
                                         obs_to_dict(to_port_obs(jo)), th,
                                         masks, deterministic=True)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-5)
        np.testing.assert_allclose(th_new["human_node_rnn"].numpy(),
                                   np.asarray(jh_new["human_node_rnn"]),
                                   atol=2e-5)

        # env step from the injected JAX state, with the JAX action
        ts = to_port_state(js, gens)
        js2, jo2, jrew, jdone, jinfo = s["j_step"](js, ja)
        ts2, to2, trew, tdone, tinfo = crowd_sim.step(tc, ts, _t(ja), "test")
        assert_obs_close(to2, jo2, 1e-3)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-3)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tinfo.outcome.numpy(),
                                      np.asarray(jinfo.outcome))
        np.testing.assert_allclose(tinfo.min_dist.numpy(),
                                   np.asarray(jinfo.min_dist), atol=1e-3)
        np.testing.assert_allclose(ts2.human_future_traj.numpy(),
                                   np.asarray(js2.human_future_traj),
                                   atol=1e-3)

        # GST pretext from the injected JAX post-step state and obs
        js3, jo3, jrew3, jpen = s["j_pre"](js2, jo2, jrew)
        ts3, to3, trew3, tpen = pretext_process(
            tc, s["gst"], to_port_state(js2, gens), to_port_obs(jo2), _t(jrew))
        assert_obs_close(to3, jo3, 1e-3)
        np.testing.assert_allclose(trew3.numpy(), np.asarray(jrew3), atol=1e-3)
        np.testing.assert_allclose(tpen.numpy(), np.asarray(jpen), atol=1e-3)
        np.testing.assert_allclose(ts3.traj_buffer.numpy(),
                                   np.asarray(js3.traj_buffer), atol=1e-5)
        js, jo, jh = js3, jo3, jh_new


def test_train_phase_injected_steps_match_jax(setup):
    s = setup
    tc = s["tc"]
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(4), i))(
        jnp.arange(B))
    js, jo = s["j_reset"](keys)
    js, jo, _, _ = s["j_pre"](js, jo, jnp.zeros(B))
    gens = [evaluation.case_generator(0, i, "train") for i in range(B)]
    rng = np.random.RandomState(0)
    for t in range(STEPS):
        action = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
        js2, jo2, jrew, jdone, jinfo = s["j_step_train"](js, jnp.asarray(action))
        ts2, to2, trew, tdone, tinfo = crowd_sim.step(
            tc, to_port_state(js, gens), torch.from_numpy(action), "train")
        assert_obs_close(to2, jo2, 1e-3)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-3)
        np.testing.assert_allclose(ts2.potential.numpy(),
                                   np.asarray(js2.potential), atol=1e-3)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tinfo.outcome.numpy(),
                                      np.asarray(jinfo.outcome))
        assert not tinfo.min_dist.any()
        # the train phase leaves the stored future untouched
        torch.testing.assert_close(ts2.human_future_traj,
                                   _t(js.human_future_traj))
        js, jo, _, _ = s["j_pre"](js2, jo2, jrew)


def _clone(gens):
    out = []
    for g in gens:
        c = torch.Generator()
        c.set_state(g.get_state())
        out.append(c)
    return out


def test_vec_step_auto_resets_only_done_envs(setup):
    tc = setup["tc"]
    gst = setup["gst"]
    gens = [evaluation.case_generator(9, i, "train") for i in range(B)]
    states, _ = vector.vec_reset_with_pretext(tc, gens, gst, "cpu")
    # env 0 reaches the time limit on this step
    states.global_time[0] = tc.env.time_limit - 1.0
    action = torch.from_numpy(np.random.RandomState(1).uniform(
        -1.0, 1.0, (B, 2)).astype(np.float32))
    twin = dataclasses.replace(states, gens=_clone(states.gens))

    got_s, got_o, rew, done, info, penalty = vector.vec_step(
        tc, states, action, "train", gst)
    ref_s, ref_o, ref_rew, ref_done, ref_info = crowd_sim.step(
        tc, twin, action, "train")
    fresh_s, fresh_o = vector.vec_reset_with_pretext(
        tc, _clone(twin.gens[:1]), gst, "cpu")
    ref_s, ref_o, _, _ = pretext_process(tc, gst, ref_s, ref_o, ref_rew)

    assert done.tolist() == [True] + [False] * (B - 1)
    np.testing.assert_array_equal(done.numpy(), ref_done.numpy())
    np.testing.assert_array_equal(info.outcome.numpy(),
                                  ref_info.outcome.numpy())
    # reward and done are the terminating step's (plus the pretext penalty)
    torch.testing.assert_close(rew - penalty, ref_rew)
    # the done env starts its next episode from its own generator
    assert got_s.step_count[0] == 0 and got_s.global_time[0] == 0.0
    for f in ("robot_node", "spatial_edges", "detected_human_num"):
        torch.testing.assert_close(getattr(got_o, f)[0],
                                   getattr(fresh_o, f)[0])
    # the other envs are the step without reset
    keep = torch.arange(1, B)
    for f in ("robot_node", "temporal_edges", "spatial_edges",
              "visible_masks", "detected_human_num"):
        torch.testing.assert_close(getattr(got_o, f)[keep],
                                   getattr(ref_o, f)[keep])
    torch.testing.assert_close(got_s.humans.pos[keep], ref_s.humans.pos[keep])
    torch.testing.assert_close(got_s.traj_buffer[keep],
                               ref_s.traj_buffer[keep])
    torch.testing.assert_close(rew[keep], (ref_rew + penalty)[keep])


def test_reset_matches_distribution_and_invariants():
    """Resets draw from torch generators, so they match the JAX package only
    in distribution; the invariants hold exactly."""
    cfg = tconfig.config_from_snapshot(os.path.join(MODEL_DIR, "config.json"))
    gens = [evaluation.case_generator(425, i) for i in range(64)]
    state, obs = crowd_sim.reset(cfg, gens, "cpu")
    A = cfg.sim.max_human_num
    assert torch.all(state.human_num == A)
    dist_goal = torch.linalg.norm(state.robot.pos - state.robot.goal, dim=-1)
    assert torch.all(dist_goal >= 8.0)
    ring = torch.linalg.norm(state.humans.pos, dim=-1)
    # on the circle plus U[0, 2)^2 noise
    assert torch.all((ring > cfg.sim.circle_radius - 2.9)
                     & (ring < cfg.sim.circle_radius + 2.9))
    torch.testing.assert_close(state.humans.goal, -state.humans.pos)
    assert torch.all((state.humans.radius >= 0.3) & (state.humans.radius < 0.5))
    assert obs.spatial_edges.shape == (64, A, cfg.spatial_edge_dim)
    # the same case draws the same episode in any batch
    again, _ = crowd_sim.reset(cfg, [evaluation.case_generator(425, 5)], "cpu")
    torch.testing.assert_close(again.humans.pos[0], state.humans.pos[5])


def test_evaluate_two_cases_on_cpu():
    cfg = tconfig.config_from_snapshot(os.path.join(MODEL_DIR, "config.json"))
    policy = t_policy.load_policy(
        cfg, os.path.join(WEIGHTS, "r5_selfgst_10250_policy.npz"), "cpu")
    gst = load_gst(cfg.pred, os.path.join(WEIGHTS,
                                          "gst_sj_tpu_r5_b64_epoch100.npz"), "cpu")
    res = evaluation.evaluate(cfg, policy, gst, test_size=2, device="cpu",
                              log=lambda m: None)
    line = evaluation.format_results(res)
    m = re.fullmatch(
        r"Testing success rate: ([\d.]+), collision rate: ([\d.]+), "
        r"timeout rate: ([\d.]+), nav time: ([\d.]+), path length: ([\d.]+), "
        r"average intrusion ratio: ([\d.]+)%, "
        r"average minimal distance during intrusions: ([\d.]+)", line)
    assert m, line
    vals = [float(x) for x in m.groups()]
    assert all(np.isfinite(vals))
    assert abs(vals[0] + vals[1] + vals[2] - 1.0) < 1e-6
    assert res["env_steps"] > 0
