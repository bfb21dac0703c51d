"""The gym-style adapter on the port: the eight cases of the JAX package's
tests/test_gym_adapter.py (the committed GST predictor as its ``.npz``
export), and parity with the JAX adapter by state injection.

Parity: both adapters are reset, then, before each of 6 steps of the same
actions, the JAX adapter's state is injected into the port's
(tests/test_torch_slice.py's ``to_port_state``) and both step. The steps go
through ORCA (and, in CrowdSimPredRealGST-v0, the GST pretext pass), so
observations and rewards are held to 1e-3, the bound of
tests/test_torch_env_variants.py and tests/test_torch_slice.py; masks,
counts, outcomes and the terminated / truncated flags exactly.
"""

import os

import numpy as np
import pytest

import jax
import torch

from crowdnav_prediction_attngraph_tpu.env import gym_adapter as jgym
from crowdnav_prediction_attngraph_tpu_torch.env import gym_adapter
from crowdnav_prediction_attngraph_tpu_torch.utils.params import load_npz
from test_torch_slice import to_port_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GST_NPZ = os.path.join(REPO, "crowdnav_prediction_attngraph_tpu_torch",
                       "weights", "gst_sj_tpu_r5_b64_epoch100.npz")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(**kw):
    return dict(human_num=5, human_num_range=0, device="cpu", **kw)


def test_varnum_episode_runs():
    env = gym_adapter.make("CrowdSimVarNum-v0", **_small())
    obs, info = env.reset(seed=0)
    assert set(obs) == {"robot_node", "temporal_edges", "spatial_edges",
                        "visible_masks", "detected_human_num"}
    assert all(isinstance(v, np.ndarray) for v in obs.values())
    assert obs["robot_node"].shape == (7,)
    assert obs["spatial_edges"].shape == (5, 2)
    for _ in range(20):
        obs, r, term, trunc, info = env.step(np.array([0.3, 0.0]))
        assert np.isfinite(r)
        assert {"outcome", "in_danger", "min_dist", "global_time"} <= set(info)
        if term or trunc:
            break
    env.close()


def test_pred_env_spatial_edges_width():
    env = gym_adapter.make("CrowdSimPred-v0", **_small())
    obs, _ = env.reset(seed=1)
    # 2*(K+1) with K=5 predict steps (crowd_sim_pred.py:50-52)
    assert obs["spatial_edges"].shape == (5, 12)
    obs, r, term, trunc, _ = env.step(np.array([0.0, 0.5]))
    assert obs["spatial_edges"].shape == (5, 12)
    env.close()


def test_scripted_robot_policy_reaches_goal():
    env = gym_adapter.make("CrowdSimVarNum-v0", robot_policy="orca",
                           **_small())
    env.reset(seed=2)
    outcome = None
    for _ in range(env.cfg.max_episode_steps):
        _, _, term, trunc, info = env.step(np.zeros(2))
        if term or trunc:
            outcome = info["outcome"]
            break
    assert outcome is not None  # the episode ends under the scripted policy
    with pytest.raises(RuntimeError):   # no auto-reset
        env.step(np.zeros(2))


def test_gst_env_requires_params():
    with pytest.raises(ValueError, match="gst_params"):
        gym_adapter.make("CrowdSimPredRealGST-v0", **_small())


def test_reset_required_before_step():
    env = gym_adapter.make("CrowdSimVarNum-v0", **_small())
    with pytest.raises(RuntimeError):
        env.step(np.zeros(2))


def test_unknown_and_native_ids_rejected():
    for env_id in ("Nope-v0", "CrowdSimVarNumCollect-v0",
                   "rosTurtlebot2iEnv-v0"):
        with pytest.raises(ValueError):
            gym_adapter.make(env_id, device="cpu")


def test_gst_env_with_committed_predictor():
    """The flagship env family through the adapter, driven by the committed
    predictor (results/gst_sj_tpu_r5_b64, exported to .npz)."""
    env = gym_adapter.make("CrowdSimPredRealGST-v0", gst_params=GST_NPZ,
                           **_small())
    obs, _ = env.reset(seed=0)
    # 2*(K+1) spatial edges with K=5 predicted steps, rewritten by the
    # pretext pass (vec_pretext_normalize semantics)
    assert obs["spatial_edges"].shape == (5, 12)
    assert np.isfinite(obs["spatial_edges"][obs["visible_masks"]]).all()
    total = 0.0
    for _ in range(6):
        obs, r, term, trunc, info = env.step(np.array([0.2, 0.1]))
        total += r
        if term or trunc:
            break
    assert np.isfinite(total)
    env.close()


def test_render_rgb_array():
    env = gym_adapter.make("CrowdSimVarNum-v0", **_small())
    env.reset(seed=3)
    frame = env.render()
    assert frame.dtype == np.uint8 and frame.ndim == 3 and frame.shape[2] == 3
    env.step(np.array([0.2, 0.0]))
    frame2 = env.render()
    assert frame2.shape == frame.shape and (frame2 != frame).any()
    with pytest.raises(NotImplementedError):
        env.render(mode="human")
    env.close()
    assert env._render_fig is None


@pytest.mark.parametrize("env_id", ["CrowdSimVarNum-v0",
                                    "CrowdSimPredRealGST-v0"])
def test_state_injected_steps_match_jax(env_id):
    kw = dict(human_num=5, human_num_range=0)
    gst_tree = load_npz(GST_NPZ) if "GST" in env_id else None
    jenv = jgym.make(env_id, gst_params=gst_tree, **kw)
    tenv = gym_adapter.make(env_id, gst_params=gst_tree, device="cpu", **kw)
    jenv.reset(seed=4)
    tenv.reset(seed=4)
    rng = np.random.RandomState(0)
    for i in range(6):
        js = jax.tree.map(lambda x: np.asarray(x)[None], jenv._state)
        tenv._state = to_port_state(js, tenv._state.gens)
        action = rng.uniform(-0.8, 0.8, 2).astype(np.float32)
        jo, jr, jterm, jtrunc, jinfo = jenv.step(action)
        to, tr, tterm, ttrunc, tinfo = tenv.step(action)
        for k in ("robot_node", "temporal_edges", "spatial_edges"):
            np.testing.assert_allclose(to[k], jo[k], atol=1e-3,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_array_equal(to["visible_masks"], jo["visible_masks"])
        np.testing.assert_array_equal(to["detected_human_num"],
                                      jo["detected_human_num"])
        np.testing.assert_allclose(tr, jr, atol=1e-3, err_msg=f"step {i}")
        assert (tterm, ttrunc, tinfo["outcome"]) == \
            (jterm, jtrunc, jinfo["outcome"])
        assert tinfo["global_time"] == pytest.approx(jinfo["global_time"])
        if jterm or jtrunc:
            break
