"""Gym-style single-env adapter over the batched simulator (JAX package
``env/gym_adapter.py``).

The reference exposes its environments through gym registration
(crowd_sim/__init__.py:1-31: CrowdSim-v0, CrowdSimPred-v0, CrowdSimVarNum-v0,
CrowdSimVarNumCollect-v0, CrowdSimPredRealGST-v0, rosTurtlebot2iEnv-v0) so
external RL code can drive them with the classic ``reset()`` / ``step()``
loop. The port's env functions step a batch of envs; this adapter holds a
batch of one on the device and squeezes it.

The API follows the gymnasium 5-tuple convention (``reset(seed) -> (obs,
info)``, ``step(a) -> (obs, reward, terminated, truncated, info)``); the gym
package itself is not a dependency. Observations come back as a dict of
numpy arrays with the reference's key names (crowd_sim_var_num.py:37-58).
The state is cleared on a terminal or truncated step (no auto-reset), and
``render`` then raises until the next ``reset``; ``render`` draws no
predicted futures. Both are the JAX adapter's behaviour.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config, gst_config, pred_config, varnum_config
from ..models.gst.predictor import load_gst
from ..utils.device import resolve_device
from ..utils.render import new_figure, render_frame
from . import crowd_sim
from .pretext import pretext_process
from .types import (OUTCOME_COLLISION, OUTCOME_DANGER, OUTCOME_REACH_GOAL,
                    OUTCOME_TIMEOUT)


class Box:
    """Minimal stand-in for gym.spaces.Box (gym is not a dependency)."""

    def __init__(self, low, high, shape, dtype=np.float32):
        self.low, self.high = low, high
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self):
        return f"Box(low={self.low}, high={self.high}, shape={self.shape})"


class DictSpace(dict):
    """Minimal stand-in for gym.spaces.Dict."""


class CrowdNavGymEnv:
    """Single-env host wrapper. One instance = one episode stream.

    ``phase='test'`` reproduces the suite semantics (truth-future refresh for
    intrusion accounting); ``robot_policy`` may be 'network' (actions come
    from the caller), 'orca', or 'social_force' (caller actions ignored),
    mirroring the reference's robot.policy configs. ``gst_params`` (the
    ``inferred`` env's predictor) is anything ``load_gst`` takes: a params
    tree, a ``.npz`` export, a reference ``.pt``.
    """

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, cfg: Config, gst_params=None, phase: str = "test",
                 robot_policy: str = "network", device="cuda"):
        if cfg.sim.predict_method == "inferred" and gst_params is None:
            raise ValueError(
                "CrowdSimPredRealGST needs gst_params (weights for "
                "models.gst.predictor.load_gst)")
        self.cfg = cfg
        self.phase = phase
        self.robot_policy = robot_policy
        self.device = resolve_device(device)
        self._gst = (None if gst_params is None
                     else load_gst(cfg.pred, gst_params, self.device))
        self._state = None
        self._seed_counter = 0
        self._render_fig = None
        self._render_ax = None

        A, D = cfg.sim.max_human_num, cfg.spatial_edge_dim
        inf = np.inf
        self.observation_space = DictSpace(
            robot_node=Box(-inf, inf, (7,)),
            temporal_edges=Box(-inf, inf, (2,)),
            spatial_edges=Box(-inf, inf, (A, D)),
            visible_masks=Box(0, 1, (A,), dtype=bool),
            detected_human_num=Box(1, A, (1,), dtype=np.int64),
        )
        # reference: high = np.inf * ones(2,) Box (crowd_sim_var_num.py:61-64)
        self.action_space = Box(-inf, inf, (2,))

    # -- gym surface --------------------------------------------------------

    @torch.no_grad()
    def reset(self, seed: Optional[int] = None):
        """A new episode drawn from a generator seeded ``seed`` (default: 0,
        1, 2, ... over this instance's resets)."""
        if seed is None:
            seed = self._seed_counter
            self._seed_counter += 1
        gen = torch.Generator()
        gen.manual_seed(seed)
        state, obs = crowd_sim.reset(self.cfg, [gen], self.device)
        if self.cfg.sim.predict_method == "inferred":
            state, obs, _, _ = pretext_process(
                self.cfg, self._gst, state, obs,
                torch.zeros(1, device=self.device))
        self._state = state
        return self._obs_to_numpy(obs), {}

    @torch.no_grad()
    def step(self, action):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        action = torch.as_tensor(np.asarray(action, np.float32),
                                 device=self.device).reshape(1, 2)
        state, obs, reward, done, info = crowd_sim.step(
            self.cfg, self._state, action, self.phase,
            robot_policy=self.robot_policy)
        if self.cfg.sim.predict_method == "inferred":
            state, obs, reward, _ = pretext_process(self.cfg, self._gst,
                                                    state, obs, reward)
        self._state = state
        outcome = int(info.outcome[0])
        terminated = outcome in (OUTCOME_REACH_GOAL, OUTCOME_COLLISION)
        truncated = outcome == OUTCOME_TIMEOUT
        info_d = {
            "outcome": outcome,
            "in_danger": outcome == OUTCOME_DANGER,
            "min_dist": float(info.min_dist[0]),
            "global_time": float(state.global_time[0]),
        }
        if terminated or truncated:
            self._state = None  # no auto-reset in the gym contract
        return (self._obs_to_numpy(obs), float(reward[0]), terminated,
                truncated, info_d)

    def render(self, mode: str = "rgb_array"):
        """Draw the current timestep (reference CrowdSim.render,
        crowd_sim.py:750-873) on this env's own figure and return it as an
        (H, W, 3) uint8 array."""
        if mode != "rgb_array":
            raise NotImplementedError(f"render mode {mode!r}; use 'rgb_array'")
        if self._state is None:
            raise RuntimeError("call reset() before render()")
        s = self._state
        if self._render_fig is None:
            self._render_fig, self._render_ax = new_figure()
        render_frame(
            self._render_ax,
            s.robot.pos[0].cpu().numpy(), s.robot.goal[0].cpu().numpy(),
            float(s.robot.radius[0]),
            s.humans.pos[0].cpu().numpy(), s.humans.radius[0].cpu().numpy(),
            s.visible_masks[0].cpu().numpy(), self.cfg.robot.sensor_range,
            int(s.human_num[0]), arena_size=self.cfg.sim.arena_size)
        canvas = self._render_fig.canvas
        canvas.draw()
        return np.asarray(canvas.buffer_rgba())[..., :3].copy()

    def close(self):
        self._state = None
        self._render_fig = self._render_ax = None

    @staticmethod
    def _obs_to_numpy(obs):
        return {
            "robot_node": obs.robot_node[0].cpu().numpy(),
            "temporal_edges": obs.temporal_edges[0].cpu().numpy(),
            "spatial_edges": obs.spatial_edges[0].cpu().numpy(),
            "visible_masks": obs.visible_masks[0].cpu().numpy(),
            "detected_human_num":
                obs.detected_human_num[0].cpu().numpy().reshape(1),
        }


def make(env_id: str, gst_params=None, phase: str = "test",
         robot_policy: str = "network", device="cuda",
         **config_overrides) -> CrowdNavGymEnv:
    """Factory keyed by the reference's gym ids (crowd_sim/__init__.py:1-31).

    'CrowdSim-v0' maps to the var-num env with a fixed population
    (human_num_range=0), matching what the reference's base CrowdSim provides;
    'CrowdSimVarNumCollect-v0' is served by env/collect.py's trajectory
    collector and 'rosTurtlebot2iEnv-v0' by sim2real.py — both have richer
    native entry points, so this factory points there instead of wrapping.
    """
    if env_id in ("CrowdSim-v0", "CrowdSimVarNum-v0"):
        kw = dict(config_overrides)
        if env_id == "CrowdSim-v0":
            kw.setdefault("human_num_range", 0)
        cfg = varnum_config(**kw)
    elif env_id == "CrowdSimPred-v0":
        cfg = pred_config(**config_overrides)
    elif env_id == "CrowdSimPredRealGST-v0":
        cfg = gst_config(**config_overrides)
    elif env_id == "CrowdSimVarNumCollect-v0":
        raise ValueError(
            "trajectory collection runs through "
            "crowdnav_prediction_attngraph_tpu_torch.collect_data "
            "(env/collect.py)")
    elif env_id == "rosTurtlebot2iEnv-v0":
        raise ValueError(
            "the ROS deployment env runs through "
            "crowdnav_prediction_attngraph_tpu_torch.sim2real")
    else:
        raise ValueError(f"unknown env id {env_id!r}")
    return CrowdNavGymEnv(cfg, gst_params=gst_params, phase=phase,
                          robot_policy=robot_policy, device=device)
