"""Data-collection environment for GST predictor training, batched over envs
(JAX package ``env/collect.py:1-96``; reference
crowd_sim/envs/crowd_sim_var_num_collect.py + collect_data.py).

An ORCA-driven robot wanders the crowd forever: on reaching its goal it
takes the crowd's median position w.p. 0.5, else a uniform point of the
arena, and collisions do not end anything (crowd_sim_var_num_collect.py
:163-181). Each step emits ``(frame, tracking_id, px, py)`` for every human
the robot sees; a human that leaves the robot's view gets a fresh tracking
id (crowd_sim_var_num_collect.py:106-110), as the GST sees at deployment.

Every step draws :data:`GOAL_DRAWS` uniforms from each env's generator (the
coin and the two coordinates of the uniform goal), whether or not the goal
was reached, so each env's stream is independent of its batch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..config import Config
from . import crowd_sim, spawn
from .types import EnvState

GOAL_DRAWS = 3


@dataclasses.dataclass
class CollectState:
    env: EnvState
    last_observability: torch.Tensor   # (B, A) bool
    pred_id: torch.Tensor              # (B, A) int64 tracking ids
    max_id: torch.Tensor               # (B,) int64


@dataclasses.dataclass
class PredInfo:
    frame: torch.Tensor                # (B, A)
    pred_id: torch.Tensor              # (B, A) int64
    pos: torch.Tensor                  # (B, A, 2) absolute positions
    valid: torch.Tensor                # (B, A) bool


def reset(cfg: Config, gens: List[torch.Generator], device
          ) -> Tuple[CollectState, PredInfo]:
    env_state, _ = crowd_sim.reset(cfg, gens, device)
    B, A = len(gens), cfg.sim.max_human_num
    state = CollectState(
        env=env_state,
        last_observability=torch.zeros((B, A), dtype=torch.bool,
                                       device=device),
        pred_id=torch.arange(A, device=device).expand(B, A).clone(),
        max_id=env_state.human_num.clone())
    return _emit(cfg, state)


def _emit(cfg: Config, state: CollectState) -> Tuple[CollectState, PredInfo]:
    vis = crowd_sim.robot_human_visibility(cfg, state.env)
    # humans leaving the view get fresh ids (crowd_sim_var_num_collect.py
    # :106-110): the k-th such slot of a step takes max_id + k
    out = state.last_observability & ~vis
    n_out = out.long().cumsum(dim=1)
    pred_id = torch.where(out, state.max_id[:, None] + n_out - 1,
                          state.pred_id)
    state = dataclasses.replace(state, pred_id=pred_id,
                                max_id=state.max_id + n_out[:, -1],
                                last_observability=vis)
    frame = state.env.global_time / cfg.data.pred_timestep
    info = PredInfo(frame=frame[:, None].expand_as(vis), pred_id=pred_id,
                    pos=state.env.humans.pos, valid=vis)
    return state, info


def crowd_median(pos, active):
    """(B, 2) the per-coordinate median of the humans' positions as the JAX
    package computes it (``collect.py:81-84``): ``jnp.median`` over every
    slot with the inactive ones set to NaN, then ``nan_to_num``. An even
    count averages the two middle values (``torch.median`` would take the
    lower one), and a single inactive slot makes the median NaN, hence 0
    (``nanmedian`` would skip it)."""
    A = pos.shape[1]
    s = pos.sort(dim=1).values
    mid = s[:, A // 2] if A % 2 else (s[:, A // 2 - 1] + s[:, A // 2]) * 0.5
    return torch.where(active.all(dim=1)[:, None], mid, torch.zeros_like(mid))


def redirect_goal(cfg: Config, env: EnvState, u) -> EnvState:
    """A robot at its goal takes the crowd's median w.p. 0.5, else a point
    uniform on the arena (``collect.py:77-91``). u (B, GOAL_DRAWS): the coin
    and the uniform goal's two coordinates, in U[0, 1)."""
    r = env.robot
    reached = torch.linalg.norm(r.pos - r.goal, dim=-1) < r.radius
    active = (torch.arange(cfg.sim.max_human_num, device=r.pos.device)[None]
              < env.human_num[:, None])
    a = cfg.sim.arena_size
    rand_goal = u[:, 1:3] * (2.0 * a) - a
    new_goal = torch.where((u[:, 0] < 0.5)[:, None],
                           crowd_median(env.humans.pos, active), rand_goal)
    goal = torch.where(reached[:, None], new_goal, r.goal)
    return dataclasses.replace(env, robot=dataclasses.replace(r, goal=goal))


def step(cfg: Config, state: CollectState, u: Optional[torch.Tensor] = None
         ) -> Tuple[CollectState, PredInfo]:
    """One collect step of every env: the goal redirection, then an ORCA
    robot's step of the train phase. ``u`` (B, GOAL_DRAWS) replaces the
    goal draws of this step (drawn from the envs' generators when None)."""
    env = state.env
    device = env.robot.pos.device
    if u is None:
        u = spawn.draw_uniform(env.gens, GOAL_DRAWS, device)
    env = redirect_goal(cfg, env, u)
    env, _, _, _, _ = crowd_sim.step(
        cfg, env, torch.zeros((len(env.gens), 2), device=device), "train",
        robot_policy="orca")
    return _emit(cfg, dataclasses.replace(state, env=env))
