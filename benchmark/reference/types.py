"""Batched simulator state and observation (JAX package ``env/types.py``).

Every tensor carries a leading env axis B: where the JAX package vmaps a
one-env pytree, the port steps one dataclass of batched tensors. Randomness
comes from one CPU ``torch.Generator`` per env (``EnvState.gens``) instead of
the JAX PRNG key, so a case draws the same numbers whichever batch it runs
in and whichever device the batch runs on.

The active humans of an env are the slot prefix ``[0, human_num)``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

# Episode outcome codes (reference crowd_sim/envs/utils/info.py:1-44).
OUTCOME_NOTHING = 0
OUTCOME_TIMEOUT = 1
OUTCOME_REACH_GOAL = 2
OUTCOME_COLLISION = 3
OUTCOME_DANGER = 4  # non-terminal


@dataclasses.dataclass
class RobotState:
    pos: torch.Tensor       # (B, 2)
    vel: torch.Tensor       # (B, 2)
    theta: torch.Tensor     # (B,)
    goal: torch.Tensor      # (B, 2)
    radius: torch.Tensor    # (B,)
    v_pref: torch.Tensor    # (B,)


@dataclasses.dataclass
class HumanState:
    pos: torch.Tensor       # (B, A, 2)
    vel: torch.Tensor       # (B, A, 2)
    goal: torch.Tensor      # (B, A, 2)
    radius: torch.Tensor    # (B, A)
    v_pref: torch.Tensor    # (B, A)


@dataclasses.dataclass
class EnvState:
    gens: List[torch.Generator]      # one CPU generator per env
    robot: RobotState
    humans: HumanState
    human_num: torch.Tensor          # (B,) int64 — active slot count
    last_human_states: torch.Tensor  # (B, A, 5) belief [px, py, vx, vy, r]
    prev_human_states: torch.Tensor  # (B, A, 5) the belief one step earlier
    visible_masks: torch.Tensor      # (B, A) bool
    potential: torch.Tensor          # (B,)
    global_time: torch.Tensor        # (B,)
    step_count: torch.Tensor         # (B,) int64
    desired_velocity: torch.Tensor   # (B,) the unicycle's accumulated speed
    orca_neighbor_dist: torch.Tensor  # (B,)
    traj_buffer: torch.Tensor        # (B, L, A, 2) GST history (L = 0
    mask_buffer: torch.Tensor        # (B, L, A) bool   without GST)
    human_future_traj: torch.Tensor  # (B, K+1, A, 4) const_vel / truth future


@dataclasses.dataclass
class Observation:
    robot_node: torch.Tensor          # (B, 7)
    temporal_edges: torch.Tensor      # (B, 2)
    spatial_edges: torch.Tensor       # (B, A, D)
    visible_masks: torch.Tensor       # (B, A) bool
    detected_human_num: torch.Tensor  # (B,) int64, >= 1


@dataclasses.dataclass
class StepInfo:
    outcome: torch.Tensor    # (B,) int64
    min_dist: torch.Tensor   # (B,) min intrusion distance when in Danger


def tree_where(cond: torch.Tensor, new, old):
    """Per-env select over a dataclass (or dict) of batched tensors: ``new``
    where ``cond`` (B,) is True, else ``old``. Generators are taken from
    ``new`` (they are the same objects either way)."""
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: tree_where(cond, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(new)})
    if isinstance(new, dict):
        return {k: tree_where(cond, new[k], old[k]) for k in new}
    if isinstance(new, torch.Tensor):
        c = cond.reshape(cond.shape + (1,) * (new.dim() - 1))
        return torch.where(c, new, old)
    return new


def tree_scatter(idx: torch.Tensor, src, dst):
    """``dst`` with env slots ``idx`` (K,) replaced by the K envs of ``src``,
    over a dataclass (or dict) of batched tensors. Generators are taken from
    ``dst``."""
    if dataclasses.is_dataclass(dst):
        return dataclasses.replace(dst, **{
            f.name: tree_scatter(idx, getattr(src, f.name), getattr(dst, f.name))
            for f in dataclasses.fields(dst)})
    if isinstance(dst, dict):
        return {k: tree_scatter(idx, src[k], dst[k]) for k in dst}
    if isinstance(dst, torch.Tensor):
        return dst.index_copy(0, idx, src)
    return dst
