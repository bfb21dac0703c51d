"""Agent kinematics, batched over envs (JAX package ``env/kinematics.py``;
reference crowd_sim/envs/utils/agent.py:143-183): the holonomic robot and
the unicycle (differential-drive) robot."""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def step_holonomic(pos, action_vxy, dt: float):
    """Returns (new_pos, new_vel)."""
    return pos + action_vxy * dt, action_vxy


def step_unicycle(pos, theta, action_v, action_r, dt: float):
    """Differential-drive integration (``kinematics.py:19-31``). pos (B, 2);
    theta, action_v and action_r (B,), ``action_r`` a heading change per
    step. A turn of |action_r| < 1e-4 has turn radius 0, so the robot does
    not move on that step (agent.py:158-165). Returns (pos, theta in
    [0, 2 pi), vel)."""
    straight = action_r.abs() < 1e-4
    w = action_r / dt
    r_turn = torch.where(straight, torch.zeros_like(action_v),
                         action_v / torch.where(straight, torch.ones_like(w),
                                                w))
    turned = theta + action_r
    px = pos[:, 0] - r_turn * torch.sin(theta) + r_turn * torch.sin(turned)
    py = pos[:, 1] + r_turn * torch.cos(theta) - r_turn * torch.cos(turned)
    new_theta = torch.remainder(turned, TWO_PI)
    vel = torch.stack([action_v * torch.cos(new_theta),
                       action_v * torch.sin(new_theta)], dim=-1)
    return torch.stack([px, py], dim=-1), new_theta, vel


def clip_holonomic_action(raw_action, v_pref):
    """Norm-clip raw (vx, vy) (B, 2) to the preferred speed (B,)."""
    norm = torch.linalg.norm(raw_action, dim=-1)
    scale = torch.where(norm > v_pref, v_pref / norm.clamp_min(1e-9),
                        torch.ones_like(norm))
    return raw_action * scale[:, None]


def clip_unicycle_action(raw_action):
    """Clip raw (delta_v, delta_theta) (B, 2) for the unicycle robot
    (``kinematics.py:40-44``; srnn.py:37-44): delta_v to [-0.1, 0.087],
    delta_theta to [-0.06, 0.06]."""
    return torch.stack([raw_action[:, 0].clamp(-0.1, 0.087),
                        raw_action[:, 1].clamp(-0.06, 0.06)], dim=-1)
