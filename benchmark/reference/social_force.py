"""Batched social-force policy (JAX package ``env/social_force.py``;
reference crowd_nav/policy/social_force.py:11-49), for E egos at once."""

from __future__ import annotations

import torch


def social_force_velocity(ego_pos, ego_vel, ego_radius, ego_goal, ego_v_pref,
                          nbr_pos, nbr_radius, nbr_mask, A: float, B: float,
                          KI: float, time_step: float):
    """New velocities (E, 2) under the circular social-force model: goal
    attraction (social_force.py:16-23) plus exponential repulsion from the
    masked neighbours (:26-35), the speed clipped to v_pref (:41-49).

    ego_*: (E, 2) / (E,); nbr_pos (E, N, 2); nbr_radius, nbr_mask (E, N).
    Masked neighbours contribute no force."""
    delta = ego_goal - ego_pos
    dist_to_goal = torch.linalg.norm(delta, dim=-1).clamp_min(1e-9)
    desired_v = delta / dist_to_goal[:, None] * ego_v_pref[:, None]
    pull = KI * (desired_v - ego_vel)

    d = ego_pos[:, None, :] - nbr_pos                          # (E, N, 2)
    dist = torch.linalg.norm(d, dim=-1).clamp_min(1e-9)
    mag = A * torch.exp((ego_radius[:, None] + nbr_radius - dist) / B) / dist
    push = torch.where(nbr_mask[..., None], mag[..., None] * d,
                       torch.zeros_like(d)).sum(dim=1)

    new_v = ego_vel + (pull + push) * time_step
    speed = torch.linalg.norm(new_v, dim=-1, keepdim=True)
    v_pref = ego_v_pref[:, None]
    return torch.where(speed > v_pref,
                       new_v / speed.clamp_min(1e-9) * v_pref, new_v)
