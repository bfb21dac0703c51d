"""Seeded inputs of the spawn passes (``env/spawn.py``), for their kernel's
card tests and ``chip_smoke.py``.

A scene is B envs of A slots: a crowd of 1..A active humans already placed
on the circle by the plain spawn, a robot and its goal inside the arena,
randomized radii and preferred speeds, and the slots that ``need`` a new
position or goal. The draws ``u`` are a column slice of a wider draw, as
the env step passes them.
"""

from __future__ import annotations

import math

import torch

from ..env import spawn

CIRCLE_RADIUS = 6.0 * math.sqrt(2.0)    # the flagship's circle_radius
ARENA_SIZE = 6.0
DISCOMFORT_DIST = 0.25
NEEDS = ("none", "all", "random")
PLACED = ("rest", "none", "prefix")


def _crowd(B: int, A: int, g: torch.Generator):
    """(active (B, A), pos, goal (B, A, 2), radius, v_pref (B, A), robot
    pos, goal (B, 2), radius (B,)) on the CPU."""
    n = torch.randint(1, A + 1, (B,), generator=g)
    active = torch.arange(A)[None, :] < n[:, None]
    radius = 0.3 + torch.rand(B, A, generator=g) * 0.2
    v_pref = 0.5 + torch.rand(B, A, generator=g)
    robot = (torch.rand(B, 4, generator=g) * 2.0 - 1.0) * ARENA_SIZE
    robot_radius = torch.full((B,), 0.3)
    far = torch.full((B, A, 2), 15.0)
    pos, goal = spawn.reference_circle_spawn(
        torch.rand(B, spawn.circle_spawn_draws(A), generator=g), active,
        radius, CIRCLE_RADIUS, robot[:, :2], robot[:, 2:], robot_radius, far,
        far, radius, torch.zeros_like(active), DISCOMFORT_DIST)
    pos = torch.where(active[..., None], pos, far)
    goal = torch.where(active[..., None], goal, far)
    return active, pos, goal, radius, v_pref, robot[:, :2], robot[:, 2:], \
        robot_radius


def _need(kind: str, active, g: torch.Generator):
    if kind == "none":
        return torch.zeros_like(active)
    if kind == "all":
        return active.clone()
    if kind == "random":
        return active & (torch.rand(active.shape, generator=g) < 0.3)
    raise ValueError(f"need must be one of {NEEDS}, got {kind!r}")


def _draws(B: int, draws: int, g: torch.Generator):
    """(B, draws) U[0, 1) values, a column slice of a wider tensor."""
    return torch.rand(B, draws + 7, generator=g)[:, 3:3 + draws]


def circle_spawn_args(B: int, A: int, seed: int, device, need: str = "random",
                      placed: str = "rest",
                      discomfort_dist: float = DISCOMFORT_DIST) -> list:
    """``batched_circle_spawn``'s positional arguments (without
    ``robot_min_dist``). ``placed``: "rest" (the active slots not in need,
    the respawn's default), "none" (a reset) or "prefix" (the first half of
    the active slots, which may overlap ``need``, as the human count
    change's)."""
    g = torch.Generator().manual_seed(seed)
    active, pos, goal, radius, _, r_pos, r_goal, r_radius = _crowd(B, A, g)
    need_ = _need(need, active, g)
    if placed == "rest":
        placed_ = active & ~need_
    elif placed == "none":
        placed_ = torch.zeros_like(active)
    elif placed == "prefix":
        half = (active.sum(dim=1, keepdim=True) + 1) // 2
        placed_ = torch.arange(A)[None, :] < half
    else:
        raise ValueError(f"placed must be one of {PLACED}, got {placed!r}")
    u = _draws(B, spawn.circle_spawn_draws(A), g)
    dev = [t.to(device) for t in (u, need_, radius, r_pos, r_goal, r_radius,
                                  pos, goal, radius, placed_)]
    return dev[:3] + [CIRCLE_RADIUS] + dev[3:] + [discomfort_dist]


def goal_resample_args(B: int, A: int, seed: int, device,
                       need: str = "random", v_pref_zero: bool = False,
                       discomfort_dist: float = DISCOMFORT_DIST) -> list:
    """``batched_goal_resample``'s positional arguments; with
    ``v_pref_zero`` every third slot stands still (v_pref 0, whose noise
    the plain version scales by 1)."""
    g = torch.Generator().manual_seed(seed)
    active, pos, goal, radius, v_pref, r_pos, r_goal, r_radius = _crowd(B, A, g)
    need_ = _need(need, active, g)
    if v_pref_zero:
        v_pref = torch.where(torch.arange(A) % 3 == 0, 0.0, v_pref)
    u = _draws(B, spawn.goal_resample_draws(A), g)
    dev = [t.to(device) for t in (u, need_, radius, v_pref, r_pos, r_goal,
                                  r_radius, pos, goal, radius, active)]
    return dev[:4] + [CIRCLE_RADIUS] + dev[4:] + [discomfort_dist]
