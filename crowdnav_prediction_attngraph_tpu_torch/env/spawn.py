"""Episode-generation primitives, batched over envs (JAX package
``env/spawn.py``).

Fixed-round batched proposal/rejection passes stand in for the reference's
sequential NumPy rejection loops (crowd_sim_var_num.py:64-146,
crowd_sim.py:413-485), as in the JAX package. Random numbers come from one
CPU ``torch.Generator`` per env: :func:`draw_uniform` takes a fixed count of
U[0, 1) values from each, so a case's stream does not depend on the batch it
runs in or on the device. The functions here take those values as ``u``
(B, n) and consume them in a fixed layout. The streams differ from
``jax.random``'s, so seeded cases match the JAX package only in
distribution (PARITY.md, "Known deviations" 1).

The rejection-sampling passes, :func:`batched_circle_spawn` and
:func:`batched_goal_resample`, run their plain versions
(:func:`reference_circle_spawn`, :func:`reference_goal_resample`: whole-batch
tensor ops, round by round) for CPU tensors. For CUDA tensors they launch one
hand-written kernel (``ops/csrc/human_spawn.cu``) that runs every round of a
pass for each env in a thread block, with the same arithmetic bit for bit and
no host read.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ..ops import _build
from ..utils import profiling
from ..utils.profiling import count

KERNEL = "human_spawn"
TWO_PI = 2.0 * math.pi
ROBOT_CANDIDATES = 24
SPAWN_ROUNDS = 10
GOAL_ROUNDS = 8


def draw_uniform(gens: List[torch.Generator], n: int, device) -> torch.Tensor:
    """(B, n) U[0, 1) values, row b from ``gens[b]`` (drawn on the CPU)."""
    u = torch.stack([torch.rand(n, generator=g) for g in gens])
    return u.to(device, non_blocking=True)


def robot_draws() -> int:
    return 4 * ROBOT_CANDIDATES


def sample_robot_position(u, arena_size: float, min_goal_dist: float):
    """Holonomic robot spawn (``spawn.py:21-35``): U(-arena, arena)^4 until
    |p - g| >= min_goal_dist, as ``ROBOT_CANDIDATES`` parallel draws (first
    valid wins; deterministic corner fallback). u (B, robot_draws())."""
    B = u.shape[0]
    vals = (u.reshape(B, ROBOT_CANDIDATES, 4) * 2.0 - 1.0) * arena_size
    ok = torch.linalg.norm(vals[..., :2] - vals[..., 2:], dim=-1) >= min_goal_dist
    first = ok.to(torch.uint8).argmax(dim=1)
    chosen = vals[torch.arange(B, device=u.device), first]
    count("sync.reset_robot")
    fallback = torch.tensor([-arena_size, -arena_size, arena_size, arena_size],
                            device=u.device, dtype=u.dtype)
    chosen = torch.where(ok.any(dim=1)[:, None], chosen, fallback)
    return chosen[:, :2], chosen[:, 2:]


def unicycle_robot_draws() -> int:
    return 2 + 2 * ROBOT_CANDIDATES


def sample_unicycle_robot(u, arena_size: float, min_goal_dist: float):
    """Unicycle robot spawn (``spawn.py:35-47``; crowd_sim_var_num.py:78-87):
    the robot on the arena circle at a uniform angle, its goal the first of
    ``ROBOT_CANDIDATES`` U(-arena, arena)^2 draws at least min_goal_dist
    away (-pos when none is), its heading uniform on [0, 2 pi).
    u (B, unicycle_robot_draws()): the angle, the candidates, the heading.
    Returns (pos (B, 2), goal (B, 2), theta (B,))."""
    B = u.shape[0]
    u_angle, u_goal, u_theta = split_draws(u, (1, 2 * ROBOT_CANDIDATES, 1))
    angle = u_angle[:, 0] * TWO_PI
    pos = arena_size * torch.stack([torch.cos(angle), torch.sin(angle)], -1)
    g = (u_goal.reshape(B, ROBOT_CANDIDATES, 2) * 2.0 - 1.0) * arena_size
    ok = torch.linalg.norm(pos[:, None] - g, dim=-1) >= min_goal_dist
    first = g[torch.arange(B, device=u.device), ok.to(torch.uint8).argmax(1)]
    goal = torch.where(ok.any(dim=1)[:, None], first, -pos)
    return pos, goal, u_theta[:, 0] * TWO_PI


def circle_spawn_draws(A: int) -> int:
    return 3 * A * (SPAWN_ROUNDS + 1)


def _ring(u_angle, u_noise, circle_radius: float, noise_scale, noise_shift):
    angle = u_angle * TWO_PI
    ring = circle_radius * torch.stack([torch.cos(angle), torch.sin(angle)], -1)
    return ring + (u_noise.reshape(u_noise.shape[0], -1, 2) + noise_shift) \
        * noise_scale


def batched_circle_spawn(u, need, self_radius, circle_radius: float,
                         robot_pos, robot_goal, robot_radius, humans_pos,
                         humans_goal, humans_radius, placed,
                         discomfort_dist: float, robot_min_dist=None):
    """:func:`reference_circle_spawn`, as one launch of the kernel's
    ``circle_spawn`` for CUDA tensors (float32 but the bool masks; the
    slots in ``need`` are added on the device to ``spawn.slots``). Returns
    (pos, goal), each (B, A, 2)."""
    if need.device.type != "cuda":
        return reference_circle_spawn(
            u, need, self_radius, circle_radius, robot_pos, robot_goal,
            robot_radius, humans_pos, humans_goal, humans_radius, placed,
            discomfort_dist, robot_min_dist)
    B, A = need.shape
    pos = torch.empty(B, A, 2, device=need.device)
    goal = torch.empty_like(pos)
    f32, mask = torch.float32, torch.bool
    _launch("circle_spawn", u, circle_spawn_draws(A),
            ((need, mask, (B, A)), (self_radius, f32, (B, A)),
             (robot_pos, f32, (B, 2)), (robot_goal, f32, (B, 2)),
             (robot_radius, f32, (B,)), (humans_pos, f32, (B, A, 2)),
             (humans_goal, f32, (B, A, 2)), (humans_radius, f32, (B, A)),
             (placed, mask, (B, A)), (pos, f32, (B, A, 2)),
             (goal, f32, (B, A, 2))),
            (SPAWN_ROUNDS, float(circle_radius), float(discomfort_dist),
             float(robot_min_dist or 0.0), int(robot_min_dist is not None)))
    return pos, goal


def reference_circle_spawn(u, need, self_radius, circle_radius: float,
                           robot_pos, robot_goal, robot_radius, humans_pos,
                           humans_goal, humans_radius, placed,
                           discomfort_dist: float, robot_min_dist=None):
    """Circle-crossing spawn for every slot in ``need`` (B, A) at once
    (``spawn.py:53-124``): each of ``SPAWN_ROUNDS`` rounds proposes positions
    for the still-unplaced slots, rejecting against the robot's position and
    goal, already placed humans, and lower-indexed proposals of the round.
    A slot still unplaced after the last round keeps its fallback proposal.
    u (B, circle_spawn_draws(A)). Returns (pos, goal), each (B, A, 2)."""
    B, A = need.shape
    idx = torch.arange(A, device=need.device)
    chunks = u.reshape(B, SPAWN_ROUNDS + 1, 3 * A)

    def proposal(c):
        return _ring(c[:, :A], c[:, A:], circle_radius, 2.0, 0.0)

    fallback = proposal(chunks[:, 0])
    pos = torch.where(need[..., None], fallback, humans_pos)
    placed_now = placed & ~need
    md_rob = self_radius + robot_radius[:, None] + discomfort_dist
    if robot_min_dist is not None:
        md_rob = torch.full_like(md_rob, robot_min_dist)
    md_pp = self_radius[:, :, None] + self_radius[:, None, :] + discomfort_dist
    md_ph = self_radius[:, :, None] + humans_radius[:, None, :] + discomfort_dist
    lower_idx = idx[None, :] < idx[:, None]

    for r in range(SPAWN_ROUNDS):
        prop = proposal(chunks[:, r + 1])
        pending = need & ~placed_now
        cand = torch.where(pending[..., None], prop, pos)
        bad = (torch.linalg.norm(cand - robot_pos[:, None], dim=-1) < md_rob) | \
              (torch.linalg.norm(cand - robot_goal[:, None], dim=-1) < md_rob)
        # obstacles: original humans + proposals accepted in earlier rounds
        cur_goal = torch.where((need & placed_now)[..., None], -pos, humans_goal)
        other = placed_now & ~pending
        dp = torch.linalg.norm(cand[:, :, None] - pos[:, None], dim=-1)
        dg = torch.linalg.norm(cand[:, :, None] - cur_goal[:, None], dim=-1)
        bad |= (other[:, None, :] & ((dp < md_ph) | (dg < md_ph))).any(dim=2)
        # this round's proposals: slot i defers to j < i
        dpp = torch.linalg.norm(cand[:, :, None] - cand[:, None], dim=-1)
        dpg = torch.linalg.norm(cand[:, :, None] + cand[:, None], dim=-1)
        lower = lower_idx[None] & pending[:, None, :]
        bad |= (lower & ((dpp < md_pp) | (dpg < md_pp))).any(dim=2)
        accept = pending & ~bad
        pos = torch.where(accept[..., None], cand, pos)
        placed_now = placed_now | accept

    goal = torch.where(need[..., None], -pos, humans_goal)
    pos = torch.where(need[..., None], pos, humans_pos)
    return pos, goal


def goal_resample_draws(A: int) -> int:
    return 3 * A * (GOAL_ROUNDS + 1)


def batched_goal_resample(u, need, self_radius, v_pref, circle_radius: float,
                          robot_pos, robot_goal, robot_radius, humans_pos,
                          humans_goal, humans_radius, active,
                          discomfort_dist: float):
    """:func:`reference_goal_resample`, as one launch of the kernel's
    ``goal_resample`` for CUDA tensors (as :func:`batched_circle_spawn`).
    Returns goals (B, A, 2)."""
    if need.device.type != "cuda":
        return reference_goal_resample(
            u, need, self_radius, v_pref, circle_radius, robot_pos,
            robot_goal, robot_radius, humans_pos, humans_goal, humans_radius,
            active, discomfort_dist)
    B, A = need.shape
    goal = torch.empty(B, A, 2, device=need.device)
    f32, mask = torch.float32, torch.bool
    _launch("goal_resample", u, goal_resample_draws(A),
            ((need, mask, (B, A)), (self_radius, f32, (B, A)),
             (v_pref, f32, (B, A)), (robot_pos, f32, (B, 2)),
             (robot_goal, f32, (B, 2)), (robot_radius, f32, (B,)),
             (humans_pos, f32, (B, A, 2)), (humans_goal, f32, (B, A, 2)),
             (humans_radius, f32, (B, A)), (active, mask, (B, A)),
             (goal, f32, (B, A, 2))),
            (GOAL_ROUNDS, float(circle_radius), float(discomfort_dist)))
    return goal


def reference_goal_resample(u, need, self_radius, v_pref,
                            circle_radius: float, robot_pos, robot_goal,
                            robot_radius, humans_pos, humans_goal,
                            humans_radius, active, discomfort_dist: float):
    """Resample mid-episode goals for all ``need`` slots at once
    (``spawn.py:127-166``). u (B, goal_resample_draws(A)). Returns goals
    (B, A, 2)."""
    B, A = need.shape
    idx = torch.arange(A, device=need.device)
    chunks = u.reshape(B, GOAL_ROUNDS + 1, 3 * A)
    v = torch.where(v_pref == 0.0, torch.ones_like(v_pref), v_pref)[..., None]

    def proposal(c):
        return _ring(c[:, :A], c[:, A:], circle_radius, v, -0.5)

    goal = torch.where(need[..., None], proposal(chunks[:, 0]), humans_goal)
    done = ~need
    md_rob = self_radius + robot_radius[:, None] + discomfort_dist
    others = active[:, None, :] & (idx[None, :] != idx[:, None])[None]
    md = self_radius[:, :, None] + humans_radius[:, None, :] + discomfort_dist
    for r in range(GOAL_ROUNDS):
        prop = proposal(chunks[:, r + 1])
        pending = need & ~done
        bad = (torch.linalg.norm(prop - robot_pos[:, None], dim=-1) < md_rob) | \
              (torch.linalg.norm(prop - robot_goal[:, None], dim=-1) < md_rob)
        dp = torch.linalg.norm(prop[:, :, None] - humans_pos[:, None], dim=-1)
        dg = torch.linalg.norm(prop[:, :, None] - humans_goal[:, None], dim=-1)
        bad |= (others & ((dp < md) | (dg < md))).any(dim=2)
        accept = pending & ~bad
        goal = torch.where(accept[..., None], prop, goal)
        done = done | accept
    return goal


def _launch(symbol: str, u, draws: int, tensors, scalars):
    """One launch of the kernel's entry ``symbol``: ``u`` (B, draws), which
    may be a column slice of a wider draw, then ``tensors`` (as
    ``_build.launch`` takes them, the first (B, A)) and the device counter
    ``spawn.slots``, then B, A and ``scalars``."""
    need = tensors[0][0]
    B, A = need.shape
    slots = profiling.device_counter("spawn.slots", need.device)
    _build.launch(KERNEL, symbol, "spawn",
                  ((_build.Rows(u), torch.float32, (B, draws)), *tensors,
                   (slots, torch.int32, ())), (B, A, *scalars))


def split_draws(u, sizes) -> Tuple[torch.Tensor, ...]:
    """Cut (B, sum(sizes)) draws into consecutive (B, size) pieces."""
    return tuple(torch.split(u, list(sizes), dim=1))
