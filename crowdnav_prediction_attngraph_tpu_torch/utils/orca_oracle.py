"""Scalar NumPy ORCA oracle (JAX package ``utils/orca_oracle.py``).

A straightforward, loop-based float64 implementation of the RVO2 algorithm
(van den Berg et al., ISRR 2009), an independent reference for the batched
``env/orca.py`` and the native engine (``runtime/native.py``) where the JAX
package is not installed (the reference repo relied on the external C++
``rvo2`` binding, reference crowd_nav/policy/orca.py:64-117). The
neighbours are unmasked: pass only the present ones.

It also holds the seeded scenes that the ORCA kernel is checked on against
the batched plain solve (``random_scene``, ``scene_tensors``,
``SCENE_SHAPES``, ``plain_solve``, ``lp2_failures``), shared by the card
tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..env.orca import _lp2, orca_lines, reference_orca_velocity_batch

EPS = 1e-5


def det(a, b):
    return a[0] * b[1] - a[1] * b[0]


def lp1(lines, line_no, radius, opt_vel, direction_opt, result):
    d = lines[line_no][1]
    p = lines[line_no][0]
    dot = np.dot(p, d)
    disc = dot * dot + radius * radius - np.dot(p, p)
    if disc < 0.0:
        return False, result
    sqrt_disc = np.sqrt(disc)
    t_left = -dot - sqrt_disc
    t_right = -dot + sqrt_disc
    for i in range(line_no):
        pi, di = lines[i]
        denom = det(d, di)
        numer = det(di, p - pi)
        if abs(denom) <= EPS:
            if numer < 0.0:
                return False, result
            continue
        t = numer / denom
        if denom >= 0.0:
            t_right = min(t_right, t)
        else:
            t_left = max(t_left, t)
        if t_left > t_right:
            return False, result
    if direction_opt:
        t = t_right if np.dot(opt_vel, d) > 0.0 else t_left
    else:
        t = np.dot(d, opt_vel - p)
        t = min(max(t, t_left), t_right)
    return True, p + t * d


def lp2(lines, radius, opt_vel, direction_opt):
    if direction_opt:
        result = opt_vel * radius
    elif np.dot(opt_vel, opt_vel) > radius * radius:
        result = opt_vel / np.linalg.norm(opt_vel) * radius
    else:
        result = np.array(opt_vel, dtype=np.float64)
    for i, (p, d) in enumerate(lines):
        if det(d, p - result) > 0.0:
            ok, new_result = lp1(lines, i, radius, opt_vel, direction_opt,
                                 result)
            if not ok:
                return i, result
            result = new_result
    return len(lines), result


def lp3(lines, begin_line, radius, result):
    distance = 0.0
    for i in range(begin_line, len(lines)):
        p_i, d_i = lines[i]
        if det(d_i, p_i - result) > distance:
            proj_lines = []
            for j in range(i):
                p_j, d_j = lines[j]
                determinant = det(d_i, d_j)
                if abs(determinant) <= EPS:
                    if np.dot(d_i, d_j) > 0.0:
                        continue
                    point = 0.5 * (p_i + p_j)
                else:
                    point = p_i + (det(d_j, p_i - p_j) / determinant) * d_i
                direction = (d_j - d_i) / np.linalg.norm(d_j - d_i)
                proj_lines.append((point, direction))
            perp = np.array([-d_i[1], d_i[0]])
            fail, new_result = lp2(proj_lines, radius, perp, True)
            if fail >= len(proj_lines):
                result = new_result
            distance = det(d_i, p_i - result)
    return result


def orca_velocity_np(ego_pos, ego_vel, ego_radius, ego_max_speed, pref_vel,
                     nbr_pos, nbr_vel, nbr_radius, time_step, time_horizon,
                     neighbor_dist):
    """New ORCA velocity for the ego agent. Radii pre-inflated by caller."""
    ego_pos = np.asarray(ego_pos, dtype=np.float64)
    ego_vel = np.asarray(ego_vel, dtype=np.float64)
    pref_vel = np.asarray(pref_vel, dtype=np.float64)
    inv_th = 1.0 / time_horizon
    inv_dt = 1.0 / time_step

    lines = []
    for j in range(len(nbr_pos)):
        rel_pos = np.asarray(nbr_pos[j], dtype=np.float64) - ego_pos
        if np.dot(rel_pos, rel_pos) >= neighbor_dist ** 2:
            continue
        rel_vel = ego_vel - np.asarray(nbr_vel[j], dtype=np.float64)
        dist_sq = np.dot(rel_pos, rel_pos)
        comb_r = ego_radius + nbr_radius[j]
        comb_r_sq = comb_r * comb_r
        if dist_sq > comb_r_sq:
            w = rel_vel - inv_th * rel_pos
            w_len_sq = np.dot(w, w)
            dot1 = np.dot(w, rel_pos)
            if dot1 < 0.0 and dot1 * dot1 > comb_r_sq * w_len_sq:
                w_len = np.sqrt(w_len_sq)
                unit_w = w / w_len
                direction = np.array([unit_w[1], -unit_w[0]])
                u = (comb_r * inv_th - w_len) * unit_w
            else:
                leg = np.sqrt(dist_sq - comb_r_sq)
                if det(rel_pos, w) > 0.0:
                    direction = np.array([
                        rel_pos[0] * leg - rel_pos[1] * comb_r,
                        rel_pos[0] * comb_r + rel_pos[1] * leg]) / dist_sq
                else:
                    direction = -np.array([
                        rel_pos[0] * leg + rel_pos[1] * comb_r,
                        -rel_pos[0] * comb_r + rel_pos[1] * leg]) / dist_sq
                dot2 = np.dot(rel_vel, direction)
                u = dot2 * direction - rel_vel
        else:
            w = rel_vel - inv_dt * rel_pos
            w_len = np.linalg.norm(w)
            unit_w = w / w_len
            direction = np.array([unit_w[1], -unit_w[0]])
            u = (comb_r * inv_dt - w_len) * unit_w
        lines.append((ego_vel + 0.5 * u, direction))

    fail, result = lp2(lines, ego_max_speed, pref_vel, False)
    if fail < len(lines):
        result = lp3(lines, fail, ego_max_speed, result)
    return result


SCENE_KINDS = ("crowd", "coincident", "masked", "far", "parallel")
# the checks' shapes (egos, lines): the humans' solve of the flagship (64
# envs x 20 humans, 21 lines with the robot) and of config 5 (256 x 50, 51),
# and the scripted ORCA robot's truth rollout ((K + 1) x A lines: 64 envs x
# 120, 500 cases x 300); the scenes' time step and horizon
SCENE_SHAPES = ((1280, 21), (12800, 51), (64, 120), (500, 300))
SCENE_TIME_STEP, SCENE_TIME_HORIZON = 0.25, 5.0
# the plain solve's elements per chunk of egos: its LP3 builds (egos, n, n,
# n) tensors, 74 egos at a time at n = 300
PLAIN_CHUNK_ELEMENTS = 2e9


def random_scene(egos: int, n: int, seed: int, kind: str = "crowd"):
    """Seeded ORCA inputs for the checks of the batched solve: ``[ego_pos,
    ego_vel, ego_radius, ego_max_speed, pref_vel, nbr_pos, nbr_vel,
    nbr_radius, nbr_mask, neighbor_dist]`` as NumPy arrays (float64, the
    mask bool), in the order of ``env/orca.py``'s ``orca_velocity_batch``.

    ``crowd``: each ego's n neighbours scattered around it (standard
    deviation 1.1 sqrt(n) m, so that a fifth to a quarter of the egos fail
    LP2 and run LP3), 85% of the slots present, radii with the +0.01 margin,
    neighbor_dist 5-10 m. On top of that, ``coincident``: every other
    neighbour on its ego, every fourth with its velocity too, and every
    other ego, with its neighbours, at rest at the origin; ``masked``: no
    neighbour present; ``far``: neighbor_dist 0.5 m, so nearly all are out
    of reach; ``parallel``: every slot present, the second half of the
    neighbours mirrored through the ego (positions and relative velocities)
    and the last a copy of the first, so lines come in antiparallel and
    parallel pairs."""
    if kind not in SCENE_KINDS:
        raise ValueError(f"kind must be one of {SCENE_KINDS}, got {kind!r}")
    g = np.random.default_rng(seed)
    ego_pos = g.uniform(-4.0, 4.0, (egos, 2))
    ego_vel = g.normal(0.0, 0.5, (egos, 2))
    ego_radius = 0.31 + g.uniform(0.0, 0.15, egos)
    ego_max_speed = g.uniform(0.5, 1.5, egos)
    pref = g.normal(0.0, 1.0, (egos, 2))
    speed = np.linalg.norm(pref, axis=-1, keepdims=True)
    pref_vel = np.where(speed > 1.0, pref / speed, pref)
    nbr_pos = ego_pos[:, None] + g.normal(0.0, 1.1 * np.sqrt(n), (egos, n, 2))
    nbr_vel = g.normal(0.0, 0.5, (egos, n, 2))
    nbr_radius = 0.31 + g.uniform(0.0, 0.15, (egos, n))
    nbr_mask = g.random((egos, n)) < 0.85
    neighbor_dist = g.uniform(5.0, 10.0, egos)
    if kind == "coincident":
        nbr_pos[:, ::2] = ego_pos[:, None]
        nbr_vel[:, ::4] = ego_vel[:, None]
        for a in (ego_pos, ego_vel, nbr_pos, nbr_vel):
            a[1::2] = 0.0
    elif kind == "masked":
        nbr_mask[:] = False
    elif kind == "far":
        neighbor_dist[:] = 0.5
    elif kind == "parallel":
        half = n // 2
        nbr_pos[:, half:2 * half] = 2 * ego_pos[:, None] - nbr_pos[:, :half]
        nbr_vel[:, half:2 * half] = 2 * ego_vel[:, None] - nbr_vel[:, :half]
        nbr_radius[:, half:2 * half] = nbr_radius[:, :half]
        for a in (nbr_pos, nbr_vel, nbr_radius):
            a[:, -1] = a[:, 0]
        nbr_mask[:] = True
    return [ego_pos, ego_vel, ego_radius, ego_max_speed, pref_vel, nbr_pos,
            nbr_vel, nbr_radius, nbr_mask, neighbor_dist]


def scene_tensors(egos: int, n: int, seed: int, device,
                  dtype=torch.float32, kind: str = "crowd") -> list:
    """:func:`random_scene` as tensors on ``device``: the floats in
    ``dtype``, the mask bool."""
    return [torch.from_numpy(a).to(device) if a.dtype == bool
            else torch.from_numpy(a).to(device, dtype)
            for a in random_scene(egos, n, seed, kind)]


def plain_solve(args) -> torch.Tensor:
    """``reference_orca_velocity_batch`` on a scene's tensors, some egos at
    a time (``PLAIN_CHUNK_ELEMENTS``): each ego is solved on its own, so the
    chunks give the bits of one call."""
    egos, n = args[8].shape
    chunk = max(16, int(PLAIN_CHUNK_ELEMENTS // n ** 3))
    return torch.cat([reference_orca_velocity_batch(
        *(t[i:i + chunk] for t in args[:9]), SCENE_TIME_STEP,
        SCENE_TIME_HORIZON, args[9][i:i + chunk])
        for i in range(0, egos, chunk)])


def lp2_failures(args) -> int:
    """The egos of a scene whose plain LP2 fails: those that run LP3."""
    d, p, valid = orca_lines(*args[:3], *args[5:9], SCENE_TIME_STEP,
                             SCENE_TIME_HORIZON, args[9])
    _, fail = _lp2(d, p, valid, args[3], args[4], False)
    return int((fail < d.shape[1]).sum())
