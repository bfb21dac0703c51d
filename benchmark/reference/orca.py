"""Batched ORCA (Optimal Reciprocal Collision Avoidance) in PyTorch.

Port of the JAX package's ``env/orca.py``: ``orca_lines``, the incremental
2-D linear programs LP1/LP2 and the LP3 projection fallback of RVO2 (van den
Berg et al., "Reciprocal n-Body Collision Avoidance", ISRR 2009), batched
over a flat ego axis E. Every ego has its own neighbour slice; nothing loops
over envs or humans.

The JAX package runs LP2 as a sequential loop of LP1 calls and LP3 as a
sequential loop of LP2 calls. Eagerly, that is ~440 sequential steps of many
small ops per call. Two observations let the port do the same arithmetic in
far fewer launches, with identical results:
  * LP1 on line i depends on the running LP2 result only through its
    fallback (an infeasible LP1 keeps the current result). So LP1 is
    evaluated for all lines at once (:func:`_lp1_all`), and the sequential
    loop over lines only selects (:func:`_lp2`).
  * LP3's inner LP2 for outer line i reads only the lines, never the outer
    running result. So all of them run as one batched LP2 over an extra axis,
    and LP3's outer loop only selects (:func:`_lp3`).
The remaining loops run over the ~21 line slots, each step a few whole-batch
tensor ops. LP3 stays bounded at the outer line index (PARITY.md, deviation
11) and, as in ``orca_velocity_batch`` (JAX ``orca.py:269-301``), runs only
for the egos whose LP2 failed.
"""

from __future__ import annotations

import torch

_EPS = 1e-5      # RVO_EPSILON
_SAFE = 1e-9     # guard against 0/0 in degenerate (coincident-agent) states


def _det(a, b):
    """2x2 determinant of stacked 2-vectors; broadcasts over leading dims."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def orca_lines(ego_pos, ego_vel, ego_radius, nbr_pos, nbr_vel, nbr_radius,
               nbr_mask, time_step: float, time_horizon: float,
               neighbor_dist):
    """ORCA half-planes for E egos against N masked neighbours each.

    ego_*: (E, 2) / (E,); nbr_*: (E, N, 2) / (E, N); neighbor_dist (E,).
    Returns (direction (E, N, 2), point (E, N, 2), valid (E, N)).
    Neighbours outside ``neighbor_dist`` are dropped (RVO2's KdTree query).
    """
    inv_th = 1.0 / time_horizon
    inv_dt = 1.0 / time_step

    rel_pos = nbr_pos - ego_pos[:, None, :]
    rel_vel = ego_vel[:, None, :] - nbr_vel
    dist_sq = _dot(rel_pos, rel_pos)
    comb_r = ego_radius[:, None] + nbr_radius
    comb_r_sq = comb_r * comb_r

    valid = nbr_mask & (dist_sq < (neighbor_dist ** 2)[:, None])
    no_collision = dist_sq > comb_r_sq

    # no-collision branch: project on the cut-off circle or on a leg
    w = rel_vel - inv_th * rel_pos
    w_len_sq = _dot(w, w)
    dot1 = _dot(w, rel_pos)
    on_circle = (dot1 < 0.0) & (dot1 * dot1 > comb_r_sq * w_len_sq)

    w_len = torch.sqrt(w_len_sq.clamp_min(_SAFE))
    unit_w = w / w_len[..., None]
    dir_circle = torch.stack([unit_w[..., 1], -unit_w[..., 0]], dim=-1)
    u_circle = (comb_r * inv_th - w_len)[..., None] * unit_w

    leg = torch.sqrt((dist_sq - comb_r_sq).clamp_min(0.0))
    rx, ry = rel_pos[..., 0], rel_pos[..., 1]
    left_leg = torch.stack([rx * leg - ry * comb_r, rx * comb_r + ry * leg], -1)
    right_leg = torch.stack([rx * leg + ry * comb_r, -rx * comb_r + ry * leg], -1)
    use_left = _det(rel_pos, w) > 0.0
    dir_leg = torch.where(use_left[..., None], left_leg, -right_leg) \
        / dist_sq.clamp_min(_SAFE)[..., None]
    dot2 = _dot(rel_vel, dir_leg)
    u_leg = dot2[..., None] * dir_leg - rel_vel

    dir_nc = torch.where(on_circle[..., None], dir_circle, dir_leg)
    u_nc = torch.where(on_circle[..., None], u_circle, u_leg)

    # collision branch
    w_c = rel_vel - inv_dt * rel_pos
    w_c_len = torch.sqrt(_dot(w_c, w_c)).clamp_min(_SAFE)
    unit_w_c = w_c / w_c_len[..., None]
    dir_c = torch.stack([unit_w_c[..., 1], -unit_w_c[..., 0]], dim=-1)
    u_c = (comb_r * inv_dt - w_c_len)[..., None] * unit_w_c

    direction = torch.where(no_collision[..., None], dir_nc, dir_c)
    u = torch.where(no_collision[..., None], u_nc, u_c)
    point = ego_vel[:, None, :] + 0.5 * u   # reciprocity: share avoidance 50/50
    return direction, point, valid


def _lp1_all(d, p, valid, radius, opt_vel, direction_opt: bool):
    """RVO2 linearProgram1 for every line i at once, each constrained by the
    valid lines j < i (JAX ``orca.py:124-163``).

    d, p (..., n, 2); valid (..., n); radius (...); opt_vel (..., 2).
    Returns (candidate (..., n, 2), feasible (..., n))."""
    n = d.shape[-2]
    dot = _dot(p, d)
    disc = dot * dot + (radius * radius)[..., None] - _dot(p, p)
    feasible = disc >= 0.0
    sqrt_disc = torch.sqrt(disc.clamp_min(0.0))
    t_left = -dot - sqrt_disc
    t_right = -dot + sqrt_disc

    di, pi = d[..., :, None, :], p[..., :, None, :]     # line i
    dj, pj = d[..., None, :, :], p[..., None, :, :]     # constraint j
    denom = _det(di, dj)                                # (..., n, n)
    numer = _det(dj, pi - pj)
    parallel = denom.abs() <= _EPS
    earlier = torch.ones(n, n, dtype=torch.bool, device=d.device).tril(-1)
    cmask = valid[..., None, :] & earlier

    # a parallel constraint that line i entirely violates
    feasible &= ~(cmask & parallel & (numer < 0.0)).any(dim=-1)

    t = numer / torch.where(parallel, torch.ones_like(denom), denom)
    upper = cmask & ~parallel & (denom >= 0.0)
    lower = cmask & ~parallel & (denom < 0.0)
    inf = torch.full_like(t, float("inf"))
    t_right = torch.minimum(t_right, torch.where(upper, t, inf).amin(dim=-1))
    t_left = torch.maximum(t_left, torch.where(lower, t, -inf).amax(dim=-1))
    feasible &= t_left <= t_right

    if direction_opt:
        t_opt = torch.where(_dot(opt_vel[..., None, :], d) > 0.0,
                            t_right, t_left)
    else:
        t_opt = torch.minimum(torch.maximum(
            _dot(d, opt_vel[..., None, :] - p), t_left), t_right)
    return p + t_opt[..., None] * d, feasible


def _lp2(d, p, valid, radius, opt_vel, direction_opt: bool):
    """RVO2 linearProgram2 over masked lines (JAX ``orca.py:166-209``).
    Returns (result (..., 2), fail (...)); fail == n means feasible."""
    n = d.shape[-2]
    if direction_opt:
        result = opt_vel * radius[..., None]
    else:
        speed = torch.sqrt(_dot(opt_vel, opt_vel))
        result = torch.where(
            (speed > radius)[..., None],
            opt_vel / speed.clamp_min(_SAFE)[..., None] * radius[..., None],
            opt_vel)
    cand, feas = _lp1_all(d, p, valid, radius, opt_vel, direction_opt)
    fail = torch.full(valid.shape[:-1], n, dtype=torch.long, device=d.device)
    for i in range(n):
        need = valid[..., i] & (fail == n) & \
            (_det(d[..., i, :], p[..., i, :] - result) > 0.0)
        result = torch.where((need & feas[..., i])[..., None], cand[..., i, :],
                             result)
        fail = torch.where(need & ~feas[..., i], torch.full_like(fail, i), fail)
    return result, fail


def _lp3(d, p, valid, fail_begin, radius, result):
    """RVO2 linearProgram3: minimise the maximum constraint violation when
    LP2 failed (JAX ``orca.py:212-253``). d, p (E, n, 2); valid (E, n);
    fail_begin (E,); radius (E,); result (E, 2)."""
    n = d.shape[-2]
    di, pi = d[:, :, None, :], p[:, :, None, :]         # outer line i
    dj, pj = d[:, None, :, :], p[:, None, :, :]         # line j < i
    determinant = _det(di, dj)                          # (E, n, n)
    parallel = determinant.abs() <= _EPS
    same_dir = _dot(di, dj) > 0.0
    mid_point = 0.5 * (pi + pj)
    t_proj = _det(dj, pi - pj) / torch.where(
        parallel, torch.ones_like(determinant), determinant)
    gen_point = pi + t_proj[..., None] * di
    proj_pt = torch.where(parallel[..., None], mid_point, gen_point)
    dir_diff = dj - di
    dir_len = torch.sqrt(_dot(dir_diff, dir_diff)).clamp_min(_SAFE)
    proj_dir = dir_diff / dir_len[..., None]
    earlier = torch.ones(n, n, dtype=torch.bool, device=d.device).tril(-1)
    # parallel lines pointing the same way impose no projected constraint
    proj_valid = valid[:, None, :] & earlier & ~(parallel & same_dir)
    perp = torch.stack([-d[..., 1], d[..., 0]], dim=-1)     # (E, n, 2)

    # every outer line's inner LP2 at once
    res2, fail2 = _lp2(proj_dir, proj_pt, proj_valid,
                       radius[:, None].expand(-1, n), perp, True)
    ok = fail2 == n

    distance = torch.zeros_like(radius)
    for i in range(n):
        d_i, p_i = d[:, i, :], p[:, i, :]
        need = valid[:, i] & (fail_begin <= i) & \
            (_det(d_i, p_i - result) > distance)
        result = torch.where((need & ok[:, i])[:, None], res2[:, i, :], result)
        distance = torch.where(need, _det(d_i, p_i - result), distance)
    return result


def orca_velocity_batch(ego_pos, ego_vel, ego_radius, ego_max_speed,
                        pref_vel, nbr_pos, nbr_vel, nbr_radius, nbr_mask,
                        time_step: float, time_horizon: float, neighbor_dist):
    """New ORCA velocities (E, 2) for E egos (JAX ``orca_velocity_batch``).

    Radii must already include RVO2's +0.01 margin and the safety space;
    ``pref_vel`` is the unit-clipped preferred velocity. LP3 runs only on the
    egos whose LP2 failed (one host sync to find them)."""
    d, p, valid = orca_lines(ego_pos, ego_vel, ego_radius, nbr_pos, nbr_vel,
                             nbr_radius, nbr_mask, time_step, time_horizon,
                             neighbor_dist)
    result, fail = _lp2(d, p, valid, ego_max_speed, pref_vel, False)
    idx = (fail < d.shape[-2]).nonzero().squeeze(-1)
    if idx.numel():
        lp3 = _lp3(d[idx], p[idx], valid[idx], fail[idx], ego_max_speed[idx],
                   result[idx])
        result = result.index_copy(0, idx, lp3)
    return result
