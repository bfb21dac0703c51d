"""Scalar NumPy ORCA oracle (JAX package ``utils/orca_oracle.py``).

A straightforward, loop-based float64 implementation of the RVO2 algorithm
(van den Berg et al., ISRR 2009), an independent reference for the batched
``env/orca.py`` and the native engine (``runtime/native.py``) where the JAX
package is not installed (the reference repo relied on the external C++
``rvo2`` binding, reference crowd_nav/policy/orca.py:64-117). The
neighbours are unmasked: pass only the present ones.
"""

from __future__ import annotations

import numpy as np

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
