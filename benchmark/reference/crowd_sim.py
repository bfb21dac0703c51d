"""The crowd-navigation simulator, natively batched over envs.

Port of the JAX package's ``env/crowd_sim.py``, one parametric env family
selected by ``sim.predict_method`` as there: ``none`` (CrowdSimVarNum),
``const_vel`` and ``truth`` (CrowdSimPred) and ``inferred``
(CrowdSimPredRealGST, whose GST predictions ``env/pretext.py`` writes in).
It covers robot and human visibility (:65-113), the humans' neighbour
inputs with the robot's column when it is visible (:120-151), ORCA and
social-force humans (:163-194), the const-vel and ground-truth futures
(:201-271), ``generate_ob`` (:283-346), ``calc_reward`` with the social
term of the CrowdSimPred envs (:353-429), respawn, goal changes and the
varying human count (:436-546), ``reset`` (:553-611), the scripted ORCA and
social-force robots (:614-656) and ``step`` (:659-745), for the holonomic
and the unicycle robot. Where the JAX package vmaps one-env functions,
these take a leading env axis B; every ORCA and social-force call solves
all (env x agent) egos at once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import Config
from . import kinematics, spawn
from .orca import orca_velocity_batch
from .social_force import social_force_velocity
from .types import (EnvState, HumanState, Observation, RobotState, StepInfo,
                    OUTCOME_COLLISION, OUTCOME_DANGER, OUTCOME_NOTHING,
                    OUTCOME_REACH_GOAL, OUTCOME_TIMEOUT, tree_where)

# Belief placeholder for out-of-view humans (crowd_sim.py:258).
BELIEF_DUMMY = (15.0, 15.0, 0.0, 0.0, 0.3)
# Dummy neighbour an agent substitutes for peers outside its FOV.
NEIGHBOR_DUMMY_POS = 7.0
HIDDEN_FUTURE = (15.0, 15.0, 0.0, 0.0)


def stale_neighbor_radii(A: int) -> torch.Tensor:
    """(A,) the fixed U(0.3, 0.5) neighbour radii of the
    ``orca.stale_neighbor_radii`` emulation: the JAX package's
    ``jax.random.uniform(jax.random.key(0), (A,), minval=0.3, maxval=0.5)``
    (``crowd_sim.py:633-634``), bit for bit: threefry-2x32 (20 rounds) of
    key (0, 0) on the counters (0, i), its two words xor-ed (JAX's
    partitionable bit layout), mapped to [1, 2) by the top 23 bits."""
    m = np.uint32

    def rotl(v, r):
        return (v << m(r)) | (v >> m(32 - r))

    ks = (m(0), m(0), m(0x1BD11BDA))               # key words and parity
    x0 = np.zeros(A, np.uint32) + ks[0]
    x1 = np.arange(A, dtype=np.uint32) + ks[1]
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in rotations[i % 2]:
                x0 = x0 + x1
                x1 = rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + m(i + 1)
    unit = (((x0 ^ x1) >> m(9)) | m(0x3F800000)).view(np.float32) - \
        np.float32(1.0)
    lo, hi = np.float32(0.3), np.float32(0.5)
    # unit * (hi - lo) + lo rounded once, as XLA's fused multiply-add does
    # (the f32 product is exact in f64)
    fma = (unit.astype(np.float64) * np.float64(hi - lo)
           + np.float64(lo)).astype(np.float32)
    return torch.from_numpy(np.maximum(lo, fma))


def _active_mask(cfg: Config, human_num) -> torch.Tensor:
    idx = torch.arange(cfg.sim.max_human_num, device=human_num.device)
    return idx[None, :] < human_num[:, None]


def _unicycle(cfg: Config) -> bool:
    return cfg.action_space.kinematics == "unicycle"


def _heading(cfg: Config, vel, theta=None):
    """Holonomic agents head along their velocity (crowd_sim.py:51-53);
    under the unicycle every agent heads along its theta. The JAX package
    (as the reference) switches on the robot's kinematics for the humans
    too, whose theta is 0 there (``crowd_sim.py:77-100``): reproduced."""
    if _unicycle(cfg):
        return torch.zeros_like(vel[..., 0]) if theta is None else theta
    return torch.atan2(vel[..., 1], vel[..., 0])


def _offset_angle(p1_pos, p1_heading, p2_pos):
    """Angle between agent1's heading ray and the ray to agent2."""
    fwd = torch.stack([torch.cos(p1_heading), torch.sin(p1_heading)], dim=-1)
    v12 = p2_pos - p1_pos
    v12 = v12 / torch.linalg.norm(v12, dim=-1, keepdim=True).clamp_min(1e-9)
    return torch.arccos((fwd * v12).sum(dim=-1).clamp(-1.0, 1.0))


def robot_human_visibility(cfg: Config, state: EnvState) -> torch.Tensor:
    """(B, A): which active humans the robot sees (crowd_sim.py:558-572)."""
    heading = _heading(cfg, state.robot.vel, state.robot.theta)
    offset = _offset_angle(state.robot.pos[:, None], heading[:, None],
                           state.humans.pos)
    in_fov = offset.abs() <= (math.pi * cfg.robot.fov) / 2.0
    dist = (torch.linalg.norm(state.humans.pos - state.robot.pos[:, None], dim=-1)
            - state.humans.radius - state.robot.radius[:, None])
    in_range = dist <= cfg.robot.sensor_range
    return _active_mask(cfg, state.human_num) & in_fov & in_range


def human_sees_robot(cfg: Config, state: EnvState) -> torch.Tensor:
    """(B, A): does each active human see the robot (crowd_sim.py:92-100)."""
    heading = _heading(cfg, state.humans.vel)
    offset = _offset_angle(state.humans.pos, heading,
                           state.robot.pos[:, None].expand_as(state.humans.pos))
    in_fov = offset.abs() <= (math.pi * cfg.humans.fov) / 2.0
    return in_fov & _active_mask(cfg, state.human_num)


def human_pair_visibility(cfg: Config, state: EnvState) -> torch.Tensor:
    """(B, A, A): does human i see human j (unbounded range, FOV
    humans.fov * pi)."""
    heading = _heading(cfg, state.humans.vel)                     # (B, A)
    offset = _offset_angle(state.humans.pos[:, :, None], heading[:, :, None],
                           state.humans.pos[:, None, :])
    in_fov = offset.abs() <= (math.pi * cfg.humans.fov) / 2.0
    active = _active_mask(cfg, state.human_num)
    return in_fov & active[:, :, None] & active[:, None, :]


def update_last_human_states(cfg: Config, state: EnvState, visibility,
                             reset: bool) -> torch.Tensor:
    """Belief tracking (crowd_sim.py:243-273): visible -> truth; invisible ->
    straight-line coasting (the dummy at reset)."""
    truth = torch.cat([state.humans.pos, state.humans.vel,
                       state.humans.radius[..., None]], dim=-1)
    last = state.last_human_states
    if reset:
        fallback = torch.tensor(BELIEF_DUMMY, device=last.device).expand_as(last)
    else:
        fallback = torch.cat([last[..., 0:2] + last[..., 2:4] * cfg.env.time_step,
                              last[..., 2:]], dim=-1)
    return torch.where(visibility[..., None], truth, fallback)


# --------------------------------------------------------------------------
# crowd engine
# --------------------------------------------------------------------------

def _inflate(cfg: Config) -> float:
    return 0.01 + cfg.orca.safety_space               # orca.py:85-89


def _pref_velocity(goal, pos):
    """Unit-clipped preferred velocity toward the goal (orca.py:98-100)."""
    goal_vec = goal - pos
    speed = torch.linalg.norm(goal_vec, dim=-1, keepdim=True)
    return torch.where(speed > 1.0, goal_vec / speed.clamp_min(1e-9), goal_vec)


def build_human_neighbor_inputs(cfg: Config, state: EnvState):
    """Neighbour tensors for the human policies (crowd_sim.py:120-151): each
    human acts on the true states of the peers it sees (unseen peers become
    a dummy at (7, 7)), plus the robot as a last column when
    ``robot.visible`` (the dummy when out of the human's view). Returns
    (nbr_pos (B, A, N, 2), nbr_vel, nbr_radius (B, A, N), nbr_mask, active),
    N = A, or A + 1 with the robot."""
    A = cfg.sim.max_human_num
    vis = human_pair_visibility(cfg, state)
    eye = torch.eye(A, dtype=torch.bool, device=vis.device)
    active = _active_mask(cfg, state.human_num)
    use_true = vis & ~eye
    pos, vel = state.humans.pos, state.humans.vel
    nbr_pos = torch.where(use_true[..., None], pos[:, None],
                          torch.full_like(pos[:, None], NEIGHBOR_DUMMY_POS))
    nbr_vel = torch.where(use_true[..., None], vel[:, None],
                          torch.zeros_like(vel[:, None]))
    nbr_radius = torch.where(use_true, state.humans.radius[:, None],
                             torch.full_like(vis, cfg.humans.radius,
                                             dtype=pos.dtype))
    nbr_mask = active[:, None, :] & ~eye
    if cfg.robot.visible:
        sees = human_sees_robot(cfg, state)[..., None]          # (B, A, 1)
        r = state.robot
        r_pos = torch.where(sees, r.pos[:, None],
                            torch.full_like(pos, NEIGHBOR_DUMMY_POS))
        r_vel = torch.where(sees, r.vel[:, None], torch.zeros_like(vel))
        r_rad = torch.where(sees[..., 0], r.radius[:, None],
                            torch.full_like(state.humans.radius,
                                            cfg.robot.radius))
        nbr_pos = torch.cat([nbr_pos, r_pos[:, :, None]], dim=2)
        nbr_vel = torch.cat([nbr_vel, r_vel[:, :, None]], dim=2)
        nbr_radius = torch.cat([nbr_radius, r_rad[..., None]], dim=2)
        nbr_mask = torch.cat([nbr_mask, torch.ones_like(sees)], dim=2)
    return nbr_pos, nbr_vel, nbr_radius, nbr_mask, active


def _orca_humans(cfg: Config, state: EnvState, pos, vel, nbr_pos, nbr_vel,
                 nbr_radius, nbr_mask):
    """One ORCA solve for every (env x human) ego; returns (B, A, 2)."""
    B, A = pos.shape[:2]
    inflate = _inflate(cfg)
    N = nbr_pos.shape[2]
    out = orca_velocity_batch(
        pos.reshape(B * A, 2), vel.reshape(B * A, 2),
        (state.humans.radius + inflate).reshape(B * A),
        state.humans.v_pref.reshape(B * A),
        _pref_velocity(state.humans.goal, pos).reshape(B * A, 2),
        nbr_pos.reshape(B * A, N, 2), nbr_vel.reshape(B * A, N, 2),
        (nbr_radius + inflate).reshape(B * A, N), nbr_mask.reshape(B * A, N),
        cfg.env.time_step, cfg.orca.time_horizon,
        state.orca_neighbor_dist[:, None].expand(B, A).reshape(B * A))
    return out.reshape(B, A, 2)


def get_human_actions(cfg: Config, state: EnvState) -> torch.Tensor:
    """New velocities (B, A, 2) for all humans (crowd_sim.py:163-194): ORCA
    or social force on the neighbours of build_human_neighbor_inputs."""
    nbr_pos, nbr_vel, nbr_radius, nbr_mask, active = \
        build_human_neighbor_inputs(cfg, state)
    h = state.humans
    if cfg.humans.policy == "orca":
        act = _orca_humans(cfg, state, h.pos, h.vel, nbr_pos, nbr_vel,
                           nbr_radius, nbr_mask)
    elif cfg.humans.policy == "social_force":
        B, A, N = nbr_mask.shape
        act = social_force_velocity(
            h.pos.reshape(B * A, 2), h.vel.reshape(B * A, 2),
            h.radius.reshape(B * A), h.goal.reshape(B * A, 2),
            h.v_pref.reshape(B * A), nbr_pos.reshape(B * A, N, 2),
            nbr_radius.reshape(B * A, N), nbr_mask.reshape(B * A, N),
            cfg.sf.A, cfg.sf.B, cfg.sf.KI, cfg.env.time_step).reshape(B, A, 2)
    else:
        raise ValueError(f"unknown human policy {cfg.humans.policy}")
    return torch.where(active[..., None], act, torch.zeros_like(act))


def calc_human_future_traj(cfg: Config, state: EnvState, visibility,
                           method: str = "truth") -> torch.Tensor:
    """Future (B, K+1, A, 4) of (px, py, vx, vy) (crowd_sim.py:201-271):
    ``const_vel`` moves each human on from its true position with the
    velocity of its previous belief; ``truth`` rolls ORCA out over all
    active peers, no FOV filter, plus the robot moving on linearly when it
    is visible. Hidden humans are pinned to (15, 15, 0, 0)."""
    A, K = cfg.sim.max_human_num, cfg.sim.predict_steps
    B = state.human_num.shape[0]
    active = _active_mask(cfg, state.human_num)
    pos, vel = state.humans.pos, state.humans.vel
    if method == "const_vel":
        vel0 = state.prev_human_states[..., 2:4]
        t = (torch.arange(K + 1, device=pos.device, dtype=pos.dtype)
             * cfg.env.time_step * cfg.pred_interval)
        future = pos[:, None] + t[None, :, None, None] * vel0[:, None]
        traj = torch.cat([future, vel0[:, None].expand(B, K + 1, A, 2)], -1)
    elif method == "truth":
        eye = torch.eye(A, dtype=torch.bool, device=active.device)
        nbr_mask = (active[:, None, :] & ~eye).expand(B, A, A)
        nbr_rad = state.humans.radius[:, None, :].expand(B, A, A)
        r = state.robot
        if cfg.robot.visible:
            nbr_mask = torch.cat([nbr_mask, torch.ones_like(nbr_mask[..., :1])],
                                 dim=2)
            nbr_rad = torch.cat([nbr_rad, r.radius[:, None, None].expand(
                B, A, 1)], dim=2)
        r_pos = r.pos
        frames = [torch.cat([pos, vel], dim=-1)]
        for _ in range(cfg.buffer_len):
            nbr_pos = pos[:, None].expand(B, A, A, 2)
            nbr_vel = vel[:, None].expand(B, A, A, 2)
            if cfg.robot.visible:
                nbr_pos = torch.cat([nbr_pos, r_pos[:, None, None].expand(
                    B, A, 1, 2)], dim=2)
                nbr_vel = torch.cat([nbr_vel, r.vel[:, None, None].expand(
                    B, A, 1, 2)], dim=2)
            vel = _orca_humans(cfg, state, pos, vel, nbr_pos, nbr_vel,
                               nbr_rad, nbr_mask)
            pos = pos + vel * cfg.env.time_step
            r_pos = r_pos + r.vel * cfg.env.time_step
            frames.append(torch.cat([pos, vel], dim=-1))
        traj = torch.stack(frames, dim=1)[:, ::cfg.pred_interval]
    else:
        raise ValueError(f"unknown prediction method {method}")
    hidden = ~(visibility & active)
    return torch.where(hidden[:, None, :, None],
                       torch.tensor(HIDDEN_FUTURE, device=traj.device), traj)


# --------------------------------------------------------------------------
# observation and reward
# --------------------------------------------------------------------------

def generate_ob(cfg: Config, state: EnvState, reset: bool
                ) -> Tuple[Observation, EnvState]:
    """The dict observation, with belief updates folded back into the state
    (crowd_sim.py:283-346; crowd_sim_var_num.py:233-279,
    crowd_sim_pred.py:62-97, crowd_sim_pred_real_gst.py:76-94).
    spatial_edges holds each seen human's relative position (``none``), its
    relative const-vel or ground-truth future (``const_vel``, ``truth``;
    the future is also stored in the state), the seen humans first in order
    of current distance when ``network.sort_humans``, unseen ones at 15; or,
    for ``inferred``, the current relative position tiled K+1 times, which
    pretext_process overwrites with the GST predictions."""
    A, K = cfg.sim.max_human_num, cfg.sim.predict_steps
    vis = robot_human_visibility(cfg, state)
    num_vis = vis.sum(dim=-1)
    prev = state.last_human_states
    last = update_last_human_states(cfg, state, vis, reset=reset)
    state = dataclasses.replace(state, last_human_states=last,
                                prev_human_states=prev, visible_masks=vis)
    r = state.robot
    robot_node = torch.cat([r.pos, r.radius[:, None], r.goal,
                            r.v_pref[:, None], r.theta[:, None]], dim=-1)
    method = cfg.sim.predict_method
    rel = last[..., :2] - r.pos[:, None]
    if method == "inferred":
        base = torch.where(vis[..., None], rel, torch.full_like(rel, 15.0))
        edges, vis_out = base.repeat(1, 1, K + 1), vis
    else:
        if method in ("const_vel", "truth"):
            future = calc_human_future_traj(cfg, state, vis, method)
            state = dataclasses.replace(state, human_future_traj=future)
            rel = (future[..., :2].transpose(1, 2)
                   - r.pos[:, None, None]).reshape(-1, A, 2 * (K + 1))
        elif method != "none":
            raise ValueError(f"unknown prediction method {method}")
        inf = torch.full_like(rel, math.inf)
        edges = torch.where(vis[..., None], rel, inf)
        vis_out = vis
        if cfg.network.sort_humans:
            key = torch.linalg.norm(edges[..., :2], dim=-1)
            order = torch.argsort(key, dim=-1, stable=True)
            edges = torch.gather(edges, 1, order[..., None].expand_as(edges))
            vis_out = torch.arange(A, device=vis.device)[None] < num_vis[:, None]
        edges = torch.where(torch.isinf(edges), torch.full_like(edges, 15.0),
                            edges)
    obs = Observation(
        robot_node=robot_node.float(),
        temporal_edges=r.vel.float(),
        spatial_edges=edges.float(),
        visible_masks=vis_out,
        detected_human_num=num_vis.clamp_min(1),
    )
    return obs, state


def calc_reward(cfg: Config, state: EnvState, future_traj, phase: str,
                action_v=None, action_r=None, spin_coef=None):
    """R(s, a) (crowd_sim_var_num.py:465-561; JAX ``crowd_sim.py:353-429``).
    In the test phase the danger zone comes from the ground-truth future;
    in the train phase it is the current ``dmin < discomfort_dist`` and the
    reported min_dist is 0. The CrowdSimPred envs (``const_vel``, ``truth``)
    add the social term of the predicted futures (crowd_sim_pred.py:216-233).
    The unicycle reaches its goal within 0.6 m, earns 3x the potential
    (2x for the holonomic robot) and pays the spin penalty
    -coef * action_r^2 and, when driving backwards, -2 |action_v|; its speed
    and heading change ``action_v``, ``action_r`` (B,) are then required.
    ``coef`` is ``spin_coef`` (a float or a device scalar: the annealed
    coefficient of the training rollout) when given, else
    ``reward.spin_penalty_factor``. Returns (reward, done, new_potential,
    StepInfo), each (B,)."""
    unicycle = _unicycle(cfg)
    active = _active_mask(cfg, state.human_num)
    r = state.robot
    d = torch.linalg.norm(state.humans.pos - r.pos[:, None], dim=-1) \
        - state.humans.radius - r.radius[:, None]
    d = torch.where(active, d, torch.full_like(d, math.inf))
    collision = (d < 0.0).any(dim=-1)
    dmin = d.amin(dim=-1)
    goal_radius = 0.6 if unicycle else r.radius
    reaching_goal = torch.linalg.norm(r.pos - r.goal, dim=-1) < goal_radius

    zero = torch.zeros_like(dmin)
    if phase == "train":
        danger_cond = dmin < cfg.reward.discomfort_dist
        min_danger_dist = zero
    else:
        # future danger zone from the ground-truth rollout (:499-511)
        rel_dist = torch.linalg.norm(future_traj[:, 1:, :, :2]
                                     - r.pos[:, None, None], dim=-1)
        hit = rel_dist < r.radius[:, None, None] + cfg.humans.radius
        danger_cond = hit.flatten(1).any(dim=-1)
        closest = torch.where(hit, rel_dist,
                              torch.full_like(rel_dist, math.inf))
        min_danger_dist = torch.where(danger_cond,
                                      closest.flatten(1).amin(-1), zero)

    timeout = state.global_time >= cfg.env.time_limit - 1.0
    pot_cur = torch.linalg.norm(r.pos - r.goal, dim=-1)
    pot_factor = 3.0 if unicycle else 2.0
    pot_reward = pot_factor * (-pot_cur.abs() - state.potential)
    danger_reward = ((dmin - cfg.reward.discomfort_dist)
                     * cfg.reward.discomfort_penalty_factor * cfg.env.time_step)

    reward = torch.where(
        timeout, zero,
        torch.where(collision, zero + cfg.reward.collision_penalty,
                    torch.where(reaching_goal, zero + cfg.reward.success_reward,
                                torch.where(danger_cond, danger_reward,
                                            pot_reward))))
    done = timeout | collision | reaching_goal

    def code(c):
        return torch.full_like(state.human_num, c)

    outcome = torch.where(
        timeout, code(OUTCOME_TIMEOUT),
        torch.where(collision, code(OUTCOME_COLLISION),
                    torch.where(reaching_goal, code(OUTCOME_REACH_GOAL),
                                torch.where(danger_cond, code(OUTCOME_DANGER),
                                            code(OUTCOME_NOTHING)))))
    # potential only updates on the potential-reward branch (:540-543)
    took_pot = ~(timeout | collision | reaching_goal | danger_cond)
    new_potential = torch.where(took_pot, -pot_cur.abs(), state.potential)
    if unicycle:
        coef = cfg.reward.spin_penalty_factor if spin_coef is None \
            else spin_coef
        reward = reward - coef * action_r ** 2             # :551
        reward = reward + torch.where(action_v < 0, -2.0 * action_v.abs(),
                                      torch.zeros_like(action_v))
    if cfg.sim.predict_method in ("const_vel", "truth"):
        K = cfg.sim.predict_steps
        rel_dist = torch.linalg.norm(future_traj[:, 1:, :, :2]
                                     - r.pos[:, None, None], dim=-1)
        hit = rel_dist < r.radius[:, None, None] + cfg.humans.radius
        coeff = 2.0 ** torch.arange(2, K + 2, device=hit.device,
                                    dtype=rel_dist.dtype)
        penalties = cfg.reward.collision_penalty / coeff        # negative
        reward = reward + (hit * penalties[None, :, None]).flatten(1).amin(-1)
    info = StepInfo(outcome=outcome, min_dist=min_danger_dist)
    return reward, done, new_potential, info


# --------------------------------------------------------------------------
# mid-episode human dynamics
# --------------------------------------------------------------------------

def respawn_draws(cfg: Config) -> int:
    A = cfg.sim.max_human_num
    return 2 * A + spawn.circle_spawn_draws(A)


def _respawn_humans(cfg: Config, u, state: EnvState, need,
                    placed=None) -> EnvState:
    """Regenerate every slot in ``need`` (B, A) as a fresh circle-crossing
    human (crowd_sim_var_num.py:116-146): fresh attributes when randomized,
    position on the circle ring, goal opposite, velocity zero.
    u (B, respawn_draws(cfg))."""
    A = cfg.sim.max_human_num
    u_r, u_v, u_pos = spawn.split_draws(u, (A, A, spawn.circle_spawn_draws(A)))
    h = state.humans
    if cfg.env.randomize_attributes:
        radius_new = 0.3 + u_r * 0.2
        v_pref_new = 0.5 + u_v * 1.0
    else:
        radius_new = torch.full_like(h.radius, cfg.humans.radius)
        v_pref_new = torch.full_like(h.v_pref, cfg.humans.v_pref)
    radius = torch.where(need, radius_new, h.radius)
    v_pref = torch.where(need, v_pref_new, h.v_pref)
    if placed is None:
        placed = _active_mask(cfg, state.human_num) & ~need
    # the unicycle keeps the humans half the circle away (:453-455)
    robot_min = cfg.sim.circle_radius / 2.0 if _unicycle(cfg) else None
    pos, goal = spawn.batched_circle_spawn(
        u_pos, need, radius, cfg.sim.circle_radius, state.robot.pos,
        state.robot.goal, state.robot.radius, h.pos, h.goal, radius, placed,
        cfg.reward.discomfort_dist, robot_min_dist=robot_min)
    humans = HumanState(
        pos=pos, vel=torch.where(need[..., None], torch.zeros_like(h.vel), h.vel),
        goal=goal, radius=radius, v_pref=v_pref)
    return dataclasses.replace(state, humans=humans)


def goal_change_draws(cfg: Config) -> int:
    A = cfg.sim.max_human_num
    return A + spawn.goal_resample_draws(A)


def update_human_goals_randomly(cfg: Config, u, state: EnvState) -> EnvState:
    """Random goal changes, each human w.p. goal_change_chance
    (crowd_sim.py:415-450). u (B, goal_change_draws(cfg))."""
    A = cfg.sim.max_human_num
    u_chance, u_goal = spawn.split_draws(u, (A, spawn.goal_resample_draws(A)))
    h = state.humans
    active = _active_mask(cfg, state.human_num)
    need = (u_chance <= cfg.humans.goal_change_chance) & active & (h.v_pref != 0.0)
    goal = spawn.batched_goal_resample(
        u_goal, need, h.radius, h.v_pref, cfg.sim.circle_radius,
        state.robot.pos, state.robot.goal, state.robot.radius, h.pos, h.goal,
        h.radius, active, cfg.reward.discomfort_dist)
    return dataclasses.replace(state, humans=dataclasses.replace(h, goal=goal))


def end_goal_draws(cfg: Config) -> int:
    return goal_change_draws(cfg) if _unicycle(cfg) else respawn_draws(cfg)


def end_goal_updates(cfg: Config, u, state: EnvState) -> EnvState:
    """Humans that reached their goal are regenerated (holonomic,
    crowd_sim_var_num.py:451-458) or, under the unicycle, given a new goal
    w.p. ``end_goal_change_chance`` (crowd_sim.py:453-485; JAX :483-502).
    u (B, end_goal_draws(cfg))."""
    active = _active_mask(cfg, state.human_num)
    h = state.humans
    reached = active & (torch.linalg.norm(h.goal - h.pos, dim=-1) < h.radius)
    if not bool(reached.any()):
        return state
    if not _unicycle(cfg):
        return _respawn_humans(cfg, u, state, reached)
    A = cfg.sim.max_human_num
    u_chance, u_goal = spawn.split_draws(u, (A, spawn.goal_resample_draws(A)))
    need = reached & (u_chance <= cfg.humans.end_goal_change_chance)
    goal = spawn.batched_goal_resample(
        u_goal, need, h.radius, h.v_pref, cfg.sim.circle_radius,
        state.robot.pos, state.robot.goal, state.robot.radius, h.pos, h.goal,
        h.radius, active, cfg.reward.discomfort_dist)
    return dataclasses.replace(state, humans=dataclasses.replace(h, goal=goal))


def vary_draws(cfg: Config) -> int:
    return 3 + respawn_draws(cfg)


def _uniform_int(u, high):
    """Integers uniform on [0, high] (B,) from U[0, 1) draws u (B,)."""
    return torch.minimum((u * (high + 1)).long(), high)


def vary_human_num(cfg: Config, u, state: EnvState, pred_rule: bool
                   ) -> EnvState:
    """Add or remove humans (crowd_sim.py:505-546; crowd_sim_var_num.py
    :406-439, crowd_sim_pred.py:167-194): a coin chooses; removal takes up
    to max_remove humans off the end of the active prefix, never a seen one
    (``pred_rule`` selects CrowdSimPred's max_remove rule), addition
    respawns up to ``human_num_range`` new slots past it with fresh belief
    rows. u (B, vary_draws(cfg)): the coin, the two counts and the
    respawn's draws, in that order."""
    A, n = cfg.sim.max_human_num, state.human_num
    u_coin, u_rm, u_add, u_gen = spawn.split_draws(
        u, (1, 1, 1, respawn_draws(cfg)))
    vis = state.visible_masks
    idx = torch.arange(A, device=n.device)
    any_vis = vis.any(dim=-1)
    max_vis_id = torch.where(vis, idx, torch.full_like(idx, -1)).amax(dim=-1)
    if pred_rule:
        max_rm = torch.where(any_vis, (n - 1) - max_vis_id, n - 1)
        max_rm = max_rm.clamp(max=cfg.sim.human_num_range)
    else:
        max_rm = torch.where(
            any_vis, torch.minimum(n - cfg.sim.min_human_num,
                                   (n - 1) - max_vis_id),
            n - cfg.sim.min_human_num)
    max_rm = max_rm.clamp_min(0)
    remove_num = _uniform_int(u_rm[:, 0], max_rm)
    add_num = torch.minimum(
        _uniform_int(u_add[:, 0], torch.full_like(n, cfg.sim.human_num_range)),
        A - n)
    do_remove = u_coin[:, 0] < 0.5
    new_num = torch.where(do_remove, n - remove_num, n + add_num)
    is_new = ~do_remove[:, None] & (idx >= n[:, None]) & (idx < new_num[:, None])
    state = _respawn_humans(cfg, u_gen, state, is_new, placed=idx < n[:, None])
    dummy = torch.tensor(BELIEF_DUMMY, device=n.device)
    return dataclasses.replace(
        state, human_num=new_num,
        last_human_states=torch.where(is_new[..., None], dummy,
                                      state.last_human_states))


# --------------------------------------------------------------------------
# reset / step
# --------------------------------------------------------------------------

def reset(cfg: Config, gens: List[torch.Generator], device
          ) -> Tuple[EnvState, Observation]:
    """Seeded episode generation for one env per generator
    (crowd_sim_var_num.py:303-363; JAX ``crowd_sim.py:553-611``). The
    holonomic robot starts at a U(-arena, arena)^2 point with a goal at
    least 8 m away, facing pi / 2, among max_human_num humans, or with
    ``human_num_range > 0`` a count drawn uniformly from [min_human_num,
    max_human_num] (one more draw a case; none otherwise, so the
    fixed-count streams are unchanged). The unicycle starts on the arena
    circle with a goal at least 4 m away and a uniform heading, among a
    count drawn uniformly from [1, max_human_num] (crowd_sim_var_num.py
    :78-89)."""
    A, K = cfg.sim.max_human_num, cfg.sim.predict_steps
    B = len(gens)
    unicycle = _unicycle(cfg)
    draws_count = unicycle or cfg.sim.human_num_range > 0
    sizes = (spawn.unicycle_robot_draws() if unicycle else spawn.robot_draws(),
             1, respawn_draws(cfg), int(draws_count))
    u_robot, u_nd, u_humans, u_num = spawn.split_draws(
        spawn.draw_uniform(gens, sum(sizes), device), sizes)
    human_num = torch.full((B,), A, dtype=torch.long, device=device)
    if unicycle:
        pos, goal, theta = spawn.sample_unicycle_robot(
            u_robot, cfg.sim.arena_size, 4.0)
        human_num = 1 + _uniform_int(u_num[:, 0], human_num - 1)
    else:
        pos, goal = spawn.sample_robot_position(u_robot, cfg.sim.arena_size,
                                                8.0)
        theta = torch.full((B,), math.pi / 2.0, device=device)
        if draws_count:
            lo = cfg.sim.min_human_num
            human_num = lo + _uniform_int(u_num[:, 0], human_num - lo)

    def full(shape, v, dtype=torch.float32):
        return torch.full(shape, v, device=device, dtype=dtype)

    robot = RobotState(pos=pos, vel=full((B, 2), 0.0), theta=theta, goal=goal,
                       radius=full((B,), cfg.robot.radius),
                       v_pref=full((B,), cfg.robot.v_pref))
    if cfg.env.randomize_attributes:
        neighbor_dist = 5.0 + u_nd[:, 0] * 5.0      # agent.py:21-22
    else:
        neighbor_dist = full((B,), cfg.orca.neighbor_dist)
    humans = HumanState(pos=full((B, A, 2), 15.0), vel=full((B, A, 2), 0.0),
                        goal=full((B, A, 2), 15.0),
                        radius=full((B, A), cfg.humans.radius),
                        v_pref=full((B, A), cfg.humans.v_pref))
    dummy = torch.tensor(BELIEF_DUMMY, device=device).expand(B, A, 5)
    L = cfg.obs_buffer_len if cfg.sim.predict_method == "inferred" else 0
    state = EnvState(
        gens=list(gens), robot=robot, humans=humans, human_num=human_num,
        last_human_states=dummy.clone(), prev_human_states=dummy.clone(),
        visible_masks=full((B, A), False, torch.bool),
        potential=-torch.linalg.norm(pos - goal, dim=-1),
        global_time=full((B,), 0.0),
        step_count=full((B,), 0, torch.long),
        desired_velocity=full((B,), 0.0),
        orca_neighbor_dist=neighbor_dist,
        traj_buffer=full((B, L, A, 2), -999.0),
        mask_buffer=full((B, L, A), False, torch.bool),
        human_future_traj=full((B, K + 1, A, 4), 0.0))
    need = torch.arange(A, device=device)[None, :] < human_num[:, None]
    state = _respawn_humans(cfg, u_humans, state, need,
                            placed=torch.zeros_like(need))
    obs, state = generate_ob(cfg, state, reset=True)
    return state, obs


ROBOT_POLICIES = ("network", "orca", "social_force")


def scripted_robot_action(cfg: Config, state: EnvState, policy: str,
                          truth: Optional[torch.Tensor] = None):
    """The ORCA or social-force robot's velocity (B, 2), acting on its
    belief states (crowd_sim.py:614-656; crowd_sim_var_num.py:371-375).
    ORCA in the CrowdSimPred envs takes every ground-truth future position
    of every human as a neighbour (crowd_sim_pred.py:105-116): ``truth`` is
    that future (``calc_human_future_traj(..., state.visible_masks,
    "truth")``), computed here when not given. With
    ``orca.stale_neighbor_radii`` the neighbours' radii are the fixed
    :func:`stale_neighbor_radii` instead of the beliefs'."""
    A, K = cfg.sim.max_human_num, cfg.sim.predict_steps
    r = state.robot
    active = _active_mask(cfg, state.human_num)
    beliefs = state.last_human_states                          # (B, A, 5)
    if policy == "social_force":
        return social_force_velocity(
            r.pos, r.vel, r.radius, r.goal, r.v_pref, beliefs[..., :2],
            beliefs[..., 4], active, cfg.sf.A, cfg.sf.B, cfg.sf.KI,
            cfg.env.time_step)
    if policy != "orca":
        raise ValueError(f"unknown robot policy {policy}")
    inflate = _inflate(cfg)
    if cfg.sim.predict_method == "none":
        nbr_pos, nbr_vel = beliefs[..., :2], beliefs[..., 2:4]
        nbr_radius = beliefs[..., 4]
        if cfg.orca.stale_neighbor_radii:
            nbr_radius = stale_neighbor_radii(A).to(r.pos.device).expand_as(
                nbr_radius)
        nbr_mask = active
    else:
        if truth is None:
            truth = calc_human_future_traj(cfg, state, state.visible_masks,
                                           "truth")
        B = r.pos.shape[0]
        nbr_pos = truth[..., :2].reshape(B, (K + 1) * A, 2)
        nbr_vel = truth[..., 2:].reshape(B, (K + 1) * A, 2)
        nbr_radius = beliefs[..., 4].repeat(1, K + 1)
        nbr_mask = active.repeat(1, K + 1)
    return orca_velocity_batch(
        r.pos, r.vel, r.radius + inflate, r.v_pref,
        _pref_velocity(r.goal, r.pos), nbr_pos, nbr_vel, nbr_radius + inflate,
        nbr_mask, cfg.env.time_step, cfg.orca.time_horizon,
        state.orca_neighbor_dist)


def step(cfg: Config, state: EnvState, action, phase: str,
         robot_policy: str = "network", spin_coef=None
         ) -> Tuple[EnvState, Observation, torch.Tensor, torch.Tensor, StepInfo]:
    """One control step for every env (crowd_sim_var_num.py:366-460; JAX
    ``crowd_sim.py:659-745``). ``action`` (B, 2) is the raw policy output,
    clipped here: (vx, vy) for the holonomic robot; (delta_v, delta_theta)
    for the unicycle, whose speed ``desired_velocity`` accumulates delta_v
    within +-v_pref (negative is backwards) before the differential-drive
    integration. With ``robot_policy`` "orca" or "social_force" the
    scripted robot's velocity replaces the action, unclipped, as in the JAX
    package (under the unicycle its norm is the speed and the turn is 0).
    ``phase`` is "train" or "test"; only the test phase runs the
    ground-truth future rollout (:694-698). ``spin_coef`` overrides the
    unicycle's spin-penalty coefficient (see calc_reward). With
    ``human_num_range > 0`` the human count varies every 5 s (:727-735)."""
    if phase not in ("train", "test"):
        raise ValueError(f"phase must be 'train' or 'test', got {phase!r}")
    if robot_policy not in ROBOT_POLICIES:
        raise ValueError(f"robot_policy must be one of {ROBOT_POLICIES}, "
                         f"got {robot_policy!r}")
    unicycle = _unicycle(cfg)
    # this step's random numbers, a fixed count per env whatever happens
    varies = cfg.sim.human_num_range > 0
    sizes = ((goal_change_draws(cfg) if cfg.humans.random_goal_changing else 0),
             (end_goal_draws(cfg) if cfg.humans.end_goal_changing else 0),
             (vary_draws(cfg) if varies else 0))
    u_goal, u_end, u_vary = spawn.split_draws(
        spawn.draw_uniform(state.gens, sum(sizes), action.device), sizes)

    # the ground-truth future of the pre-step state: the test phase's
    # intrusion accounting (:385-388) and the CrowdSimPred ORCA robot's
    # neighbours read the same rollout
    truth = None
    if phase == "test" or (robot_policy == "orca"
                           and cfg.sim.predict_method != "none"):
        truth = calc_human_future_traj(cfg, state, state.visible_masks,
                                       "truth")
    action_v = action_r = None
    if robot_policy != "network":
        a = scripted_robot_action(cfg, state, robot_policy, truth)
        if unicycle:
            action_v = torch.linalg.norm(a, dim=-1)
            action_r = torch.zeros_like(action_v)
    elif unicycle:
        a = kinematics.clip_unicycle_action(action)
        v_pref = state.robot.v_pref
        action_v = torch.minimum(torch.maximum(
            state.desired_velocity + a[:, 0], -v_pref), v_pref)
        action_r = a[:, 1]
        state = dataclasses.replace(state, desired_velocity=action_v)
    else:
        a = kinematics.clip_holonomic_action(action, state.robot.v_pref)
    human_actions = get_human_actions(cfg, state)

    if phase == "test":
        state = dataclasses.replace(state, human_future_traj=truth)
    reward, done, new_potential, info = calc_reward(
        cfg, state, state.human_future_traj, phase, action_v, action_r,
        spin_coef)

    if unicycle:
        r_pos, r_theta, r_vel = kinematics.step_unicycle(
            state.robot.pos, state.robot.theta, action_v, action_r,
            cfg.env.time_step)
    else:
        r_pos, r_vel = kinematics.step_holonomic(state.robot.pos, a,
                                                 cfg.env.time_step)
        r_theta = state.robot.theta
    active = _active_mask(cfg, state.human_num)
    h = state.humans
    h_pos = torch.where(active[..., None],
                        h.pos + human_actions * cfg.env.time_step, h.pos)
    h_vel = torch.where(active[..., None], human_actions, h.vel)
    state = dataclasses.replace(
        state, potential=new_potential,
        robot=dataclasses.replace(state.robot, pos=r_pos, vel=r_vel,
                                  theta=r_theta),
        humans=dataclasses.replace(h, pos=h_pos, vel=h_vel),
        global_time=state.global_time + cfg.env.time_step,
        step_count=state.step_count + 1)

    # every-5 s population and goal events, guarded by the step counter
    steps_per_5s = int(round(5.0 / cfg.env.time_step))
    at_5s = (state.step_count % steps_per_5s) == 0
    if varies and bool(at_5s.any()):
        varied = vary_human_num(cfg, u_vary, state,
                                pred_rule=cfg.sim.predict_method != "none")
        state = tree_where(at_5s, varied, state)

    obs, state = generate_ob(cfg, state, reset=False)

    if cfg.humans.random_goal_changing and bool(at_5s.any()):
        regoaled = update_human_goals_randomly(cfg, u_goal, state)
        goal = torch.where(at_5s[:, None, None], regoaled.humans.goal,
                           state.humans.goal)
        state = dataclasses.replace(
            state, humans=dataclasses.replace(state.humans, goal=goal))
    if cfg.humans.end_goal_changing:
        state = end_goal_updates(cfg, u_end, state)
    return state, obs, reward, done, info
