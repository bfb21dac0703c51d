"""The crowd-navigation simulator, natively batched over envs.

Port of the JAX package's ``env/crowd_sim.py`` for what the GST env needs
in the train and the test phase: robot and human visibility (:65-118),
``build_human_neighbor_inputs``, ``get_human_actions`` with ORCA humans, the
ground-truth future rollout used for intrusion accounting in the test phase
(``calc_human_future_traj`` "truth", :201-276), ``generate_ob`` for the
``inferred`` prediction method, ``calc_reward``, respawn, random and end goal
changes, ``reset`` and ``step``. Where the JAX package vmaps one-env
functions, these functions take a leading env axis B; every ORCA call solves
all (env x human) egos at once.

Not ported yet (they raise): social-force humans, the unicycle robot, a
robot visible to the humans, a varying human count (``human_num_range >
0``), the ``none``/``const_vel``/``truth`` observation methods and scripted
robot policies.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch

from ..config import Config
from . import kinematics, spawn
from .orca import orca_velocity_batch
from .types import (EnvState, HumanState, Observation, RobotState, StepInfo,
                    OUTCOME_COLLISION, OUTCOME_DANGER, OUTCOME_NOTHING,
                    OUTCOME_REACH_GOAL, OUTCOME_TIMEOUT)

# Belief placeholder for out-of-view humans (crowd_sim.py:258).
BELIEF_DUMMY = (15.0, 15.0, 0.0, 0.0, 0.3)
# Dummy neighbour an agent substitutes for peers outside its FOV.
NEIGHBOR_DUMMY_POS = 7.0
HIDDEN_FUTURE = (15.0, 15.0, 0.0, 0.0)


def check_supported(cfg: Config):
    """Raise for the configurations this port does not cover yet."""
    missing = []
    if cfg.humans.policy != "orca":
        missing.append(f"humans.policy={cfg.humans.policy!r}")
    if cfg.action_space.kinematics != "holonomic":
        missing.append(f"kinematics={cfg.action_space.kinematics!r}")
    if cfg.sim.human_num_range != 0:
        missing.append("human_num_range > 0")
    if cfg.sim.predict_method != "inferred":
        missing.append(f"predict_method={cfg.sim.predict_method!r}")
    if cfg.robot.visible:
        missing.append("robot.visible=True")
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


def _active_mask(cfg: Config, human_num) -> torch.Tensor:
    idx = torch.arange(cfg.sim.max_human_num, device=human_num.device)
    return idx[None, :] < human_num[:, None]


def _heading(vel):
    # holonomic agents head along their velocity (crowd_sim.py:514-517)
    return torch.atan2(vel[..., 1], vel[..., 0])


def _offset_angle(p1_pos, p1_heading, p2_pos):
    """Angle between agent1's heading ray and the ray to agent2."""
    fwd = torch.stack([torch.cos(p1_heading), torch.sin(p1_heading)], dim=-1)
    v12 = p2_pos - p1_pos
    v12 = v12 / torch.linalg.norm(v12, dim=-1, keepdim=True).clamp_min(1e-9)
    return torch.arccos((fwd * v12).sum(dim=-1).clamp(-1.0, 1.0))


def robot_human_visibility(cfg: Config, state: EnvState) -> torch.Tensor:
    """(B, A): which active humans the robot sees (crowd_sim.py:558-572)."""
    heading = _heading(state.robot.vel)
    offset = _offset_angle(state.robot.pos[:, None], heading[:, None],
                           state.humans.pos)
    in_fov = offset.abs() <= (math.pi * cfg.robot.fov) / 2.0
    dist = (torch.linalg.norm(state.humans.pos - state.robot.pos[:, None], dim=-1)
            - state.humans.radius - state.robot.radius[:, None])
    in_range = dist <= cfg.robot.sensor_range
    return _active_mask(cfg, state.human_num) & in_fov & in_range


def human_pair_visibility(cfg: Config, state: EnvState) -> torch.Tensor:
    """(B, A, A): does human i see human j (unbounded range, FOV
    humans.fov * pi)."""
    heading = _heading(state.humans.vel)                          # (B, A)
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
    """Neighbour tensors for the human policies (crowd_sim.py:680-703): each
    human acts on the true states of the peers it sees (unseen peers become
    a dummy at (7, 7)); the robot is invisible to them. Returns
    (nbr_pos (B, A, A, 2), nbr_vel, nbr_radius (B, A, A), nbr_mask, active)."""
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
    """New velocities (B, A, 2) for all humans (crowd_sim.py:159-199)."""
    nbr_pos, nbr_vel, nbr_radius, nbr_mask, active = \
        build_human_neighbor_inputs(cfg, state)
    act = _orca_humans(cfg, state, state.humans.pos, state.humans.vel,
                       nbr_pos, nbr_vel, nbr_radius, nbr_mask)
    return torch.where(active[..., None], act, torch.zeros_like(act))


def calc_human_future_traj(cfg: Config, state: EnvState,
                           visibility) -> torch.Tensor:
    """Ground-truth future (B, K+1, A, 4) of (px, py, vx, vy) from an ORCA
    rollout of all active peers, no FOV filter (crowd_sim.py:201-276,
    method "truth"). Hidden humans are pinned to (15, 15, 0, 0)."""
    A = cfg.sim.max_human_num
    B = state.human_num.shape[0]
    active = _active_mask(cfg, state.human_num)
    eye = torch.eye(A, dtype=torch.bool, device=active.device)
    pos, vel = state.humans.pos, state.humans.vel
    nbr_mask = (active[:, None, :] & ~eye).expand(B, A, A)
    nbr_rad = state.humans.radius[:, None, :].expand(B, A, A)
    frames = [torch.cat([pos, vel], dim=-1)]
    for _ in range(cfg.buffer_len):
        vel = _orca_humans(cfg, state, pos, vel,
                           pos[:, None].expand(B, A, A, 2),
                           vel[:, None].expand(B, A, A, 2), nbr_rad, nbr_mask)
        pos = pos + vel * cfg.env.time_step
        frames.append(torch.cat([pos, vel], dim=-1))
    traj = torch.stack(frames, dim=1)[:, ::cfg.pred_interval]
    hidden = ~(visibility & active)
    return torch.where(hidden[:, None, :, None],
                       torch.tensor(HIDDEN_FUTURE, device=traj.device), traj)


# --------------------------------------------------------------------------
# observation and reward
# --------------------------------------------------------------------------

def generate_ob(cfg: Config, state: EnvState, reset: bool
                ) -> Tuple[Observation, EnvState]:
    """The dict observation for the ``inferred`` (GST) env, with belief
    updates folded back into the state (crowd_sim_var_num.py:233-279,
    crowd_sim_pred_real_gst.py:76-94). spatial_edges holds the current
    relative position tiled K+1 times; pretext_process writes the GST
    predictions in."""
    K = cfg.sim.predict_steps
    vis = robot_human_visibility(cfg, state)
    num_vis = vis.sum(dim=-1)
    last = update_last_human_states(cfg, state, vis, reset=reset)
    state = dataclasses.replace(state, last_human_states=last,
                                visible_masks=vis)
    r = state.robot
    robot_node = torch.cat([r.pos, r.radius[:, None], r.goal,
                            r.v_pref[:, None], r.theta[:, None]], dim=-1)
    rel = last[..., :2] - r.pos[:, None]
    base = torch.where(vis[..., None], rel, torch.full_like(rel, math.inf))
    base = torch.where(torch.isinf(base), torch.full_like(base, 15.0), base)
    obs = Observation(
        robot_node=robot_node.float(),
        temporal_edges=r.vel.float(),
        spatial_edges=base.repeat(1, 1, K + 1).float(),
        visible_masks=vis,
        detected_human_num=num_vis.clamp_min(1),
    )
    return obs, state


def calc_reward(cfg: Config, state: EnvState, future_traj, phase: str):
    """R(s, a) for the holonomic robot (crowd_sim_var_num.py:465-561). In the
    test phase the danger zone comes from the ground-truth future; in the
    train phase it is the current ``dmin < discomfort_dist`` and the
    reported min_dist is 0 (JAX ``crowd_sim.py:372-374, 425-428``). Returns
    (reward, done, new_potential, StepInfo), each (B,)."""
    active = _active_mask(cfg, state.human_num)
    r = state.robot
    d = torch.linalg.norm(state.humans.pos - r.pos[:, None], dim=-1) \
        - state.humans.radius - r.radius[:, None]
    d = torch.where(active, d, torch.full_like(d, math.inf))
    collision = (d < 0.0).any(dim=-1)
    dmin = d.amin(dim=-1)
    reaching_goal = torch.linalg.norm(r.pos - r.goal, dim=-1) < r.radius

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
    pot_reward = 2.0 * (-pot_cur.abs() - state.potential)
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
    pos, goal = spawn.batched_circle_spawn(
        u_pos, need, radius, cfg.sim.circle_radius, state.robot.pos,
        state.robot.goal, state.robot.radius, h.pos, h.goal, radius, placed,
        cfg.reward.discomfort_dist)
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


def end_goal_updates(cfg: Config, u, state: EnvState) -> EnvState:
    """Humans that reached their goal are regenerated (holonomic,
    crowd_sim_var_num.py:451-458). u (B, respawn_draws(cfg))."""
    active = _active_mask(cfg, state.human_num)
    h = state.humans
    reached = active & (torch.linalg.norm(h.goal - h.pos, dim=-1) < h.radius)
    if not bool(reached.any()):
        return state
    return _respawn_humans(cfg, u, state, reached)


# --------------------------------------------------------------------------
# reset / step
# --------------------------------------------------------------------------

def reset(cfg: Config, gens: List[torch.Generator], device
          ) -> Tuple[EnvState, Observation]:
    """Seeded episode generation for one env per generator
    (crowd_sim_var_num.py:303-363)."""
    check_supported(cfg)
    A, K = cfg.sim.max_human_num, cfg.sim.predict_steps
    B = len(gens)
    u_robot, u_nd, u_humans = spawn.split_draws(
        spawn.draw_uniform(gens, spawn.robot_draws() + 1 + respawn_draws(cfg),
                           device),
        (spawn.robot_draws(), 1, respawn_draws(cfg)))
    pos, goal = spawn.sample_robot_position(u_robot, cfg.sim.arena_size, 8.0)
    # human_num_range == 0 (check_supported): every slot is active
    human_num = torch.full((B,), A, dtype=torch.long, device=device)

    def full(shape, v, dtype=torch.float32):
        return torch.full(shape, v, device=device, dtype=dtype)

    robot = RobotState(pos=pos, vel=full((B, 2), 0.0),
                       theta=full((B,), math.pi / 2.0), goal=goal,
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
    L = cfg.obs_buffer_len
    state = EnvState(
        gens=list(gens), robot=robot, humans=humans, human_num=human_num,
        last_human_states=dummy.clone(),
        visible_masks=full((B, A), False, torch.bool),
        potential=-torch.linalg.norm(pos - goal, dim=-1),
        global_time=full((B,), 0.0),
        step_count=full((B,), 0, torch.long),
        orca_neighbor_dist=neighbor_dist,
        traj_buffer=full((B, L, A, 2), -999.0),
        mask_buffer=full((B, L, A), False, torch.bool),
        human_future_traj=full((B, K + 1, A, 4), 0.0))
    need = torch.arange(A, device=device)[None, :] < human_num[:, None]
    state = _respawn_humans(cfg, u_humans, state, need,
                            placed=torch.zeros_like(need))
    obs, state = generate_ob(cfg, state, reset=True)
    return state, obs


def step(cfg: Config, state: EnvState, action, phase: str
         ) -> Tuple[EnvState, Observation, torch.Tensor, torch.Tensor, StepInfo]:
    """One control step for every env (crowd_sim_var_num.py:366-460; JAX
    ``crowd_sim.py:657-745``). ``action`` (B, 2) is the raw policy output
    (vx, vy), clipped here. ``phase`` is "train" or "test"; only the test
    phase runs the ground-truth future rollout (:694-698)."""
    check_supported(cfg)
    if phase not in ("train", "test"):
        raise ValueError(f"phase must be 'train' or 'test', got {phase!r}")
    # this step's random numbers, a fixed count per env whatever happens
    sizes = ((goal_change_draws(cfg) if cfg.humans.random_goal_changing else 0),
             (respawn_draws(cfg) if cfg.humans.end_goal_changing else 0))
    u_goal, u_end = spawn.split_draws(
        spawn.draw_uniform(state.gens, sum(sizes), action.device), sizes)

    a = kinematics.clip_holonomic_action(action, state.robot.v_pref)
    human_actions = get_human_actions(cfg, state)

    if phase == "test":
        # refresh the truth future for intrusion accounting (:385-388)
        state = dataclasses.replace(state, human_future_traj=(
            calc_human_future_traj(cfg, state, state.visible_masks)))
    reward, done, new_potential, info = calc_reward(
        cfg, state, state.human_future_traj, phase)

    r_pos, r_vel = kinematics.step_holonomic(state.robot.pos, a,
                                             cfg.env.time_step)
    active = _active_mask(cfg, state.human_num)
    h = state.humans
    h_pos = torch.where(active[..., None],
                        h.pos + human_actions * cfg.env.time_step, h.pos)
    h_vel = torch.where(active[..., None], human_actions, h.vel)
    state = dataclasses.replace(
        state, potential=new_potential,
        robot=dataclasses.replace(state.robot, pos=r_pos, vel=r_vel),
        humans=dataclasses.replace(h, pos=h_pos, vel=h_vel),
        global_time=state.global_time + cfg.env.time_step,
        step_count=state.step_count + 1)

    # every-5 s goal events, guarded by the step counter
    steps_per_5s = int(round(5.0 / cfg.env.time_step))
    at_5s = (state.step_count % steps_per_5s) == 0

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
