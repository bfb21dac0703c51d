"""Seeded evaluation suite (JAX package ``algo/evaluation.py``; reference
rl/evaluation.py:7-160).

Cases run in lock-step batches: each case is an env slot whose generator is
seeded from ``base_seed``, the phase's offset (``PHASE_OFFSET``: val cases
at 0, test at 1000, train at 2000, crowd_sim.py:382-389) and its case index.
Finished episodes are frozen (done-latching) and a batch stops once every
episode has ended. Metrics and the log line are those of the JAX package:
success/collision/timeout rates, nav time (time at the start of the final
step), path length, intrusion ratio (% steps in Danger) and the mean minimal
intrusion distance pooled over all intrusion steps.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..env import crowd_sim
from ..env.pretext import pretext_process
from ..env.types import (OUTCOME_COLLISION, OUTCOME_DANGER,
                         OUTCOME_REACH_GOAL, OUTCOME_TIMEOUT, tree_where)
from ..models import policy as policy_mod
from ..models.policy_net import init_hidden, obs_to_dict
from ..utils.device import resolve_device
from ..utils.profiling import span

PHASE_OFFSET = {"val": 0, "test": 1000, "train": 2000}


def case_generator(base_seed: int, case_idx: int,
                   phase: str = "test") -> torch.Generator:
    """The CPU generator that drives one seeded case."""
    g = torch.Generator()
    g.manual_seed((base_seed << 32) + PHASE_OFFSET[phase] + case_idx)
    return g


@torch.no_grad()
def evaluate(cfg: Config, policy, gst_model,
             test_size: Optional[int] = None, base_seed: Optional[int] = None,
             batch_size: Optional[int] = None, phase: str = "test",
             device="cuda", log=print, robot_policy: str = "network",
             max_steps: Optional[int] = None) -> Dict:
    """Run the seeded suite in batches of ``batch_size`` (default: all cases
    at once) on ``device``, where the policy and the GST model must lie.
    ``robot_policy`` "network" drives the robot with ``policy``
    (deterministic); "orca" and "social_force" run the scripted baselines
    (``policy`` unused, zero actions, JAX ``evaluation.py:103-110``). The
    GST model is used only by the ``inferred`` env (None otherwise).
    ``max_steps`` cuts every batch after that many steps (default: the
    episode limit, time_limit / time_step + 1); a case still running then
    counts as a timeout. Returns the metrics dict, plus ``env_steps`` (env
    steps simulated, frozen slots included) and ``seconds``."""
    device = resolve_device(device)
    test_size = test_size or (cfg.env.val_size if phase == "val"
                              else cfg.env.test_size)
    base_seed = cfg.ppo.seed if base_seed is None else base_seed
    bs = min(batch_size or test_size, test_size)
    dt = cfg.env.time_step
    t0 = time.perf_counter()
    chunks, env_steps = [], 0
    for start in range(0, test_size, bs):
        idx = list(range(start, min(start + bs, test_size)))
        acc, n = _evaluate_chunk(cfg, policy, gst_model, base_seed, idx,
                                 phase, device, robot_policy, max_steps)
        chunks.append(acc)
        env_steps += n
        log(f"[evaluate] cases {idx[0]}..{idx[-1]} done")
    steps, outcome, path_len, danger_steps, min_dist_sum, ep_rew, alive = (
        np.concatenate([c[i] for c in chunks]) for i in range(7))

    success = outcome == OUTCOME_REACH_GOAL
    collision = outcome == OUTCOME_COLLISION
    timeout = (outcome == OUTCOME_TIMEOUT) | alive
    nav_times = (steps - 1) * dt       # evaluation.py:74-75 semantics
    return {
        "success_rate": float(np.mean(success)),
        "collision_rate": float(np.mean(collision)),
        "timeout_rate": float(np.mean(timeout)),
        "nav_time": float(np.mean(nav_times[success]))
        if success.any() else cfg.env.time_limit,
        "path_length": float(np.mean(path_len)),
        "intrusion_ratio": float(np.mean(danger_steps / np.maximum(steps, 1)
                                         * 100.0)),
        "min_intrusion_dist": float(min_dist_sum.sum()
                                    / max(danger_steps.sum(), 1)),
        "mean_episode_reward": float(np.mean(ep_rew)),
        "collision_cases": np.nonzero(collision)[0].tolist(),
        "timeout_cases": np.nonzero(timeout)[0].tolist(),
        "env_steps": env_steps,
        "seconds": time.perf_counter() - t0,
    }


def _evaluate_chunk(cfg: Config, policy, gst_model, base_seed: int, idx,
                    phase: str, device, robot_policy: str, max_steps=None):
    B = len(idx)
    max_steps = max_steps or cfg.max_episode_steps + 1
    gst = cfg.sim.predict_method == "inferred"     # (:95-98, :116-119)
    gens = [case_generator(base_seed, i, phase) for i in idx]
    states, obs = crowd_sim.reset(cfg, gens, device)
    zeros = torch.zeros(B, device=device)
    if gst:
        states, obs, _, _ = pretext_process(cfg, gst_model, states, obs,
                                            zeros)
    obs_d = obs_to_dict(obs)
    hxs = init_hidden(cfg, B, device)
    masks = torch.ones(B, device=device)

    alive = torch.ones(B, dtype=torch.bool, device=device)
    steps = torch.zeros(B, dtype=torch.long, device=device)
    outcome = torch.zeros(B, dtype=torch.long, device=device)
    danger_steps = torch.zeros(B, dtype=torch.long, device=device)
    path_len, min_dist_sum, ep_rew = zeros.clone(), zeros.clone(), zeros.clone()
    last_pos = obs_d["robot_node"][:, :2]
    n_steps = 0
    for _ in range(max_steps):
        if not bool(alive.any()):
            break
        with span("eval.step"):
            if robot_policy == "network":
                _, action, _, hxs_new = policy_mod.act(
                    policy, obs_d, hxs, masks, deterministic=True)
            else:
                action, hxs_new = torch.zeros(B, 2, device=device), hxs
            states_new, obs_new, rew, done, info = crowd_sim.step(
                cfg, states, action, "test", robot_policy)
            if gst:
                states_new, obs_new, rew, _ = pretext_process(
                    cfg, gst_model, states_new, obs_new, rew)
            n_steps += 1

            # freeze finished episodes
            states = tree_where(alive, states_new, states)
            obs_d = tree_where(alive, obs_to_dict(obs_new), obs_d)
            hxs = tree_where(alive, hxs_new, hxs)

            new_pos = obs_d["robot_node"][:, :2]
            step_now = alive
            steps += step_now.long()
            ep_rew += torch.where(step_now, rew, zeros)
            path_len += torch.where(
                step_now, torch.linalg.norm(new_pos - last_pos, dim=-1), zeros)
            last_pos = torch.where(step_now[:, None], new_pos, last_pos)
            is_danger = step_now & (info.outcome == OUTCOME_DANGER)
            danger_steps += is_danger.long()
            min_dist_sum += torch.where(is_danger, info.min_dist, zeros)
            outcome = torch.where(step_now & done, info.outcome, outcome)
            alive = alive & ~done
    acc = tuple(t.cpu().numpy() for t in (steps, outcome, path_len,
                                          danger_steps, min_dist_sum, ep_rew,
                                          alive))
    return acc, n_steps * B


def format_results(r: Dict) -> str:
    """The reference log line (evaluation.py:149-157)."""
    return ("Testing success rate: {:.2f}, collision rate: {:.2f}, "
            "timeout rate: {:.2f}, nav time: {:.2f}, path length: {:.2f}, "
            "average intrusion ratio: {:.2f}%, "
            "average minimal distance during intrusions: {:.2f}".format(
                r["success_rate"], r["collision_rate"], r["timeout_rate"],
                r["nav_time"], r["path_length"], r["intrusion_ratio"],
                r["min_intrusion_dist"]))
