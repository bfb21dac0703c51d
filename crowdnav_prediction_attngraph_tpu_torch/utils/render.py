"""Episode visualization (JAX package ``utils/render.py``; reference
crowd_sim_var_num.py:564-691 render).

``record_episode`` steps one seeded episode on the device and returns a
host-side trajectory dict; it needs no matplotlib. ``render_frame``,
``render_episode`` and ``render_episode_live`` draw with matplotlib, which
they import when called: importing this module imports neither matplotlib
nor pandas. Headless drawing goes to a ``Figure`` of its own through
``FigureCanvasAgg``; only a live window (``DISPLAY`` set) uses pyplot.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..algo.evaluation import case_generator
from ..env import crowd_sim
from ..env.pretext import pretext_process
from ..models import policy as policy_mod
from ..models.policy_net import init_hidden, obs_to_dict
from ..utils.device import resolve_device

FIGSIZE = (7, 7)


def new_figure(figsize=FIGSIZE):
    """A (figure, axes) pair drawn by the Agg canvas, outside pyplot's
    global state."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure
    fig = Figure(figsize=figsize)
    FigureCanvasAgg(fig)
    return fig, fig.add_subplot()


def render_frame(ax, robot_pos, robot_goal, robot_radius, human_pos,
                 human_radius, human_visible, sensor_range: float,
                 human_num: int, pred_pos: Optional[np.ndarray] = None,
                 arena_size: float = 6.0):
    """Draw one timestep. pred_pos: (A, K, 2) predicted future positions."""
    from matplotlib.patches import Circle
    ax.clear()
    lim = arena_size + 4
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_aspect("equal")
    ax.add_artist(Circle(robot_pos, robot_radius, fill=True, color="gold"))
    ax.plot([robot_goal[0]], [robot_goal[1]], color="red", marker="*",
            markersize=15, linestyle="None")
    ax.add_artist(Circle(robot_pos, sensor_range + robot_radius + 0.3,
                         fill=False, linestyle="--", color="gray"))
    for i in range(human_num):
        color = "b" if human_visible[i] else "r"
        ax.add_artist(Circle(human_pos[i], human_radius[i], fill=False,
                             linewidth=1.5, color=color))
        ax.text(human_pos[i][0] - 0.1, human_pos[i][1] - 0.1, str(i),
                color="black", fontsize=10)
        if pred_pos is not None and human_visible[i]:
            for k in range(pred_pos.shape[1]):
                ax.add_artist(Circle(pred_pos[i, k], human_radius[i],
                                     fill=False, color="tab:orange",
                                     alpha=0.3, linewidth=0.8))


def _draw_step(ax, traj, t, robot_radius, sensor_range, arena):
    render_frame(ax, traj["robot_pos"][t], traj["robot_goal"][t],
                 robot_radius, traj["human_pos"][t], traj["human_radius"][t],
                 traj["human_visible"][t], sensor_range,
                 int(traj["human_num"][t]), traj["pred_pos"][t], arena)


def render_episode(traj: dict, out_path: str, cfg=None, fps: int = 8,
                   max_frames: int = 400):
    """Draw a trajectory of :func:`record_episode` to a GIF at
    ``out_path``, or, if the GIF cannot be written, to PNG frames in
    ``<out_path stem>_frames/``. Returns the path written."""
    T = min(len(traj["robot_pos"]), max_frames)
    sensor_range = getattr(getattr(cfg, "robot", None), "sensor_range", 5.0)
    arena = getattr(getattr(cfg, "sim", None), "arena_size", 6.0)
    robot_radius = float(np.asarray(traj.get("robot_radius", 0.3)).ravel()[0])
    traj = dict(traj)
    traj.setdefault("pred_pos", [None] * T)

    fig, ax = new_figure()
    try:
        from matplotlib.animation import PillowWriter
        writer = PillowWriter(fps=fps)
        with writer.saving(fig, out_path, dpi=80):
            for t in range(T):
                _draw_step(ax, traj, t, robot_radius, sensor_range, arena)
                writer.grab_frame()
        return out_path
    except (ImportError, OSError, ValueError):
        frames_dir = os.path.splitext(out_path)[0] + "_frames"
        os.makedirs(frames_dir, exist_ok=True)
        for t in range(T):
            _draw_step(ax, traj, t, robot_radius, sensor_range, arena)
            fig.savefig(os.path.join(frames_dir, f"{t:04d}.png"), dpi=80)
        return frames_dir


def render_episode_live(cfg, policy=None, gst_model=None, case_idx: int = 0,
                        base_seed: int = 425, robot_policy: str = "network",
                        out_path: Optional[str] = None, fps: int = 8,
                        device="cuda"):
    """Step the episode and draw each frame as it happens (the reference
    renders inside env.step, crowd_sim.py:750-873).

    With a display (DISPLAY set and an interactive backend available) the
    figure updates live; headless, frames stream to a GIF at ``out_path``
    while the episode is still running. Either way rendering is per step.
    Returns the trajectory of :func:`record_episode`.
    """
    plt = None
    if os.environ.get("DISPLAY"):
        try:
            import matplotlib
            matplotlib.use("TkAgg", force=True)
            import matplotlib.pyplot as plt
            plt.ion()
        except ImportError:
            plt = None
    if plt is not None:
        fig, ax = plt.subplots(figsize=FIGSIZE)
    else:
        fig, ax = new_figure()
    sensor_range = cfg.robot.sensor_range
    arena = cfg.sim.arena_size
    writer = None
    if out_path:
        from matplotlib.animation import PillowWriter
        writer = PillowWriter(fps=fps)
        writer.setup(fig, out_path, dpi=80)

    def on_frame(t, frame):
        render_frame(ax, frame["robot_pos"], frame["robot_goal"],
                     float(np.ravel(frame["robot_radius"])[0]),
                     frame["human_pos"], frame["human_radius"],
                     frame["human_visible"], sensor_range,
                     int(frame["human_num"]), frame.get("pred_pos"), arena)
        ax.set_title(f"t = {t * cfg.env.time_step:.2f}s")
        if writer is not None:
            writer.grab_frame()
        if plt is not None:
            plt.pause(0.001)

    try:
        traj = record_episode(cfg, policy, gst_model, case_idx, base_seed,
                              robot_policy, on_frame=on_frame, device=device)
    finally:
        if writer is not None:
            writer.finish()
        if plt is not None:
            plt.close(fig)
    return traj


@torch.no_grad()
def record_episode(cfg, policy=None, gst_model=None, case_idx: int = 0,
                   base_seed: int = 425, robot_policy: str = "orca",
                   on_frame=None, device="cuda"):
    """Roll one seeded test case (``case_generator(base_seed, case_idx)``)
    on ``device`` and return a host-side trajectory dict: per step
    ``robot_pos``, ``robot_goal``, ``human_pos``, ``human_radius``,
    ``human_visible``, ``human_num`` and ``pred_pos`` (the predicted futures
    in the pred/GST envs, else None), and ``robot_radius``. With
    ``robot_policy="network"`` the ``policy`` (a PolicyHead on ``device``)
    acts deterministically; in the ``inferred`` env ``gst_model`` runs the
    per-step GST pretext pass. ``on_frame(t, frame_dict)`` is called before
    each step, for live rendering."""
    device = resolve_device(device)
    state, obs = crowd_sim.reset(
        cfg, [case_generator(base_seed, case_idx)], device)
    use_pretext = (cfg.sim.predict_method == "inferred"
                   and gst_model is not None)
    if use_pretext:
        state, obs, _, _ = pretext_process(cfg, gst_model, state, obs,
                                           torch.zeros(1, device=device))
    hxs = init_hidden(cfg, 1, device)
    masks = torch.ones(1, device=device)
    network = robot_policy == "network" and policy is not None

    traj = {k: [] for k in ("robot_pos", "robot_goal", "human_pos",
                            "human_radius", "human_visible", "human_num",
                            "pred_pos")}
    done = False
    t = 0
    while not done and t < cfg.max_episode_steps:
        robot_pos = state.robot.pos[0].cpu().numpy()
        traj["robot_pos"].append(robot_pos)
        traj["robot_goal"].append(state.robot.goal[0].cpu().numpy())
        traj["human_pos"].append(state.humans.pos[0].cpu().numpy())
        traj["human_radius"].append(state.humans.radius[0].cpu().numpy())
        traj["human_visible"].append(
            crowd_sim.robot_human_visibility(cfg, state)[0].cpu().numpy())
        traj["human_num"].append(int(state.human_num[0]))
        # predicted future positions ride in spatial_edges[:, 2:] for the
        # pred/GST envs (robot-centric; crowd_sim_pred_real_gst.py:226-235)
        se = obs.spatial_edges[0].cpu().numpy()
        traj["pred_pos"].append(
            se[:, 2:].reshape(se.shape[0], -1, 2) + robot_pos
            if se.shape[-1] > 2 else None)
        if on_frame is not None:
            on_frame(t, {k: traj[k][-1] for k in traj} |
                     {"robot_radius": state.robot.radius[0].cpu().numpy()})
        if network:
            _, action, _, hxs = policy_mod.act(policy, obs_to_dict(obs), hxs,
                                               masks, deterministic=True)
        else:
            action = torch.zeros(1, 2, device=device)
        state, obs, rew, d, _ = crowd_sim.step(cfg, state, action, "test",
                                               robot_policy)
        if use_pretext:
            # per-step GST prediction + reward rewrite, as in vector.vec_step
            # (VecPretextNormalize.step_wait:69-75)
            state, obs, rew, _ = pretext_process(cfg, gst_model, state, obs,
                                                 rew)
        done = bool(d[0])
        t += 1
    traj["robot_radius"] = state.robot.radius[0].cpu().numpy()
    return traj
