"""GST observation/reward processing of the reference (a frozen copy of the
port's ``env/pretext.py``, with the penalty and the sorted prediction mask
exposed for the comparison)."""

from __future__ import annotations

import dataclasses

import torch

from .config import Config
from .predictor import gst_predict
from .st_model import STModel
from .types import EnvState, Observation


def penalty_of(cfg: Config, rel, mask):
    """The future-collision penalty (B,) of robot-frame predictions ``rel``
    (B, A, K, 2) where ``mask`` (B, A) (vec_pretext_normalize.py:134-159)."""
    K = cfg.sim.predict_steps
    hit = torch.linalg.norm(rel, dim=-1) < cfg.robot.radius + cfg.humans.radius
    hit = hit & mask[..., None]
    coeff = 2.0 ** torch.arange(2, K + 2, device=hit.device, dtype=rel.dtype)
    penalties = cfg.reward.collision_penalty / coeff           # negative
    return (hit * penalties).flatten(1).amin(dim=-1)


def pretext_process(cfg: Config, gst_model: STModel, state: EnvState,
                    obs: Observation, rew):
    """Returns (new_state, new_obs, new_rew, penalty); rew/penalty (B,)."""
    return pretext_parts(cfg, gst_model, state, obs, rew)[:4]


def pretext_parts(cfg: Config, gst_model: STModel, state: EnvState,
                  obs: Observation, rew):
    """:func:`pretext_process` and, last, the predicted humans' mask in
    the sorted order of the new observation (B, A)."""
    B, A = obs.visible_masks.shape
    K = cfg.sim.predict_steps
    robot_pos = obs.robot_node[:, :2]

    # rolling history buffers (vec_pretext_normalize.py:117-128)
    human_pos = robot_pos[:, None] + obs.spatial_edges[..., :2]
    traj_buffer = torch.cat([state.traj_buffer[:, 1:], human_pos[:, None]], 1)
    mask_buffer = torch.cat([state.mask_buffer[:, 1:],
                             obs.visible_masks[:, None]], 1)
    state = dataclasses.replace(state, traj_buffer=traj_buffer,
                                mask_buffer=mask_buffer)

    in_traj = traj_buffer[:, ::cfg.pred_interval].transpose(1, 2)
    in_mask = mask_buffer[:, ::cfg.pred_interval].transpose(1, 2)
    out_traj, out_mask = gst_predict(gst_model, in_traj, in_mask)
    out_mask = out_mask[..., 0]                                # (B, A)

    # future-collision penalty (vec_pretext_normalize.py:134-159)
    hr = out_traj[..., :2] - robot_pos[:, None, None]          # (B, A, K, 2)
    penalty = penalty_of(cfg, hr, out_mask)
    rew = rew + penalty

    # robot-frame predictions where predicted (vec_pretext_normalize.py:162-170)
    rel = hr.reshape(B, A, 2 * K)
    edges = obs.spatial_edges
    edges = torch.cat([edges[..., :2],
                       torch.where(out_mask[..., None], rel, edges[..., 2:])], -1)

    # sort humans by current distance (vec_pretext_normalize.py:173-178)
    order = torch.argsort(torch.linalg.norm(edges[..., :2], dim=-1), dim=-1,
                          stable=True)
    edges = torch.gather(edges, 1, order[..., None].expand_as(edges))
    return (state, dataclasses.replace(obs, spatial_edges=edges), rew,
            penalty, torch.gather(out_mask, 1, order))
