"""GST observation/reward processing, batched over envs.

Port of the JAX package's ``env/pretext.py:26-70`` (reference
rl/vec_env/vec_pretext_normalize.py:112-191): push the history buffers,
predict 5-step futures with the GST model, add the future-collision
penalty, write the robot-frame predictions into ``spatial_edges`` and sort
humans by current distance (stable).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..models.gst.predictor import gst_predict
from ..models.gst.st_model import STModel
from ..utils.profiling import spanned
from .types import EnvState, Observation


@spanned("gst.pretext")
def pretext_process(cfg: Config, gst_model: STModel, state: EnvState,
                    obs: Observation, rew):
    """Returns (new_state, new_obs, new_rew, penalty); rew/penalty (B,)."""
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
    hit = torch.linalg.norm(hr, dim=-1) < cfg.robot.radius + cfg.humans.radius
    hit = hit & out_mask[..., None]
    coeff = 2.0 ** torch.arange(2, K + 2, device=hit.device, dtype=hr.dtype)
    penalties = cfg.reward.collision_penalty / coeff           # negative
    penalty = (hit * penalties).flatten(1).amin(dim=-1)
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
    return state, dataclasses.replace(obs, spatial_edges=edges), rew, penalty
