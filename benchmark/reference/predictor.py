"""Env-facing GST inference of the reference (a frozen copy of the port's
``models/gst/predictor.py``; weights from a ``.npz`` export only)."""

from __future__ import annotations

from typing import Tuple

import torch

from .config import PredConfig
from .params import params_tree, tree_to_state_dict
from .st_model import STModel

INVALID = -999.0


def load_gst(cfg: PredConfig, params, device) -> STModel:
    """An STModel on ``device`` holding ``params``: a flax-style tree or the
    path of a ``.npz`` export."""
    model = STModel(cfg)
    model.load_state_dict(tree_to_state_dict(params_tree(params)), strict=True)
    return model.to(torch.device(device)).eval()


@torch.no_grad()
def gst_predict(model: STModel, input_traj, input_mask, noise=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """input_traj (B, A, L, 2) absolute positions; input_mask (B, A, L) bool.
    With the edge selector (``spatial_num_heads_edges > 0``) the model reads
    the pairwise relative positions and the Gumbel uniforms ``noise``
    (``st_model.draw_noise``'s layout; default: drawn from a generator
    seeded 0).

    Returns (out_traj (B, A, K, 5) [mu_x, mu_y, sx, sy, corr] in the absolute
    frame, out_mask (B, A, 1) bool)."""
    B, A, L, _ = input_traj.shape
    K = model.cfg.pred_seq_len
    m = input_mask.float()

    # relative-displacement validity (interface lines 77-78)
    lm_rel_obs = torch.cat([m[..., :1], m[..., :-1] * m[..., -1:]], dim=-1)
    lm_rel_pred = lm_rel_obs[..., -1:].expand(B, A, K)
    loss_mask_rel = torch.cat([lm_rel_obs, lm_rel_pred], dim=-1)

    # pairwise attention masks per timestep (lines 82-84)
    lm_t = lm_rel_obs.transpose(1, 2)                          # (B, L, A)
    attn_mask_obs = lm_t[..., :, None] * lm_t[..., None, :]   # (B, L, A, A)

    # displacements, invalid slots -> -999 (lines 86-89)
    disp = input_traj[:, :, 1:] - input_traj[:, :, :-1]
    disp = torch.cat([torch.zeros_like(input_traj[:, :, :1]), disp], dim=2)
    disp = torch.where(lm_rel_obs[..., None] > 0, disp,
                       torch.full_like(disp, INVALID))
    v_obs = disp.transpose(1, 2)                               # (B, L, A, 2)
    a_obs = None
    if model.cfg.spatial_num_heads_edges:
        # relative positions (i - j) per timestep (seq_to_graph, lines 9-21)
        pos_t = input_traj.transpose(1, 2)                     # (B, L, A, 2)
        a_obs = pos_t[:, :, :, None] - pos_t[:, :, None]       # (B, L, A, A, 2)

    (mu, sx, sy, corr), _ = model(v_obs, attn_mask_obs, loss_mask_rel,
                                  a_obs, noise=noise)

    # accumulate displacement Gaussians to the absolute frame (lines 98-111)
    mu_cum = torch.cumsum(mu, dim=1) + input_traj[:, None, :, -1]
    sx_cum = torch.sqrt(torch.cumsum(sx ** 2, dim=1))
    sy_cum = torch.sqrt(torch.cumsum(sy ** 2, dim=1))
    corr_cum = torch.cumsum(corr * sx * sy, dim=1) / (sx_cum * sy_cum)

    lm_pred = lm_rel_pred.transpose(1, 2)[..., None]           # (B, K, A, 1)
    mu_cum = mu_cum * lm_pred + INVALID * (1.0 - lm_pred)
    out = torch.cat([mu_cum, sx_cum, sy_cum, corr_cum], dim=-1)
    return out.transpose(1, 2), lm_rel_pred[..., :1] > 0
