"""GST losses and metrics (JAX package ``models/gst/losses.py:1-59``;
reference gst_updated st_model.py:15-111, src/mgnn/utils.py:8-26), over
padded dense batches."""

from __future__ import annotations

import torch


def _masks(loss_mask_ped, loss_mask_pred_seq):
    """(B, K, A, 1) per-step and (B, 1, A, 1) per-pedestrian masks."""
    return (loss_mask_pred_seq.transpose(1, 2)[..., None],
            loss_mask_ped[:, None, :, None])


def negative_log_likelihood(gaussian_params, x_target, loss_mask_ped,
                            loss_mask_pred_seq):
    """Masked bivariate-Gaussian NLL (``losses.py:8-33``).

    gaussian_params: (mu (B, K, A, 2), sx (B, K, A, 1), sy, corr);
    x_target (B, K, A, 2) ground-truth displacements; loss_mask_ped (B, A);
    loss_mask_pred_seq (B, A, K). Returns (prob_loss (B, K, A),
    eventual_mask (B, K, A))."""
    mu, sx, sy, corr = gaussian_params
    lm_seq, lm_ped = _masks(loss_mask_ped, loss_mask_pred_seq)
    mu = mu * lm_seq * lm_ped
    corr = corr * lm_seq * lm_ped
    x_target = x_target * lm_seq * lm_ped
    sx = sx * lm_seq + (1.0 - lm_seq)
    sy = sy * lm_seq + (1.0 - lm_seq)
    sx = sx * lm_ped + (1.0 - lm_ped)
    sy = sy * lm_ped + (1.0 - lm_ped)
    xn = (x_target - mu) / torch.cat([sx, sy], dim=-1)
    nx, ny = xn[..., 0:1], xn[..., 1:2]
    t1 = torch.log(1.0 - corr ** 2) / 2.0 + torch.log(sx) + torch.log(sy)
    t2 = (nx ** 2 - 2.0 * corr * nx * ny + ny ** 2) / (2.0 * (1.0 - corr ** 2))
    eventual = lm_seq[..., 0] * lm_ped[..., 0]
    return (t1 + t2)[..., 0] * eventual, eventual


def offset_error_square(x_pred, x_target, loss_mask_ped, loss_mask_pred_seq):
    """Masked squared position offset (``losses.py:36-47``); returns
    (err (B, K, A), eventual_mask (B, K, A))."""
    lm_seq, lm_ped = _masks(loss_mask_ped, loss_mask_pred_seq)
    pos_pred = torch.cumsum(x_pred * lm_seq * lm_ped, dim=1)
    pos_target = torch.cumsum(x_target * lm_seq * lm_ped, dim=1)
    err = ((pos_pred - pos_target) ** 2).sum(dim=-1)
    eventual = lm_seq[..., 0] * lm_ped[..., 0]
    return err * eventual, eventual


def offset_errors(x_pred, x_target, loss_mask_ped):
    """(aoe (B, A), foe (B, A)) masked by ``loss_mask_ped`` (the
    fully-observed pedestrians, ``losses.py:50-59``)."""
    pos_pred = torch.cumsum(x_pred, dim=1)
    pos_target = torch.cumsum(x_target, dim=1)
    err = torch.sqrt(((pos_pred - pos_target) ** 2).sum(dim=-1))  # (B, K, A)
    return err.mean(dim=1) * loss_mask_ped, err[:, -1] * loss_mask_ped
