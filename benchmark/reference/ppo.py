"""PPO's update of the reference: GAE, the clipped surrogate and value
loss, the global-norm clip, and Adam (frozen copies of the port's
``algo/ppo.py`` pieces over the plain policy)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from .config import Config
from . import policy as policy_mod
from .gae import compute_returns


@dataclasses.dataclass
class RolloutBatch:
    """One rollout, as the port's ``RolloutBatch`` holds it."""
    obs: Dict[str, torch.Tensor]      # (T+1, N, ...)
    hxs0: Dict[str, torch.Tensor]     # hidden at rollout start (N, ...)
    actions: torch.Tensor             # (T, N, 2)
    log_probs: torch.Tensor           # (T, N, 1)
    values: torch.Tensor              # (T+1, N, 1)
    rewards: torch.Tensor             # (T, N)
    masks: torch.Tensor               # (T+1, N)
    bad_masks: torch.Tensor           # (T+1, N)


def make_optimizer(cfg: Config, params):
    """Adam(lr, eps) and the linear decay of ``use_linear_lr_decay`` over
    num_updates x ppo_epoch x num_mini_batch Adam steps."""
    p = cfg.ppo
    optimizer = torch.optim.Adam(params, lr=p.lr, eps=p.eps)
    total = (int(p.num_env_steps) // p.num_steps // p.num_processes
             * p.ppo_epoch * p.num_mini_batch)
    if p.use_linear_lr_decay and total > 0:
        def factor(k):
            return 1.0 - min(k, total) / total
    else:
        def factor(k):
            return 1.0
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sq_norm: Optional[torch.Tensor] = None):
    """optax.clip_by_global_norm in place: every gradient times
    min(1, max_norm / ||all gradients||). ``sq_norm`` is the squared norm
    when ``grads`` are not all of it (tensor-parallel pieces)."""
    if sq_norm is None:
        sq_norm = sum((g * g).sum() for g in grads)
    norm = torch.sqrt(sq_norm)
    factor = torch.clamp(max_norm / norm, max=1.0)
    for g in grads:
        g.mul_(factor)


def advantages(cfg: Config, batch: RolloutBatch):
    """(returns (T, N), normalised advantages (T, N)) (``ppo.py:174-181``):
    advantages over the whole batch, normalised with std(ddof=1) as torch's
    ``.std()`` does."""
    p = cfg.ppo
    returns = compute_returns(batch.rewards, batch.values[:, :, 0],
                              batch.masks, batch.bad_masks, p.gamma,
                              p.gae_lambda, p.use_gae,
                              p.use_proper_time_limits)
    adv = returns - batch.values[:-1, :, 0]
    return returns, (adv - adv.mean()) / (adv.std() + 1e-5)


def ppo_loss(cfg: Config, model: policy_mod.PolicyHead, batch: RolloutBatch,
             returns, adv_n, idx):
    """The minibatch loss over envs ``idx`` (``ppo.py:187-215``): clipped
    surrogate, (clipped) value loss and entropy bonus. Returns (total,
    (value_loss, action_loss, entropy))."""
    p = cfg.ppo
    obs_mb = {k: v[:-1, idx] for k, v in batch.obs.items()}
    hxs_mb = {k: v[idx] for k, v in batch.hxs0.items()}
    values, log_probs, entropy = policy_mod.evaluate_actions(
        model, obs_mb, hxs_mb, batch.masks[:-1, idx], batch.actions[:, idx])
    values = values[:, :, 0]
    vpred_old = batch.values[:-1, idx, 0]
    ret_mb, adv_mb = returns[:, idx], adv_n[:, idx]
    ratio = torch.exp(log_probs[:, :, 0] - batch.log_probs[:, idx, 0])
    surr1 = ratio * adv_mb
    surr2 = torch.clamp(ratio, 1.0 - p.clip_param, 1.0 + p.clip_param) * adv_mb
    action_loss = -torch.minimum(surr1, surr2).mean()
    if p.use_clipped_value_loss:
        v_clipped = vpred_old + torch.clamp(values - vpred_old,
                                            -p.clip_param, p.clip_param)
        value_loss = 0.5 * torch.maximum((values - ret_mb) ** 2,
                                         (v_clipped - ret_mb) ** 2).mean()
    else:
        value_loss = 0.5 * ((ret_mb - values) ** 2).mean()
    total = (value_loss * p.value_loss_coef + action_loss
             - entropy * p.entropy_coef)
    return total, (value_loss, action_loss, entropy)
