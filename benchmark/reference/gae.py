"""Returns for PPO: generalized advantage estimation or discounted returns
(JAX package ``algo/gae.py:10-42``; reference rl/networks/storage.py:98-137),
as a reverse loop over T."""

from __future__ import annotations

import torch


def compute_returns(rewards, values, masks, bad_masks, gamma: float,
                    gae_lambda: float, use_gae: bool = True,
                    use_proper_time_limits: bool = False) -> torch.Tensor:
    """rewards (T, N); values (T+1, N); masks and bad_masks (T+1, N).
    masks[t+1] = 0 when the episode ended at step t; bad_masks[t+1] = 0 when
    that end was a time-limit truncation (storage.py:49-51). Returns (T, N)."""
    T = rewards.shape[0]
    returns = torch.empty_like(rewards)
    if use_gae:
        gae = torch.zeros_like(rewards[0])
        for t in range(T - 1, -1, -1):
            delta = (rewards[t] + gamma * values[t + 1] * masks[t + 1]
                     - values[t])
            gae = delta + gamma * gae_lambda * masks[t + 1] * gae
            if use_proper_time_limits:
                gae = gae * bad_masks[t + 1]
            returns[t] = gae + values[t]
    else:
        ret = values[-1]
        for t in range(T - 1, -1, -1):
            ret = ret * gamma * masks[t + 1] + rewards[t]
            if use_proper_time_limits:
                ret = (ret * bad_masks[t + 1]
                       + (1.0 - bad_masks[t + 1]) * values[t])
            returns[t] = ret
    return returns
