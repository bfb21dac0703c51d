"""Running mean/std + observation/reward normalization (JAX package
``utils/running_mean_std.py``; reference rl/vec_env/running_mean_std.py +
vec_normalize.py, vendored baselines utilities that the shipped recipes do
not use). Functional form on tensors: state in, state out."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RMSState(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor


def rms_init(shape=(), device="cpu") -> RMSState:
    """Zero mean, unit variance and the reference's 1e-4 initial count, on
    ``device``."""
    return RMSState(torch.zeros(shape, device=device),
                    torch.ones(shape, device=device),
                    torch.tensor(1e-4, device=device))


def rms_update(state: RMSState, batch: torch.Tensor) -> RMSState:
    """Parallel-variance update over the leading axis of ``batch``
    (running_mean_std.py:18-37)."""
    batch_mean = batch.mean(dim=0)
    batch_var = batch.var(dim=0, unbiased=False)
    batch_count = batch.shape[0]

    delta = batch_mean - state.mean
    tot = state.count + batch_count
    new_mean = state.mean + delta * batch_count / tot
    m_a = state.var * state.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta ** 2 * state.count * batch_count / tot
    return RMSState(new_mean, m2 / tot, tot)


def normalize_obs(state: RMSState, obs, clip: float = 10.0,
                  epsilon: float = 1e-8):
    """(obs - mean) / sqrt(var + eps), clipped (vec_normalize.py:27-33)."""
    return torch.clamp((obs - state.mean) / torch.sqrt(state.var + epsilon),
                       -clip, clip)


def normalize_reward(state: RMSState, rew, clip: float = 10.0,
                     epsilon: float = 1e-8):
    """Reward scaled by return std (vec_normalize.py:35-39)."""
    return torch.clamp(rew / torch.sqrt(state.var + epsilon), -clip, clip)
