"""DiagGaussian action head (JAX package ``models/distributions.py``;
reference rl/networks/distributions.py:76-95).

State-dependent mean from a linear layer, state-independent ``logstd`` (the
reference's AddBias over zeros): ``mode``, ``log_prob``, ``entropy`` and
``sample`` with an explicit ``torch.Generator``. ``log_prob`` and
``entropy`` are plain tensor expressions, so the PPO loss differentiates
through them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

LOG_2PI = math.log(2.0 * math.pi)


class DiagGaussianParams(nn.Module):
    """Parameters ``fc_mean`` and ``logstd``, as in the flax tree."""

    def __init__(self, num_inputs: int, num_outputs: int):
        super().__init__()
        self.fc_mean = nn.Linear(num_inputs, num_outputs)
        self.logstd = nn.Parameter(torch.zeros(num_outputs))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        mean = self.fc_mean(x)
        return mean, self.logstd.expand_as(mean)


def mode(mean):
    return mean


def sample(mean, logstd, generator: Optional[torch.Generator] = None,
           rows: Optional[Tuple[int, int]] = None):
    """mean + std x noise. ``rows`` = (offset, total): draw the noise of
    ``total`` rows and keep ``mean``'s rows from ``offset`` on, so that a
    process holding a slice of the envs draws what one process stepping
    them all would give that slice."""
    if rows is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    else:
        offset, total = rows
        noise = torch.randn((total, *mean.shape[1:]), generator=generator,
                            device=mean.device, dtype=mean.dtype)
        noise = noise[offset:offset + mean.shape[0]]
    return mean + torch.exp(logstd) * noise


def log_prob(mean, logstd, actions):
    """Summed-over-dims Gaussian log prob (FixedNormal.log_probs)."""
    var = torch.exp(2.0 * logstd)
    lp = -((actions - mean) ** 2) / (2.0 * var) - logstd - 0.5 * LOG_2PI
    return lp.sum(dim=-1, keepdim=True)


def entropy(logstd):
    """Per-dimension Gaussian entropies; callers take the mean."""
    return 0.5 + 0.5 * LOG_2PI + logstd
