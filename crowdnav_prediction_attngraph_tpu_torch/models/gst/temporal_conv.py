"""Temporal-convolution readout decoder (JAX package
``models/gst/temporal_conv.py:1-48``; reference
gst_updated/src/gumbel_social_transformer/temporal_convolution_net.py).

The alternative to the recursive LSTM decoder, unused by the shipped
checkpoints: stacked residual time-convolutions over the observation
window, a time-expansion linear pair (obs_len -> pred_len) and a per-node
output MLP. The JAX version convolves ``(batch, obs_len, node, C)`` as NHWC
with a ``(k, 1)`` kernel; torch's ``Conv2d`` is NCHW, so the input is
permuted around it. Parameter names follow the flax tree (``timeconv_i``
kernels carry across through ``utils/params.py``'s conv layout).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .st_model import FLAX_LN_EPS


class TemporalConvolutionNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dim_hidden: int,
                 nconv: int = 2, obs_seq_len: int = 8, pred_seq_len: int = 12,
                 kernel_size: int = 3):
        super().__init__()
        if kernel_size % 2 != 1 or nconv < 2:
            raise ValueError("kernel_size must be odd and nconv >= 2")
        self.nconv = nconv
        for i in range(nconv):
            self.add_module(f"norm_{i}", nn.LayerNorm(in_channels,
                                                      eps=FLAX_LN_EPS))
            self.add_module(f"timeconv_{i}", nn.Conv2d(
                in_channels, in_channels, (kernel_size, 1),
                padding=(kernel_size // 2, 0)))
        self.timelinear1 = nn.Linear(obs_seq_len, pred_seq_len)
        self.timelinear2 = nn.Linear(pred_seq_len, pred_seq_len)
        self.linear1 = nn.Linear(in_channels, dim_hidden)
        self.linear2 = nn.Linear(dim_hidden, out_channels)

    def forward(self, x):
        """x (batch, obs_len, node, C) -> (batch, pred_len, node, out)."""
        for i in range(self.nconv):
            h = getattr(self, f"norm_{i}")(x).permute(0, 3, 1, 2)   # NCHW
            h = F.relu(getattr(self, f"timeconv_{i}")(h))
            x = x + h.permute(0, 2, 3, 1)
        x = x.permute(0, 2, 3, 1)                  # (batch, node, C, obs_len)
        x = F.relu(self.timelinear1(x))
        x = F.relu(self.timelinear2(x))
        x = x.permute(0, 3, 1, 2)                  # (batch, pred_len, node, C)
        return self.linear2(F.relu(self.linear1(x)))
