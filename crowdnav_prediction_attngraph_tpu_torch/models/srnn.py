"""DS-RNN, the baseline policy behind ``robot.policy = "srnn"`` (JAX package
``models/srnn.py``; reference rl/networks/srnn_model.py:326-468).

A temporal-edge GRU over the robot's velocity, a spatial-edge GRU over every
robot-human edge, an unmasked dot-product attention of the temporal edge
over the spatial ones, and a node GRU, then the critic and actor towers of
the flagship policy. Submodule and parameter names follow the flax tree, so
``utils/params.tree_to_state_dict`` of a JAX tree loads directly. Plain
PyTorch: the JAX package has no kernel here either. Each GRU multiplies its
carry by the done mask before every step (srnn_model.py:35-105).

While the port's tracing is on (``utils/profiling``), each block of
:meth:`SRNN.forward` is a span, ``srnn.temporal_edge``,
``srnn.spatial_edge``, ``srnn.attention``, ``srnn.node`` and
``srnn.heads``, and the counter ``srnn.gru_cells`` counts the GRU cell calls
(3 x T a forward: the temporal, spatial and node GRUs over T steps).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..utils.profiling import count, span
from .policy_net import TorchGRUCell


def _masked_gru(cell: TorchGRUCell, x, h, masks):
    """The GRU over time with done-mask resets (``srnn.py:21-35``).
    x (T, N, E, in); h (N, E, H); masks (T, N). Returns (outputs (T, N, E,
    H), the last carry)."""
    count("srnn.gru_cells", x.shape[0])
    outs = []
    for t in range(x.shape[0]):
        h = cell(x[t], h * masks[t][:, None, None])
        outs.append(h)
    return torch.stack(outs), h


class HumanHumanEdgeRNN(nn.Module):
    """Edge GRU (``srnn.py:38-50``): Linear(in -> 64) + ReLU + GRU(64 ->
    256). The temporal instance runs over one edge a step, the spatial one
    over A (N x A rows a step)."""

    def __init__(self, in_size: int, embedding_size: int = 64,
                 rnn_size: int = 256):
        super().__init__()
        self.encoder_linear = nn.Linear(in_size, embedding_size)
        self.gru = TorchGRUCell(embedding_size, rnn_size)

    def forward(self, inp, h, masks):
        return _masked_gru(self.gru, F.relu(self.encoder_linear(inp)), h,
                           masks)


class HumanNodeRNN(nn.Module):
    """Node GRU (``srnn.py:53-70``) over the robot's node embedding and its
    edges' (temporal output and attention-weighted spatial output)."""

    def __init__(self, node_size: int = 3, edge_size: int = 256,
                 embedding_size: int = 64, rnn_size: int = 128,
                 output_size: int = 256):
        super().__init__()
        self.encoder_linear = nn.Linear(node_size, embedding_size)
        self.edge_attention_embed = nn.Linear(2 * edge_size, embedding_size)
        self.gru = TorchGRUCell(2 * embedding_size, rnn_size)
        self.output_linear = nn.Linear(rnn_size, output_size)

    def forward(self, pos, h_temporal, h_spatial_other, h, masks):
        enc = F.relu(self.encoder_linear(pos))
        att = F.relu(self.edge_attention_embed(
            torch.cat([h_temporal, h_spatial_other], dim=-1)))
        outputs, h_new = _masked_gru(self.gru, torch.cat([enc, att], dim=-1),
                                     h, masks)
        return self.output_linear(outputs), h_new


class EdgeAttention(nn.Module):
    """Unmasked robot-human attention, temperature A / sqrt(64)
    (``srnn.py:73-88``)."""

    def __init__(self, attention_size: int = 64, in_size: int = 256):
        super().__init__()
        self.attention_size = attention_size
        self.temporal_edge_layer = nn.Linear(in_size, attention_size)
        self.spatial_edge_layer = nn.Linear(in_size, attention_size)

    def forward(self, h_temporal, h_spatials):
        # h_temporal (T, N, 1, 256); h_spatials (T, N, A, 256)
        A = h_spatials.shape[2]
        te = self.temporal_edge_layer(h_temporal)
        sp = self.spatial_edge_layer(h_spatials)
        attn = (te * sp).sum(dim=-1) * (A / math.sqrt(self.attention_size))
        attn = torch.softmax(attn, dim=-1)                      # (T, N, A)
        weighted = torch.einsum("tna,tnac->tnc", attn, h_spatials)
        return weighted[:, :, None, :], attn


class SRNN(nn.Module):
    """The DS-RNN base (``srnn.py:91-138``). Consumes time-major obs
    [T, N, ...] and the two-slot hidden state of ``init_hidden``; returns
    (value [T, N, 1], actor_features [T, N, 256], new hidden: the node GRU's
    and, in ``human_human_edge_rnn``, the temporal edge's carry followed by
    the A spatial edges')."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        net = cfg.network
        edge = (net.human_human_edge_embedding_size,
                net.human_human_edge_rnn_size)
        self.edgeRNN_temporal = HumanHumanEdgeRNN(2, *edge)
        self.edgeRNN_spatial = HumanHumanEdgeRNN(cfg.spatial_edge_dim, *edge)
        self.attn = EdgeAttention(net.attention_size,
                                  net.human_human_edge_rnn_size)
        self.robot_linear = nn.Linear(7, 3)
        self.humanNodeRNN = HumanNodeRNN(
            3, net.human_human_edge_rnn_size, net.human_node_embedding_size,
            net.human_node_rnn_size, net.human_node_output_size)
        h = net.human_node_output_size
        self.critic_0, self.critic_1 = nn.Linear(h, h), nn.Linear(h, h)
        self.actor_0, self.actor_1 = nn.Linear(h, h), nn.Linear(h, h)
        self.critic_linear = nn.Linear(h, 1)

    def forward(self, obs: Dict[str, torch.Tensor], rnn_hxs, masks,
                use_kernel: bool = False):
        """``use_kernel`` is taken for the common policy interface; DS-RNN
        has no human-human attention, so no kernel runs."""
        T, N = masks.shape
        A = self.cfg.sim.max_human_num
        robot_node = obs["robot_node"].reshape(T, N, 1, -1)
        temporal_edges = obs["temporal_edges"].reshape(T, N, 1, -1)
        spatial_edges = obs["spatial_edges"].reshape(T, N, A, -1)
        h_edges = rnn_hxs["human_human_edge_rnn"]               # (N, A+1, 256)

        with span("srnn.temporal_edge"):
            out_temporal, h_temporal = self.edgeRNN_temporal(
                temporal_edges, h_edges[:, 0:1], masks)
        with span("srnn.spatial_edge"):
            out_spatial, h_spatial = self.edgeRNN_spatial(
                spatial_edges, h_edges[:, 1:], masks)
        with span("srnn.attention"):
            weighted, _ = self.attn(out_temporal, out_spatial)
        with span("srnn.node"):
            outputs, h_node = self.humanNodeRNN(
                self.robot_linear(robot_node), out_temporal, weighted,
                rnn_hxs["human_node_rnn"], masks)
        with span("srnn.heads"):
            x = outputs[:, :, 0, :]
            hidden_critic = torch.tanh(
                self.critic_1(torch.tanh(self.critic_0(x))))
            hidden_actor = torch.tanh(
                self.actor_1(torch.tanh(self.actor_0(x))))
            value = self.critic_linear(hidden_critic)
        return value, hidden_actor, {
            "human_node_rnn": h_node,
            "human_human_edge_rnn": torch.cat([h_temporal, h_spatial], dim=1)}
