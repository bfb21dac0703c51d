"""DS-RNN, the base of ``robot.policy = "srnn"``, plain PyTorch.

A frozen copy of the port's ``models/srnn.py`` (Liu et al., "Decentralized
Structural-RNN for Robot Crowd Navigation with Deep Reinforcement
Learning", ICRA 2021; upstream rl/networks/srnn_model.py:326-468): a
temporal-edge GRU over the robot's velocity, a spatial-edge GRU over every
robot-human edge, an unmasked dot-product attention of the temporal edge
over the spatial ones, a node GRU, and the critic and actor towers. Every
product is stated in float32, so its operands pass through
``precision.rnd`` at "f32". Parameter names are the port's, so one
state_dict loads into both.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..policy_net import TorchGRUCell
from ..precision import Linear, rnd


def _masked_gru(cell: TorchGRUCell, x, h, masks):
    """The GRU over time, its carry times the done mask before every step.
    x (T, N, E, in); h (N, E, H); masks (T, N). Returns (outputs (T, N, E,
    H), the last carry)."""
    outs = []
    for t in range(x.shape[0]):
        h = cell(x[t], h * masks[t][:, None, None])
        outs.append(h)
    return torch.stack(outs), h


class HumanHumanEdgeRNN(nn.Module):
    """Edge GRU: Linear(in -> 64) + ReLU + GRU(64 -> 256)."""

    def __init__(self, in_size: int, embedding_size: int = 64,
                 rnn_size: int = 256):
        super().__init__()
        self.encoder_linear = Linear(in_size, embedding_size)
        self.gru = TorchGRUCell(embedding_size, rnn_size)

    def forward(self, inp, h, masks):
        return _masked_gru(self.gru, F.relu(self.encoder_linear(inp)), h,
                           masks)


class HumanNodeRNN(nn.Module):
    """Node GRU over the robot's node embedding and its edges' (temporal
    output and attention-weighted spatial output)."""

    def __init__(self, node_size: int = 3, edge_size: int = 256,
                 embedding_size: int = 64, rnn_size: int = 128,
                 output_size: int = 256):
        super().__init__()
        self.encoder_linear = Linear(node_size, embedding_size)
        self.edge_attention_embed = Linear(2 * edge_size, embedding_size)
        self.gru = TorchGRUCell(2 * embedding_size, rnn_size)
        self.output_linear = Linear(rnn_size, output_size)

    def forward(self, pos, h_temporal, h_spatial_other, h, masks):
        enc = F.relu(self.encoder_linear(pos))
        att = F.relu(self.edge_attention_embed(
            torch.cat([h_temporal, h_spatial_other], dim=-1)))
        outputs, h_new = _masked_gru(self.gru, torch.cat([enc, att], dim=-1),
                                     h, masks)
        return self.output_linear(outputs), h_new


class EdgeAttention(nn.Module):
    """Unmasked robot-human attention, temperature A / sqrt(64)."""

    def __init__(self, attention_size: int = 64, in_size: int = 256):
        super().__init__()
        self.attention_size = attention_size
        self.temporal_edge_layer = Linear(in_size, attention_size)
        self.spatial_edge_layer = Linear(in_size, attention_size)

    def forward(self, h_temporal, h_spatials):
        # h_temporal (T, N, 1, 256); h_spatials (T, N, A, 256)
        A = h_spatials.shape[2]
        te = self.temporal_edge_layer(h_temporal)
        sp = self.spatial_edge_layer(h_spatials)
        attn = (te * sp).sum(dim=-1) * (A / math.sqrt(self.attention_size))
        attn = torch.softmax(attn, dim=-1)                      # (T, N, A)
        weighted = torch.einsum("tna,tnac->tnc", rnd(attn, "f32"),
                                rnd(h_spatials, "f32"))
        return weighted[:, :, None, :], attn


class Base(nn.Module):
    """The DS-RNN base. Consumes time-major obs [T, N, ...] and the two-slot
    hidden state of ``policy_net.init_hidden``; returns (value [T, N, 1],
    actor_features [T, N, 256], new hidden: the node GRU's and, in
    ``human_human_edge_rnn``, the temporal edge's carry followed by the A
    spatial edges')."""

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
        self.robot_linear = Linear(7, 3)
        self.humanNodeRNN = HumanNodeRNN(
            3, net.human_human_edge_rnn_size, net.human_node_embedding_size,
            net.human_node_rnn_size, net.human_node_output_size)
        h = net.human_node_output_size
        self.critic_0, self.critic_1 = Linear(h, h), Linear(h, h)
        self.actor_0, self.actor_1 = Linear(h, h), Linear(h, h)
        self.critic_linear = Linear(h, 1)

    def forward(self, obs: Dict[str, torch.Tensor], rnn_hxs, masks,
                use_kernel: bool = False):
        """``use_kernel`` is read by nothing: DS-RNN has no human-human
        attention."""
        T, N = masks.shape
        A = self.cfg.sim.max_human_num
        robot_node = obs["robot_node"].reshape(T, N, 1, -1)
        temporal_edges = obs["temporal_edges"].reshape(T, N, 1, -1)
        spatial_edges = obs["spatial_edges"].reshape(T, N, A, -1)
        h_edges = rnn_hxs["human_human_edge_rnn"]               # (N, A+1, 256)

        out_temporal, h_temporal = self.edgeRNN_temporal(
            temporal_edges, h_edges[:, 0:1], masks)
        out_spatial, h_spatial = self.edgeRNN_spatial(
            spatial_edges, h_edges[:, 1:], masks)
        weighted, _ = self.attn(out_temporal, out_spatial)
        outputs, h_node = self.humanNodeRNN(
            self.robot_linear(robot_node), out_temporal, weighted,
            rnn_hxs["human_node_rnn"], masks)
        x = outputs[:, :, 0, :]
        hidden_critic = torch.tanh(self.critic_1(torch.tanh(self.critic_0(x))))
        hidden_actor = torch.tanh(self.actor_1(torch.tanh(self.actor_0(x))))
        value = self.critic_linear(hidden_critic)
        return value, hidden_actor, {
            "human_node_rnn": h_node,
            "human_human_edge_rnn": torch.cat([h_temporal, h_spatial], dim=1)}
