"""The attention interaction-graph policy network, plain PyTorch.

A frozen copy of the port's ``models/policy_net.py`` with its kernel branch
and its ring taken out: the human-human attention is the einsum branch,
and every product's operands pass through ``precision.rnd`` at the
precision the configuration states for it (the attention block at
``pallas_dtype``, the rest float32). Parameter names are the port's, so one
state_dict loads into both.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .config import Config
from .precision import Linear, rnd


def create_attn_mask(each_seq_len, max_human_num: int):
    """Sentinel-cumsum padding mask (``policy_net.py:37-45``): slot j of a row
    is valid iff j < each_seq_len. Returns (rows, max_human_num) bool."""
    idx = torch.arange(max_human_num, device=each_seq_len.device)
    return idx[None, :] < each_seq_len[:, None]


class TorchGRUCell(nn.Module):
    """GRU cell with torch ``nn.GRU`` gate order [r, z, n]; weights kept in the
    flax layout w_ih (in, 3H), w_hh (H, 3H) (``policy_net.py:48-70``)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        H = hidden_size
        self.w_ih = nn.Parameter(torch.zeros(input_size, 3 * H))
        self.w_hh = nn.Parameter(torch.zeros(H, 3 * H))
        self.b_ih = nn.Parameter(torch.zeros(3 * H))
        self.b_hh = nn.Parameter(torch.zeros(3 * H))

    def forward(self, x, h):
        gi = rnd(x, "f32") @ rnd(self.w_ih, "f32") + self.b_ih
        gh = rnd(h, "f32") @ rnd(self.w_hh, "f32") + self.b_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class SpatialEdgeSelfAttn(nn.Module):
    """Human-human MHA over spatial edges (``policy_net.py:73-170``).
    (rows, A, input_size) -> (rows, A, attn_size); ``attn_mask`` (rows, A)
    True = valid key."""

    def __init__(self, input_size: int, attn_size: int = 512,
                 num_heads: int = 8, kernel_dtype: str = "bfloat16",
                 use_ring: bool = False):
        super().__init__()
        D = attn_size
        self.attn_size, self.num_heads = D, num_heads
        self.use_ring = use_ring
        self.kernel_dtype = (torch.float32 if kernel_dtype == "float32"
                             else torch.bfloat16)
        # the block the kernel branch runs in ``kernel_dtype``
        cd = "f32" if kernel_dtype == "float32" else "bf16"
        self.cd = cd
        self.embed_0 = Linear(input_size, 128)
        self.embed_1 = Linear(128, D)
        self.q_linear = Linear(D, D, cd)
        self.k_linear = Linear(D, D, cd)
        self.v_linear = Linear(D, D, cd)
        self.mha_in_proj_weight = nn.Parameter(torch.zeros(D, 3 * D))
        self.mha_in_proj_bias = nn.Parameter(torch.zeros(3 * D))
        self.mha_out_proj = Linear(D, D, cd)

    def forward(self, inp, attn_mask, use_kernel: bool = False):
        """Plain multi-head attention over the valid keys (the port's
        einsum branch); ``use_kernel`` is read by nothing."""
        rows, A, _ = inp.shape
        D, nh, cd = self.attn_size, self.num_heads, self.cd
        hd = D // nh
        x = F.relu(self.embed_1(F.relu(self.embed_0(inp))))
        w_in = rnd(self.mha_in_proj_weight, cd)
        b_in = self.mha_in_proj_bias
        q = rnd(self.q_linear(x), cd) @ w_in[:, :D] + b_in[:D]
        k = rnd(self.k_linear(x), cd) @ w_in[:, D:2 * D] + b_in[D:2 * D]
        v = rnd(self.v_linear(x), cd) @ w_in[:, 2 * D:] + b_in[2 * D:]
        qh = rnd(q.reshape(rows, A, nh, hd), cd)
        kh = rnd(k.reshape(rows, A, nh, hd), cd)
        vh = rnd(v.reshape(rows, A, nh, hd), cd)
        logits = torch.einsum("rqhd,rkhd->rhqk", qh, kh) / math.sqrt(hd)
        logits = logits.masked_fill(~attn_mask[:, None, None, :], -math.inf)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("rhqk,rkhd->rqhd", rnd(w, cd),
                           vh).reshape(rows, A, D)
        return self.mha_out_proj(out)


class EdgeAttentionM(nn.Module):
    """Robot-human single-head dot-product attention, temperature
    num_edges / sqrt(64) (``policy_net.py:173-190``)."""

    def __init__(self, attention_size: int = 64, in_size: int = 256):
        super().__init__()
        self.attention_size = attention_size
        self.temporal_edge_layer = Linear(in_size, attention_size)
        self.spatial_edge_layer = Linear(in_size, attention_size)

    def forward(self, h_temporal, h_spatials, attn_mask):
        rows, A, _ = h_spatials.shape
        te = self.temporal_edge_layer(h_temporal)
        sp = self.spatial_edge_layer(h_spatials)
        attn = (te * sp).sum(dim=-1) * (A / math.sqrt(self.attention_size))
        attn = attn.masked_fill(~attn_mask, -1e9)
        attn = torch.softmax(attn, dim=-1)
        weighted = torch.einsum("ra,rac->rc", rnd(attn, "f32"),
                                rnd(h_spatials, "f32"))
        return weighted[:, None, :], attn


class EndRNN(nn.Module):
    """Node GRU with a done-mask reset before each step
    (``policy_net.py:193-220``)."""

    def __init__(self, rnn_size: int = 128, output_size: int = 256,
                 embedding_size: int = 64, in_size: int = 256):
        super().__init__()
        self.encoder_linear = Linear(in_size, embedding_size)
        self.edge_attention_embed = Linear(in_size, embedding_size)
        self.gru = TorchGRUCell(2 * embedding_size, rnn_size)
        self.output_linear = Linear(rnn_size, output_size)

    def forward(self, robot_s, h_spatial_other, h, masks):
        # robot_s, h_spatial_other: (T, N, 1, 256); h (N, 1, rnn); masks (T, N)
        enc = F.relu(self.encoder_linear(robot_s))
        att = F.relu(self.edge_attention_embed(h_spatial_other))
        x = torch.cat([enc, att], dim=-1)
        outs = []
        for t in range(x.shape[0]):
            h = h * masks[t][:, None, None]
            h = self.gru(x[t], h)
            outs.append(h)
        return self.output_linear(torch.stack(outs)), h


class SelfAttnMergeSRNN(nn.Module):
    """The policy base (``policy_net.py:223-319``). Consumes time-major obs
    [T, N, ...]; returns (value [T, N, 1], actor_features [T, N, 256],
    new_hidden). Only the submodules of the configured ablation exist, as
    in the flax tree."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        net = cfg.network
        robot_in = 2 + 7   # temporal_edges (vx, vy) + robot_node
        self.robot_linear = Linear(robot_in, 256)
        if net.use_self_attn:
            self.spatial_attn = SpatialEdgeSelfAttn(
                cfg.spatial_edge_dim, net.attn_size, net.num_attn_heads,
                kernel_dtype=net.pallas_dtype,
                use_ring=net.use_ring_attention)
            self.spatial_linear = Linear(net.attn_size, 256)
        else:
            self.spatial_linear_0 = Linear(cfg.spatial_edge_dim, 128)
            self.spatial_linear_1 = Linear(128, 256)
        if net.use_hr_attn:
            self.attn = EdgeAttentionM(net.attention_size)
        self.humanNodeRNN = EndRNN(net.human_node_rnn_size,
                                   net.human_node_output_size,
                                   net.human_node_embedding_size)
        h = net.human_node_output_size
        self.critic_0, self.critic_1 = Linear(h, h), Linear(h, h)
        self.actor_0, self.actor_1 = Linear(h, h), Linear(h, h)
        self.critic_linear = Linear(h, 1)

    def forward(self, obs: Dict[str, torch.Tensor], rnn_hxs, masks,
                use_kernel: bool):
        net = self.cfg.network
        T, N = masks.shape
        A = self.cfg.sim.max_human_num
        rows = T * N
        robot_node = obs["robot_node"].reshape(T, N, 1, -1)
        temporal_edges = obs["temporal_edges"].reshape(T, N, 1, -1)
        spatial_edges = obs["spatial_edges"].reshape(rows, A, -1)

        if net.sort_humans:
            # the detected humans come first: a prefix mask
            attn_mask = create_attn_mask(
                obs["detected_human_num"].reshape(rows).long(), A)
        else:
            # the env's visibility, column 0 valid where nothing is
            # (selfAttn_srnn_temp_node.py:351-356, 383)
            attn_mask = obs["visible_masks"].reshape(rows, A).bool()
            none_visible = ~attn_mask.any(dim=-1)
            attn_mask = torch.cat([(attn_mask[:, 0] | none_visible)[:, None],
                                   attn_mask[:, 1:]], dim=1)

        robot_states = F.relu(self.robot_linear(
            torch.cat([temporal_edges, robot_node], dim=-1)))  # (T, N, 1, 256)

        if net.use_self_attn:
            out_sp = F.relu(self.spatial_linear(self.spatial_attn(
                spatial_edges, attn_mask, use_kernel)))
        else:
            out_sp = F.relu(self.spatial_linear_1(F.relu(
                self.spatial_linear_0(spatial_edges))))       # (rows, A, 256)
        if net.use_hr_attn:
            weighted, _ = self.attn(robot_states.reshape(rows, 1, 256),
                                    out_sp, attn_mask)
        else:
            weighted = out_sp.mean(dim=1, keepdim=True)
        weighted = weighted.reshape(T, N, 1, 256)

        outputs, h_new = self.humanNodeRNN(
            robot_states, weighted, rnn_hxs["human_node_rnn"], masks)
        x = outputs[:, :, 0, :]
        hidden_critic = torch.tanh(self.critic_1(torch.tanh(self.critic_0(x))))
        hidden_actor = torch.tanh(self.actor_1(torch.tanh(self.actor_0(x))))
        value = self.critic_linear(hidden_critic)
        return value, hidden_actor, {"human_node_rnn": h_new}


def init_hidden(cfg: Config, n_envs: int, device):
    """Fresh recurrent state (``policy_net.py:322-333``): the node GRU's
    (N, 1, 128), and for DS-RNN (``robot.policy == "srnn"``) its edge GRUs'
    (N, A + 1, 256) in ``human_human_edge_rnn``. The flagship never reads
    that slot (the JAX package re-zeroes it every call), so it has none."""
    net = cfg.network
    hidden = {"human_node_rnn": torch.zeros(
        (n_envs, 1, net.human_node_rnn_size), device=device)}
    if cfg.robot.policy == "srnn":
        hidden["human_human_edge_rnn"] = torch.zeros(
            (n_envs, cfg.sim.max_human_num + 1, net.human_human_edge_rnn_size),
            device=device)
    return hidden


def obs_to_dict(obs) -> Dict[str, torch.Tensor]:
    """Observation dataclass -> network input dict (no copies)."""
    return {
        "robot_node": obs.robot_node,
        "temporal_edges": obs.temporal_edges,
        "spatial_edges": obs.spatial_edges,
        "visible_masks": obs.visible_masks,
        "detected_human_num": obs.detected_human_num,
    }
