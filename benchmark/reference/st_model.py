"""Gumbel Social Transformer trajectory predictor of the reference.

A frozen copy of the port's ``models/gst/st_model.py``: every product's
operands pass through ``precision.rnd`` at the precision the configuration
states (``matmul_dtype``), so the reference computes in float32 and the
control one step below; the initializers are left out (the weights are a
``.npz`` export).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import PredConfig
from .precision import Linear, rnd

FLAX_LN_EPS = 1e-6   # flax LayerNorm's default epsilon (torch's is 1e-5)


def _cd(matmul_dtype: str) -> str:
    """The precision the configuration states for the GST's products."""
    return "bf16" if matmul_dtype == "bf16" else "f32"


def _r(t, cd):
    """A product's operand at the precision in force (``precision.rnd``)."""
    return rnd(t, cd)


def _dense(layer: nn.Linear, x, cd):
    """A Dense whose product is stated in ``cd``."""
    return F.linear(_r(x, cd), _r(layer.weight, cd), layer.bias)


def masked_renorm_attention(q, k, v, float_mask, num_heads: int,
                            cd="f32"):
    """Multi-head attention with the float mask applied AFTER the softmax and
    the weights renormalised (+1e-10) (``st_model.py:40-60``).
    q (B, L, D); k/v (B, S, D); float_mask (B, L, S). Returns
    out (B, L, H, hd)."""
    B, L, D = q.shape
    hd = D // num_heads
    qh = _r(q.reshape(B, L, num_heads, hd), cd)
    kh = _r(k.reshape(B, k.shape[1], num_heads, hd), cd)
    vh = _r(v.reshape(B, v.shape[1], num_heads, hd), cd)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
    w = torch.softmax(logits, dim=-1)
    w = w * float_mask[:, None, :, :]
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-10)
    return torch.einsum("bhqk,bkhd->bqhd", _r(w, cd), vh)


def _in_proj(x, kv, w, b, cd="f32"):
    """The packed MHA input projection: q from ``x``, k and v from ``kv``."""
    D = x.shape[-1]
    w_c = _r(w, cd)
    x_c, kv_c = _r(x, cd), _r(kv, cd)
    return (x_c @ w_c[:, :D] + b[:D], kv_c @ w_c[:, D:2 * D] + b[D:2 * D],
            kv_c @ w_c[:, 2 * D:] + b[2 * D:])


class NodeEncoderLayer(nn.Module):
    """Pre-norm masked MHA + FFN; the residual goes around the attention from
    the normed input (``st_model.py:72-120``). With ``ghost`` a zero
    "attend-to-nothing" row joins the keys and values (:97-98)."""

    def __init__(self, d_model: int = 64, nhead: int = 8,
                 dim_feedforward: int = 128, ghost: bool = False,
                 matmul_dtype: str = "f32"):
        super().__init__()
        D = d_model
        self.nhead = nhead
        self.ghost = ghost
        self.cd = _cd(matmul_dtype)
        self.norm_node = nn.LayerNorm(D, eps=FLAX_LN_EPS)
        self.in_proj_weight = nn.Parameter(torch.zeros(D, 3 * D))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * D))
        self.out_proj = Linear(D, D)
        self.norm1_node = nn.LayerNorm(D, eps=FLAX_LN_EPS)
        self.linear1 = Linear(D, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, D)

    def forward(self, x, adj, attn_mask):
        """x (B, A, D); adj (B, A, A[+1]) float, [target, neighbour], the
        attention's mask; attn_mask (B, A, A) the pedestrians' validity. With
        full connectivity both are the same tensor."""
        B, A, D = x.shape
        cd = self.cd
        ped_mask = (attn_mask.sum(dim=-1) > 0).to(x.dtype)[..., None]
        h = self.norm_node(x) * ped_mask
        kv = torch.cat([h, h.new_zeros(B, 1, D)], dim=1) if self.ghost else h
        q, k, v = _in_proj(h, kv, self.in_proj_weight, self.in_proj_bias, cd)
        out_h = masked_renorm_attention(q, k, v, adj, self.nhead, cd)
        x = h + _dense(self.out_proj, out_h.reshape(B, A, D), cd)
        h2 = self.norm1_node(x)
        h2 = F.relu(_dense(self.linear1, h2, cd))
        h2 = _dense(self.linear2, h2, cd)
        return x + h2


def gumbel_softmax(u, logits, tau: float, hard: bool, eps: float = 1e-10):
    """Straight-through Gumbel softmax (``st_model.py:123-132``) on uniforms
    ``u`` of the logits' shape. The hard form is the one-hot of the first
    maximum, with the soft sample's gradient."""
    g = -torch.log(eps - torch.log(u + eps))
    y_soft = torch.softmax((logits + g) / tau, dim=-1)
    if not hard:
        return y_soft
    y_hard = F.one_hot(y_soft.argmax(dim=-1), logits.shape[-1]).to(y_soft.dtype)
    return y_hard + y_soft - y_soft.detach()


class EdgeSelector(nn.Module):
    """Sparse-edge sampler (``st_model.py:135-198``; ghost adds an
    always-available zero neighbour so a target may attend to nothing). The
    unused ``out_proj`` is kept so that the parameter trees match (the JAX
    package creates it, :185-187). Runs in f32."""

    def __init__(self, d_motion: int = 2, d_model: int = 64, nhead: int = 4,
                 ghost: bool = False):
        super().__init__()
        D, hd = d_model, d_model // nhead
        self.nhead = nhead
        self.ghost = ghost
        self.augmented_edge_embedding = Linear(3 * d_motion, D)
        self.norm_augmented_edge = nn.LayerNorm(D, eps=FLAX_LN_EPS)
        self.in_proj_weight = nn.Parameter(torch.zeros(D, 3 * D))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * D))
        self.out_proj = Linear(D, D)
        self.linear1 = Linear(hd, hd)
        self.linear2 = Linear(hd, 1)

    def forward(self, x, A, attn_mask, tau: float, hard: bool, u):
        """x (B, N, d); A (B, N, N, d) relative positions; attn_mask
        (B, N, N) [target, neighbour]; u (B, N, nhead, N[+1]) uniforms.
        Returns (multinomial, sampled), each (B, N, nhead, N[+1])."""
        B, nnode, d_motion = x.shape
        nh = self.nhead
        ped_mask = (attn_mask.sum(dim=-1) > 0).to(x.dtype)[..., None]
        x = x * ped_mask
        Am = A * attn_mask.transpose(1, 2)[..., None]
        x_aug = x
        if self.ghost:
            x_aug = torch.cat([x, x.new_zeros(B, 1, d_motion)], dim=1)
            Am = torch.cat([Am, Am.new_zeros(B, 1, nnode, d_motion)], dim=1)
            attn_mask = torch.cat(
                [attn_mask, attn_mask.new_ones(B, nnode, 1)], dim=2)
        n_nbr = x_aug.shape[1]
        x_nbr = x_aug[:, :, None, :].expand(B, n_nbr, nnode, d_motion)
        x_tgt = x[:, None, :, :].expand(B, n_nbr, nnode, d_motion)
        aug = self.augmented_edge_embedding(torch.cat([x_nbr, x_tgt, Am], -1))
        aug = self.norm_augmented_edge(aug)
        D = aug.shape[-1]
        rows = aug.transpose(1, 2).reshape(B * nnode, n_nbr, D)
        q, k, v = _in_proj(rows, rows, self.in_proj_weight, self.in_proj_bias)
        nbr_mask = (attn_mask[:, :, :, None] * attn_mask[:, :, None, :]) \
            .reshape(B * nnode, n_nbr, n_nbr)
        heads = masked_renorm_attention(q, k, v, nbr_mask, nh)
        heads = heads.reshape(B, nnode, n_nbr, nh, D // nh).transpose(2, 3)
        logit = self.linear2(F.relu(self.linear1(heads)))[..., 0]
        multinomial = torch.softmax(logit, dim=-1) * attn_mask[:, :, None, :]
        multinomial = multinomial / (multinomial.sum(dim=-1, keepdim=True)
                                     + 1e-10)
        sampled = gumbel_softmax(u, torch.log(multinomial + 1e-10), tau, hard)
        return multinomial, sampled


class GumbelSocialTransformer(nn.Module):
    """Spatial encoder (``st_model.py:201-234``): the edge selector's
    sampled adjacency, or full connectivity (``spatial_num_heads_edges=0``),
    then the node encoder layers."""

    def __init__(self, cfg: PredConfig):
        super().__init__()
        if cfg.ghost and cfg.spatial_num_heads_edges == 0:
            # gumbel_social_transformer.py:10-11
            raise ValueError("Full connectivity conflicts with ghost mode")
        self.num_layers = cfg.spatial_num_layers
        if cfg.spatial_num_heads_edges:
            self.edge_selector = EdgeSelector(
                cfg.motion_dim, cfg.embedding_size,
                nhead=cfg.spatial_num_heads_edges, ghost=cfg.ghost)
        self.node_embedding = Linear(cfg.motion_dim, cfg.embedding_size)
        for i in range(cfg.spatial_num_layers):
            self.add_module(f"layer_{i}", NodeEncoderLayer(
                cfg.embedding_size, cfg.spatial_num_heads,
                cfg.dim_feedforward, ghost=cfg.ghost,
                matmul_dtype=cfg.matmul_dtype))

    def forward(self, x, attn_mask, A, tau: float, hard: bool, u):
        """x (B, N, d); attn_mask (B, N, N) [target, neighbour]; A
        (B, N, N, d) relative positions, ``tau``, ``hard`` and the uniforms
        u (:func:`draw_noise`) are read only by the edge selector."""
        if hasattr(self, "edge_selector"):
            _, sampled = self.edge_selector(x, A, attn_mask, tau, hard, u)
            adj = sampled.sum(dim=2)                   # (B, tgt, nbr[+ghost])
        else:
            adj = attn_mask     # full connectivity (gumbel_social_transformer.py:83-86)
        h = self.node_embedding(x)
        for i in range(self.num_layers):
            h = getattr(self, f"layer_{i}")(h, adj, attn_mask)
        return h


def lstm_step(w_ih, w_hh, b_ih, b_hh, x, h, c, cd="f32"):
    """torch nn.LSTM cell semantics, gate order [i, f, g, o]
    (``st_model.py:237-250``)."""
    gates = (_r(x, cd) @ _r(w_ih, cd) + b_ih) + (_r(h, cd) @ _r(w_hh, cd) + b_hh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def draw_noise(cfg: PredConfig, B: int, A: int, sampling: bool,
               generator: Optional[torch.Generator], device
               ) -> Dict[str, torch.Tensor]:
    """The random numbers of one STModel call, drawn from ``generator`` (on
    ``device``; a fresh generator seeded 0 when None, as the JAX model
    defaults to ``key(0)``): the edge selector's Gumbel uniforms
    ``gumbel_obs`` (B * obs_len, A, heads, A[+1]) and ``gumbel_dec``
    (pred_len - 1, B, A, heads, A[+1]), and with ``sampling`` the decoder's
    standard normals ``normal_first`` (B, 1, A, 2) and ``normal_dec``
    (pred_len - 1, B, 1, A, 2)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    noise = {}
    K1 = cfg.pred_seq_len - 1
    if cfg.spatial_num_heads_edges:
        shape = (A, cfg.spatial_num_heads_edges, A + int(cfg.ghost))
        noise["gumbel_obs"] = torch.rand((B * cfg.obs_seq_len,) + shape,
                                         generator=generator, device=device)
        noise["gumbel_dec"] = torch.rand((K1, B) + shape, generator=generator,
                                         device=device)
    if sampling:
        noise["normal_first"] = torch.randn((B, 1, A, 2), generator=generator,
                                            device=device)
        noise["normal_dec"] = torch.randn((K1, B, 1, A, 2),
                                          generator=generator, device=device)
    return noise


class STModel(nn.Module):
    """Spatial -> temporal -> recursive Gaussian decoder
    (``st_model.py:252-382``)."""

    def __init__(self, cfg: PredConfig):
        super().__init__()
        self.cfg = cfg
        H, E = cfg.lstm_hidden_size, cfg.embedding_size
        self.gst = GumbelSocialTransformer(cfg)
        self.lstm_w_ih = nn.Parameter(torch.zeros(E, 4 * H))
        self.lstm_w_hh = nn.Parameter(torch.zeros(H, 4 * H))
        self.lstm_b_ih = nn.Parameter(torch.zeros(4 * H))
        self.lstm_b_hh = nn.Parameter(torch.zeros(4 * H))
        self.hidden2pos = Linear(H, cfg.output_dim)

    def _lstm(self, x, h, c):
        return lstm_step(self.lstm_w_ih, self.lstm_w_hh, self.lstm_b_ih,
                         self.lstm_b_hh, x, h, c, _cd(self.cfg.matmul_dtype))

    def forward(self, x, attn_mask, loss_mask_rel, A_edges=None,
                tau: Optional[float] = None, hard: bool = True,
                sampling: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None):
        """x (B, obs_len, A, 2) displacements; attn_mask (B, obs_len, A, A)
        float in [neighbor, target] orientation; loss_mask_rel
        (B, A, obs_len + pred_len); A_edges (B, obs_len, A, A, 2) relative
        positions (i - j), read only by the edge selector. ``tau``
        (default ``cfg.tau``) and ``hard`` shape the Gumbel sample;
        ``sampling`` feeds the decoder draws from the predicted Gaussians
        instead of their means. Randomness: ``noise`` (see
        :func:`draw_noise`) or draws from ``generator``.

        Returns ((mu, sx, sy, corr), x_sample_pred), each (B, pred_len, A, .)."""
        cfg = self.cfg
        B, obs_len, A, _ = x.shape
        H = cfg.lstm_hidden_size
        tau = cfg.tau if tau is None else tau
        if not cfg.spatial_num_heads_edges:
            A_edges = None              # full connectivity reads no edges
        elif A_edges is None:
            raise ValueError("the edge selector needs A_edges")
        if noise is None:
            noise = draw_noise(cfg, B, A, sampling, generator, x.device)
        u_dec = noise.get("gumbel_dec")

        # observation period: spatial (st_model.py:290-297)
        am = attn_mask.transpose(2, 3).reshape(B * obs_len, A, A)
        A_flat = None if A_edges is None else \
            A_edges.reshape(B * obs_len, A, A, -1)
        xs = self.gst(x.reshape(B * obs_len, A, -1), am, A_flat, tau, hard,
                      noise.get("gumbel_obs"))
        xs = xs.reshape(B, obs_len, A, -1)

        # temporal (faster_lstm, :299-315)
        xs = xs * loss_mask_rel[:, :, :obs_len].transpose(1, 2)[..., None]
        ht = x.new_zeros(B * A, H)
        ct = x.new_zeros(B * A, H)
        for t in range(obs_len):
            ht, ct = self._lstm(xs[:, t].reshape(B * A, -1), ht, ct)

        # pedestrians valid for prediction (:317-327)
        if cfg.only_observe_full_period:
            lm_fp = (loss_mask_rel.sum(dim=2) ==
                     loss_mask_rel.shape[2]).to(x.dtype)
        else:
            lm_fp = loss_mask_rel[:, :, obs_len - 1]               # (B, A)
        lm = lm_fp.reshape(B * A, 1)
        ht, ct = ht * lm, ct * lm
        attn_mask_pred = (lm_fp[:, :, None] * lm_fp[:, None, :]).transpose(1, 2)
        lm_x = lm_fp[:, None, :, None]

        # recursive decoder (:329-371)
        def gaussian(h):
            raw = self.hidden2pos(h).reshape(B, 1, A, -1)
            return (raw[..., :2], torch.exp(raw[..., 2:3]),
                    torch.exp(raw[..., 3:4]), torch.tanh(raw[..., 4:5]))

        def draw(u, mu, sx, sy, corr):
            if not sampling:
                return mu
            ux, uy = u[..., 0:1], u[..., 1:2]
            s_y = corr * sy * ux + torch.sqrt(1.0 - corr ** 2) * sy * uy
            return torch.cat([sx * ux, s_y], dim=-1) + mu

        g = gaussian(ht)
        x_s = draw(noise.get("normal_first"), *g) * lm_x          # (B, 1, A, 2)
        out = [g + (x_s,)]
        A_s = None
        if A_edges is not None:
            A_s = A_edges[:, -1:] + (x_s[:, :, :, None, :]
                                     - x_s[:, :, None, :, :])
        for t in range(cfg.pred_seq_len - 1):
            xs_tt = self.gst(
                x_s.reshape(B, A, -1), attn_mask_pred,
                None if A_s is None else A_s.reshape(B, A, A, -1), tau, hard,
                None if u_dec is None else u_dec[t])
            h_new, c_new = self._lstm(xs_tt.reshape(B * A, -1) * lm, ht, ct)
            ht = h_new * lm + ht * (1.0 - lm)
            ct = c_new * lm + ct * (1.0 - lm)
            g = gaussian(ht)
            x_s = draw(None if not sampling else noise["normal_dec"][t],
                       *g) * lm_x
            if A_s is not None:
                A_s = A_s + (x_s[:, :, :, None, :] - x_s[:, :, None, :, :])
            out.append(g + (x_s,))
        mu, sx, sy, corr, x_sample = (torch.cat(v, dim=1) for v in zip(*out))
        return (mu, sx, sy, corr), x_sample
