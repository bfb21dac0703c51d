"""Env-facing GST inference, batched over envs.

Port of the JAX package's ``models/gst/predictor.py:27-74`` (reference
gst_updated/scripts/wrapper/crowd_nav_interface_parallel.py:45-114): rolling
position/mask history -> displacement-graph inputs -> the recursive st_model
-> per-step displacement Gaussians accumulated into absolute-frame
predictions (mu cumsum, sigma^2 cumsum). The JAX version handles one env and
is vmapped; this one takes a leading env axis.

On CUDA inputs, without a caller-given ``noise``, :func:`gst_predict`
replays one CUDA graph of :func:`gst_forward` per model and input shape,
captured at the shape's first call: the same kernels in the same order on
the same dtypes, so eager's bits, with one launch in place of ~600. CPU
inputs, and calls given ``noise``, run :func:`gst_forward` op by op. The
counters ``gst.graph_captures``, ``gst.graph_replays`` and ``gst.eager``
(CUDA calls run op by op) count the calls (``utils/profiling``);
``gst.edge_rows`` counts, on every call, the edge selector's target rows
from the shapes (B x A x (obs_len + pred_len - 1); 0 with full
connectivity).
"""

from __future__ import annotations

import os
import weakref
from typing import Tuple

import torch

from ...config import PredConfig
from ...utils.device import resolve_device
from ...utils.params import params_tree, tree_to_state_dict
from ...utils.profiling import count
from ...utils.torch_import import load_gst_checkpoint
from .st_model import STModel, draw_noise

INVALID = -999.0


REFERENCE_CKPT = os.path.join("checkpoint", "epoch_100.pt")


def load_gst(cfg: PredConfig, params, device="cuda") -> STModel:
    """An STModel on ``device`` holding ``params``: a flax-style tree (with or
    without the top ``'params'`` level), the path of a ``.npz`` export, or
    one of the reference's torch checkpoints, as a ``.pt`` file or as the
    reference's results directory holding ``checkpoint/epoch_100.pt`` (JAX
    ``train.py::load_gst_params``)."""
    if isinstance(params, str):
        if os.path.isdir(params):
            params = os.path.join(params, REFERENCE_CKPT)
        if params.endswith(".pt"):
            params = load_gst_checkpoint(params, cfg.spatial_num_layers)
    model = STModel(cfg)
    model.load_state_dict(tree_to_state_dict(params_tree(params)), strict=True)
    return model.to(resolve_device(device)).eval()


@torch.no_grad()
def gst_predict(model: STModel, input_traj, input_mask, noise=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """input_traj (B, A, L, 2) absolute positions; input_mask (B, A, L) bool.
    With the edge selector (``spatial_num_heads_edges > 0``) the model reads
    the pairwise relative positions and the Gumbel uniforms ``noise``
    (``st_model.draw_noise``'s layout; default: drawn from a generator
    seeded 0).

    Returns (out_traj (B, A, K, 5) [mu_x, mu_y, sx, sy, corr] in the absolute
    frame, out_mask (B, A, 1) bool). CUDA inputs without ``noise`` replay
    the shape's CUDA graph (see the module's docstring); the returned
    tensors are the caller's own."""
    count("gst.edge_rows", edge_rows(model.cfg, *input_traj.shape[:2]))
    if not input_traj.is_cuda:
        return gst_forward(model, input_traj, input_mask, noise)
    if noise is not None:
        count("gst.eager")
        return gst_forward(model, input_traj, input_mask, noise)
    graphs = _GRAPHS.setdefault(model, {})
    key = (input_traj.shape, input_traj.dtype, input_mask.dtype,
           input_traj.device)
    g = graphs.get(key)
    if g is None or g.params != _param_ptrs(model):
        with torch.cuda.device(input_traj.device):
            g = graphs[key] = _Graph(model, input_traj, input_mask)
        count("gst.graph_captures")
    else:
        g.traj.copy_(input_traj)
        g.mask.copy_(input_mask)
        count("gst.graph_replays")
    g.graph.replay()
    # the next replay overwrites the graph's outputs
    return g.out[0].clone(), g.out[1].clone()


def edge_rows(cfg: PredConfig, B: int, A: int) -> int:
    """The edge selector's target rows in one call over B envs x A humans:
    one a pedestrian at each of the obs_len observed and pred_len - 1
    fed-back frames; 0 with full connectivity."""
    if not cfg.spatial_num_heads_edges:
        return 0
    return B * A * (cfg.obs_seq_len + cfg.pred_seq_len - 1)


def graph_noise(cfg: PredConfig, B: int, A: int, device):
    """The ``noise`` a graph is captured with: with the edge selector its
    Gumbel uniforms, drawn once as every call without ``noise`` draws them
    (from a generator seeded 0, so the same each call); otherwise none,
    and no generator is made."""
    if not cfg.spatial_num_heads_edges:
        return {}
    return draw_noise(cfg, B, A, False, None, device)


def _param_ptrs(model: STModel) -> tuple:
    return tuple(p.data_ptr() for p in model.parameters())


# {model: {(input shape, dtypes, device): _Graph}}; a model's graphs go
# with it
_GRAPHS: "weakref.WeakKeyDictionary[STModel, dict]" = \
    weakref.WeakKeyDictionary()


class _Graph:
    """:func:`gst_forward` captured for one input shape: the static inputs
    and noise it reads, the outputs it writes, and the addresses of the
    parameters it reads (a graph reads weights updated in place; replaced
    ones make :func:`gst_predict` capture again)."""

    def __init__(self, model: STModel, input_traj, input_mask):
        B, A = input_traj.shape[:2]
        self.params = _param_ptrs(model)
        self.traj, self.mask = input_traj.clone(), input_mask.clone()
        self.noise = graph_noise(model.cfg, B, A, input_traj.device)
        # one eager call on a side stream first: cuBLAS sets up lazily
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            gst_forward(model, self.traj, self.mask, self.noise)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = gst_forward(model, self.traj, self.mask, self.noise)


@torch.no_grad()
def gst_forward(model: STModel, input_traj, input_mask, noise=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gst_predict` op by op, on any device (the eager path)."""
    B, A, L, _ = input_traj.shape
    K = model.cfg.pred_seq_len
    m = input_mask.float()

    # relative-displacement validity (interface lines 77-78)
    lm_rel_obs = torch.cat([m[..., :1], m[..., :-1] * m[..., -1:]], dim=-1)
    lm_rel_pred = lm_rel_obs[..., -1:].expand(B, A, K)
    loss_mask_rel = torch.cat([lm_rel_obs, lm_rel_pred], dim=-1)

    # pairwise attention masks per timestep (lines 82-84)
    lm_t = lm_rel_obs.transpose(1, 2)                          # (B, L, A)
    attn_mask_obs = lm_t[..., :, None] * lm_t[..., None, :]   # (B, L, A, A)

    # displacements, invalid slots -> -999 (lines 86-89)
    disp = input_traj[:, :, 1:] - input_traj[:, :, :-1]
    disp = torch.cat([torch.zeros_like(input_traj[:, :, :1]), disp], dim=2)
    disp = torch.where(lm_rel_obs[..., None] > 0, disp,
                       torch.full_like(disp, INVALID))
    v_obs = disp.transpose(1, 2)                               # (B, L, A, 2)
    a_obs = None
    if model.cfg.spatial_num_heads_edges:
        # relative positions (i - j) per timestep (seq_to_graph, lines 9-21)
        pos_t = input_traj.transpose(1, 2)                     # (B, L, A, 2)
        a_obs = pos_t[:, :, :, None] - pos_t[:, :, None]       # (B, L, A, A, 2)

    (mu, sx, sy, corr), _ = model(v_obs, attn_mask_obs, loss_mask_rel,
                                  a_obs, noise=noise)

    # accumulate displacement Gaussians to the absolute frame (lines 98-111)
    mu_cum = torch.cumsum(mu, dim=1) + input_traj[:, None, :, -1]
    sx_cum = torch.sqrt(torch.cumsum(sx ** 2, dim=1))
    sy_cum = torch.sqrt(torch.cumsum(sy ** 2, dim=1))
    corr_cum = torch.cumsum(corr * sx * sy, dim=1) / (sx_cum * sy_cum)

    lm_pred = lm_rel_pred.transpose(1, 2)[..., None]           # (B, K, A, 1)
    mu_cum = mu_cum * lm_pred + INVALID * (1.0 - lm_pred)
    out = torch.cat([mu_cum, sx_cum, sy_cum, corr_cum], dim=-1)
    return out.transpose(1, 2), lm_rel_pred[..., :1] > 0
