"""The work of the GST's forward in one ``env/pretext.pretext_process``
call: its FLOPs, from the configuration's widths, split by the precision
each product runs in: the edge selector's (always float32), and the rest's
(the node encoder's and the LSTM's products in ``pred.matmul_dtype``; the
node embedding and the Gaussian head, which the port keeps in float32);
and the least bytes it moves (``pretext_bytes``).

Counted for B envs x A humans (A the most the configuration holds, the
slots the forward computes over), over the spatial encoder and the LSTM at
each of the obs_len observed and pred_len - 1 fed-back frames and the head
at each of pred_len. The edge selector scores every candidate edge of every
target: the A (A + 1 with the ghost node) neighbours' embedding, its
q / k / v projections, 4-headed attention over them, and the logit MLP per
head. The node encoder attends over A keys (A + 1 with the ghost). Products
only: softmax, LayerNorm, masks and the Gumbel sample are not counted.
"""

from __future__ import annotations

import os

import numpy as np


def dense(n_in: int, n_out: int) -> int:
    """The FLOPs of one row through a dense layer (in, out)."""
    return 2 * n_in * n_out


def frame_flops(p: dict, a: int) -> dict:
    """{"selector": ..., "encoder": ..., "embed": ...} of one env's graph of
    ``a`` humans at one frame."""
    e, d = p["embedding_size"], p["motion_dim"]
    m = a + int(bool(p.get("ghost")))          # neighbours, the ghost's too
    heads = p["spatial_num_heads_edges"]
    selector = 0
    if heads:
        hd = e // heads
        edges = a * m
        selector = (edges * dense(3 * d, e)             # edge embedding
                    + edges * 3 * dense(e, e)           # q, k, v
                    + 2 * 2 * a * m * m * e             # QK^T and PV
                    + edges * heads * (dense(hd, hd) + dense(hd, 1)))
    layer = (a * dense(e, e) + 2 * m * dense(e, e)      # q; k, v (ghost row)
             + 2 * 2 * a * m * e                        # QK^T and PV
             + a * (dense(e, e) + dense(e, p["dim_feedforward"])
                    + dense(p["dim_feedforward"], e)))
    encoder = p["spatial_num_layers"] * layer
    return {"selector": selector, "encoder": encoder,
            "embed": a * dense(d, e)}


def pretext_flops(snapshot: dict) -> dict:
    """{dtype: FLOPs} of the GST's forward in one pretext call over every
    env of the configuration: ``"f32"`` the selector's, the node
    embedding's and the head's, and ``pred.matmul_dtype`` the node
    encoder's and the LSTM's (the two add where that is ``"f32"``); {} where
    the configuration runs no GST."""
    p, sim = snapshot["pred"], snapshot["sim"]
    if sim["predict_method"] != "inferred":
        return {}
    b = snapshot["ppo"]["num_processes"]
    a = sim["human_num"] + sim.get("human_num_range", 0)
    hid = p["lstm_hidden_size"]
    frames = p["obs_seq_len"] + p["pred_seq_len"] - 1
    f = frame_flops(p, a)
    lstm = a * (dense(p["embedding_size"], 4 * hid) + dense(hid, 4 * hid))
    head = a * dense(hid, p["output_dim"])
    out = {"f32": b * (frames * (f["selector"] + f["embed"])
                       + p["pred_seq_len"] * head)}
    low = b * frames * (f["encoder"] + lstm)
    cd = p.get("matmul_dtype", "f32")
    out[cd] = out.get(cd, 0) + low
    return out


def pretext_bytes(snapshot: dict, root: str) -> int:
    """The bytes the GST's forward in one pretext call cannot avoid moving
    over every env of the configuration: its inputs (the float32 history
    (B, A, obs_len, 2) and its bool mask; with the edge selector, the
    float32 Gumbel uniforms of its obs_len + pred_len - 1 frames, B x A x
    heads x (A + 1 with the ghost) each), its weights (the configuration's
    ``gst_weights`` file under ``root``, as stored) and its outputs (the
    float32 (B, A, pred_len, 5) Gaussians and the (B, A, 1) bool mask);
    none of its intermediates. 0 where the configuration runs no GST."""
    p, sim = snapshot["pred"], snapshot["sim"]
    if sim["predict_method"] != "inferred":
        return 0
    b = snapshot["ppo"]["num_processes"]
    a = sim["human_num"] + sim.get("human_num_range", 0)
    heads = p["spatial_num_heads_edges"]
    m = a + int(bool(p.get("ghost")))
    frames = p["obs_seq_len"] + p["pred_seq_len"] - 1
    inputs = b * a * p["obs_seq_len"] * (2 * 4 + 1)
    uniforms = 4 * b * frames * a * heads * m if heads else 0
    with np.load(os.path.join(root,
                              snapshot["benchmark"]["gst_weights"])) as w:
        weights = sum(w[k].nbytes for k in w.files)
    outputs = b * a * (p["pred_seq_len"] * p["output_dim"] * 4 + 1)
    return inputs + uniforms + weights + outputs
