"""The work the port's calls need, from their shapes: the K1 and K2 bounds
and the model's FLOPs, against the H100's published peaks.

The bound arithmetic is a copy of ``chip_smoke.py``'s ``bound_ms``,
``k1_bound_ms`` and ``k2_bound_ms``, kept here so that a change to the
program cannot move the yardstick. The model FLOPs count the products of
the policy's forward for one row (one env at one step), and of the GST's
forward for one env, from the configuration's widths; the update's rows
count three times (forward and backward), recomputation not at all.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 and float32 outside the tensor
# cores; HBM3 bandwidth
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
MFU_PEAK = PEAK_FLOPS["bf16"]


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the peak rate for the compute type."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def k1_work(rows: int, a: int, d: int) -> tuple:
    """K1's (FLOPs, bytes): each input read once, the output written once;
    the QKV projection, QK^T and PV, and the output projection."""
    tokens = rows * a
    flops = 2 * tokens * d * 3 * d + 2 * 2 * rows * a * a * d \
        + 2 * tokens * d * d
    nbytes = (4 * tokens * d + tokens
              + 4 * (d * 3 * d + 3 * d + d * d + d)
              + 4 * tokens * d)
    return flops, nbytes


def k2_work(rows: int, a: int, d: int) -> tuple:
    """K2's (FLOPs, bytes): x, g, the mask and the weights read once, dx and
    the four weight gradients written once; 22 T D^2 FLOP of projections
    and 12 rows A^2 D of attention."""
    tokens = rows * a
    flops = 22 * tokens * d * d + 12 * rows * a * a * d
    nbytes = (4 * 2 * tokens * d + tokens + 4 * (d * 3 * d + 3 * d + d * d)
              + 4 * tokens * d + 4 * (d * 3 * d + 3 * d + d * d + d))
    return flops, nbytes


def k1_bound_s(rows: int, a: int, d: int, dtype: str) -> float:
    return bound_s(*k1_work(rows, a, d), dtype)


def k2_bound_s(rows: int, a: int, d: int, dtype: str) -> float:
    return bound_s(*k2_work(rows, a, d), dtype)


def _dense(n_in: int, n_out: int) -> int:
    return 2 * n_in * n_out


def policy_row_flops(snapshot: dict) -> int:
    """The policy's forward for one env at one step (the attention-graph
    network): every dense layer, the human-human attention with the q/k/v
    projections folded into one (D, 3D) product as the kernel runs it, the
    robot-human attention, the GRU, the heads."""
    net, sim = snapshot["network"], snapshot["sim"]
    a = sim["human_num"] + sim.get("human_num_range", 0)
    e = 2 if sim["predict_method"] == "none" else 2 * (sim["predict_steps"] + 1)
    d, h = net["attn_size"], net["human_node_rnn_size"]
    out, emb = net["human_node_output_size"], net["human_node_embedding_size"]
    f = _dense(2 + 7, 256)                                    # robot_linear
    if net["use_self_attn"]:
        f += a * (_dense(e, 128) + _dense(128, d))            # embed_0, _1
        f += a * (_dense(d, 3 * d) + _dense(d, d))            # qkv, out
        f += 2 * 2 * a * a * d                                # QK^T, PV
        f += a * _dense(d, 256)                               # spatial_linear
    else:
        f += a * (_dense(e, 128) + _dense(128, 256))
    if net["use_hr_attn"]:
        att = net["attention_size"]
        f += _dense(256, att) + a * _dense(256, att)          # edge layers
        f += 2 * a * att + 2 * a * 256                        # scores, sum
    f += 2 * _dense(256, emb)                                 # EndRNN embeds
    f += _dense(2 * emb, 3 * h) + _dense(h, 3 * h)            # GRU
    f += _dense(h, out)                                       # output_linear
    f += 4 * _dense(out, out) + _dense(out, 1)                # critic, actor
    f += _dense(out, 2)                                       # fc_mean
    return f


def gst_env_flops(snapshot: dict) -> int:
    """The GST's forward for one env (the full-connectivity spatial encoder
    over A humans at each of the obs_len observed and pred_len - 1 fed-back
    steps, the LSTM at each, the Gaussian head at each of pred_len)."""
    p, sim = snapshot["pred"], snapshot["sim"]
    a = sim["human_num"] + sim.get("human_num_range", 0)
    e, ff, hid = p["embedding_size"], p["dim_feedforward"], \
        p["lstm_hidden_size"]
    layer = (_dense(e, 3 * e) + _dense(e, e) + _dense(e, ff) + _dense(ff, e)
             + 2 * 2 * a * e)                                 # per node
    spatial = _dense(p["motion_dim"], e) + p["spatial_num_layers"] * layer
    lstm = _dense(e, 4 * hid) + _dense(hid, 4 * hid)
    times = p["obs_seq_len"] + p["pred_seq_len"] - 1
    return a * (times * (spatial + lstm)
                + p["pred_seq_len"] * _dense(hid, p["output_dim"]))
