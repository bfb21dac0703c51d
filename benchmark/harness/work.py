"""The work the port's calls need, from their shapes: the K1 and K2 bounds
and the model's FLOPs, against the H100's published peaks.

The bound arithmetic is a copy of ``chip_smoke.py``'s ``bound_ms``,
``k1_bound_ms`` and ``k2_bound_ms``, kept here so that a change to the
program cannot move the yardstick. The model FLOPs count the products of
the policy's forward for one row (one env at one step), and of the GST's
forward for one env, from the configuration's widths; the update's rows
count three times (forward and backward), recomputation not at all. Each
policy base's count is a file of its own, ``flops/<robot.policy>.py``,
found by that name.
"""

from __future__ import annotations

from . import spec

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


def dense(n_in: int, n_out: int) -> int:
    """The FLOPs of one row through a dense layer (in, out)."""
    return 2 * n_in * n_out


def policy_row_flops(snapshot: dict, root: str = spec.ROOT) -> int:
    """The policy's forward for one env at one step, counted for the base
    that ``robot.policy`` names by ``flops/<robot.policy>.py``'s
    ``row_flops``; a base without such a file stops the run."""
    policy = snapshot["robot"]["policy"]
    return int(spec.load_module("flops", policy, root).row_flops(snapshot))


def gst_env_flops(snapshot: dict) -> int:
    """The GST's forward for one env (the full-connectivity spatial encoder
    over A humans at each of the obs_len observed and pred_len - 1 fed-back
    steps, the LSTM at each, the Gaussian head at each of pred_len); 0
    where the configuration runs no GST (``predict_method`` other than
    ``inferred``)."""
    p, sim = snapshot["pred"], snapshot["sim"]
    if sim["predict_method"] != "inferred":
        return 0
    a = sim["human_num"] + sim.get("human_num_range", 0)
    e, ff, hid = p["embedding_size"], p["dim_feedforward"], \
        p["lstm_hidden_size"]
    layer = (dense(e, 3 * e) + dense(e, e) + dense(e, ff) + dense(ff, e)
             + 2 * 2 * a * e)                                 # per node
    spatial = dense(p["motion_dim"], e) + p["spatial_num_layers"] * layer
    lstm = dense(e, 4 * hid) + dense(hid, 4 * hid)
    times = p["obs_seq_len"] + p["pred_seq_len"] - 1
    return a * (times * (spatial + lstm)
                + p["pred_seq_len"] * dense(hid, p["output_dim"]))
