"""Time K1, K2 and K3 of a checkout of the port on the card, and optionally
a flagship train iteration.

  python tools/time_attention_kernels.py [--root DIR] [--train-iters N]

``--root`` is the directory that holds the ``crowdnav_prediction_attngraph_tpu_torch``
package to time (default: this repo), so two versions of the kernels (an
unpacked ``git archive`` of another commit, and this tree) can be timed in
turns within one run on one card, one process each. The inputs are made from
a seed, as in ``chip_smoke.py`` (K3's from seed 0 with numpy, as the edges/s
bench makes them: f32 at the bench's rows 4096 x A 20 and at 960 x 50);
K1's and K2's also at D = 100 with 4 heads (head dim 25).
Each time is the median over 5 groups of
back-to-back calls, each group between one pair of CUDA events, divided by
its call count. ``--train-iters N`` also times N flagship ``train_iteration``s
after one warm-up (host clock around a synchronise; same recipe and
warm start as ``chip_smoke.py``). Prints one JSON object. Runs on ``cuda``
only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, HEADS = 512, 8
K1_SHAPES = ((32, 20), (64, 20), (960, 20), (960, 50))
K2_SHAPES = ((960, 20), (960, 50))
K3_SHAPES = ((4096, 20), (960, 50))
# K1 and K2 at a head dim the tensor-core attention does not take (25):
# (rows, A, D, heads)
ODD_HEAD_DIM = (960, 20, 100, 4)


def time_ms(fn, reps: int, groups: int = 5) -> float:
    """Median over ``groups`` of the mean time of ``reps`` back-to-back
    calls between one pair of CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    per_call = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def inputs(rows: int, a: int, seed: int, device, d: int = D):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, a, d, generator=g)
    w_qkv = torch.randn(d, 3 * d, generator=g) / math.sqrt(d)
    b_qkv = torch.randn(3 * d, generator=g) * 0.01
    w_out = torch.randn(d, d, generator=g) / math.sqrt(d)
    b_out = torch.randn(d, generator=g) * 0.01
    det = torch.randint(1, a + 1, (rows,), generator=g)
    mask = torch.arange(a)[None, :] < det[:, None]
    gy = torch.randn(rows, a, d, generator=g)
    return [t.to(device) for t in (x, mask, w_qkv, b_qkv, w_out, b_out, gy)]


def time_train(iters: int, device) -> list:
    from crowdnav_prediction_attngraph_tpu_torch.algo import ppo
    from crowdnav_prediction_attngraph_tpu_torch.config import config_from_snapshot
    from crowdnav_prediction_attngraph_tpu_torch.models import policy as pmod
    from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import load_gst
    from crowdnav_prediction_attngraph_tpu_torch.test import (
        DEFAULT_GST_PARAMS, DEFAULT_PARAMS)
    cfg = config_from_snapshot(os.path.join(
        REPO, "trained_models", "GST_predictor_rand_tpu_r5_selfgst",
        "config.json"))
    gst = load_gst(cfg.pred, DEFAULT_GST_PARAMS, device)
    model = pmod.load_policy(cfg, DEFAULT_PARAMS, device)
    ts = ppo.init_train_state(cfg, gst, device, model)
    ts, _ = ppo.train_iteration(cfg, ts, gst)          # warm-up
    seconds = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, _ = ppo.train_iteration(cfg, ts, gst)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--train-iters", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_attention_kernels: needs a card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from crowdnav_prediction_attngraph_tpu_torch.ops import bench_edges
    from crowdnav_prediction_attngraph_tpu_torch.ops.masked_attention import (
        fused_graph_attention, fused_graph_attention_backward,
        packed_masked_attention)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0), "k1": {}, "k2": {},
           "k3": {}}
    for rows, a in K3_SHAPES:
        q, k, v, mask = bench_edges._inputs(rows, a, D, device)
        res["k3"][f"f32_{rows}x{a}"] = time_ms(
            lambda: packed_masked_attention(q, k, v, mask, HEADS), reps=30)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for rows, a in K1_SHAPES:
            x, mask, w_qkv, b_qkv, w_out, b_out, _ = inputs(rows, a, rows, device)
            res["k1"][f"{tag}_{rows}x{a}"] = time_ms(
                lambda: fused_graph_attention(x, mask, w_qkv, b_qkv, w_out,
                                              b_out, HEADS, dtype),
                reps=50 if rows < 960 else 10)
        for rows, a in K2_SHAPES:
            x, mask, w_qkv, b_qkv, w_out, _, gy = inputs(rows, a, rows, device)
            res["k2"][f"{tag}_{rows}x{a}"] = time_ms(
                lambda: fused_graph_attention_backward(
                    x, mask, w_qkv, b_qkv, w_out, gy, HEADS, dtype), reps=10)
        rows, a, d, heads = ODD_HEAD_DIM
        x, mask, w_qkv, b_qkv, w_out, b_out, gy = inputs(rows, a, rows, device,
                                                         d)
        tag_d = f"{tag}_{rows}x{a}_d{d}_h{heads}"
        res["k1"][tag_d] = time_ms(
            lambda: fused_graph_attention(x, mask, w_qkv, b_qkv, w_out, b_out,
                                          heads, dtype), reps=10)
        res["k2"][tag_d] = time_ms(
            lambda: fused_graph_attention_backward(
                x, mask, w_qkv, b_qkv, w_out, gy, heads, dtype), reps=10)
    if args.train_iters:
        res["train_iteration_seconds"] = time_train(args.train_iters, device)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
