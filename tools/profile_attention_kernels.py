"""Device time of each CUDA kernel behind one K1 or K2 call, on the card.

  python tools/profile_attention_kernels.py [--calls 10]

For K1 (``fused_graph_attention``) and K2 (``fused_graph_attention_backward``)
in bf16 at the paths' shapes (rows 32 and 960, A = 20) and at 960 x 50 and
960 x 80, runs ``--calls`` back-to-back calls under ``torch.profiler`` after
a warm-up and prints one JSON object: for each call, its device kernels in
launch order with their mean device time in microseconds, and their sum.
Inputs are made from a seed as in ``chip_smoke.py``. Runs on ``cuda`` only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from crowdnav_prediction_attngraph_tpu_torch.ops.masked_attention import (  # noqa: E402
    fused_graph_attention, fused_graph_attention_backward)

D, HEADS = 512, 8
SHAPES = ((32, 20), (960, 20), (960, 50), (960, 80))


def inputs(rows: int, a: int, device):
    g = torch.Generator().manual_seed(rows + a)
    x = torch.randn(rows, a, D, generator=g)
    w_qkv = torch.randn(D, 3 * D, generator=g) / math.sqrt(D)
    b_qkv = torch.randn(3 * D, generator=g) * 0.01
    w_out = torch.randn(D, D, generator=g) / math.sqrt(D)
    b_out = torch.randn(D, generator=g) * 0.01
    det = torch.randint(1, a + 1, (rows,), generator=g)
    mask = torch.arange(a)[None, :] < det[:, None]
    gy = torch.randn(rows, a, D, generator=g)
    return [t.to(device) for t in (x, mask, w_qkv, b_qkv, w_out, b_out, gy)]


def kernel_times(fn, calls: int) -> dict:
    """{kernel: mean device us per call} in order of first launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    totals = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            totals[e.name] = (totals.get(e.name, 0.0)
                              + e.time_range.elapsed_us())
    per_call = {k: v / calls for k, v in totals.items()}
    per_call["sum"] = sum(per_call.values())
    return per_call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_attention_kernels: needs a card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    bf16 = torch.bfloat16
    res = {"device": torch.cuda.get_device_name(0)}
    for rows, a in SHAPES:
        x, mask, w_qkv, b_qkv, w_out, b_out, gy = inputs(rows, a, device)
        res[f"K1_{rows}x{a}"] = kernel_times(
            lambda: fused_graph_attention(x, mask, w_qkv, b_qkv, w_out, b_out,
                                          HEADS, bf16), args.calls)
        if rows > 32:
            res[f"K2_{rows}x{a}"] = kernel_times(
                lambda: fused_graph_attention_backward(
                    x, mask, w_qkv, b_qkv, w_out, gy, HEADS, bf16), args.calls)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
