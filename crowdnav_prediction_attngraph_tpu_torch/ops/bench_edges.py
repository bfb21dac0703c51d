"""edges/s benchmark of the interaction-graph attention (JAX package
``ops/bench_edges.py``, its single-device parts).

  python -m crowdnav_prediction_attngraph_tpu_torch.ops.bench_edges          # edges/s
  python -m crowdnav_prediction_attngraph_tpu_torch.ops.bench_edges --sweep  # K1 vs plain

``single_device`` measures edges/s (rows x A^2 per second) of the packed
masked attention over precomputed q, k, v: its plain version ("einsum") and
the K3 kernel ("kernel"). ``fused_sweep`` times the fused graph attention
(K1, bf16: "kernel_ms") against its plain version in f32 ("einsum_ms", the
JAX package's yardstick, its XLA reference) at three row counts. The inputs are
made with numpy from seed 0, as in the JAX package, so both packages time
the same numbers. Runs on ``cuda`` unless ``--device cpu`` is given; a
kernel that fails ends the run (there is no fallback). The JAX package's
``--weak-scaling`` and ``--weak-scaling-train`` wait for the port's
``parallel/``; its ``strip_rows`` sweep axis exists only on the TPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..utils.device import resolve_device
from .masked_attention import (fused_graph_attention,
                               packed_masked_attention,
                               reference_fused_graph_attention,
                               reference_masked_attention)

# timed calls per measurement (each after one warm-up call) and the sweep's
# row counts, as in the JAX package
ITERS = 20
SWEEP_ROWS = (480, 1920, 7680)


def _inputs(rows, A, D, device, seed=0):
    rng = np.random.RandomState(seed)

    def mk():
        return torch.from_numpy(rng.randn(rows, A, D).astype(np.float32)).to(
            device)
    det = rng.randint(1, A + 1, rows)
    mask = torch.from_numpy(np.arange(A)[None, :] < det[:, None]).to(device)
    return mk(), mk(), mk(), mask


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(f, args, device, iters=ITERS):
    """Seconds per call: one warm-up call, then ``iters`` calls between two
    synchronisations."""
    f(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        f(*args)
    _sync(device)
    return (time.perf_counter() - t0) / iters


@torch.no_grad()
def single_device(rows=4096, A=20, D=512, H=8, device="cuda"):
    """edges/s of the plain version ("einsum") and of K3 ("kernel")."""
    device = resolve_device(device)
    q, k, v, mask = _inputs(rows, A, D, device)
    edges = rows * A * A
    return {
        "einsum": edges / _time(lambda *a: reference_masked_attention(*a, H),
                                (q, k, v, mask), device),
        "kernel": edges / _time(lambda *a: packed_masked_attention(*a, H),
                                (q, k, v, mask), device),
    }


def sweep_inputs(rows_list=SWEEP_ROWS, A=20, D=512, device="cuda"):
    """``fused_sweep``'s inputs, made with numpy from seed 0 in the JAX
    package's order: yields (rows, (x, mask, w_qkv, b_qkv, w_out, b_out))."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)
    weights = (t(rng.randn(D, 3 * D) / np.sqrt(D)), t(rng.randn(3 * D) * 0.01),
               t(rng.randn(D, D) / np.sqrt(D)), t(rng.randn(D) * 0.01))
    for rows in rows_list:
        x = t(rng.randn(rows, A, D) * 0.3)
        det = rng.randint(1, A + 1, rows)
        mask = torch.from_numpy(np.arange(A)[None, :] < det[:, None]).to(
            device)
        yield rows, (x, mask, *weights)


@torch.no_grad()
def fused_sweep(rows_list=SWEEP_ROWS, A=20, D=512, H=8, iters=ITERS,
                device="cuda"):
    """ms per call of K1 in bf16 ("kernel_ms") and of its plain version in
    f32 ("einsum_ms") at each row count: {rows: {...}}."""
    device = resolve_device(device)
    out = {}
    for rows, args in sweep_inputs(rows_list, A, D, device):
        out[rows] = {
            "einsum_ms": _time(lambda *a: reference_fused_graph_attention(
                *a, H), args, device, iters) * 1e3,
            "kernel_ms": _time(lambda *a: fused_graph_attention(
                *a, H, compute_dtype=torch.bfloat16), args, device,
                iters) * 1e3,
        }
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sweep", action="store_true",
                   help="K1 against its plain version at rows 480/1920/7680")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.sweep:
        res = fused_sweep(device=args.device)
        for rows, row in res.items():
            print(f"rows={rows}: " + " | ".join(f"{k} {v:.3f}"
                                                for k, v in row.items()))
    else:
        res = single_device(device=args.device)
        for k, v in res.items():
            print(f"{k}: {v/1e9:.3f} G edges/s")
    return res


if __name__ == "__main__":
    main()
