"""edges/s benchmark of the interaction-graph attention (JAX package
``ops/bench_edges.py``).

  python -m crowdnav_prediction_attngraph_tpu_torch.ops.bench_edges          # edges/s
  python -m crowdnav_prediction_attngraph_tpu_torch.ops.bench_edges --sweep  # K1 vs plain
  torchrun --nproc-per-node 4 -m crowdnav_prediction_attngraph_tpu_torch.ops.bench_edges \\
      --weak-scaling [--device cpu]        # the ring, n = 1, 2, 4 ranks
  torchrun --nproc-per-node 4 -m crowdnav_prediction_attngraph_tpu_torch.ops.bench_edges \\
      --weak-scaling-train [--device cpu]  # the data-parallel train step

``single_device`` measures edges/s (rows x A^2 per second) of the packed
masked attention over precomputed q, k, v: its plain version ("einsum") and
the K3 kernel ("kernel"). ``fused_sweep`` times the fused graph attention
(K1, bf16: "kernel_ms") against its plain version in f32 ("einsum_ms", the
JAX package's yardstick, its XLA reference) at three row counts. The inputs are
made with numpy from seed 0, as in the JAX package, so both packages time
the same numbers. Runs on ``cuda`` unless ``--device cpu`` is given; a
kernel that fails ends the run (there is no fallback). The JAX package's
``strip_rows`` sweep axis exists only on the TPU.

``weak_scaling`` and ``weak_scaling_train`` run over the world they are
started in (``parallel.launch.initialize``: ``torchrun``'s, else a world of
one), on n = 1, 2, 4, ... of its ranks: the edge-partitioned ring with A
growing by 16 agents a rank (rows 256, D 256, 8 heads), and the
data-parallel train step of the GST env with 8 envs a rank. Efficiency is
rate(n) / (n x rate(1)), each time the slowest rank's.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

import torch.distributed as dist

from ..config import gst_config
from ..models.gst.st_model import init_gst
from ..parallel import launch
from ..parallel.edge_partition import edge_partitioned_attention
from ..parallel.mesh import make_mesh
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


def _slowest(seconds: float, mesh, device) -> float:
    """The largest of the mesh's ranks' ``seconds``."""
    t = torch.tensor([seconds], dtype=torch.float64, device=device)
    for group, size in ((mesh.dp_group, mesh.dp), (mesh.tp_group, mesh.tp)):
        if size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t[0])


def _sizes(max_dev):
    n, top = 1, max_dev or dist.get_world_size()
    while n <= top:
        yield n
        n *= 2


@torch.no_grad()
def weak_scaling(rows=256, A_base=16, D=256, H=8, max_dev=None,
                 device="cuda", iters=10):
    """edges/s of the ring (``parallel/edge_partition.py``) over n = 1, 2,
    4, ... tp ranks with A = A_base x n: {n: {"edges_per_s", "efficiency"}}
    (JAX ``bench_edges.py:103-128``). Every rank of the process group calls
    it; ranks past n wait out that size."""
    device = launch.local_device(device)
    results = {}
    base_rate = None
    for n in _sizes(max_dev):
        A = A_base * n
        mesh = make_mesh(n, tp=n)
        if mesh is None:
            continue
        q, k, v, mask = _inputs(rows, A, D, device)
        dt = _time(lambda *a: edge_partitioned_attention(*a, H, mesh),
                   (q, k, v, mask), device, iters)
        rate = rows * A * A / _slowest(dt, mesh, device)
        base_rate = base_rate or rate
        results[n] = {"edges_per_s": rate,
                      "efficiency": rate / (base_rate * n)}
    return results


def weak_scaling_train(envs_per_dev=8, num_steps=8, max_dev=None,
                       device="cuda", iters=5):
    """env-steps/s of the data-parallel train step (``parallel/
    train_step.py``) over n = 1, 2, 4, ... dp ranks with envs_per_dev envs
    each: the GST env with 20 humans, num_steps steps, 1 epoch of 2
    minibatches, a fresh GST from seed 0 and the policy from ``ppo.seed``;
    one warm-up iteration, then ``iters`` timed (JAX
    ``bench_edges.py:131-183``). {n: {"env_steps_per_s", "efficiency"}}."""
    device = launch.local_device(device)
    results = {}
    base_rate = None
    for n in _sizes(max_dev):
        mesh = make_mesh(n, tp=1)
        if mesh is None:
            continue
        num_envs = envs_per_dev * n
        cfg = gst_config(human_num=20)
        cfg = cfg.replace(ppo=dataclasses.replace(
            cfg.ppo, num_processes=num_envs, num_steps=num_steps,
            num_mini_batch=2, ppo_epoch=1))
        gst = init_gst(cfg.pred, torch.Generator().manual_seed(0),
                       device).eval()
        ts = launch.init_sharded_global(cfg, mesh, gst, device)
        it = launch.make_global_iteration(cfg, mesh, gst)
        ts, _ = it(ts)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            ts, _ = it(ts)
        _sync(device)
        dt = _slowest((time.perf_counter() - t0) / iters, mesh, device)
        rate = num_envs * num_steps / dt
        base_rate = base_rate or rate
        results[n] = {"env_steps_per_s": rate,
                      "efficiency": rate / (base_rate * n)}
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sweep", action="store_true",
                   help="K1 against its plain version at rows 480/1920/7680")
    p.add_argument("--weak-scaling", action="store_true",
                   help="the ring over n = 1, 2, 4, ... ranks of the world")
    p.add_argument("--weak-scaling-train", action="store_true",
                   help="the data-parallel train step over n = 1, 2, 4, "
                        "... ranks of the world")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.weak_scaling or args.weak_scaling_train:
        launch.initialize(device=args.device)
        if args.weak_scaling_train:
            res = weak_scaling_train(device=args.device)
            lines = [f"n={n}: {r['env_steps_per_s']:.1f} env-steps/s, "
                     f"efficiency {r['efficiency'] * 100:.1f}%"
                     for n, r in res.items()]
        else:
            res = weak_scaling(device=args.device)
            lines = [f"n={n}: {r['edges_per_s'] / 1e9:.3f} G edges/s, "
                     f"efficiency {r['efficiency'] * 100:.1f}%"
                     for n, r in res.items()]
        if dist.get_rank() == 0:
            print("\n".join(lines), flush=True)
        launch.finalize()
        return res
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
