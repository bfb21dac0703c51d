"""The data- and tensor-parallel train step over several GPUs: parity with
one process, and weak scaling.

  torchrun --nproc-per-node 4 tools/parallel_scaling.py
      [--device cpu] [--envs 64] [--steps 30] [--epochs 5] [--small-bench]

One process per GPU (NCCL; gloo with ``--device cpu``), the world from
``torchrun``. Rank 0 prints one JSON line per part, then the card's name
and power limit as nvidia-smi gives them.

1. parity: the flagship recipe (trained_models/GST_predictor_rand_tpu_r5_
   selfgst/config.json: 64 envs x 30 steps, 5 epochs x 2 minibatches, lr
   4e-5 with linear decay, K1/K2 in bf16), warm-started from the committed
   ckpt 10250 export with the committed GST. Every rank first runs two
   plain single-process ``ppo.train_iteration``s on its own card from the
   snapshot, then each layout the world holds for two iterations through
   ``parallel.launch.make_global_iteration`` from the same snapshot: dp =
   world (the kernel branch), and dp = world / 2 x tp 2 with
   ``use_ring_attention`` (the einsum branch, the ring over the tp pair)
   and through the kernel branch (the wide leaves as tp pieces). The first
   iteration is held against the plain one of its config (value loss
   relative error, largest param error and its leaf, and the largest but
   the attention's k bias, whose gradient is rounding noise; the JAX tests'
   bounds 1e-4 / 1e-5 and 2e-4 / 2e-5 with the ring, printed, not gated);
   the second is timed (the slowest rank), as the plain one's second: the
   global batch is fixed, so the ratio is strong scaling. Also rank 0's K1
   / K2 launches in the first. To tell the env from the update: a fresh
   rollout of the layout against the plain one step by step (the largest
   action error at each step, and the done flags that differ), and the
   layout's update alone on the plain rollout's batch (from the snapshot,
   one fixed minibatch order) against the plain update on it, and for the
   kernel layouts the same with K1/K2 in f32.
2. weak scaling: ``ops.bench_edges.weak_scaling`` (the ring, rows 256, A 16
   a rank, D 256, 8 heads) and ``weak_scaling_train`` (8 envs a rank, the
   GST env, 8 steps) over n = 1, 2, 4, ... ranks (``--small-bench``: tiny
   sizes, for a rehearsal on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from crowdnav_prediction_attngraph_tpu_torch.algo import ppo  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.config import (  # noqa: E402
    config_from_snapshot)
from crowdnav_prediction_attngraph_tpu_torch.models import (  # noqa: E402
    policy as pmod)
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import (  # noqa: E402,E501
    load_gst)
from crowdnav_prediction_attngraph_tpu_torch.ops import (  # noqa: E402
    bench_edges)
from crowdnav_prediction_attngraph_tpu_torch.parallel import (  # noqa: E402
    launch, train_step)
from crowdnav_prediction_attngraph_tpu_torch.parallel.mesh import (  # noqa: E402,E501
    full_params, make_mesh, shard_params, use_mesh)
from crowdnav_prediction_attngraph_tpu_torch.test import (  # noqa: E402
    DEFAULT_GST_PARAMS, DEFAULT_MODEL_DIR, DEFAULT_PARAMS)
from crowdnav_prediction_attngraph_tpu_torch.utils import profiling  # noqa: E402,E501

BOUNDS = {False: (1e-4, 1e-5), True: (2e-4, 2e-5)}   # use_ring -> bounds
# its gradient is 0 in exact arithmetic (softmax ignores a shift of every
# logit in a row), so Adam's first step there is rounding noise over
# |noise| + eps: anywhere within +-lr on either side
ZERO_GRAD_LEAF = "base.spatial_attn.k_linear.bias"


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def slowest(seconds: float, device) -> float:
    t = torch.tensor([seconds], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def layouts(world: int):
    """(name, dp, tp, use_ring, use_kernel) for the layouts the world
    holds."""
    out = [(f"dp{world}", world, 1, False, True)]
    if world % 2 == 0 and world > 1:
        dp = world // 2
        out += [(f"dp{dp}_tp2_ring", dp, 2, True, False),
                (f"dp{dp}_tp2_kernel", dp, 2, False, True)]
    return out


def compare(got, want, vl, vl_plain, ring) -> dict:
    """The value loss's relative error and the params' largest errors
    against the JAX tests' bounds."""
    errs = {k: (got[k] - want[k]).abs().max().item() for k in want}
    worst = max(errs, key=errs.get)
    rtol, atol = BOUNDS[ring]
    rel = abs(vl - vl_plain) / abs(vl_plain)
    return {"value_loss": vl, "value_loss_plain": vl_plain,
            "value_loss_rel_err": rel, "param_max_abs_err": errs[worst],
            "worst_param": worst,
            "param_max_abs_err_but_k_bias": max(
                v for k, v in errs.items() if k != ZERO_GRAD_LEAF),
            "bounds": {"rtol": rtol, "atol": atol},
            "within_bounds": rel <= rtol and errs[worst] <= atol}


def parity(cfg, gst, device) -> dict:
    world = dist.get_world_size()
    p = cfg.ppo
    g = torch.Generator().manual_seed(0)
    perms = torch.stack([torch.randperm(p.num_processes, generator=g)
                         for _ in range(p.ppo_epoch)])

    def variant(ring, kernel, dtype=cfg.network.pallas_dtype):
        return cfg.replace(network=dataclasses.replace(
            cfg.network, use_ring_attention=ring,
            use_pallas_attention=kernel, pallas_dtype=dtype))

    def policy(c):
        return pmod.load_policy(c, DEFAULT_PARAMS, device)

    def update(c, model, batch, mesh=None):
        """The update alone from the snapshot's optimizer state, on
        ``batch``, in the order of ``perms``: (whole params, value loss)."""
        opt, sched = ppo.make_optimizer(c, model.parameters())
        with (use_mesh(mesh) if mesh else contextlib.nullcontext()):
            m = ppo.ppo_update(c, model, opt, sched, batch, perms=perms,
                               mesh=mesh)
        got = (full_params(model, mesh) if mesh else
               {k: v.clone() for k, v in model.state_dict().items()})
        return got, float(m["value_loss"])

    plain = {}
    for kernel in (True, False):
        c = variant(False, kernel)
        ts = ppo.init_train_state(c, gst, device, policy(c))

        def first(ts=ts, c=c):
            # ppo.train_iteration, keeping the batch
            ts, batch = ppo.rollout(c, ts, gst)
            m = ppo.ppo_update(c, ts.model, ts.optimizer, ts.schedule,
                               batch, ts.generator)
            return ts, batch, m
        (ts, batch, m), _ = timed(first, device)
        params = {k: v.clone() for k, v in ts.model.state_dict().items()}
        _, sec = timed(lambda: ppo.train_iteration(c, ts, gst), device)
        plain[kernel] = {"params": params, "value_loss": float(m["value_loss"]),
                         "seconds": slowest(sec, device), "batch": batch,
                         "update": update(c, policy(c), batch)}
        if kernel:
            c32 = variant(False, True, "float32")
            plain[kernel]["update_f32"] = update(c32, policy(c32), batch)
    res = {"plain_iteration_seconds": {
        "kernel" if k else "einsum": v["seconds"] for k, v in plain.items()}}
    for name, dp, tp, ring, kernel in layouts(world):
        c = variant(ring, kernel)
        ref = plain[kernel]
        mesh = make_mesh(dp * tp, tp=tp)
        ts = launch.init_sharded_global(c, mesh, gst, device, policy(c))
        it = launch.make_global_iteration(c, mesh, gst)
        profiling.zero_launches()
        (ts, m), _ = timed(lambda: it(ts), device)
        launches = [profiling.launches()[k] for k in ("k1", "k2")]
        got = full_params(ts.model, mesh)
        _, sec = timed(lambda: it(ts), device)

        # where the rollouts part: a fresh rollout of the same snapshot,
        # gathered, step by step against the plain one
        fresh = launch.init_sharded_global(c, mesh, gst, device, policy(c))
        with use_mesh(mesh):
            _, batch = ppo.rollout(
                c, fresh, gst,
                env_offset=mesh.env_slice(p.num_processes).start)
            batch = train_step.gather_batch(batch, mesh)
        actions_err = (batch.actions - ref["batch"].actions).abs().amax(
            dim=(1, 2))
        # the update alone on the plain rollout's batch
        upd_got, upd_vl = update(c, shard_params(policy(c), mesh),
                                 ref["batch"], mesh)
        if kernel:
            c32 = variant(ring, kernel, "float32")
            got32, vl32 = update(c32, shard_params(policy(c32), mesh),
                                 ref["batch"], mesh)
            res[f"{name}_update_on_the_plain_batch_f32"] = compare(
                got32, ref["update_f32"][0], vl32, ref["update_f32"][1],
                ring)
        res[name] = {
            "iteration": compare(got, ref["params"], float(m["value_loss"]),
                                 ref["value_loss"], ring),
            "rollout_actions_max_abs_err_by_step": actions_err.tolist(),
            "rollout_done_flags_differing": int(
                (batch.masks != ref["batch"].masks).sum()),
            "update_on_the_plain_batch": compare(
                upd_got, ref["update"][0], upd_vl, ref["update"][1], ring),
            "iteration_seconds": slowest(sec, device),
            "plain_iteration_seconds": ref["seconds"],
            "speedup": ref["seconds"] / slowest(sec, device),
            "K1_K2_launches_rank0": launches}
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--envs", type=int, default=64)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--small-bench", action="store_true")
    args = p.parse_args(argv)
    launch.initialize(device=args.device)
    device = launch.local_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()

    def emit(part, t0, **kw):
        if rank == 0:
            print(json.dumps({"part": part, "seconds": time.perf_counter()
                              - t0, **kw}), flush=True)

    t0 = time.perf_counter()
    cfg = config_from_snapshot(os.path.join(DEFAULT_MODEL_DIR,
                                            "config.json"))
    cfg = cfg.replace(ppo=dataclasses.replace(
        cfg.ppo, num_processes=args.envs, num_steps=args.steps,
        ppo_epoch=args.epochs))
    gst = load_gst(cfg.pred, DEFAULT_GST_PARAMS, device)
    emit("parity", t0, world=dist.get_world_size(),
         backend=dist.get_backend(), envs=args.envs, steps=args.steps,
         epochs=args.epochs, **parity(cfg, gst, device))

    t0 = time.perf_counter()
    small = (dict(rows=8, A_base=4, D=32), dict(envs_per_dev=2, num_steps=2,
                                                iters=1))
    weak = bench_edges.weak_scaling(device=args.device,
                                    **(small[0] if args.small_bench else {}))
    weak_train = bench_edges.weak_scaling_train(
        device=args.device, **(small[1] if args.small_bench else {}))
    emit("weak_scaling", t0, weak_scaling=weak,
         weak_scaling_train=weak_train)
    if rank == 0 and device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    launch.finalize()


if __name__ == "__main__":
    main()
