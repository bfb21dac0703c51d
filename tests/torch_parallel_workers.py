"""Worker processes of the port's multi-rank tests (gloo on the CPU).

Each worker joins a world through ``parallel.launch.initialize`` with a
``FileStore`` path, runs torch on one thread, and writes what rank 0 (or
every rank) computed to ``out`` with ``torch.save``. This module imports
no jax, so a spawned worker never loads it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from crowdnav_prediction_attngraph_tpu_torch import train as train_cli
from crowdnav_prediction_attngraph_tpu_torch.algo import ppo
from crowdnav_prediction_attngraph_tpu_torch.config import varnum_config
from crowdnav_prediction_attngraph_tpu_torch.models import policy_net
from crowdnav_prediction_attngraph_tpu_torch.ops import bench_edges
from crowdnav_prediction_attngraph_tpu_torch.parallel import (
    edge_partition, launch, mesh as mesh_mod)

# the tp degrees of the ring checks
RING_TP = (1, 2, 4)
# the iteration cases: (dp, tp, use_ring_attention, use_pallas_attention)
ITERATION_CASES = {"dp2": (2, 1, False, True),
                   "dp2_tp2_ring": (2, 2, True, False),
                   "dp2_tp2_kernel": (2, 2, False, True)}


def join(rank: int, world: int, store: str):
    torch.set_num_threads(1)
    launch.initialize(num_processes=world, process_id=rank, device="cpu",
                      init_method=f"file://{store}")


def small_cfg(ring: bool = False, kernel: bool = True):
    """The JAX parallel tests' ``small_cfg`` (8 envs x 4 steps, 2
    minibatches, 1 epoch) at 4 humans, so A divides tp = 2. The time limit
    is cut so that every env ends an episode in the rollout (auto-reset and
    the finished-episode metrics on every rank); the kernel branch runs in
    f32, whose plain versions are exact per row."""
    cfg = varnum_config(human_num=4)
    return cfg.replace(
        ppo=dataclasses.replace(cfg.ppo, num_processes=8, num_steps=4,
                                num_mini_batch=2, ppo_epoch=1),
        env=dataclasses.replace(cfg.env, time_limit=1.75),
        network=dataclasses.replace(cfg.network, use_ring_attention=ring,
                                    use_pallas_attention=kernel,
                                    pallas_dtype="float32"))


def ring_world(rank: int, world: int, store: str, inputs: str, out: str):
    """The ring over tp = 1, 2 and 4 ranks of a world of 4 on every input
    set of ``inputs`` (a list of (q, k, v, mask, heads) numpy tuples); the
    gradients of sum(out x g) for the sets that carry a g; the mesh layout
    of (dp 2, tp 2); ``bench_edges.weak_scaling`` at a tiny size."""
    join(rank, world, store)
    sets = torch.load(inputs, weights_only=False)
    res = {"forward": {}, "grads": {}}
    for tp in RING_TP:
        mesh = mesh_mod.make_mesh(tp, tp=tp)
        if mesh is None:
            continue
        for i, s in enumerate(sets):
            q, k, v = (torch.from_numpy(s[key]).requires_grad_()
                       for key in ("q", "k", "v"))
            mask = torch.from_numpy(s["mask"])
            o = edge_partition.edge_partitioned_attention(
                q, k, v, mask, s["heads"], mesh)
            res["forward"][tp, i] = o.detach()
            if "g" in s:
                (o * torch.from_numpy(s["g"])).sum().backward()
                res["grads"][tp, i] = [t.grad for t in (q, k, v)]
    mesh = mesh_mod.make_mesh(4, tp=2)
    coords = [None] * world
    torch.distributed.all_gather_object(coords, (mesh.dp_rank,
                                                 mesh.tp_rank))
    res["coords"] = coords
    res["weak_scaling"] = bench_edges.weak_scaling(
        rows=4, A_base=4, D=16, H=2, device="cpu", iters=2)
    torch.save(res, f"{out}.{rank}")
    launch.finalize()


def iteration_world(rank: int, world: int, store: str, out: str):
    """One data-parallel iteration of each of ``ITERATION_CASES`` in a world
    of 4 (a dp = 2 mesh leaves ranks 2 and 3 out): the whole params after
    it, its metrics, the ring's calls, and the tp pieces' shapes."""
    join(rank, world, store)
    ring_calls = []
    ring = policy_net.edge_partitioned_attention

    def counted(*a, **kw):
        ring_calls.append(1)
        return ring(*a, **kw)
    policy_net.edge_partitioned_attention = counted
    res = {}
    for name, (dp, tp, use_ring, kernel) in ITERATION_CASES.items():
        cfg = small_cfg(use_ring, kernel)
        mesh = mesh_mod.make_mesh(dp * tp, tp=tp)
        if mesh is None:
            continue
        ring_calls.clear()
        ts = launch.init_sharded_global(cfg, mesh, None, "cpu")
        ts, m = launch.make_global_iteration(cfg, mesh)(ts)
        pieces = {n: (tuple(p.shape),
                      tuple(ts.optimizer.state[p]["exp_avg"].shape))
                  for n, p in ts.model.named_parameters()
                  if hasattr(p, "tp_dim")}
        res[name] = {
            "params": mesh_mod.full_params(ts.model, mesh),
            "metrics": {k: v.clone() for k, v in m.items()},
            "ring_calls": len(ring_calls), "pieces": pieces,
            "envs": len(ts.env_states.gens)}
    torch.save(res, f"{out}.{rank}")
    launch.finalize()


def single_iteration(case: str):
    """The single-process iteration of ``ITERATION_CASES[case]``'s config:
    (whole params, metrics)."""
    _, _, use_ring, kernel = ITERATION_CASES[case]
    cfg = small_cfg(use_ring, kernel)
    ts = ppo.init_train_state(cfg, None, "cpu")
    ts, m = ppo.train_iteration(cfg, ts, None)
    return ts.model.state_dict(), m


def ring_inputs():
    """The JAX edge-partition tests' inputs (tests/test_edge_partition.py):
    rows 6, A 16, D 256, 8 heads with prefix masks from seed n for
    n in (1, 2, 4), then its partial masks (rows 4, A 8, D 128, 4 heads,
    column 0 valid), and the first set again with row 0 all masked; each
    with a cotangent g for the gradient checks but the all-masked one."""
    sets = []
    for n in RING_TP:
        rng = np.random.RandomState(n)
        q, k, v = (rng.randn(6, 16, 256).astype(np.float32)
                   for _ in range(3))
        det = rng.randint(1, 17, 6)
        mask = np.arange(16)[None, :] < det[:, None]
        sets.append(dict(q=q, k=k, v=v, mask=mask, heads=8))
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(4, 8, 128).astype(np.float32) for _ in range(3))
    mask = rng.rand(4, 8) > 0.4
    mask[:, 0] = True
    sets.append(dict(q=q, k=k, v=v, mask=mask, heads=4))
    masked = dict(sets[0])
    masked["mask"] = sets[0]["mask"].copy()
    masked["mask"][0] = False
    g_rng = np.random.RandomState(7)
    for s in sets:
        s["g"] = g_rng.randn(*s["q"].shape).astype(np.float32)
    sets.append(masked)
    return sets


def tiny_train_main(argv):
    """``train.main(argv)`` on one thread with the time limit cut to 1.75 s,
    so that episodes end in every update of 5 steps and ``progress.csv``
    gets rows, and the kernel branch in f32."""
    build = train_cli.build_config

    def tiny(args):
        cfg = build(args)
        return cfg.replace(
            env=dataclasses.replace(cfg.env, time_limit=1.75),
            network=dataclasses.replace(cfg.network,
                                        pallas_dtype="float32"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    train_cli.build_config = tiny
    try:
        return train_cli.main(argv)
    finally:
        train_cli.build_config = build
        torch.set_num_threads(n)
