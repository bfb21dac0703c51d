"""Training CLI (JAX package ``train.py``; reference train.py:23-244).

Runs PPO iterations in a loop, keeps the rolling episode-reward windows (the
reference's Monitor deque), writes ``progress.csv`` with the JAX package's
columns, ``eval_history.csv`` and ``best.json`` from in-loop evaluations,
``config.json``, and checkpoints under ``checkpoints/`` (the optimizer
state included, plus a params-only ``.npz`` that the port's ``test`` CLI
loads with ``--params``). The flagship recipe on the card:

  python -m crowdnav_prediction_attngraph_tpu_torch.train \\
      --output-dir trained_models/my_model --num-processes 64 \\
      --use-linear-lr-decay

``--policy-base srnn`` trains DS-RNN in the attention graph's place (the
upstream recipe runs it in CrowdSimVarNum); ``config.json`` keeps the base,
so ``test --model-dir`` scores the run with it:

  python -m crowdnav_prediction_attngraph_tpu_torch.train \\
      --output-dir trained_models/my_srnn --env-name CrowdSimVarNum \\
      --policy-base srnn --num-processes 64 --use-linear-lr-decay

Runs on ``cuda`` unless ``--device cpu`` is given. ``--gst-params`` (a
``.npz`` export, the committed in-repo predictor by default, or one of the
reference's ``.pt`` checkpoints, as a file or as a results dir holding
``checkpoint/epoch_100.pt``) takes the place of ``--gst-model-dir``.
``--gst-edge-heads N`` and ``--gst-ghost`` run the sparse GST, whose edge
selector samples each pedestrian's neighbours (with the ghost node, maybe
none); ``config.json`` keeps both, so ``test --model-dir`` rebuilds the same
GST (given the same ``--gst-params``). Seeded sparse weights:

  python -m crowdnav_prediction_attngraph_tpu_torch.train \
      --output-dir trained_models/my_sparse --human-num 30 \
      --human-num-range 20 --num-processes 256 --gst-edge-heads 4 \
      --gst-ghost --gst-matmul-dtype f32 --gst-params \
      crowdnav_prediction_attngraph_tpu_torch/weights/gst_sparse_ghost_e4_seed2022.npz

Data- and tensor-parallel training, one process per GPU (``parallel/``):
``--multihost`` with ``--coordinator-address host:port``, ``--num-hosts``
(the process count) and ``--process-id``, or with none of the three under
``torchrun``; ``--tp`` shards the 512-wide attention projections over that
many processes of each dp group. ``--num-processes`` stays the global env
count. Rank 0 alone writes ``config.json``, ``progress.csv`` (from the
batch's finished-episode count and sums, as the JAX CLI's multi-host log)
and the checkpoints, in the single-process layout that ``test`` and
``--resume`` read; the in-loop evaluation is off, as in the JAX CLI.

  torchrun --nproc-per-node 8 -m crowdnav_prediction_attngraph_tpu_torch.train \\
      --multihost --num-processes 512 --use-linear-lr-decay

``--spans`` turns on the port's spans and counters (``utils/profiling``)
and prints, at each log interval, the self time of each span and each
counter per env step since the last print (rank 0's, under
``--multihost``).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time

import numpy as np
import torch

from .algo import evaluation
from .algo import ppo as ppo_mod
from .config import build_config
from .models.gst.predictor import load_gst
from .models.policy import BASES, load_policy
from .parallel import launch
from .test import DEFAULT_GST_PARAMS
from .utils import checkpoint as ckpt_util
from .utils import profiling
from .utils.device import resolve_device


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output-dir", default="trained_models/my_model")
    p.add_argument("--env-name", default="CrowdSimPredRealGST")
    p.add_argument("--predict-method", default="const_vel")
    p.add_argument("--human-num", type=int, default=20)
    p.add_argument("--human-num-range", type=int, default=0)
    p.add_argument("--num-processes", type=int, default=16)
    p.add_argument("--num-steps", type=int, default=30)
    p.add_argument("--num-env-steps", type=int, default=20_000_000)
    p.add_argument("--lr", type=float, default=4e-5)
    p.add_argument("--num-mini-batch", type=int, default=2)
    p.add_argument("--ppo-epoch", type=int, default=5)
    p.add_argument("--entropy-coef", type=float, default=0.0)
    p.add_argument("--use-linear-lr-decay", action="store_true",
                   help="linear lr schedule over every Adam step")
    p.add_argument("--seed", type=int, default=425)
    p.add_argument("--log-interval", type=int, default=20)
    p.add_argument("--save-interval", type=int, default=200)
    p.add_argument("--gst-params", default=DEFAULT_GST_PARAMS,
                   help="GST predictor weights: a .npz export, a reference "
                        ".pt checkpoint, or a reference results dir holding "
                        "checkpoint/epoch_100.pt")
    p.add_argument("--gst-matmul-dtype", default="bf16",
                   choices=["f32", "bf16"],
                   help="GST predictor inference matmul dtype")
    p.add_argument("--gst-edge-heads", type=int, default=0,
                   help="the GST's edge-selector heads "
                        "(pred.spatial_num_heads_edges; 0: full "
                        "connectivity, the committed GST's)")
    p.add_argument("--gst-ghost", action="store_true",
                   help="the edge selector's ghost node (pred.ghost; needs "
                        "--gst-edge-heads)")
    p.add_argument("--no-randomize-attributes", dest="randomize_attributes",
                   action="store_false",
                   help="fixed human v_pref/radius")
    p.add_argument("--kinematics", default=None,
                   choices=["holonomic", "unicycle"],
                   help="robot action space")
    p.add_argument("--robot-v-pref", type=float, default=None,
                   help="robot max speed")
    p.add_argument("--spin-warmup-steps", type=int, default=0,
                   help="anneal the unicycle spin penalty linearly from 0 "
                        "over this many env steps")
    p.add_argument("--policy-base", default="selfAttn_merge_srnn",
                   choices=sorted(BASES),
                   help="the policy's base (robot.policy): the attention "
                        "graph, or DS-RNN")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory of a port run to resume from")
    p.add_argument("--init-params-from", default=None,
                   help="warm-start only the policy params (fresh "
                        "optimizer, envs and update counter) from a params "
                        ".npz, or from a checkpoint directory")
    p.add_argument("--init-params-step", type=int, default=None,
                   help="checkpoint for a directory --init-params-from "
                        "(default: the latest)")
    p.add_argument("--eval-interval", type=int, default=0,
                   help="run a deterministic val evaluation every N "
                        "updates (0 = off)")
    p.add_argument("--eval-size", type=int, default=500,
                   help="episodes per in-loop evaluation")
    p.add_argument("--device", default="cuda")
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel training over torch.distributed, one "
                        "process per GPU: the same command on every "
                        "process; the envs split over the dp ranks")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of rank 0 (default: torchrun's env)")
    p.add_argument("--num-hosts", type=int, default=None,
                   help="number of processes")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree of the wide attention "
                        "projections (--multihost)")
    p.add_argument("--spans", action="store_true",
                   help="print the port's spans and counters per env step "
                        "at each log interval")
    return p


def _warm_start_path(path: str, step) -> str:
    if os.path.isdir(path):
        step = ckpt_util.latest_step(path) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = os.path.join(path, f"{step:05d}.npz")
    return path


def main(argv=None):
    args = _parser().parse_args(argv)
    mesh, is_main = None, True
    if args.multihost:
        launch.initialize(args.coordinator_address, args.num_hosts,
                          args.process_id, args.device)
        device = launch.local_device(args.device)
        mesh = launch.global_mesh(tp=args.tp)
        is_main = torch.distributed.get_rank() == 0
    elif args.tp != 1:
        raise SystemExit("--tp needs --multihost")
    else:
        device = resolve_device(args.device)
    cfg = build_config(args)
    if args.spans:
        profiling.enable()
    if is_main:
        os.makedirs(args.output_dir, exist_ok=True)
        with open(os.path.join(args.output_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)

    gst = (load_gst(cfg.pred, args.gst_params, device)
           if cfg.sim.predict_method == "inferred" else None)
    model = None
    if args.init_params_from and not args.resume:
        path = _warm_start_path(args.init_params_from, args.init_params_step)
        model = load_policy(cfg, path, device)
        if is_main:
            print(f"warm-started params from {path}")
    start_update = 0
    if mesh is None:
        ts = ppo_mod.init_train_state(cfg, gst, device, model)
        if args.resume:
            ts, start_update = ckpt_util.restore_train_state(args.resume, ts)

        def iteration(ts):
            return ppo_mod.train_iteration(cfg, ts, gst)

        def save(ts, step):
            ckpt_util.save_train_state(ckpt_dir, ts, step)
    else:
        ts = launch.init_sharded_global(cfg, mesh, gst, device, model)
        if args.resume:
            ts, start_update = launch.restore_train_state(args.resume, ts,
                                                          mesh)
        iteration = launch.make_global_iteration(cfg, mesh, gst)

        def save(ts, step):
            launch.save_train_state(ckpt_dir, ts, step, mesh)
    num_updates = int(cfg.ppo.num_env_steps) // cfg.ppo.num_steps \
        // cfg.ppo.num_processes
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if is_main:
        layout = ("" if mesh is None else
                  f"; {torch.distributed.get_world_size()} processes "
                  f"({torch.distributed.get_backend()}), mesh {mesh.shape}")
        print(f"[train] device {name}{layout}; updates {start_update} to "
              f"{num_updates - 1}", flush=True)
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    best_success = -1.0
    episode_rewards = collections.deque(maxlen=100)
    episode_rewards_env = collections.deque(maxlen=100)  # reference Monitor
    start = time.time()
    csv_path = os.path.join(args.output_dir, "progress.csv")
    # metrics stay on the device until a log or eval boundary
    pending = []

    def flush_pending():
        for m in pending:
            if mesh is not None:
                # one mean per iteration, as the JAX multi-host log keeps
                c = float(m["done_count"])
                if c > 0:
                    episode_rewards.append(float(m["done_sum"]) / c)
                    episode_rewards_env.append(float(m["done_sum_env"]) / c)
                continue
            for key, window in (("done_returns", episode_rewards),
                                ("done_returns_env", episode_rewards_env)):
                rets = m[key].cpu().numpy()
                window.extend(rets[~np.isnan(rets)].tolist())
        pending.clear()

    for j in range(start_update, num_updates):
        ts, metrics = iteration(ts)
        pending.append(metrics)

        if args.eval_interval and j % args.eval_interval == 0 and j > 0 \
                and mesh is None:
            flush_pending()
            r = evaluation.evaluate(cfg, ts.model, gst,
                                    test_size=args.eval_size, phase="val",
                                    device=device, log=lambda m: None)
            print(f"[eval @ update {j}] " + evaluation.format_results(r))
            with open(os.path.join(args.output_dir, "eval_history.csv"),
                      "a") as f:
                f.write(f"{j},{r['success_rate']},{r['collision_rate']},"
                        f"{r['timeout_rate']},{r['nav_time']},"
                        f"{r['path_length']},{r['intrusion_ratio']},"
                        f"{r['min_intrusion_dist']}\n")
            # every eval point is checkpointed, so the best one can be
            # recovered
            save(ts, j)
            if r["success_rate"] >= best_success:
                best_success = r["success_rate"]
                with open(os.path.join(args.output_dir, "best.json"),
                          "w") as f:
                    json.dump({"update": j, **{k: v for k, v in r.items()
                                               if not k.endswith("_cases")}},
                              f, indent=2)

        if j % args.save_interval == 0 or j == num_updates - 1:
            save(ts, j)

        if j % args.log_interval == 0:
            flush_pending()
            if args.spans:
                if is_main:
                    print(profiling.per_step_table(profiling.snapshot()),
                          flush=True)
                profiling.reset()
        if j % args.log_interval == 0 and len(episode_rewards) > 1 \
                and is_main:
            total_num_steps = (j + 1) * cfg.ppo.num_processes \
                * cfg.ppo.num_steps
            fps = int(total_num_steps / (time.time() - start))
            lr_now = cfg.ppo.lr * (max(0.0, 1.0 - j / num_updates)
                                   if cfg.ppo.use_linear_lr_decay else 1.0)
            row = {
                "misc/nupdates": j,
                "misc/total_timesteps": total_num_steps,
                "misc/lr": lr_now,
                "fps": fps,
                "eprewmean": float(np.mean(episode_rewards)),
                "eprewmean_env": float(np.mean(episode_rewards_env)),
                "loss/policy_entropy": float(metrics["dist_entropy"]),
                "loss/policy_loss": float(metrics["action_loss"]),
                "loss/value_loss": float(metrics["value_loss"]),
            }
            print(f"Updates {j}, num timesteps {total_num_steps}, FPS {fps} "
                  f"eprewmean {row['eprewmean']:.2f} "
                  f"value_loss {row['loss/value_loss']:.3f}", flush=True)
            header = not os.path.exists(csv_path)
            with open(csv_path, "a") as f:
                if header:
                    f.write(",".join(row.keys()) + "\n")
                f.write(",".join(str(v) for v in row.values()) + "\n")
    if mesh is not None:
        launch.finalize()
    if args.spans:
        profiling.disable()
    return ts


if __name__ == "__main__":
    main()
