"""Evaluation CLI (JAX package ``test.py:62-179``; reference test.py:16-158).

Runs the seeded suite and writes the reference metric lines to
``<out-dir>/test/test_<step>.log``. The robot is the network policy
(``--robot-policy network``, the default) or a scripted baseline
(``orca``, ``social_force``). The config is the run's snapshot
``<model-dir>/config.json``; a scripted run without one builds it from the
flags (``--env-name``, ``--predict-method``, ``--human-num``,
``--human-num-range``, ``--no-randomize-attributes``, and the PPO flags, as
the JAX CLI does), and then ``--model-dir`` is only where its log goes.
``--orca-stale-radii`` and ``--gst-matmul-dtype`` apply to either config;
``--gst-edge-heads`` and ``--gst-ghost`` only to one built from the flags,
and are refused beside a snapshot, which states its GST's (pass its weights
with ``--gst-params``).
``--out-dir`` defaults to ``torch_eval`` (or, for a scripted run without a
snapshot, ``--model-dir``), so a model dir's committed log is never
overwritten; a scripted run's log is ``test_00000.log``.

For the network policy the weights are, in this order:

* ``--params`` (a params ``.npz``), the log named by ``--step``;
* the run's own checkpoint ``<model-dir>/checkpoints/<step>.npz``, written
  by the port's ``train``: ``--ckpt-step``, else the latest;
* for the flagship run the weights were exported from
  (``trained_models/GST_predictor_rand_tpu_r5_selfgst``, whose checkpoints
  are orbax's), the committed export of its step 10250.

Any other model dir without ``--params`` is an error: no other weights are
scored in its name.

  python -m crowdnav_prediction_attngraph_tpu_torch.test \\
      --model-dir trained_models/GST_predictor_rand_tpu_r5_selfgst \\
      --test-case-size 500
  python -m crowdnav_prediction_attngraph_tpu_torch.test \\
      --env-name CrowdSimVarNum --robot-policy orca --test-case-size 500

``--visualize`` runs no suite: it steps one case (``--test-case``, default
0) and draws each step as it happens, live with a display and always to a
GIF (``--render-out``, default ``<out-dir>/test/case_<N>.gif``), as the JAX
CLI does (``test.py:89-97, 143-152``). Drawing needs matplotlib, imported
only then.

``--spans`` turns on the port's spans and counters (``utils/profiling``)
and prints, at the end of the suite, the self time of each span and each
counter per env step.

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

import torch

from .algo import evaluation
from .config import build_config, config_from_snapshot
from .models.gst.predictor import load_gst
from .models.policy import load_policy
from .utils import profiling, render
from .utils.checkpoint import latest_step
from .utils.device import resolve_device

PACKAGE = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(PACKAGE, "weights")
DEFAULT_PARAMS = os.path.join(WEIGHTS, "r5_selfgst_10250_policy.npz")
DEFAULT_GST_PARAMS = os.path.join(WEIGHTS, "gst_sj_tpu_r5_b64_epoch100.npz")
DEFAULT_STEP = 10250
# the run DEFAULT_PARAMS was exported from (tools/export_torch_weights.py)
DEFAULT_MODEL_DIR = os.path.join(os.path.dirname(PACKAGE), "trained_models",
                                 "GST_predictor_rand_tpu_r5_selfgst")


def resolve_params(model_dir: str, params=None, step=None, ckpt_step=None):
    """(params .npz, step naming the log) for ``model_dir``, in the order of
    the module docstring; raises SystemExit when no weights belong to it."""
    if params is not None:
        return params, DEFAULT_STEP if step is None else step
    ckpt_dir = os.path.join(model_dir, "checkpoints")
    latest = latest_step(ckpt_dir)
    if latest is not None:
        use = latest if ckpt_step is None else ckpt_step
        path = os.path.join(ckpt_dir, f"{use:05d}.npz")
        if not os.path.exists(path):
            raise SystemExit(f"no port checkpoint {path}")
        return path, use
    if os.path.realpath(model_dir) == os.path.realpath(DEFAULT_MODEL_DIR):
        if ckpt_step not in (None, DEFAULT_STEP):
            raise SystemExit(f"only step {DEFAULT_STEP} of {model_dir} is "
                             f"exported for the port; pass other weights "
                             f"with --params")
        return DEFAULT_PARAMS, DEFAULT_STEP
    raise SystemExit(f"{model_dir} holds no port checkpoint "
                     f"(checkpoints/<step>.npz from the port's train) and is "
                     f"not {DEFAULT_MODEL_DIR}; pass the weights with --params")


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", default=None,
                   help="run directory holding config.json (required for "
                        "the network policy)")
    p.add_argument("--robot-policy", default="network",
                   choices=["network", "orca", "social_force"])
    p.add_argument("--env-name", default="CrowdSimVarNum",
                   help="without a snapshot: the env of a scripted run")
    p.add_argument("--predict-method", default="none")
    p.add_argument("--human-num", type=int, default=20)
    p.add_argument("--human-num-range", type=int, default=0)
    p.add_argument("--num-processes", type=int, default=16)
    p.add_argument("--num-steps", type=int, default=30)
    p.add_argument("--num-env-steps", type=int, default=0)
    p.add_argument("--lr", type=float, default=4e-5)
    p.add_argument("--seed", type=int, default=425)
    p.add_argument("--no-randomize-attributes", dest="randomize_attributes",
                   action="store_false",
                   help="fixed v_pref/radius humans (the reference's "
                        "*_no_rand baseline configs)")
    p.add_argument("--orca-stale-radii", action="store_true",
                   help="emulate the reference ORCA robot's stale neighbour "
                        "radii (OrcaConfig.stale_neighbor_radii)")
    p.add_argument("--gst-matmul-dtype", default=None,
                   choices=["f32", "bf16"],
                   help="override the GST predictor's matmul dtype")
    p.add_argument("--gst-edge-heads", type=int, default=0,
                   help="without a snapshot: the GST's edge-selector heads "
                        "(0: full connectivity)")
    p.add_argument("--gst-ghost", action="store_true",
                   help="without a snapshot: the edge selector's ghost node")
    p.add_argument("--params", default=None,
                   help="policy weights (.npz); default: the model dir's "
                        "checkpoint (see above)")
    p.add_argument("--gst-params", default=DEFAULT_GST_PARAMS,
                   help="GST predictor weights: a .npz export, a reference "
                        ".pt checkpoint, or a reference results dir holding "
                        "checkpoint/epoch_100.pt")
    p.add_argument("--step", type=int, default=None,
                   help="with --params: the step the weights come from "
                        f"(names the log; default {DEFAULT_STEP})")
    p.add_argument("--ckpt-step", type=int, default=None,
                   help="checkpoint of the model dir to score (default: the "
                        "latest)")
    p.add_argument("--test-case-size", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="cases per lock-step batch (default: all at once)")
    p.add_argument("--visualize", action="store_true",
                   help="render one episode live instead of running the "
                        "suite (reference test.py --visualize)")
    p.add_argument("--test-case", type=int, default=0,
                   help="case index to visualize (reference test.py "
                        "--test_case)")
    p.add_argument("--render-out", default=None,
                   help="GIF path for --visualize (default "
                        "<out-dir>/test/case_<N>.gif)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out-dir", default=None,
                   help="log root (default: torch_eval, or --model-dir for a "
                        "scripted run without a snapshot); the log goes to "
                        "<out-dir>/test/test_<step>.log")
    p.add_argument("--spans", action="store_true",
                   help="print the port's spans and counters per env step "
                        "at the end of the suite")
    return p


def load_config(args):
    """(config, whether it came from a snapshot): the model dir's snapshot,
    else, for a scripted robot, the flags (JAX ``test.py:105-124``)."""
    snapshot = args.model_dir and os.path.join(args.model_dir, "config.json")
    if snapshot and os.path.exists(snapshot):
        if args.gst_edge_heads or args.gst_ghost:
            raise SystemExit(f"{snapshot} states the GST's edge selector: "
                             "--gst-edge-heads and --gst-ghost apply only "
                             "to a config built from the flags")
        cfg, from_snapshot = config_from_snapshot(snapshot), True
    elif args.robot_policy == "network":
        raise SystemExit(f"no config snapshot at {snapshot or '--model-dir'}"
                         " (required for the network policy)")
    else:
        cfg, from_snapshot = build_config(args), False
    if args.orca_stale_radii:
        cfg = cfg.replace(orca=dataclasses.replace(
            cfg.orca, stale_neighbor_radii=True))
    if args.gst_matmul_dtype:
        cfg = cfg.replace(pred=dataclasses.replace(
            cfg.pred, matmul_dtype=args.gst_matmul_dtype))
    return cfg, from_snapshot


def main(argv=None):
    args = _parser().parse_args(argv)
    params, step = None, 0
    if args.robot_policy == "network":
        if not args.model_dir:
            raise SystemExit("--model-dir is required for the network policy")
        params, step = resolve_params(args.model_dir, args.params, args.step,
                                      args.ckpt_step)
    cfg, from_snapshot = load_config(args)
    device = resolve_device(args.device)
    if args.spans:
        profiling.enable()
    policy = (load_policy(cfg, params, device) if params is not None
              else None)
    gst = (load_gst(cfg.pred, args.gst_params, device)
           if cfg.sim.predict_method == "inferred" else None)

    out_root = args.out_dir or (
        args.model_dir if args.model_dir and not from_snapshot
        else "torch_eval")
    out_dir = os.path.join(out_root, "test")
    os.makedirs(out_dir, exist_ok=True)
    if args.visualize:
        out_path = args.render_out or os.path.join(
            out_dir, f"case_{args.test_case}.gif")
        render.render_episode_live(
            cfg, policy, gst, case_idx=args.test_case,
            base_seed=cfg.ppo.seed, robot_policy=args.robot_policy,
            out_path=out_path, device=device)
        print(f"wrote {out_path}")
        return out_path
    log_path = os.path.join(out_dir, f"test_{step:05d}.log")
    logger = logging.getLogger("crowdnav_prediction_attngraph_tpu_torch.test")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s, %(levelname)s: %(message)s",
                            "%Y-%m-%d %H:%M:%S")
    handlers = [logging.FileHandler(log_path, mode="w"),
                logging.StreamHandler(sys.stdout)]
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    try:
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        robot = (f"weights {params} (step {step})" if policy is not None
                 else f"scripted {args.robot_policy} robot")
        print(f"[test] device {name}; {cfg.env_name} "
              f"({cfg.sim.predict_method}, {cfg.sim.human_num} humans, "
              f"range {cfg.sim.human_num_range}); {robot}", flush=True)
        results = evaluation.evaluate(
            cfg, policy, gst, test_size=args.test_case_size,
            batch_size=args.batch_size, device=device,
            log=lambda m: print(m, flush=True),
            robot_policy=args.robot_policy)
        logger.info(evaluation.format_results(results))
        logger.info("Collision cases: " +
                    " ".join(str(x) for x in results["collision_cases"]))
        logger.info("Timeout cases: " +
                    " ".join(str(x) for x in results["timeout_cases"]))
        print(f"[test] {results['env_steps']} env steps in "
              f"{results['seconds']:.2f} s on {name}", flush=True)
        if args.spans:
            print(profiling.per_step_table(profiling.snapshot()), flush=True)
    finally:
        for h in handlers:
            logger.removeHandler(h)
            h.close()
        if args.spans:
            profiling.disable()
    return results


if __name__ == "__main__":
    main()
