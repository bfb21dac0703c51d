"""Evaluation CLI (JAX package ``test.py:62-179``; reference test.py:16-158).

Loads a run's config snapshot and its weights, runs the seeded suite with
the network policy and writes the reference metric lines to
``<out-dir>/test/test_<step>.log`` (``--out-dir`` defaults to ``torch_eval``,
so the model dir's committed log is never overwritten). The weights are, in
this order:

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

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from .algo import evaluation
from .config import config_from_snapshot
from .models.gst.predictor import load_gst
from .models.policy import load_policy
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", required=True,
                   help="run directory holding config.json")
    p.add_argument("--params", default=None,
                   help="policy weights (.npz); default: the model dir's "
                        "checkpoint (see above)")
    p.add_argument("--gst-params", default=DEFAULT_GST_PARAMS,
                   help="GST predictor weights (.npz export)")
    p.add_argument("--step", type=int, default=None,
                   help="with --params: the step the weights come from "
                        f"(names the log; default {DEFAULT_STEP})")
    p.add_argument("--ckpt-step", type=int, default=None,
                   help="checkpoint of the model dir to score (default: the "
                        "latest)")
    p.add_argument("--test-case-size", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="cases per lock-step batch (default: all at once)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out-dir", default="torch_eval",
                   help="log root, never the model dir (its committed log "
                        "stays); the log goes to <out-dir>/test/test_<step>.log")
    args = p.parse_args(argv)

    params, step = resolve_params(args.model_dir, args.params, args.step,
                                  args.ckpt_step)
    device = resolve_device(args.device)
    cfg = config_from_snapshot(os.path.join(args.model_dir, "config.json"))
    policy = load_policy(cfg, params, device)
    gst = load_gst(cfg.pred, args.gst_params, device)

    out_dir = os.path.join(args.out_dir, "test")
    os.makedirs(out_dir, exist_ok=True)
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
        print(f"[test] device {name}; weights {params} (step {step})",
              flush=True)
        results = evaluation.evaluate(
            cfg, policy, gst, test_size=args.test_case_size,
            batch_size=args.batch_size, device=device,
            log=lambda m: print(m, flush=True))
        logger.info(evaluation.format_results(results))
        logger.info("Collision cases: " +
                    " ".join(str(x) for x in results["collision_cases"]))
        logger.info("Timeout cases: " +
                    " ".join(str(x) for x in results["timeout_cases"]))
        print(f"[test] {results['env_steps']} env steps in "
              f"{results['seconds']:.2f} s on {name}", flush=True)
    finally:
        for h in handlers:
            logger.removeHandler(h)
            h.close()
    return results


if __name__ == "__main__":
    main()
