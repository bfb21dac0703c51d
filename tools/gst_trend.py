"""Does the port's GST training stack train? The JAX proof recipe on the card,
through the port's CLIs.

  python tools/gst_trend.py [--out torch_eval/gst_trend] [--train-envs 64]
      [--val-envs 16] [--steps 3200] [--epochs 20] [--cases 500]

1. ``collect_data`` (20 ORCA humans): ``--train-envs`` x ``--steps`` from
   seed 0 into ``train/``, ``--val-envs`` x ``--steps`` from seed 1 into
   ``test/``.
2. The trainer CLI with the recipe of the JAX package's proof run
   (``results/logs/gst_train_r5_b64.log:1``): 24000 train and 4000 val
   windows (``--max-windows`` / ``--max-val-windows``), batch 64, the
   default lr, temperature and seed, ``--epochs`` epochs; each epoch's
   numbers beside the same epoch of the JAX run's
   ``results/gst_sj_tpu_r5_b64/train_hist.json`` (other data, from other
   random streams: compare them only as distributions).
3. The eval CLI on the last checkpoint, in val and test mode.
4. The ``test`` CLI on the committed flagship policy
   (``trained_models/GST_predictor_rand_tpu_r5_selfgst``, ckpt 10250),
   ``--cases`` cases, with the port-trained ``params.npz`` as
   ``--gst-params``, and, in the same call, with the committed GST export.

Prints one JSON object; reports only, gates nothing. Runs on ``cuda`` only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from crowdnav_prediction_attngraph_tpu_torch import (  # noqa: E402
    collect_data, test as test_cli)
from crowdnav_prediction_attngraph_tpu_torch.models.gst import (  # noqa: E402
    eval as gst_eval, trainer)

JAX_HIST = os.path.join(REPO, "results", "gst_sj_tpu_r5_b64",
                        "train_hist.json")
MAX_WINDOWS, MAX_VAL_WINDOWS, BATCH = 24000, 4000, 64


def score(res) -> dict:
    return {k: v for k, v in res.items() if not k.endswith("_cases")}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(REPO, "torch_eval",
                                                 "gst_trend"))
    p.add_argument("--train-envs", type=int, default=64)
    p.add_argument("--val-envs", type=int, default=16)
    p.add_argument("--steps", type=int, default=3200)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--cases", type=int, default=500)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gst_trend: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    data = os.path.join(args.out, "data")
    run = os.path.join(args.out, "run")
    seconds = {}

    t0 = time.perf_counter()
    records = {}
    for phase, envs, seed in (("train", args.train_envs, 0),
                              ("test", args.val_envs, 1)):
        rows = collect_data.main(["--tot-steps", str(args.steps),
                                  "--num-envs", str(envs), "--seed",
                                  str(seed), "--phase", phase, "--out", data])
        records[phase] = sum(len(r) for r in rows)
    seconds["collect"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    hist = trainer.main(["--data-dir", data, "--out", run, "--epochs",
                         str(args.epochs), "--batch-size", str(BATCH),
                         "--max-windows", str(MAX_WINDOWS),
                         "--max-val-windows", str(MAX_VAL_WINDOWS)])
    seconds["load_and_train"] = time.perf_counter() - t0
    with open(JAX_HIST) as f:
        jax_hist = json.load(f)
    epochs = [{"epoch": e + 1,
               **{k: hist[k][e] for k in hist},
               **{f"jax_{k}": jax_hist[k][e] for k in jax_hist
                  if e < len(jax_hist[k])}}
              for e in range(args.epochs)]

    ckpt = os.path.join(run, f"epoch_{args.epochs}")
    common = ["--data-dir", data, "--split", "test", "--ckpt", ckpt,
              "--max-windows", str(MAX_VAL_WINDOWS), "--batch-size",
              str(BATCH)]
    t0 = time.perf_counter()
    evals = {mode: gst_eval.main(common + ["--mode", mode])
             for mode in ("val", "test")}
    seconds["eval"] = time.perf_counter() - t0

    scores = {}
    for name, gst in (("port_trained_gst", os.path.join(ckpt, "params.npz")),
                      ("committed_gst", test_cli.DEFAULT_GST_PARAMS)):
        t0 = time.perf_counter()
        scores[name] = score(test_cli.main([
            "--model-dir", test_cli.DEFAULT_MODEL_DIR, "--test-case-size",
            str(args.cases), "--gst-params", gst, "--out-dir",
            os.path.join(args.out, "eval", name)]))
        seconds[f"test_{name}"] = time.perf_counter() - t0
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "collect": {"train_envs": args.train_envs, "val_envs": args.val_envs,
                    "steps": args.steps, "records": records},
        "batch": BATCH, "max_windows": MAX_WINDOWS,
        "max_val_windows": MAX_VAL_WINDOWS, "epochs": epochs,
        "eval": evals, "test_cases": args.cases, "scores": scores,
        "seconds": seconds}), flush=True)


if __name__ == "__main__":
    main()
