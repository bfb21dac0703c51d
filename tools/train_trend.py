"""Does a port training run train? Two runs of the port's CLIs on the card.

  python tools/train_trend.py [--out torch_eval/train_trend]
      [--warm-iterations 20] [--fresh-iterations 50] [--cases 500]

1. The flagship recipe (``train --env-name CrowdSimPredRealGST --human-num
   20 --num-processes 64 --use-linear-lr-decay``), warm-started from the
   committed export of ckpt 10250 (``--init-params-from``), for
   ``--warm-iterations`` iterations (``--num-env-steps`` = iterations x 64
   x 30, so the lr decays over them), a checkpoint at the last; then
   ``test --model-dir <run>`` scores that checkpoint on ``--cases`` seeded
   cases (the committed pair scores 0.84-0.96 success in the port).
2. BASELINE config 1 (``train --env-name CrowdSimVarNum --human-num 5
   --num-processes 64``) from a fresh ``init_params``, ``--fresh-iterations``
   iterations, logging every iteration.

Prints one JSON object: the score, and for each run the first and last
rows of its progress.csv, its value loss and eprewmean row by row, and
their means over its first and last fifth; the runs' directories (with
their checkpoints, tens of MiB) stay under ``--out``. Runs on ``cuda``
only.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from crowdnav_prediction_attngraph_tpu_torch import (  # noqa: E402
    test as test_cli, train as train_cli)

ENVS, STEPS = 64, 30


def trend(run_dir: str) -> dict:
    """progress.csv's first and last rows, its value loss and eprewmean
    row by row, and their means over its first and last fifth ({"rows": 0}
    when no episode ended, so no row was written)."""
    path = os.path.join(run_dir, "progress.csv")
    if not os.path.exists(path):
        return {"rows": 0}
    with open(path) as f:
        rows = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
    k = max(1, len(rows) // 5)

    def mean(part, key):
        return sum(r[key] for r in part) / len(part)
    return {
        "rows": len(rows), "first": rows[0], "last": rows[-1],
        "value_loss": [r["loss/value_loss"] for r in rows],
        "eprewmean": [r["eprewmean"] for r in rows],
        **{f"{key}_{side}_fifth": mean(part, col)
           for key, col in (("value_loss", "loss/value_loss"),
                            ("eprewmean", "eprewmean"))
           for side, part in (("first", rows[:k]), ("last", rows[-k:]))}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(REPO, "torch_eval",
                                                 "train_trend"))
    p.add_argument("--warm-iterations", type=int, default=20)
    p.add_argument("--fresh-iterations", type=int, default=50)
    p.add_argument("--cases", type=int, default=500)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_trend: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    common = ["--num-processes", str(ENVS), "--num-steps", str(STEPS),
              "--log-interval", "1"]
    warm = os.path.join(args.out, "flagship_warm")
    t0 = time.perf_counter()
    train_cli.main(common + [
        "--output-dir", warm, "--env-name", "CrowdSimPredRealGST",
        "--human-num", "20", "--use-linear-lr-decay",
        "--num-env-steps", str(args.warm_iterations * ENVS * STEPS),
        "--save-interval", str(args.warm_iterations),
        "--init-params-from", test_cli.DEFAULT_PARAMS])
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    score = test_cli.main(["--model-dir", warm, "--test-case-size",
                           str(args.cases), "--out-dir",
                           os.path.join(warm, "eval")])
    test_s = time.perf_counter() - t0
    fresh = os.path.join(args.out, "config1_fresh")
    t0 = time.perf_counter()
    train_cli.main(common + [
        "--output-dir", fresh, "--env-name", "CrowdSimVarNum",
        "--human-num", "5", "--save-interval", str(args.fresh_iterations),
        "--num-env-steps", str(args.fresh_iterations * ENVS * STEPS)])
    fresh_s = time.perf_counter() - t0
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "flagship_warm": {
            "iterations": args.warm_iterations, "seconds": warm_s,
            "trend": trend(warm), "test_cases": args.cases,
            "test_seconds": test_s,
            "score": {k: v for k, v in score.items()
                      if not k.endswith("_cases")}},
        "config1_fresh": {"iterations": args.fresh_iterations,
                          "seconds": fresh_s, "trend": trend(fresh)},
    }), flush=True)


if __name__ == "__main__":
    main()
