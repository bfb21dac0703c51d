"""Driver of the evaluation suite: ``algo/evaluation.evaluate`` on the
test phase, all ``test_size`` cases in one lock-step batch, suites back to
back while the last one's length still fits the window (at least one).

The cases are the suite users score a checkpoint on: the configuration's
own ``ppo.seed`` is the base seed, as the ``test`` CLI uses it, so every
run does the same work (a suite lasts as long as its longest case). The
run's seed draws which steps of the first suite the check copies. Set-up
warms the suite's shapes with ``warmup_steps`` lock-step steps.
"""

from __future__ import annotations

import json
import random
import time

import torch

from harness import check, models, port
from harness.record import ActTape, StepTape


def _quiet(*args, **kwargs):
    pass


def setup(run):
    p = run.port
    cfg = port.build_config(p, run.config_path, run.seed)
    with open(run.config_path) as f:
        base_seed = int(json.load(f)["ppo"]["seed"])
    model, gst, rec = models.load(run, cfg)
    rec.kind = "suite"
    size = int(run.mix["test_size"])
    p["evaluation"].evaluate(cfg, model, gst, test_size=size,
                             base_seed=base_seed, device=run.device,
                             log=_quiet,
                             max_steps=int(run.mix["warmup_steps"]))
    pick = random.Random(port.fold_seed(run.seed))
    want = sorted(pick.sample(range(1, int(run.mix["check_within"]) + 1),
                              int(run.mix["check_steps"])))
    steps = StepTape("split", want, accounting=True)
    acts = ActTape(want)
    port.wrap(p["crowd_sim"].step, steps.step)
    port.wrap(p["pretext"].pretext_process, steps.pretext)
    port.wrap(p["policy"].act, acts.act)
    rec.start_seeds = [check.case_seed(base_seed, i, "test")
                       for i in range(size)]
    run.state.update(cfg=cfg, model=model, gst=gst, rec=rec, steps=steps,
                     acts=acts, base_seed=base_seed, size=size)


def window(run, seconds: float):
    s = run.state
    evaluate = run.port["evaluation"].evaluate
    t0 = time.perf_counter()
    last, results, times = 0.0, [], []
    while not times or (time.perf_counter() - t0) + last <= seconds:
        s["steps"].new_suite()
        a = time.perf_counter()
        res = evaluate(s["cfg"], s["model"], s["gst"], test_size=s["size"],
                       base_seed=s["base_seed"], device=run.device,
                       log=_quiet)
        last = time.perf_counter() - a
        times.append(last)
        results.append(res)
    run.window_s = time.perf_counter() - t0
    run.stats.update(suite_s=times,
                     suite_steps=[r["env_steps"] // s["size"]
                                  for r in results])
    s["results"] = results
    run.attempted = len(results)
    run.failed = sum(not all(torch.isfinite(torch.tensor(
        [r["path_length"], r["mean_episode_reward"]]))) for r in results)


def end_to_end(run) -> dict:
    return {"eval_suite_s": sum(run.stats["suite_s"])
            / len(run.stats["suite_s"])}


def records(run):
    s = run.state
    rec = s["rec"]
    rec.start = s["steps"].start
    rec.steps, rec.acts = s["steps"].records, s["acts"].records
    rec.suites, rec.suite_results = s["steps"].suites, s["results"]
    return rec
