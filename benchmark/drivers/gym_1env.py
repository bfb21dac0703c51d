"""Driver of the single-env control loop: one ``CrowdNavGymEnv`` (test
phase) driven by the policy acting deterministically, one control step at
a time: ``sim2real.policy_obs`` -> ``models/policy.act`` ->
``CrowdNavGymEnv.step`` returning numpy. The recurrent state resets at
each episode's end. Each step is timed by the host clock (the step returns
numpy, so the device has finished).

The episodes are the test suite's cases 0, 1, 2, ... (the configuration's
``ppo.seed`` as base seed), one after another, in every run: a step's cost
depends on its scene, and runs whose scenes differ do different work. The
run's seed draws which steps the check copies. Set-up warms the loop with
``warmup_steps`` steps of the suite's last case (past two of the env's
5-second events).
"""

from __future__ import annotations

import json
import math
import os
import random
import time

import numpy as np
import torch

from harness import check, models, port, spec
from harness.record import ActTape, StepTape


def bench_seed(config_path: str) -> int:
    """The configuration's own ``ppo.seed``: the suite's base seed."""
    with open(config_path) as f:
        return json.load(f)["ppo"]["seed"]


def _returned(ob: dict, r: float, done: bool, device) -> dict:
    """The adapter's answer as a batch of one on the device."""
    obs = {k: torch.as_tensor(v, device=device)[None]
           for k, v in ob.items() if k != "detected_human_num"}
    obs["detected_human_num"] = torch.as_tensor(
        ob["detected_human_num"], device=device).reshape(1)
    return {"obs": obs, "rew": torch.tensor([r], device=device),
            "done": torch.tensor([done], device=device)}


def _step(run, env, ob, hxs, masks):
    p = run.port
    obs_t = p["sim2real"].policy_obs(ob, run.device)
    _, action, _, hxs = p["policy"].act(run.state["model"], obs_t, hxs,
                                        masks, deterministic=True)
    ob, r, term, trunc, _ = env.step(action[0].cpu().numpy())
    return ob, r, term or trunc, hxs


def setup(run):
    p = run.port
    cfg = port.build_config(p, run.config_path, run.seed)
    with open(run.config_path) as f:
        bench = json.load(f)["benchmark"]
    model, _, rec = models.load(run, cfg)
    rec.kind = "gym"
    base = int(bench_seed(run.config_path))
    cases = int(run.mix["cases"])
    env = p["gym_adapter"].CrowdNavGymEnv(
        cfg, gst_params=os.path.join(spec.ROOT, bench["gst_weights"]),
        phase="test", device=run.device)
    run.state.update(cfg=cfg, model=model, env=env, rec=rec,
                     episode_seeds=[check.case_seed(base, k, "test")
                                    for k in range(cases)])
    masks = torch.ones(1, device=run.device)
    ob, _ = env.reset(seed=check.case_seed(base, cases - 1, "test"))
    hxs = p["policy_net"].init_hidden(cfg, 1, run.device)
    for _ in range(int(run.mix["warmup_steps"])):
        ob, _, done, hxs = _step(run, env, ob, hxs, masks)
        if done:
            ob, _ = env.reset(seed=check.case_seed(base, cases - 2, "test"))
            hxs = p["policy_net"].init_hidden(cfg, 1, run.device)
    pick = random.Random(port.fold_seed(run.seed))
    want = sorted(pick.sample(range(1, int(run.mix["check_within"]) + 1),
                              int(run.mix["check_steps"])))
    steps, acts = StepTape("split", want), ActTape(want)
    port.wrap(p["crowd_sim"].step, steps.step)
    port.wrap(p["pretext"].pretext_process, steps.pretext)
    port.wrap(p["policy"].act, acts.act)
    run.state.update(steps=steps, acts=acts, masks=masks)


def window(run, seconds: float):
    s = run.state
    p, env, cfg = run.port, s["env"], s["cfg"]
    steps = s["steps"]
    times, rewards, k, first_seed = [], [], 0, None
    ob = hxs = None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if ob is None:
            seed = s["episode_seeds"][k % len(s["episode_seeds"])]
            first_seed = seed if first_seed is None else first_seed
            ob, _ = env.reset(seed=seed)
            hxs = p["policy_net"].init_hidden(cfg, 1, run.device)
            k += 1
        run.tick()
        n_rec = len(steps.records)
        a = time.perf_counter()
        ob, r, done, hxs = _step(run, env, ob, hxs, s["masks"])
        times.append(time.perf_counter() - a)
        rewards.append(r)
        if len(steps.records) > n_rec:
            steps.records[-1]["returned"] = _returned(ob, r, done,
                                                      run.device)
        if done:
            ob = None
    run.tick()
    run.window_s = time.perf_counter() - t0
    run.stats.update(step_s=times, episodes=k)
    s["first_seed"] = first_seed
    run.attempted = len(times)
    run.failed = sum(not math.isfinite(r) for r in rewards)


def end_to_end(run) -> dict:
    return {"gym_step_ms_p95":
            float(np.percentile(np.asarray(run.stats["step_s"]), 95)) * 1e3}


def records(run):
    s = run.state
    rec = s["rec"]
    rec.start, rec.start_seeds = s["steps"].start, [s["first_seed"]]
    rec.steps, rec.acts = s["steps"].records, s["acts"].records
    return rec
