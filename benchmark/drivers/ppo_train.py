"""Driver of PPO training traffic: ``algo/ppo.train_iteration`` back to
back, closed loop (each iteration starts when the last one ends), from the
state set-up built.

Set-up builds the train state (the envs reset from the seed, the optimizer,
the action-noise and minibatch generator seeded from it) and drives it
through its first iteration with every env step, act and the first Adam
steps recorded for the check. That iteration runs every shape the window
runs, so it is the warm-up too. The window runs whole iterations while the
last one's length still fits.
"""

from __future__ import annotations

import time

import torch

from harness import check, models, port
from harness.record import ActTape, StepTape, UpdateTape, snap


def _sync(run):
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def setup(run):
    p = run.port
    cfg = port.build_config(p, run.config_path, run.seed)
    model, gst, rec = models.load(run, cfg)
    rec.kind = "train"
    ts = p["ppo"].init_train_state(cfg, gst, run.device, model)
    N, T = cfg.ppo.num_processes, cfg.ppo.num_steps
    rec.start = {"state": snap(ts.env_states), "obs": snap(ts.obs)}
    rec.start_seeds = [check.case_seed(cfg.ppo.seed, i, "train")
                       for i in range(N)]
    steps, acts = StepTape("vec", range(1, T + 1)), ActTape(range(1, T + 1))
    update = UpdateTape(ts.model, ts.optimizer)
    port.wrap(p["vector"].vec_step, steps.vec_step)
    port.wrap(p["policy"].act, acts.act)
    port.wrap(p["ppo"].ppo_loss, update.loss)
    ts, _ = p["ppo"].train_iteration(cfg, ts, gst)
    steps.on = acts.on = False
    update.close()
    rec.steps, rec.acts, rec.update = steps.records, acts.records, update
    _sync(run)
    run.state.update(cfg=cfg, ts=ts, gst=gst, rec=rec)


def window(run, seconds: float):
    cfg, gst = run.state["cfg"], run.state["gst"]
    ts = run.state["ts"]
    train_iteration = run.port["ppo"].train_iteration
    t0 = time.perf_counter()
    last, times, failed = 0.0, [], 0
    while not times or (time.perf_counter() - t0) + last <= seconds:
        run.tick()
        a = time.perf_counter()
        ts, m = train_iteration(cfg, ts, gst)
        failed += int(not bool(torch.isfinite(m["value_loss"])))
        _sync(run)
        last = time.perf_counter() - a
        times.append(last)
    run.tick()
    run.window_s = time.perf_counter() - t0
    run.state["ts"] = ts
    run.stats.update(iterations=len(times), iteration_s=times,
                     env_steps=len(times) * cfg.ppo.num_processes
                     * cfg.ppo.num_steps)
    run.attempted, run.failed = len(times), failed


def end_to_end(run) -> dict:
    return {"train_env_steps_per_s": run.stats["env_steps"] / run.window_s}


def records(run):
    return run.state["rec"]
