"""Where the port's evaluation step spends its time, on the card.

  python tools/profile_eval.py [--cases 32] [--warmup 10] [--steps 10]

Resets ``--cases`` seeded flagship cases, runs ``--warmup`` evaluation steps,
then times each stage of ``--steps`` further steps with the host clock around
``torch.cuda.synchronize()`` (policy act, the human ORCA solve, the 5-step
truth ORCA rollout, the rest of crowd_sim.step, GST pretext), counts the
operators each stage dispatches, and profiles the whole steps with
``torch.profiler`` for the device's busy share and the top kernels. Prints
one JSON object. Runs on ``cuda`` only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from crowdnav_prediction_attngraph_tpu_torch.algo import evaluation  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.config import config_from_snapshot  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.env import crowd_sim  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.env.pretext import pretext_process  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.models import policy as pmod  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import load_gst  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.models.policy_net import (  # noqa: E402
    init_hidden, obs_to_dict)
from crowdnav_prediction_attngraph_tpu_torch.test import (  # noqa: E402
    DEFAULT_GST_PARAMS, DEFAULT_PARAMS)

MODEL_DIR = os.path.join(REPO, "trained_models",
                         "GST_predictor_rand_tpu_r5_selfgst")


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cases", type=int, default=32)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval needs a card")
    device = torch.device("cuda")
    cfg = config_from_snapshot(os.path.join(MODEL_DIR, "config.json"))
    policy = pmod.load_policy(cfg, DEFAULT_PARAMS, device)
    gst = load_gst(cfg.pred, DEFAULT_GST_PARAMS, device)
    B = args.cases
    gens = [evaluation.case_generator(cfg.ppo.seed, i) for i in range(B)]
    state, obs = crowd_sim.reset(cfg, gens, device)
    state, obs, _, _ = pretext_process(cfg, gst, state, obs,
                                       torch.zeros(B, device=device))
    hxs = init_hidden(cfg, B, device)
    masks = torch.ones(B, device=device)

    def one_step(state, obs, hxs):
        _, action, _, hxs = pmod.act(policy, obs_to_dict(obs), hxs, masks)
        state, obs, rew, _, _ = crowd_sim.step(cfg, state, action, "test")
        state, obs, _, _ = pretext_process(cfg, gst, state, obs, rew)
        return state, obs, hxs

    for _ in range(args.warmup):
        state, obs, hxs = one_step(state, obs, hxs)

    stages = {
        "policy_act": lambda: pmod.act(policy, obs_to_dict(obs), hxs, masks),
        "human_orca": lambda: crowd_sim.get_human_actions(cfg, state),
        "truth_rollout_5_orca": lambda: crowd_sim.calc_human_future_traj(
            cfg, state, state.visible_masks),
        "crowd_sim_step_total": lambda: crowd_sim.step(
            cfg, state, torch.zeros(B, 2, device=device), "test"),
        "gst_pretext": lambda: pretext_process(
            cfg, gst, state, obs, torch.zeros(B, device=device)),
    }
    stage_ms, stage_ops = {}, {}
    for name, fn in stages.items():
        with _OpCount() as c:
            fn()
        stage_ops[name] = c.n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            fn()
        torch.cuda.synchronize()
        stage_ms[name] = (time.perf_counter() - t0) * 1e3 / args.steps

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            state, obs, hxs = one_step(state, obs, hxs)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # CUDA kernels only: CPU-side rows (aten ops, autograd Functions) carry
    # their kernels' device time too
    kernels = sorted([(e.key, e.device_time_total / 1e3, e.count)
                      for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA],
                     key=lambda d: -d[1])
    device_ms = sum(d[1] for d in kernels)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "cases": B,
        "stage_ms_per_step": stage_ms, "stage_ops_per_step": stage_ops,
        "profiled_steps": args.steps, "profiled_wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "top_kernels_ms": [[k, round(t, 3), n] for k, t, n in kernels[:12]],
    }))


if __name__ == "__main__":
    main()
