"""Where one flagship PPO iteration of the port spends its time, on the card.

  python tools/profile_train.py [--steps 31] [--iterations 1] [--config5]

Builds the flagship recipe from the snapshot in
trained_models/GST_predictor_rand_tpu_r5_selfgst (64 envs, 30 steps, 5
epochs x 2 minibatches), warm-started from the committed weights (with
``--config5``: BASELINE config 5 as the train CLI builds it,
CrowdSimPredRealGST with 10-50 humans, from a seeded init_params), runs one
warm-up iteration, then:

* times ``--iterations`` whole ``train_iteration``s with the host clock
  around ``torch.cuda.synchronize()``;
* times each stage of a rollout of ``--steps`` steps (policy ``act``, the
  train-phase ``crowd_sim.step``, the reset of the envs that ended, the GST
  pretext pass) and of one PPO update (per minibatch: the loss forward, the
  backward, and the optimizer: clip, Adam, schedule), each with a
  synchronise around it; the first call of each stage is not timed but
  counts the PyTorch operators it dispatches;
* profiles one whole iteration with ``torch.profiler`` for the device's busy
  share and the top kernels.

Prints one JSON object. Runs on ``cuda`` only.
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

from crowdnav_prediction_attngraph_tpu_torch import train as train_cli  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.algo import ppo  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.config import (  # noqa: E402
    build_config, config_from_snapshot)
from crowdnav_prediction_attngraph_tpu_torch.env import crowd_sim  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.env.pretext import pretext_process  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.env.types import tree_scatter  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.models import policy as pmod  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import load_gst  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.models.policy_net import obs_to_dict  # noqa: E402
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


class _Stages:
    """Per named stage: the operators of its first call (counted, not
    timed: the counting mode slows every operator) and the synchronised host
    time of every later call."""

    def __init__(self):
        self.ms, self.ops, self.calls = {}, {}, {}

    def run(self, name, fn):
        if name not in self.ops:
            with _OpCount() as c:
                out = fn()
            self.ops[name] = c.n
            return out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        self.calls[name] = self.calls.get(name, 0) + 1
        return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=31)
    p.add_argument("--iterations", type=int, default=1)
    p.add_argument("--config5", action="store_true",
                   help="BASELINE config 5 (10-50 humans) instead")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a card")
    device = torch.device("cuda")
    if args.config5:
        cfg = build_config(train_cli._parser().parse_args(
            ["--human-num", "30", "--human-num-range", "20",
             "--num-processes", "64", "--use-linear-lr-decay"]))
        model = pmod.init_params(
            cfg, torch.Generator().manual_seed(cfg.ppo.seed), device)
    else:
        cfg = config_from_snapshot(os.path.join(MODEL_DIR, "config.json"))
        model = pmod.load_policy(cfg, DEFAULT_PARAMS, device)
    gst = load_gst(cfg.pred, DEFAULT_GST_PARAMS, device)
    ts = ppo.init_train_state(cfg, gst, device, model)
    ts, _ = ppo.train_iteration(cfg, ts, gst)            # warm-up

    iteration_s = []
    for _ in range(args.iterations):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, _ = ppo.train_iteration(cfg, ts, gst)
        torch.cuda.synchronize()
        iteration_s.append(time.perf_counter() - t0)

    # rollout stages, on the live env state
    st = _Stages()
    states, obs, hxs, masks = ts.env_states, ts.obs, ts.hxs, ts.masks
    for _ in range(args.steps):
        _, action, _, hxs = st.run("policy_act", lambda: pmod.act(
            ts.model, obs, hxs, masks, deterministic=False,
            generator=ts.generator))
        states, ob, rew, done, _ = st.run(
            "crowd_sim_step_train",
            lambda: crowd_sim.step(cfg, states, action, "train"))

        def reset_done():
            idx = done.nonzero()[:, 0]
            if not idx.numel():
                return states, ob
            fresh_s, fresh_o = crowd_sim.reset(
                cfg, [states.gens[i] for i in idx.tolist()], device)
            return (tree_scatter(idx, fresh_s, states),
                    tree_scatter(idx, fresh_o, ob))
        states, ob = st.run("auto_reset", reset_done)
        states, ob, _, _ = st.run(
            "gst_pretext", lambda: pretext_process(cfg, gst, states, ob, rew))
        obs, masks = obs_to_dict(ob), 1.0 - done.float()

    # update stages, on a fresh batch
    ts, batch = ppo.rollout(cfg, ts, gst)
    pc = cfg.ppo
    returns, adv_n = ppo.advantages(cfg, batch)
    perms = torch.stack([torch.randperm(pc.num_processes, device=device)
                         for _ in range(pc.ppo_epoch)])
    n_per = pc.num_processes // pc.num_mini_batch
    params = list(ts.model.parameters())
    for k in range(pc.ppo_epoch * pc.num_mini_batch):
        epoch, mb = divmod(k, pc.num_mini_batch)
        idx = perms[epoch, mb * n_per:(mb + 1) * n_per]
        total, _ = st.run("update_forward", lambda: ppo.ppo_loss(
            cfg, ts.model, batch, returns, adv_n, idx))

        def backward():
            ts.optimizer.zero_grad()
            total.backward()
        st.run("update_backward", backward)

        def optimizer_step():
            ppo.clip_by_global_norm([q.grad for q in params],
                                    pc.max_grad_norm)
            ts.optimizer.step()
            ts.schedule.step()
        st.run("update_optimizer", optimizer_step)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ts, _ = ppo.train_iteration(cfg, ts, gst)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted([(e.key, e.device_time_total / 1e3, e.count)
                      for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA],
                     key=lambda d: -d[1])
    device_ms = sum(d[1] for d in kernels)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "config": "BASELINE config 5" if args.config5 else "flagship",
        "max_humans": cfg.sim.max_human_num,
        "envs": pc.num_processes, "steps": pc.num_steps,
        "ppo_epoch": pc.ppo_epoch, "num_mini_batch": pc.num_mini_batch,
        "iteration_s": iteration_s,
        "stage_calls_timed": st.calls,
        "stage_ms_per_call": {k: st.ms[k] / st.calls[k] for k in st.ms},
        "stage_ops_first_call": st.ops,
        "profiled_iteration_wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share_profiled": device_ms / wall_ms,
        "device_busy_share_unprofiled": device_ms / (
            1e3 * sum(iteration_s) / len(iteration_s)),
        "top_kernels_ms": [[k[:160], round(t, 3), n]
                           for k, t, n in kernels[:15]],
    }))


if __name__ == "__main__":
    main()
