"""Where a GST train step and a collect step of the port spend their time, on
the card.

  python tools/profile_gst_train.py [--steps 20] [--envs 16]

Collects ``--envs`` ORCA crowds (20 humans) for 128 steps with the port's
collect env, builds the windows (32 slots, obs 5, pred 5), then, at the JAX
recipe's full width (``PredConfig()``, batch 64, Adam at lr 1e-3):

* times ``--steps`` train steps by stage (the loss forward, the backward,
  the Adam step), each between ``torch.cuda.synchronize()`` calls, after a
  warm-up; the first call of each stage is not timed but counts the
  PyTorch operators it dispatches;
* times ``--steps`` collect steps the same way;
* profiles ``--steps`` whole train steps with ``torch.profiler`` for the
  device's busy share and the top kernels.

Prints one JSON object. Runs on ``cuda`` only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from crowdnav_prediction_attngraph_tpu_torch.collect_data import (  # noqa: E402
    collect_dataset, env_generators)
from crowdnav_prediction_attngraph_tpu_torch.config import (  # noqa: E402
    PredConfig, varnum_config)
from crowdnav_prediction_attngraph_tpu_torch.env import collect  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.models.gst import (  # noqa: E402
    dataset, trainer)
from crowdnav_prediction_attngraph_tpu_torch.models.gst.st_model import (  # noqa: E402
    init_gst)

BATCH, LR = 64, 1e-3


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
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--envs", type=int, default=16)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gst_train: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    env_cfg = varnum_config(human_num=20)
    rows = collect_dataset(env_cfg, args.envs, 128, seed=0, device=dev)
    windows = [w for r in rows for w in dataset.build_windows(r, 5, 5, 32)]
    data = trainer.to_device(trainer.stack_windows(windows), dev)
    n = len(windows) // BATCH
    model = init_gst(PredConfig(), torch.Generator().manual_seed(0), dev)
    opt = trainer.make_optimizer(model, LR)
    st = _Stages()

    def batch(i):
        sel = torch.arange(BATCH, device=dev) + (i % n) * BATCH
        return {k: a.index_select(0, sel) for k, a in data.items()}

    def step(b, timed):
        loss = st.run("forward", lambda: trainer.loss_fn(
            model, b, 0.5, False)[0]) if timed else \
            trainer.loss_fn(model, b, 0.5, False)[0]
        opt.zero_grad(set_to_none=True)
        (st.run("backward", loss.backward) if timed else loss.backward())
        (st.run("adam", opt.step) if timed else opt.step())

    for i in range(3):
        step(batch(i), False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.steps):
        step(batch(i), False)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    for i in range(args.steps + 1):
        step(batch(i), True)

    state, _ = collect.reset(env_cfg, env_generators(args.envs, 9), dev)
    for _ in range(args.steps + 1):
        state, _ = st.run("collect_step", lambda: collect.step(env_cfg,
                                                               state))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(args.steps):
            step(batch(i), False)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted([(e.key, e.device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA],
                     key=lambda d: -d[1])
    device_ms = sum(d[1] for d in kernels)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "windows": len(windows), "batch": BATCH, "slots": 32,
        "train_step_ms": step_ms,
        "stage_calls_timed": st.calls,
        "stage_ms_per_call": {k: st.ms[k] / st.calls[k] for k in st.ms},
        "stage_ops_first_call": st.ops,
        "collect_envs": args.envs,
        "profiled_steps_wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share_profiled": device_ms / wall_ms,
        "device_busy_share_unprofiled": device_ms / (step_ms * args.steps),
        "top_kernels_ms": [[k[:160], round(t, 3), c]
                           for k, t, c in kernels[:12]],
    }), flush=True)


if __name__ == "__main__":
    main()
