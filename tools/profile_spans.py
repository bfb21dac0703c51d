"""Where a PPO iteration of the port spends its time, by the port's own spans
and counters (``utils/profiling``), for the flagship recipe, config 5, the
sparse GST at config 5 or DS-RNN.

  python tools/profile_spans.py [--config flagship|config5|sparsegst|srnn] [--iterations 4]
      [--cost-rounds 4] [--envs N] [--steps T] [--device cuda]

Builds the configuration from the run snapshot in
trained_models/GST_predictor_rand_tpu_r5_selfgst (flagship: the snapshot
with the committed policy; config5: BASELINE config 5 on it, as the train
CLI's ``--human-num 30 --human-num-range 20 --num-processes 256`` builds
it, from a seeded ``init_params``; sparsegst: config 5 with the GST's edge
selector and ghost in f32 on the committed seeded sparse weights, as
``--gst-edge-heads 4 --gst-ghost --gst-matmul-dtype f32 --gst-params
<weights/gst_sparse_ghost_e4_seed2022.npz>`` builds it; srnn: DS-RNN on it
in CrowdSimVarNum with no predictor, as ``train --env-name CrowdSimVarNum
--policy-base srnn`` builds it, from a seeded ``init_params``) with the
spans on, then:

* ``init_state_s``: the ``ppo.init_train_state`` span of the set-up, and
  ``init_gst_graph``: its GST calls (the capture of the GST's CUDA graph);
* after one warm-up iteration, ``--iterations`` iterations with the spans
  on and no profiler: ``profiling.readings`` of them (each span's calls,
  self and total ms per env step, the counters per env step, and
  ``orca_ms``, ``auto_reset_ms``, ``orca_lp3_share``, ``env_syncs``,
  ``backward_ms``, ``gst_graph``, ``gst_graph_share`` and
  ``gst_edge_rows``);
* one iteration under ``torch.profiler`` (CPU and, on a card, CUDA): the
  device ops launched inside each ``crowdnav.`` range, per range
  (``orca_kernels`` is ``env.orca``'s) and their device ms, the device's
  idle share and its
  longest kernels, its idle gaps put down to the innermost port span of
  the driving thread (``idle_gaps_by_span``), and the gaps between a
  span's stamps and its range on the trace's clock;
* where a GST runs, ``eager_gst``: one GST forward op by op on the envs'
  current pretext inputs under ``torch.profiler`` (a replay hides the
  spans inside the graph), with the device ms of each ``gst.`` span's
  range (``gst.edge_selector``, ``gst.node_encoder``) and their spans;
* ``--cost-rounds`` pairs of iterations with the spans off and on, in
  turns (the registry emptied before each): env steps per second of each,
  and the cost of the spans; and the host cost of one span and one
  counter, on and off, times their number per env step.

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from crowdnav_prediction_attngraph_tpu_torch.algo import ppo  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.config import config_from_snapshot  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.models import policy as pmod  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import (  # noqa: E402
    gst_forward, load_gst)
from crowdnav_prediction_attngraph_tpu_torch.test import (  # noqa: E402
    DEFAULT_GST_PARAMS, DEFAULT_PARAMS)
from crowdnav_prediction_attngraph_tpu_torch.utils import profiling  # noqa: E402

SNAPSHOT = os.path.join(REPO, "trained_models",
                        "GST_predictor_rand_tpu_r5_selfgst", "config.json")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPARSE_GST_PARAMS = os.path.join(os.path.dirname(DEFAULT_GST_PARAMS),
                                 "gst_sparse_ghost_e4_seed2022.npz")
TOP_LEVEL = ("ppo.rollout", "ppo.update")
NO_SPAN = "no span"


def config(name: str):
    """The flagship recipe (the snapshot), config 5, the sparse GST at
    config 5 or DS-RNN on it."""
    cfg = config_from_snapshot(SNAPSHOT)
    if name in ("config5", "sparsegst"):
        cfg = cfg.replace(
            sim=dataclasses.replace(cfg.sim, human_num=30,
                                    human_num_range=20),
            ppo=dataclasses.replace(cfg.ppo, num_processes=256))
    if name == "sparsegst":
        cfg = cfg.replace(pred=dataclasses.replace(
            cfg.pred, spatial_num_heads_edges=4, ghost=True,
            matmul_dtype="f32"))
    elif name == "srnn":
        cfg = cfg.replace(
            env_name="CrowdSimVarNum",
            sim=dataclasses.replace(cfg.sim, predict_method="none"),
            robot=dataclasses.replace(cfg.robot, policy="srnn"))
    return cfg


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_iteration(cfg, ts, gst, device):
    _sync(device)
    t0 = time.perf_counter()
    ts, _ = ppo.train_iteration(cfg, ts, gst)
    _sync(device)
    return ts, time.perf_counter() - t0


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(ranges):
    """Boundaries along one thread's timeline and the innermost range in
    force after each (a thread's ranges nest: at one time, a parent starts
    before its child and ends after it)."""
    points = sorted([(s, 1, s - e, n) for s, e, n in ranges]
                    + [(e, 0, e - s, n) for s, e, n in ranges])
    stack, times, labels = [], [], []
    for t, is_start, _, name in points:
        if is_start:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        times.append(t)
        labels.append(stack[-1] if stack else NO_SPAN)
    return times, labels


def _spread(values) -> dict:
    """Median, 99th percentile and largest of ``values``, the count, and
    how many lie over 50 (us)."""
    if not values:
        return {}
    v = sorted(values)
    return {"p50": statistics.median(v), "p99": v[int(0.99 * (len(v) - 1))],
            "max": v[-1], "n": len(v), "over_50": sum(x > 50.0 for x in v)}


def trace_metrics(path: str, snap: dict, window_s: float) -> dict:
    """Device ops per port range, idle gaps by port span, and the span
    stamps against their ranges, from a Chrome trace of the slice."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    dev, launches = [], {}
    ranges = collections.defaultdict(list)
    prefix = profiling.RANGE_PREFIX
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), str(ev.get("name", ""))
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        corr = ev.get("args", {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, corr, name))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (ev.get("tid"), ts)
        elif cat == "user_annotation" and name.startswith(prefix):
            # the host's ranges (the trace repeats each on the device's
            # timeline as a gpu_user_annotation)
            ranges[ev.get("tid")].append((ts, ts + dur, name[len(prefix):]))

    # the span stamps against the nearest range of their name
    by_name = collections.defaultdict(list)
    for rs in ranges.values():
        for s, e, n in rs:
            by_name[n].append((s, e))
    gaps = {"start": [], "end": []}
    for sp in snap["spans"]:
        cand = by_name.get(sp["name"])
        if not cand or sp["name"] == "profiler.warm":
            continue
        start = profiling.trace_us(sp["start_ns"], base)
        end = profiling.trace_us(sp["end_ns"], base)
        s, e = min(cand, key=lambda r: abs(r[0] - start))
        gaps["start"].append(abs(start - s))
        gaps["end"].append(abs(end - e))

    # device ops launched inside each range (by the launching thread)
    calls = collections.Counter(n for rs in ranges.values()
                                for _, _, n in rs if n != "profiler.warm")
    device_us = collections.Counter()
    index = {}
    for tid, rs in ranges.items():
        per = collections.defaultdict(list)
        for s, e, n in rs:
            per[n].append((s, e))
        index[tid] = {n: (sorted(v), sorted(a for a, _ in v))
                      for n, v in per.items()}
    ops = collections.Counter()
    for s0, e0, corr, _ in dev:
        tid, t = launches.get(corr, (None, None))
        for n, (spans, starts) in index.get(tid, {}).items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                ops[n] += 1
                device_us[n] += e0 - s0
    out = {"device_ops": len(dev),
           "span_stamp_vs_range_us": {k: _spread(v) for k, v in gaps.items()},
           "ops_per_range": {n: ops[n] / calls[n] for n in sorted(calls)},
           "device_ms_per_range": {n: device_us[n] / 1e3 / calls[n]
                                   for n in sorted(calls)},
           "orca_kernels": (ops["env.orca"] / calls["env.orca"]
                            if ops["env.orca"] else None)}
    if not dev:
        return out
    kernel_ms = collections.Counter()
    for s, e, _, name in dev:
        kernel_ms[name[:120]] += (e - s) / 1e3
    merged = _union([(s, e) for s, e, *_ in dev])
    busy_s = sum(e - s for s, e in merged) / 1e6
    main = max(ranges, key=lambda t: len(ranges[t])) if ranges else None
    times, labels = _innermost(ranges[main]) if main is not None else ([], [])
    idle = collections.defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        i = bisect.bisect_right(times, e0) - 1
        idle[labels[i] if i >= 0 else NO_SPAN] += (s1 - e0) / 1e6
    total_idle = sum(idle.values())
    inner = sum(v for k, v in idle.items() if k not in TOP_LEVEL + (NO_SPAN,))
    out.update({
        "busy_s": busy_s, "window_s": window_s,
        "device_idle": 100.0 * (1.0 - busy_s / window_s),
        "top_kernels_ms": kernel_ms.most_common(10),
        "idle_gaps_by_span": sorted(([k, v] for k, v in idle.items()),
                                    key=lambda kv: -kv[1]),
        "idle_under_inner_spans": (100.0 * inner / total_idle
                                   if total_idle else None)})
    return out


def host_cost(readings: dict, n: int = 20000) -> dict:
    """Microseconds of one span and one counter on this host, on and off,
    and what the spans and counters of one env step cost in all."""
    def time_us(on: bool):
        (profiling.enable if on else profiling.disable)()
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("host_cost"):
                pass
        t1 = time.perf_counter()
        for _ in range(n):
            profiling.count("host_cost")
        t2 = time.perf_counter()
        profiling.disable()
        profiling.reset()
        return (t1 - t0) / n * 1e6, (t2 - t1) / n * 1e6
    (span_on, count_on), (span_off, count_off) = time_us(True), time_us(False)
    spans = sum(t["calls"] for t in readings["spans_per_step"].values())
    counts = len([k for k in readings["counters_per_step"]
                  if not k.endswith(".launches")])
    return {"span_us_on": span_on, "span_us_off": span_off,
            "count_us_on": count_on, "count_us_off": count_off,
            "spans_per_step": spans, "counter_sites_per_step": counts,
            "step_ms_on": (spans * span_on + counts * count_on) / 1e3,
            "step_ms_off": (spans * span_off + counts * count_off) / 1e3}


def _profiled(device, func):
    """``func()`` under torch.profiler (CPU and, on a card, CUDA): (the
    port's snapshot of it, the path of its Chrome trace, its seconds)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    profiling.reset()
    _sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        # the profiler's first range opens late: keep it off the readings
        with profiling.span("profiler.warm"):
            pass
        t0 = time.perf_counter()
        out = func()
        _sync(device)
        window_s = time.perf_counter() - t0
    snap = profiling.snapshot()
    snap["totals"].pop("profiler.warm")
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    return out, snap, path, window_s


def eager_gst(cfg, gst, ts, device) -> dict:
    """One GST forward op by op on the envs' current pretext inputs (the
    history buffers ``pretext_process`` last wrote), after one to warm up:
    the device ms and ops of each ``gst.`` range and the spans."""
    st = ts.env_states
    traj = st.traj_buffer[:, ::cfg.pred_interval].transpose(1, 2)
    mask = st.mask_buffer[:, ::cfg.pred_interval].transpose(1, 2)
    gst_forward(gst, traj, mask)
    _, snap, path, window_s = _profiled(
        device, lambda: gst_forward(gst, traj, mask))
    try:
        traced = trace_metrics(path, snap, window_s)
    finally:
        os.remove(path)
    keep = ("gst.edge_selector", "gst.node_encoder")
    return {"window_ms": 1e3 * window_s,
            "device_ms_per_range": {k: v for k, v in
                                    traced["device_ms_per_range"].items()
                                    if k in keep},
            "ops_per_range": {k: v for k, v in traced["ops_per_range"].items()
                              if k in keep},
            "device_busy_ms": 1e3 * traced.get("busy_s", 0.0),
            "spans": {k: {"calls": t["count"], "total_ms": 1e3 * t["total_s"]}
                      for k, t in snap["totals"].items() if k in keep}}


def build(name: str, device, envs=None, steps=None):
    cfg = config(name)
    cfg = cfg.replace(ppo=dataclasses.replace(
        cfg.ppo, num_processes=envs or cfg.ppo.num_processes,
        num_steps=steps or cfg.ppo.num_steps))
    gst_params = (SPARSE_GST_PARAMS if cfg.pred.spatial_num_heads_edges
                  else DEFAULT_GST_PARAMS)
    gst = (load_gst(cfg.pred, gst_params, device)
           if cfg.sim.predict_method == "inferred" else None)
    if name == "flagship":
        model = pmod.load_policy(cfg, DEFAULT_PARAMS, device)
    else:
        model = pmod.init_params(
            cfg, torch.Generator().manual_seed(cfg.ppo.seed), device)
    return cfg, gst, model


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config",
                   choices=("flagship", "config5", "sparsegst", "srnn"),
                   default="flagship")
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--cost-rounds", type=int, default=4)
    p.add_argument("--envs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    cfg, gst, model = build(args.config, device, args.envs, args.steps)
    out = {"config": args.config, "envs": cfg.ppo.num_processes,
           "steps": cfg.ppo.num_steps, "max_humans": cfg.sim.max_human_num,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}

    profiling.enable()
    profiling.reset()
    _sync(device)
    ts = ppo.init_train_state(cfg, gst, device, model)
    _sync(device)
    snap = profiling.snapshot()
    out["init_state_s"] = snap["totals"]["ppo.init_train_state"]["total_s"]
    out["init_gst_graph"] = profiling.readings(snap)["gst_graph"]
    ts, out["warmup_s"] = _timed_iteration(cfg, ts, gst, device)

    profiling.reset()
    times = []
    for _ in range(args.iterations):
        ts, dt = _timed_iteration(cfg, ts, gst, device)
        times.append(dt)
    out["iteration_s"] = times
    out["spans"] = profiling.readings(profiling.snapshot())

    (ts, _), snap, path, window_s = _profiled(
        device, lambda: ppo.train_iteration(cfg, ts, gst))
    try:
        out["traced"] = trace_metrics(path, snap, window_s)
    finally:
        os.remove(path)
    out["traced"]["spans"] = profiling.readings(snap)
    if gst is not None:
        out["eager_gst"] = eager_gst(cfg, gst, ts, device)

    rounds = {"off": [], "on": []}
    env_steps = cfg.ppo.num_processes * cfg.ppo.num_steps
    for r in range(args.cost_rounds):
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            profiling.reset()
            (profiling.enable if mode == "on" else profiling.disable)()
            ts, dt = _timed_iteration(cfg, ts, gst, device)
            rounds[mode].append(env_steps / dt)
    profiling.disable()
    if args.cost_rounds:
        off = statistics.median(rounds["off"])
        on = statistics.median(rounds["on"])
        out["cost"] = {"env_steps_per_s_off": rounds["off"],
                       "env_steps_per_s_on": rounds["on"],
                       "median_off": off, "median_on": on,
                       "on_cost_percent": 100.0 * (1.0 - on / off)}
    out["host_cost"] = host_cost(out["spans"])
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
