"""One run of one cell: set-up, the measured window, the traced readings,
the correctness check, and the result line.

The driver named by the cell's traffic mix (``drivers/<driver>.py``)
provides ``setup(run)``, ``window(run, seconds)``, ``end_to_end(run)`` and
``records(run)``;
the per-layer metrics' readers (``metrics/<family>.py``) provide
``read(readings)``. This module knows none of them by name.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import sys
import time
from typing import List, Optional

import torch

from . import check, port, spec, work
from .trace import Spans, Tracer

# top-level module names that may not be loaded in a run: JAX, its
# libraries, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "crowdnav_prediction_attngraph_tpu")


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole (the
    port's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """Everything a driver and a metric reader see of the run."""
    cell: spec.Cell
    seed: int
    device: torch.device
    trace: bool
    port: dict
    config_path: str
    mix: dict
    spans: Optional[Spans] = None
    tracer: Optional[Tracer] = None
    state: dict = dataclasses.field(default_factory=dict)   # the driver's
    stats: dict = dataclasses.field(default_factory=dict)   # the window's
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0

    def tick(self):
        if self.tracer is not None:
            self.tracer.tick()


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader reads."""
    run: Run
    spans: Spans
    trace: Optional[object]          # trace.TraceSummary of the slice
    trace_window_s: Optional[float]
    policy_row_flops: int
    gst_env_flops: int


def _install_spans(run: Run):
    p = run.port
    spans = run.spans
    tick_env = run.mix.get("trace", {}).get("tick") == "env_step"
    port.wrap(p["crowd_sim"].step,
              spans.timed("env_step", tick=tick_env))
    port.wrap(p["pretext"].pretext_process, spans.timed(
        "gst_pretext", rows=lambda a, k: a[3].visible_masks.shape[0]))
    port.wrap(p["policy"].act, spans.timed(
        "act", rows=lambda a, k: a[3].shape[0]))
    port.wrap(p["ppo"].rollout, spans.timed("rollout"))
    port.wrap(p["ppo"].ppo_update, spans.timed("update"))
    port.wrap(p["ppo"].ppo_loss, spans.counted(
        "update_rows", rows=lambda a, k: a[2].rewards.shape[0] * len(a[5])))
    port.wrap(p["policy_net"].fused_graph_attention,
              spans.shaped("k1", _kernel_shape))
    port.wrap(p["masked_attention"].fused_graph_attention_backward,
              spans.shaped("k2", _kernel_shape))


def _kernel_shape(args, kwargs) -> tuple:
    """(rows, A, D, compute type) of a K1 or K2 call (x first, the compute
    dtype eighth or by name)."""
    dtype = kwargs.get("compute_dtype",
                       args[7] if len(args) > 7 else torch.bfloat16)
    return tuple(args[0].shape) + ("bf16" if dtype == torch.bfloat16
                                   else "f32",)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: torch.device, t_process: float,
            config_path: Optional[str] = None,
            mix_overrides: Optional[dict] = None,
            root: str = spec.ROOT) -> dict:
    """Run the cell and return the result line (a dict). ``config_path``
    and ``mix_overrides`` replace the cell's configuration file and mix
    parameters (the tests run tiny cells on the CPU)."""
    cell = spec.load_cell(cell_name, root)
    mix = dict(cell.mix, **(mix_overrides or {}))
    driver = spec.load_module("drivers", mix["driver"], root)
    run = Run(cell=cell, seed=int(seed), device=device, trace=trace,
              port=port.import_port(),
              config_path=config_path or os.path.join(root,
                                                      cell.config_file),
              mix=mix)
    if trace:
        t = mix.get("trace", {})
        run.tracer = Tracer(device, int(t.get("skip", 1)),
                            int(t.get("active", 1)))
        run.spans = Spans(device, run.tracer)
        _install_spans(run)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
        torch.cuda.reset_peak_memory_stats()

    driver.setup(run)
    _sync(device)
    setup_s = time.perf_counter() - t_process
    if run.tracer is not None:
        run.spans.reset()
        run.tracer.start()
    try:
        driver.window(run, seconds)
        _sync(device)
    finally:
        if run.tracer is not None:
            run.tracer.stop()
    if run.tracer is not None:
        run.tracer.read()
    memory_peak = (torch.cuda.max_memory_allocated()
                   if device.type == "cuda" else 0)

    metrics = {}
    values = dict(driver.end_to_end(run), setup_s=setup_s)
    for m in cell.end_to_end:
        if m.name in values:
            metrics[m.name] = {"value": values[m.name], "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": False, "attempted": run.attempted,
              "failed": run.failed}
    if trace:
        metrics, breakdown = _per_layer(run, cell, root)
        summary = run.tracer.summary
        if summary is not None and run.tracer.window_s:
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = run.tracer.window_s
            result["breakdown"] = breakdown
    result["metrics"] = metrics
    result["device"] = dev

    # the check: the program's state freed, the reference run in its turn
    records = driver.records(run)
    port.unwrap_all()
    run.state.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    nums = check.run_check(records, device)
    # the numbers the cell's limits file names are compared
    checks = {name: {"value": nums[name], "limit": limit}
              for name, limit in cell.limits.items()}
    ok = bool(checks) and all(math.isfinite(c["value"])
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    result["correct"] = ok and run.failed == 0
    # the window has closed: nothing of JAX may be loaded
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
    result["checks"] = checks
    return result


def _per_layer(run: Run, cell: spec.Cell, root: str):
    with open(run.config_path) as f:
        snapshot = json.load(f)
    readings = Readings(run=run, spans=run.spans, trace=run.tracer.summary,
                        trace_window_s=run.tracer.window_s,
                        policy_row_flops=work.policy_row_flops(snapshot),
                        gst_env_flops=work.gst_env_flops(snapshot))
    metrics = {}
    readers = spec.readers(cell, root)
    for m in cell.per_layer:
        value = readers[m.name].read(readings)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    breakdown = {}
    s = run.tracer.summary
    if s is not None:
        breakdown = {"device_ops": [[n, t] for n, t in s.ops[:10]],
                     "idle_gaps": [[n, t] for n, t in s.idle[:10]]}
    return metrics, breakdown
