"""The sparse-GST cell ``sparsegst-train``: found by name from BENCHMARK.json
and its files alone, its configuration config 5's but for the GST's edge
selector, ghost, precision and weights, its ``gst`` limit failing the
control at a tiny size, a traced tiny run on the CPU (the env and the GST
bit-equal to the reference), the GST's FLOP and byte counts, and the readers of
``gst_device_ms`` and ``gst_roofline``."""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, tiny_config, tiny_mix
import calibrate
from harness import spec, work
from harness.trace import TraceSummary

CELL = "sparsegst-train"
CONFIG = "config5_sparsegst_h10-50"
NUMBERS = {"env", "gst", "act", "loss", "update", "batch"}
# the numbers the program reads 0 at a tiny size too (bit-equal env and
# GST, every env once in the minibatches); the bf16 policy's rounding moves
# the others more over 4 envs than over the cell's 256
TINY_EXACT = ("env", "gst", "batch")
TRAIN_METRICS = {"rollout_s.train", "update_s.train", "env_step_ms.train",
                 "env_step_kernels.train", "gst_pretext_ms.train",
                 "act_ms.train", "k1_roofline.train", "k2_roofline.train",
                 "device_idle.train", "update_kernels.train",
                 "gst_device_ms.train", "gst_roofline.train"}
# what the configuration changes from config 5's, by group
CHANGED = {"pred": {"spatial_num_heads_edges", "ghost", "matmul_dtype"},
           "benchmark": {"gst_weights", "source", "changed", "assumed"}}


def test_cell_loads_through_spec():
    cell = spec.load_cell(CELL)
    assert (cell.config_name, cell.traffic, cell.chips) == (CONFIG,
                                                            "ppo_train", 1)
    assert cell.mix["driver"] == "ppo_train"
    p = cell.config["pred"]
    assert (p["spatial_num_heads_edges"], p["ghost"], p["matmul_dtype"],
            p["tau"]) == (4, True, "f32", 0.03)
    gst = os.path.join(ROOT, cell.config["benchmark"]["gst_weights"])
    assert os.path.exists(gst)
    assert {m.name for m in cell.end_to_end} == {"train_env_steps_per_s",
                                                 "setup_s"}
    assert {m.name for m in cell.per_layer} == TRAIN_METRICS
    assert set(spec.readers(cell)) == TRAIN_METRICS
    bench = spec.load_benchmark()
    (c,) = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert c["reduced"] == ["num_processes"]


def test_configuration_is_config5_but_for_the_sparse_gst():
    with open(os.path.join(BENCH, "configs", f"{CONFIG}.json")) as f:
        sparse = json.load(f)
    with open(os.path.join(BENCH, "configs", "config5_gst_h10-50.json")) as f:
        dense = json.load(f)
    assert sparse.keys() == dense.keys()
    for group in dense:
        if group not in CHANGED:
            assert sparse[group] == dense[group], group
            continue
        for key in set(dense[group]) | set(sparse[group]):
            if key not in CHANGED[group]:
                assert sparse[group][key] == dense[group][key], (group, key)
    assert sparse["benchmark"]["reduced"] == dense["benchmark"]["reduced"]
    assert set(sparse["benchmark"]["changed"]) == {
        "pred.spatial_num_heads_edges", "pred.ghost", "pred.matmul_dtype",
        "gst_weights"}


def test_limits_are_found_and_fail_the_control(tmp_path):
    cell = spec.load_cell(CELL)
    assert set(cell.limits) == NUMBERS and cell.limits["batch"] == 0
    r = calibrate.readings(CELL, 3141592653, 1.0, torch.device("cpu"), (),
                           config_path=tiny_config(CELL, tmp_path),
                           mix_overrides=tiny_mix(CELL))
    prog, ctrl = r["program"], r["control"]
    # the env and the GST give the reference's bits at any size; the
    # policy's and the update's limits are set at the cell's 7,680 rows
    assert all(prog[k] == 0.0 for k in TINY_EXACT), prog
    assert ctrl["gst"] > cell.limits["gst"] and \
        ctrl["gst"] > 3 * prog["gst"], r


def test_traced_tiny_run_is_correct(tmp_path):
    from harness import runner
    res = runner.execute(CELL, 2 ** 31 + 54321, 1.0, True,
                         torch.device("cpu"), time.perf_counter(),
                         config_path=tiny_config(CELL, tmp_path),
                         mix_overrides=dict(tiny_mix(CELL),
                                            trace={"tick": "iteration",
                                                   "skip": 1, "active": 1}))
    assert set(res["checks"]) == NUMBERS and res["failed"] == 0
    assert all(res["checks"][k]["value"] == 0.0 for k in TINY_EXACT), \
        res["checks"]
    assert set(res["metrics"]) <= TRAIN_METRICS
    # the CPU launches no device ops: the trace's readers read nothing
    assert "gst_device_ms.train" not in res["metrics"]
    assert "gst_roofline.train" not in res["metrics"]


# --- the GST's FLOPs and the readers -----------------------------------------

def _snapshot(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_gst_flops_count_the_selector_at_config5():
    gst = spec.load_module("flops", "gst")
    snap = _snapshot(CONFIG)
    f = gst.frame_flops(snap["pred"], 50)
    # edge embedding, q/k/v, QK^T and PV, the logit MLP over 50 targets x
    # 51 candidates (the ghost's too)
    edges = 50 * 51
    want = (edges * 2 * 6 * 64 + edges * 3 * 2 * 64 * 64
            + 4 * 50 * 51 * 51 * 64 + edges * 4 * (2 * 16 * 16 + 2 * 16))
    assert f["selector"] == want == 103_468_800
    out = gst.pretext_flops(snap)
    assert set(out) == {"f32"}
    # 256 envs, 9 spatial frames, 5 heads
    assert out["f32"] > 256 * 9 * want
    dense = gst.pretext_flops(_snapshot("config5_gst_h10-50"))
    assert set(dense) == {"f32", "bf16"} and dense["bf16"] > dense["f32"]
    assert gst.pretext_flops(_snapshot("srnn_varnum_h20")) == {}


@pytest.mark.parametrize("config,uniforms", [
    (CONFIG, 4 * 256 * 9 * 50 * 4 * 51), ("config5_gst_h10-50", 0)])
def test_gst_bytes_count_inputs_uniforms_weights_outputs(config, uniforms):
    gst = spec.load_module("flops", "gst")
    snap = _snapshot(config)
    # 256 envs x 50 humans: the f32 history and its mask over 5 frames, the
    # f32 weights as stored, the 5 f32 Gaussians of 5 values and the mask
    with np.load(os.path.join(ROOT, snap["benchmark"]["gst_weights"])) as w:
        weights = 4 * sum(w[k].size for k in w.files)
    want = (256 * 50 * 5 * 9 + uniforms + weights
            + 256 * 50 * (5 * 5 * 4 + 1))
    assert gst.pretext_bytes(snap, ROOT) == want
    assert gst.pretext_bytes(_snapshot("srnn_varnum_h20"), ROOT) == 0


def _summary(range_time, range_calls):
    return TraceSummary(busy_s=0.0, ops=[], range_time=range_time,
                        range_ops={}, range_calls=range_calls, idle=[])


def _readings(trace, config=CONFIG):
    run = types.SimpleNamespace(config_path=os.path.join(
        BENCH, "configs", f"{config}.json"))
    return types.SimpleNamespace(trace=trace, run=run)


@pytest.mark.parametrize("time_s,calls,want", [
    ({"gst_pretext": 0.6}, {"gst_pretext": 30}, 20.0),
    ({"gst_pretext": 0.6, "update": 1.0}, {"gst_pretext": 20}, 30.0),
    ({}, {"gst_pretext": 30}, None),
    ({"gst_pretext": 0.6}, {}, None),
])
def test_gst_device_ms_reads_time_over_calls(time_s, calls, want):
    reader = spec.load_module("metrics", "gst_device_ms")
    got = reader.read(_readings(_summary(time_s, calls)))
    assert got == (pytest.approx(want) if want is not None else None)


@pytest.mark.parametrize("config", [CONFIG, "config5_gst_h10-50",
                                    "flagship_gst_h20"])
def test_gst_roofline_is_the_bound_over_the_device_time(config):
    reader = spec.load_module("metrics", "gst_roofline")
    gst = spec.load_module("flops", "gst")
    flops = gst.pretext_flops(_snapshot(config))
    bound = max(sum(n / work.PEAK_FLOPS[d] for d, n in flops.items()),
                gst.pretext_bytes(_snapshot(config), ROOT) / work.PEAK_BYTES)
    got = reader.read(_readings(_summary({"gst_pretext": 30 * 4 * bound},
                                         {"gst_pretext": 30}), config))
    assert got == pytest.approx(25.0)
    assert reader.read(_readings(None, config)) is None
    assert reader.read(_readings(_summary({}, {}), config)) is None


def test_gst_roofline_reads_nothing_without_a_gst():
    reader = spec.load_module("metrics", "gst_roofline")
    trace = _summary({"gst_pretext": 0.1}, {"gst_pretext": 1})
    assert reader.read(_readings(trace, "srnn_varnum_h20")) is None
