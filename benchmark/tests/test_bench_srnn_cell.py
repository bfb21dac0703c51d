"""The DS-RNN cell ``srnn-train``: found by name from BENCHMARK.json and its
files alone, its configuration the DS-RNN test data's, its limits failing
the control at a tiny size, a traced tiny run on the CPU, and the reader
of ``update_kernels``."""

import json
import os
import time
import types

import pytest
import torch

from conftest import BENCH, tiny_config, tiny_mix
import calibrate
from harness import spec
from harness.trace import TraceSummary

CELL = "srnn-train"
NUMBERS = {"env", "act", "loss", "grad", "update", "batch"}
TRAIN_METRICS = {"rollout_s.train", "update_s.train", "env_step_ms.train",
                 "env_step_kernels.train", "act_ms.train",
                 "device_idle.train", "mfu.train", "update_kernels.train"}


def test_cell_loads_through_spec():
    cell = spec.load_cell(CELL)
    assert (cell.config_name, cell.traffic, cell.chips) == (
        "srnn_varnum_h20", "ppo_train", 1)
    assert cell.mix["driver"] == "ppo_train"
    c = cell.config
    assert c["robot"]["policy"] == "srnn"
    assert c["env_name"] == "CrowdSimVarNum"
    assert c["sim"]["predict_method"] == "none"
    assert (c["sim"]["human_num"], c["sim"]["human_num_range"]) == (20, 0)
    assert (c["ppo"]["num_processes"], c["ppo"]["num_steps"],
            c["ppo"]["ppo_epoch"], c["ppo"]["num_mini_batch"]) == (64, 30,
                                                                   5, 2)
    assert c["benchmark"]["policy_weights"] == "seeded"
    assert "gst_weights" not in c["benchmark"]
    assert c["benchmark"]["reduced"] == {}
    assert {m.name for m in cell.end_to_end} == {"train_env_steps_per_s",
                                                 "setup_s"}
    # no GST and no K1/K2: their metrics are not the cell's
    assert {m.name for m in cell.per_layer} == TRAIN_METRICS
    assert set(spec.readers(cell)) == TRAIN_METRICS


def test_configuration_is_the_ds_rnn_test_data():
    with open(os.path.join(BENCH, "configs", "srnn_varnum_h20.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "tests", "srnn_varnum_h20.json")) as f:
        assert cfg == json.load(f)


def test_limits_are_found_and_fail_the_control(tmp_path):
    cell = spec.load_cell(CELL)
    assert set(cell.limits) == NUMBERS and cell.limits["batch"] == 0
    r = calibrate.readings(CELL, 2718281828, 1.0, torch.device("cpu"), (),
                           config_path=tiny_config(CELL, tmp_path),
                           mix_overrides=tiny_mix(CELL))
    prog, ctrl = r["program"], r["control"]
    assert all(prog[k] <= cell.limits[k] for k in NUMBERS), prog
    assert [k for k in cell.limits
            if ctrl[k] > cell.limits[k] and ctrl[k] > 3 * prog[k]], r


def test_traced_tiny_run_is_correct(tmp_path):
    from harness import runner
    res = runner.execute(CELL, 2 ** 31 + 12345, 1.0, True,
                         torch.device("cpu"), time.perf_counter(),
                         config_path=tiny_config(CELL, tmp_path),
                         mix_overrides=dict(tiny_mix(CELL),
                                            trace={"tick": "iteration",
                                                   "skip": 1, "active": 1}))
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == NUMBERS
    # the CPU launches no device ops: the trace's counts read nothing
    assert set(res["metrics"]) <= TRAIN_METRICS
    assert "update_kernels.train" not in res["metrics"]


def _readings(trace):
    return types.SimpleNamespace(trace=trace)


def _summary(range_ops, range_calls):
    return TraceSummary(busy_s=0.0, ops=[], range_time={},
                        range_ops=range_ops, range_calls=range_calls,
                        idle=[])


@pytest.mark.parametrize("ops,calls,want", [
    ({"update": 17530, "env_step": 900}, {"update": 1, "env_step": 30},
     17530.0),
    ({"update": 20000}, {"update": 2}, 10000.0),
    ({"env_step": 900}, {"env_step": 30}, None),
    ({"update": 0}, {"update": 1}, None),
    ({}, {}, None),
])
def test_update_kernels_reads_ops_over_calls(ops, calls, want):
    reader = spec.load_module("metrics", "update_kernels")
    assert reader.read(_readings(_summary(ops, calls))) == want


def test_update_kernels_reads_nothing_without_a_trace():
    reader = spec.load_module("metrics", "update_kernels")
    assert reader.read(_readings(None)) is None
