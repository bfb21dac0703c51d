"""The result line's keys, the check for JAX by whole top-level module
name, and the refusal to run without a card."""

import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import BENCH, ROOT, tiny_config, tiny_mix
from harness import runner

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(tmp_path, trace, all_cells):
    res = runner.execute("flagship-gym", 3141592653, 3.0, trace,
                         torch.device("cpu"), time.perf_counter(),
                         config_path=tiny_config("flagship-gym", tmp_path,
                                                 all_cells),
                         root=all_cells,
                         mix_overrides=dict(tiny_mix("flagship-gym",
                                                     all_cells),
                                            trace={"tick": "step",
                                                   "skip": 1,
                                                   "active": 2}))
    want = KEYS[:4] + (["breakdown"] if trace else []) + KEYS[4:]
    assert sorted(res) == sorted(want)
    assert list(res)[-1] == "checks"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(name.endswith(".gym") for name in res["metrics"])
    else:
        assert set(res["metrics"]) == {"gym_step_ms_p95", "setup_s"}
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("jaxlike", "crowdnav_prediction_attngraph_tpu_torch.x",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "crowdnav_prediction_attngraph_tpu.env",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert runner.forbidden_modules() == ["crowdnav_prediction_attngraph_tpu",
                                          "jax"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, f"{BENCH}/run.py", "--workload",
                        "flagship-train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
