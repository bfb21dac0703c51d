"""BENCHMARK.json against the rules for its names and units, and discovery of
configurations, mixes, drivers and metrics by name from files alone."""

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["benchmark"]
    assert all(LINE.match(w) for w in b["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    b = _bench()
    names = [e["name"] for e in b[group]]
    assert len(names) == len(set(names))
    for e in b[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and group != "end_to_end" and group != "per_layer":
                assert LINE.match(e[key])
        if group == "per_layer":
            assert LINE.match(e["layer"])
            assert e["moves"] in {m["name"] for m in b["end_to_end"]}
        if group == "workloads":
            assert e["chips"] in (1, 4) and LINE.match(e["why"])
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        if group == "configs":
            assert all(NAME.match(k) for k in e["reduced"])


def test_every_cell_reports_what_it_must():
    b = _bench()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        e2e = {m.name for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m.moves in e2e
        assert os.path.exists(os.path.join(BENCH, "drivers",
                                           cell.mix["driver"] + ".py"))
        assert set(spec.readers(cell)) == {m.name for m in cell.per_layer}
        assert cell.limits, f"{w['name']} has no limits"


def test_discovery_by_new_files_alone(tmp_path):
    """A new configuration, mix and per-layer metric are found from new
    files and a new entry of BENCHMARK.json, with no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    cfg = json.loads((root / "benchmark" / "configs" /
                      "flagship_gst_h20.json").read_text())
    cfg["sim"]["human_num"] = 10
    (root / "benchmark" / "configs" / "flagship_h10.json").write_text(
        json.dumps(cfg))
    mix = json.loads((root / "benchmark" / "mixes" /
                      "ppo_train.json").read_text())
    mix["trace"] = dict(mix["trace"], skip=2)
    (root / "benchmark" / "mixes" / "ppo_train_skip2.json").write_text(
        json.dumps(mix))
    (root / "benchmark" / "metrics" / "new_count.py").write_text(
        "def read(r):\n    return 7.0\n")
    (root / "benchmark" / "limits" / "h10-train.json").write_text(
        json.dumps({"limits": {"env": 1.0}}))
    b["configs"].append({"name": "flagship_h10", "source": "x",
                         "file": "benchmark/configs/flagship_h10.json",
                         "reduced": ["human_num"], "why": "x"})
    b["workloads"].append({"name": "h10-train", "config": "flagship_h10",
                           "traffic": "ppo_train_skip2", "chips": 1,
                           "why": "x"})
    b["per_layer"].append({"name": "new_count.train", "unit": "n",
                           "better": "lower", "source": "host_clock",
                           "layer": "train loop",
                           "moves": "train_env_steps_per_s",
                           "workloads": ["h10-train"]})
    e2e = {m["name"]: m for m in b["end_to_end"]}
    e2e["train_env_steps_per_s"]["workloads"].append("h10-train")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("h10-train", str(root))
    assert cell.config["sim"]["human_num"] == 10
    assert cell.mix["trace"]["skip"] == 2
    assert cell.mix["driver"] == "ppo_train"
    assert cell.limits == {"env": 1.0}
    readers = spec.readers(cell, str(root))
    assert readers["new_count.train"].read(None) == 7.0
    assert {m.name for m in cell.end_to_end} == {"train_env_steps_per_s",
                                                 "setup_s"}
    assert "new_count.train" in {m.name for m in cell.per_layer}
    assert spec.load_module("drivers", "ppo_train", str(root)).window
