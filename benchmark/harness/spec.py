"""What a run is: its cell, configuration, traffic mix, per-layer metrics and
limits, all found by name from ``BENCHMARK.json`` and the files beside it.

A cell names a configuration and a traffic mix. The configuration is
``configs/<name>.json`` (the file ``BENCHMARK.json`` gives), the mix is
``mixes/<traffic>.json`` and names the driver (``drivers/<driver>.py``) that
runs it, each per-layer metric ``<family>.<suffix>`` is read by
``metrics/<family>.py``, and the limits of the cell's correctness check are
``limits/<cell>.json``. A new cell, configuration, mix, driver, metric or
limit file is found by its name alone: nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]
    moves: Optional[str] = None

    @property
    def family(self) -> str:
        return self.name.split(".", 1)[0]


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config_file: str
    config: dict            # the configuration file's contents
    traffic: str
    mix: dict               # the mix file's contents
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]
    limits: dict            # limits/<cell>.json: {number: limit}


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _metric(d: dict) -> Metric:
    return Metric(name=d["name"], unit=d["unit"], better=d["better"],
                  source=d["source"], workloads=d.get("workloads"),
                  moves=d.get("moves"))


def _reports(metric: Metric, cell: str) -> bool:
    return metric.workloads is None or cell in metric.workloads


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise SystemExit(f"no BENCHMARK.json at {root}")
    return _load_json(path)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with everything its run reads."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    c = configs[w["config"]]
    bench_dir = os.path.join(root, "benchmark")
    limits_path = os.path.join(bench_dir, "limits", f"{name}.json")
    return Cell(
        name=name, config_name=c["name"], config_file=c["file"],
        config=_load_json(os.path.join(root, c["file"])),
        traffic=w["traffic"],
        mix=_load_json(os.path.join(bench_dir, "mixes",
                                    f"{w['traffic']}.json")),
        chips=int(w["chips"]),
        end_to_end=[m for m in map(_metric, bench["end_to_end"])
                    if _reports(m, name)],
        per_layer=[m for m in map(_metric, bench["per_layer"])
                   if _reports(m, name)],
        limits=(_load_json(limits_path)["limits"]
                if os.path.exists(limits_path) else {}))


def load_module(kind: str, name: str, root: str = ROOT):
    """``benchmark/<kind>/<name>.py`` as a module (a driver or a metric
    reader)."""
    if not NAME.match(name) or "." in name:
        raise SystemExit(f"bad {kind} name {name!r}")
    path = os.path.join(root, "benchmark", kind, f"{name}.py")
    if not os.path.exists(path):
        raise SystemExit(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readers(cell: Cell, root: str = ROOT) -> Dict[str, object]:
    """{per-layer metric name: its reader module} for the cell."""
    return {m.name: load_module("metrics", m.family, root)
            for m in cell.per_layer}
