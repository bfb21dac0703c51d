"""Tests of the benchmark harness. Run from the root of the repo:

  python -m pytest benchmark/tests -q -p no:cacheprovider
  python -m pytest benchmark/tests -q -m cuda      # on the card

Tests that need a card carry the ``cuda`` marker and decide inside the test
whether there is one.
"""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA card (skips without one)")


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


# the cells cut to a size the CPU runs in seconds: envs, steps, humans and
# suite cases fewer; every width as the configuration has it
TINY = {"num_processes": 4, "num_steps": 3, "human_num": 4}
TINY_MIX = {
    "ppo_train": {},
    "suite": {"test_size": 4, "warmup_steps": 3, "check_within": 6,
              "check_steps": 2},
    "gym_1env": {"warmup_steps": 3, "check_within": 8, "check_steps": 3},
}


# a configuration with another policy base and no GST, kept as test data:
# DS-RNN in CrowdSimVarNum (``srnn_varnum_h20.json``), its cell in
# ``later_cells.json`` and its limits in ``srnn_fixture_limits.json``
SRNN = "srnn_fixture-train"


@pytest.fixture(scope="session")
def all_cells(tmp_path_factory) -> str:
    """A checkout root whose BENCHMARK.json also holds the cells kept for
    later (``later_cells.json``: the suite and the gym loop, built and
    proven but left out of BENCHMARK.json) and the DS-RNN fixture
    :data:`SRNN`, so their drivers stay tested. Its ``benchmark`` links to
    every file of the benchmark, and its ``limits`` add the fixture's."""
    root = tmp_path_factory.mktemp("all_cells")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "tests", "later_cells.json")) as f:
        later = json.load(f)
    for key, entries in later.items():
        bench[key].extend(entries)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    (root / "benchmark" / "limits").mkdir(parents=True)
    for name in os.listdir(BENCH):
        if name != "limits":
            os.symlink(os.path.join(BENCH, name), root / "benchmark" / name)
    for name in os.listdir(os.path.join(BENCH, "limits")):
        os.symlink(os.path.join(BENCH, "limits", name),
                   root / "benchmark" / "limits" / name)
    os.symlink(os.path.join(BENCH, "tests", "srnn_fixture_limits.json"),
               root / "benchmark" / "limits" / f"{SRNN}.json")
    return str(root)


def tiny_config(cell_name: str, tmp_path, root: str = ROOT) -> str:
    from harness import spec
    cell = spec.load_cell(cell_name, root)
    d = dict(cell.config)
    d["ppo"] = dict(d["ppo"], num_processes=TINY["num_processes"],
                    num_steps=TINY["num_steps"])
    rng = 2 if d["sim"].get("human_num_range") else 0
    d["sim"] = dict(d["sim"], human_num=TINY["human_num"],
                    human_num_range=rng)
    path = os.path.join(str(tmp_path), f"tiny_{cell.config_name}.json")
    with open(path, "w") as f:
        json.dump(d, f)
    return path


def tiny_mix(cell_name: str, root: str = ROOT) -> dict:
    from harness import spec
    return dict(TINY_MIX[spec.load_cell(cell_name, root).traffic])
