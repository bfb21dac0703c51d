"""The port's ``test`` CLI for the scripted baselines and the flag-built
configs, against the JAX package's ``test`` CLI.

* The config a scripted run builds from its flags (no snapshot) equals,
  field for field, the one the JAX CLI builds from the same command line
  (its ``main``, with ``evaluate`` replaced by a recorder): the env
  variants, the human count and range, ``--no-randomize-attributes``,
  ``--orca-stale-radii``, ``--gst-matmul-dtype`` and the PPO flags.
* A scripted run on the CPU writes the reference metric line to
  ``<model-dir>/test/test_00000.log`` when the model dir holds no
  snapshot, and takes a snapshot's config when there is one.
* The network policy still needs a model dir.
"""

import dataclasses
import json
import logging
import os
import re

import numpy as np
import pytest

from crowdnav_prediction_attngraph_tpu import test as j_test
from crowdnav_prediction_attngraph_tpu_torch import config as tconfig
from crowdnav_prediction_attngraph_tpu_torch import test as test_cli

COMMANDS = [
    ["--env-name", "CrowdSimVarNum", "--robot-policy", "orca",
     "--human-num", "5"],
    ["--env-name", "CrowdSimPred", "--predict-method", "truth",
     "--human-num", "10", "--robot-policy", "orca", "--orca-stale-radii"],
    ["--env-name", "CrowdSimPred", "--predict-method", "const_vel",
     "--robot-policy", "social_force", "--no-randomize-attributes"],
    ["--env-name", "CrowdSimPredRealGST", "--human-num", "30",
     "--human-num-range", "20", "--robot-policy", "orca",
     "--gst-matmul-dtype", "bf16", "--seed", "7", "--num-processes", "4",
     "--lr", "1e-4"],
]


def jax_cli_config(argv, tmp_path, monkeypatch):
    """The config the JAX test CLI builds for ``argv``: its main runs up to
    ``evaluate``, which records the config instead of running."""
    seen = []

    def record(cfg, *args, **kw):
        seen.append(cfg)
        return {"success_rate": 0.0, "collision_rate": 0.0,
                "timeout_rate": 1.0, "nav_time": 0.0, "path_length": 0.0,
                "intrusion_ratio": 0.0, "min_intrusion_dist": 0.0,
                "collision_cases": [], "timeout_cases": []}
    monkeypatch.setattr(j_test.evaluation, "evaluate", record)
    monkeypatch.setattr(j_test, "load_gst_params", lambda cfg, d: None)
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        j_test.main(argv + ["--model-dir", str(tmp_path / "jax")])
    finally:
        for h in root.handlers[len(before):]:
            root.removeHandler(h)
            h.close()
    return seen[0]


@pytest.mark.parametrize("argv", COMMANDS,
                         ids=["varnum", "truth_stale", "const_vel_norand",
                              "gst_range"])
def test_flag_built_config_matches_jax_cli(argv, tmp_path, monkeypatch):
    expect = dataclasses.asdict(jax_cli_config(argv, tmp_path, monkeypatch))
    args = test_cli._parser().parse_args(argv)
    cfg, from_snapshot = test_cli.load_config(args)
    assert not from_snapshot
    got = dataclasses.asdict(cfg)
    assert got.keys() == expect.keys()
    for group in expect:
        assert got[group] == expect[group], group


@pytest.mark.parametrize("policy", ["orca", "social_force"])
def test_scripted_run_logs_to_the_model_dir(policy, tmp_path):
    model_dir = tmp_path / "baseline"
    res = test_cli.main(["--env-name", "CrowdSimVarNum", "--robot-policy",
                         policy, "--human-num", "4", "--test-case-size", "2",
                         "--device", "cpu", "--model-dir", str(model_dir)])
    assert res["env_steps"] > 0
    with open(model_dir / "test" / "test_00000.log") as f:
        line = f.readline()
    m = re.search(r"Testing success rate: ([\d.]+), collision rate: "
                  r"([\d.]+), timeout rate: ([\d.]+)", line)
    assert m, line
    assert abs(sum(float(x) for x in m.groups()) - 1.0) < 0.011


def test_scripted_run_takes_the_snapshot_config(tmp_path, monkeypatch):
    snap = tconfig.pred_config("const_vel", human_num=3)
    model_dir = tmp_path / "run"
    model_dir.mkdir()
    with open(model_dir / "config.json", "w") as f:
        json.dump(dataclasses.asdict(snap), f)
    seen = []

    def record(cfg, *args, **kw):
        seen.append((cfg, kw["robot_policy"]))
        return evaluate(cfg, *args, **kw)
    evaluate = test_cli.evaluation.evaluate
    monkeypatch.setattr(test_cli.evaluation, "evaluate", record)
    res = test_cli.main(["--model-dir", str(model_dir), "--robot-policy",
                         "orca", "--human-num", "9", "--test-case-size", "1",
                         "--device", "cpu", "--out-dir",
                         str(tmp_path / "eval"), "--orca-stale-radii"])
    cfg, policy = seen[0]
    assert policy == "orca" and cfg.sim.human_num == 3
    assert cfg.env_name == "CrowdSimPred" and cfg.orca.stale_neighbor_radii
    assert np.isfinite(res["path_length"])
    assert os.path.exists(tmp_path / "eval" / "test" / "test_00000.log")


def test_network_policy_needs_a_model_dir():
    with pytest.raises(SystemExit, match="model-dir"):
        test_cli.main(["--device", "cpu"])
