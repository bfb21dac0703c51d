"""Recorder + action replay on the port (JAX tests/test_recorder_replay.py;
reference recorder.py:52-56 + crowd_sim.py:169-173): record an episode,
replay the saved action CSV through the env, and require the replayed
positions to equal the recording bit for bit, with the ORCA robot and with
a network policy from a seeded ``init_params``. The port's ``Recorder``
writes the JAX ``Recorder``'s files byte for byte."""

import csv
import os

import numpy as np
import pytest
import torch

from crowdnav_prediction_attngraph_tpu.utils.recorder import (
    Recorder as JRecorder)
from crowdnav_prediction_attngraph_tpu_torch import sim2real
from crowdnav_prediction_attngraph_tpu_torch.config import varnum_config
from crowdnav_prediction_attngraph_tpu_torch.models import policy as pmod
from crowdnav_prediction_attngraph_tpu_torch.utils.recorder import Recorder


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg():
    return varnum_config(human_num=3)


def read_rows(path):
    with open(path) as f:
        return [[float(x) for x in row] for row in csv.reader(f)]


def test_record_save_load_roundtrip(tmp_path):
    rec, steps = sim2real.record_sim_episode(
        small_cfg(), case_idx=3, robot_policy="orca", out_dir=str(tmp_path),
        max_steps=12, device="cpu")
    assert 0 < steps <= 12
    loaded = Recorder.load_actions(str(tmp_path / "3_actions.csv"))
    assert loaded.shape == (steps, 2)
    assert len(read_rows(tmp_path / "3_positions.csv")) == steps
    assert len(read_rows(tmp_path / "3_goals.csv")) == 1
    assert rec.action_list == []           # save_episode starts a new episode


@pytest.mark.parametrize("robot", ["orca", "network"])
def test_replay_is_bit_exact(tmp_path, robot):
    cfg = small_cfg()
    policy = (pmod.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
              if robot == "network" else None)
    _, steps = sim2real.record_sim_episode(
        cfg, case_idx=5, robot_policy=robot, policy=policy,
        out_dir=str(tmp_path), max_steps=15, device="cpu")
    actions = Recorder.load_actions(str(tmp_path / "5_actions.csv"))
    replayed = sim2real.replay_actions(cfg, actions, case_idx=5, device="cpu")
    recorded = np.asarray(read_rows(tmp_path / "5_positions.csv"))
    assert replayed.shape == recorded.shape == (steps, 2)
    np.testing.assert_array_equal(replayed.astype(np.float32),
                                  recorded.astype(np.float32))
    # the robot moved: the check is not vacuous
    assert np.abs(np.diff(recorded, axis=0)).sum() > 0


def test_files_byte_equal_to_jax_recorder(tmp_path):
    rng = np.random.RandomState(0)
    recs = (Recorder(), JRecorder())
    for _ in range(4):
        row = (rng.randn(2).astype(np.float32), rng.randn(2).astype(np.float32),
               float(rng.randn()), rng.randn(2), rng.randn(2))
        for r in recs:
            r.add_step(*row)
    for r in recs:
        r.robot_goal.append([1.5, -2.0])
    recs[0].save_episode(str(tmp_path / "port"), 7)
    recs[1].save_episode(str(tmp_path / "jax"), 7)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 6
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
