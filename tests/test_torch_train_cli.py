"""The port's ``train`` CLI end to end on the CPU at a tiny size: 4 humans,
attn_size 64, 4 envs, 5 steps per update, 2 updates, then a resume for two
more, then the port's ``test`` CLI on the params ``.npz`` it wrote, and on
the run's own checkpoints when no ``--params`` is given. ``--policy-base
srnn`` trains DS-RNN through the same CLI, in CrowdSimVarNum and in the GST
env (DS-RNN's spatial-edge GRU takes their 2- and 12-wide edges), and
``test --model-dir`` scores the run with it.

The time limit is cut to 2.5 s so that episodes end inside the run (the
progress row is written only once episodes have finished, as in the JAX
package). The default config keeps the kernel branch in bf16, so on the CPU
every update runs the autograd.Function with the plain K1 and K2.
"""

import csv
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from crowdnav_prediction_attngraph_tpu_torch import test as test_cli
from crowdnav_prediction_attngraph_tpu_torch import train as train_cli
from crowdnav_prediction_attngraph_tpu_torch.models import policy as t_policy
from crowdnav_prediction_attngraph_tpu_torch.models.srnn import SRNN
from crowdnav_prediction_attngraph_tpu_torch.utils import checkpoint

# the JAX package's progress.csv columns, in order (train.py:307-317)
JAX_COLUMNS = ["misc/nupdates", "misc/total_timesteps", "misc/lr", "fps",
               "eprewmean", "eprewmean_env", "loss/policy_entropy",
               "loss/policy_loss", "loss/value_loss"]
ARGS = ["--human-num", "4", "--num-processes", "4", "--num-steps", "5",
        "--log-interval", "1", "--eval-interval", "1", "--eval-size", "2",
        "--use-linear-lr-decay", "--device", "cpu"]
# modules whose params sit before, in or after the human-human attention
ATTN = ("embed_0", "embed_1", "q_linear", "k_linear", "v_linear",
        "mha_in_proj", "mha_out_proj")


@pytest.fixture
def tiny(monkeypatch):
    build = train_cli.build_config

    def build_tiny(args):
        cfg = build(args)
        return cfg.replace(
            env=dataclasses.replace(cfg.env, time_limit=2.5),
            network=dataclasses.replace(cfg.network, attn_size=64))
    monkeypatch.setattr(train_cli, "build_config", build_tiny)


def test_train_writes_progress_checkpoints_and_resumes(tiny, tmp_path):
    out = str(tmp_path / "run")
    ts = train_cli.main(ARGS + ["--output-dir", out, "--num-env-steps", "40"])
    assert ts.model.cfg.network.use_pallas_attention

    with open(os.path.join(out, "progress.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == JAX_COLUMNS
    assert [r[0] for r in rows[1:]] == ["1"]
    assert all(math.isfinite(float(v)) for v in rows[1])
    ckpt = os.path.join(out, "checkpoints")
    assert checkpoint.latest_step(ckpt) == 1
    for name in ("00000.pt", "00000.npz", "00001.pt", "00001.npz"):
        assert os.path.exists(os.path.join(ckpt, name)), name
    with open(os.path.join(out, "best.json")) as f:
        assert json.load(f)["update"] == 1
    with open(os.path.join(out, "eval_history.csv")) as f:
        assert [ln.split(",")[0] for ln in f.read().splitlines()] == ["1"]

    # one update moved the attention block's params: the fold and K1/K2
    # carry gradients to every module there
    cfg = ts.model.cfg
    init = t_policy.init_params(
        cfg, torch.Generator().manual_seed(cfg.ppo.seed), "cpu").state_dict()
    first = torch.load(os.path.join(ckpt, "00000.pt"),
                       weights_only=True)["params"]
    for mod in ATTN:
        names = [k for k in init if f"spatial_attn.{mod}" in k]
        assert names and any(not torch.equal(init[k], first[k])
                             for k in names), mod

    # resume: updates 2 and 3 continue the saved optimizer state (the envs
    # start afresh, as in the JAX package, so episodes end in update 3)
    ts2 = train_cli.main(ARGS + ["--output-dir", out, "--num-env-steps", "80",
                                 "--resume", ckpt])
    steps = {int(st["step"]) for st in ts2.optimizer.state.values()}
    assert steps == {4 * cfg.ppo.ppo_epoch * cfg.ppo.num_mini_batch}
    with open(os.path.join(out, "progress.csv")) as f:
        assert [r[0] for r in csv.reader(f)][1:] == ["1", "3"]
    assert checkpoint.latest_step(ckpt) == 3

    # the params .npz loads in the port's test CLI
    res = test_cli.main(["--model-dir", out, "--params",
                         os.path.join(ckpt, "00003.npz"), "--step", "3",
                         "--test-case-size", "2", "--device", "cpu",
                         "--out-dir", str(tmp_path / "eval")])
    assert np.isfinite(res["success_rate"]) and res["env_steps"] > 0
    assert os.path.exists(tmp_path / "eval" / "test" / "test_00003.log")


def test_checkpoint_round_trip_restores_optimizer_and_generators(tiny,
                                                                  tmp_path):
    out = str(tmp_path / "run")
    ts = train_cli.main(ARGS + ["--output-dir", out, "--num-env-steps", "20",
                                "--eval-interval", "0"])
    ckpt = os.path.join(out, "checkpoints")
    saved = torch.load(os.path.join(ckpt, "00000.pt"), weights_only=True)
    fresh = train_cli.main(ARGS + ["--output-dir", str(tmp_path / "other"),
                                   "--num-env-steps", "0"])
    fresh, nxt = checkpoint.restore_train_state(ckpt, fresh)
    assert nxt == 1
    for a, b in zip(fresh.model.parameters(), ts.model.parameters()):
        assert torch.equal(a, b)
    for key in ("exp_avg", "exp_avg_sq", "step"):
        for p, q in zip(fresh.model.parameters(), ts.model.parameters()):
            assert torch.equal(fresh.optimizer.state[p][key],
                               ts.optimizer.state[q][key])
    assert torch.equal(fresh.generator.get_state(), saved["generator"])
    assert fresh.schedule.get_last_lr() == ts.schedule.get_last_lr()


def test_test_cli_scores_the_runs_own_checkpoints(tiny, tmp_path,
                                                  monkeypatch):
    out = str(tmp_path / "run")
    train_cli.main(ARGS + ["--output-dir", out, "--num-env-steps", "40",
                           "--eval-interval", "0"])
    ckpt = os.path.join(out, "checkpoints")
    assert checkpoint.latest_step(ckpt) == 1
    loaded = []

    def record(cfg, params, device):
        loaded.append(params)
        return t_policy.load_policy(cfg, params, device)
    monkeypatch.setattr(test_cli, "load_policy", record)
    common = ["--model-dir", out, "--test-case-size", "2", "--device", "cpu",
              "--out-dir", str(tmp_path / "eval")]

    # no --params: the run's latest checkpoint, and the log named by it
    res = test_cli.main(common)
    assert np.isfinite(res["success_rate"]) and res["env_steps"] > 0
    assert loaded == [os.path.join(ckpt, "00001.npz")]
    assert os.listdir(tmp_path / "eval" / "test") == ["test_00001.log"]
    # --ckpt-step picks an earlier one
    test_cli.main(common + ["--ckpt-step", "0"])
    assert loaded[-1] == os.path.join(ckpt, "00000.npz")
    assert os.path.exists(tmp_path / "eval" / "test" / "test_00000.log")

    # neither checkpoints nor --params, and not the flagship run: an error
    # before anything is scored
    other = tmp_path / "other"
    other.mkdir()
    with pytest.raises(SystemExit, match="--params"):
        test_cli.main(["--model-dir", str(other), "--device", "cpu"])
    assert len(loaded) == 2
    # the flagship run scores its committed export, step 10250
    assert test_cli.resolve_params(test_cli.DEFAULT_MODEL_DIR) == (
        test_cli.DEFAULT_PARAMS, 10250)


def test_policy_base_defaults_to_the_attention_graph():
    args = train_cli._parser().parse_args([])
    assert args.policy_base == "selfAttn_merge_srnn"
    assert train_cli.build_config(args).robot.policy == "selfAttn_merge_srnn"
    args = train_cli._parser().parse_args(["--policy-base", "srnn"])
    assert train_cli.build_config(args).robot.policy == "srnn"
    with pytest.raises(SystemExit):
        train_cli._parser().parse_args(["--policy-base", "lstm"])


@pytest.mark.parametrize("env_name", ["CrowdSimVarNum",
                                      "CrowdSimPredRealGST"])
def test_train_and_test_carry_ds_rnn(env_name, tiny, tmp_path, monkeypatch):
    out = str(tmp_path / "run")
    ts = train_cli.main(ARGS + ["--output-dir", out, "--num-env-steps", "20",
                                "--eval-interval", "0", "--env-name",
                                env_name, "--policy-base", "srnn"])
    assert isinstance(ts.model.base, SRNN)
    with open(os.path.join(out, "config.json")) as f:
        snap = json.load(f)
    assert snap["robot"]["policy"] == "srnn" and snap["env_name"] == env_name
    assert checkpoint.latest_step(os.path.join(out, "checkpoints")) == 0
    loaded = []

    def record(cfg, params, device):
        loaded.append(t_policy.load_policy(cfg, params, device))
        return loaded[-1]
    monkeypatch.setattr(test_cli, "load_policy", record)
    res = test_cli.main(["--model-dir", out, "--test-case-size", "2",
                         "--device", "cpu", "--out-dir",
                         str(tmp_path / "eval")])
    assert len(loaded) == 1 and isinstance(loaded[0].base, SRNN)
    assert np.isfinite(res["success_rate"]) and res["env_steps"] > 0
    for name, p in loaded[0].state_dict().items():
        assert torch.equal(p, ts.model.state_dict()[name]), name
