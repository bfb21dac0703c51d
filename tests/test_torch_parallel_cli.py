"""The port's ``train --multihost`` CLI on the CPU: two processes over gloo
against one process.

Each case runs ``train`` with all five multi-process flags
(``--multihost --coordinator-address 127.0.0.1:P --num-hosts 2
--process-id r --tp T``) in two subprocesses, torch on one thread: tp = 1
(dp = 2, the envs split) and tp = 2 (dp = 1, the wide attention leaves
stored as pieces). The config is the train CLI test's tiny one
(CrowdSimVarNum, 4 humans, 4 envs x 5 steps, 2 updates) with its time limit
cut to 1.75 s, so that episodes end in every update and ``progress.csv``
gets rows, and the kernel branch in f32 (its plain CPU versions round per
row; see tests/test_torch_parallel.py). Then:

* rank 0 alone writes: rank 1's output directory is never made;
  ``progress.csv`` has the single-process columns, and its row for update
  1 (the multi-process window holds one mean a finished-episode update,
  as in the JAX CLI, so update 0 has no row);
* each checkpoint (params ``.npz``; params, Adam moments, generator states
  and update index in the ``.pt``) is the single-process run's, in its
  layout: params and moments to atol 1e-5, generator states exactly;
* ``--resume`` of the two-process run for a third update equals the
  single-process resume's checkpoint;
* the port's ``test`` CLI scores the two-process run's directory.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from crowdnav_prediction_attngraph_tpu_torch import test as test_cli
from crowdnav_prediction_attngraph_tpu_torch import train as train_cli
from crowdnav_prediction_attngraph_tpu_torch.parallel.launch import free_port

import torch_parallel_workers as workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--env-name", "CrowdSimVarNum", "--human-num", "4",
        "--num-processes", "4", "--num-steps", "5", "--log-interval", "1",
        "--use-linear-lr-decay", "--device", "cpu"]
# the train CLI with the tiny config (torch_parallel_workers.tiny_train_main)
WRAPPER = f"""
import sys
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
import torch_parallel_workers
torch_parallel_workers.tiny_train_main(sys.argv[1:])
"""


def _multihost(out_dirs, tp, extra):
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", WRAPPER, *ARGS, *extra,
         "--output-dir", out_dirs[r], "--multihost",
         "--coordinator-address", f"127.0.0.1:{port}", "--num-hosts", "2",
         "--process-id", str(r), "--tp", str(tp)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out


def _same_checkpoint(path_a, path_b):
    a = torch.load(path_a, weights_only=True)
    b = torch.load(path_b, weights_only=True)
    assert a["update"] == b["update"]
    assert list(a["params"]) == list(b["params"])
    for name in a["params"]:
        np.testing.assert_allclose(a["params"][name].numpy(),
                                   b["params"][name].numpy(), atol=1e-5,
                                   err_msg=name)
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["param_groups"] == ob["param_groups"]
    assert sorted(oa["state"]) == sorted(ob["state"])
    for i, st in oa["state"].items():
        for key, v in st.items():
            np.testing.assert_allclose(v.numpy(), ob["state"][i][key].numpy(),
                                       atol=1e-5, err_msg=f"{i} {key}")
    assert torch.equal(a["generator"], b["generator"])
    assert len(a["env_generators"]) == len(b["env_generators"]) == 4
    for ga, gb in zip(a["env_generators"], b["env_generators"]):
        assert torch.equal(ga, gb)
    assert a["schedule"] == b["schedule"]
    za, zb = np.load(path_a[:-3] + ".npz"), np.load(path_b[:-3] + ".npz")
    assert sorted(za.files) == sorted(zb.files)
    for key in za.files:
        np.testing.assert_allclose(za[key], zb[key], atol=1e-5, err_msg=key)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("single") / "run")
    workers.tiny_train_main(ARGS + ["--output-dir", out,
                                    "--num-env-steps", "40"])
    resumed = out + "_resumed"
    workers.tiny_train_main(ARGS + ["--output-dir", resumed,
                                    "--num-env-steps", "60", "--resume",
                                    os.path.join(out, "checkpoints")])
    return out, resumed


@pytest.mark.parametrize("tp", [1, 2])
def test_multihost_train_matches_single_process(single, tmp_path, tp):
    single_out, single_resumed = single
    outs = [str(tmp_path / "rank0"), str(tmp_path / "rank1")]
    _multihost(outs, tp, ["--num-env-steps", "40"])
    assert not os.path.exists(outs[1])
    ckpt = os.path.join(outs[0], "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["00000.npz", "00000.pt",
                                        "00001.npz", "00001.pt"]
    for step in ("00000", "00001"):
        _same_checkpoint(os.path.join(ckpt, f"{step}.pt"),
                         os.path.join(single_out, "checkpoints",
                                      f"{step}.pt"))
    with open(os.path.join(outs[0], "progress.csv")) as f, \
            open(os.path.join(single_out, "progress.csv")) as g:
        rows, want = list(csv.reader(f)), list(csv.reader(g))
    assert rows[0] == want[0]
    assert [r[0] for r in rows[1:]] == ["1"]
    assert [r[0] for r in want[1:]] == ["0", "1"]
    assert all(np.isfinite(float(v)) for v in rows[1])

    # a third update from the two-process checkpoint
    resumed = [str(tmp_path / "resumed0"), str(tmp_path / "resumed1")]
    _multihost(resumed, tp, ["--num-env-steps", "60", "--resume", ckpt])
    _same_checkpoint(os.path.join(resumed[0], "checkpoints", "00002.pt"),
                     os.path.join(single_resumed, "checkpoints",
                                  "00002.pt"))

    # the port's test CLI scores the two-process run as it is
    res = test_cli.main(["--model-dir", outs[0], "--test-case-size", "2",
                         "--device", "cpu",
                         "--out-dir", str(tmp_path / "eval")])
    assert np.isfinite(res["success_rate"]) and res["env_steps"] > 0
    assert os.listdir(tmp_path / "eval" / "test") == ["test_00001.log"]


def test_tp_needs_multihost():
    with pytest.raises(SystemExit, match="--multihost"):
        train_cli.main(ARGS + ["--tp", "2", "--num-env-steps", "0"])
