"""The port's data- and tensor-parallel PPO iteration against its
single-process iteration, on a gloo CPU world.

One world of 4 processes (``torch_parallel_workers.iteration_world``,
spawned once for the module, torch on one thread each) runs one iteration
of the JAX parallel tests' ``small_cfg`` (8 envs x 4 steps, 2 minibatches,
1 epoch, at 4 humans) in each of three layouts:

* dp = 2 (ranks 2 and 3 sit out), through the kernel branch;
* dp 2 x tp 2 with ``use_ring_attention`` and the einsum branch: the
  agent axis over the ring, the 512-wide leaves stored as tp pieces;
* dp 2 x tp 2 through the kernel branch on the gathered pieces.

Each is held against the port's single-process iteration from the same
seed, at the JAX tests' bounds (tests/test_parallel_train.py): value loss
rtol 1e-4 and every param atol 1e-5; with the ring rtol 2e-4 and atol
2e-5. The kernel branch runs in f32 here: its plain CPU versions round per
row, while the bf16 ones round products whose f32 sums differ in the last
bit with the batch's size. The finished-episode metrics (the time limit is
cut so that every env ends an episode) must equal the single process's,
and ``done_count`` / ``done_sum`` / ``done_sum_env`` must equal the counts
and sums of the batch's ``done_returns``.
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from crowdnav_prediction_attngraph_tpu_torch.models import distributions
from crowdnav_prediction_attngraph_tpu_torch.parallel.mesh import (
    param_shard_dim, plain_name)

import torch_parallel_workers as workers

WORLD = 4
BOUNDS = {"dp2": (1e-4, 1e-5), "dp2_tp2_ring": (2e-4, 2e-5),
          "dp2_tp2_kernel": (1e-4, 1e-5)}


@pytest.fixture(scope="module")
def parallel_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("iteration")
    mp.spawn(workers.iteration_world, nprocs=WORLD,
             args=(WORLD, str(d / "store"), str(d / "out")))
    return [torch.load(f"{d / 'out'}.{r}", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def single_runs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {case: workers.single_iteration(case)
                for case in workers.ITERATION_CASES}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(workers.ITERATION_CASES))
def test_iteration_matches_single_process(parallel_runs, single_runs, case):
    dp, tp, use_ring, _ = workers.ITERATION_CASES[case]
    rtol, atol = BOUNDS[case]
    params, metrics = single_runs[case]
    for rank in range(dp * tp):
        got = parallel_runs[rank][case]
        assert got["envs"] == 8 // dp
        np.testing.assert_allclose(float(got["metrics"]["value_loss"]),
                                   float(metrics["value_loss"]), rtol=rtol)
        assert set(got["params"]) == set(params)
        for name, want in params.items():
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       want.numpy(), atol=atol,
                                       err_msg=f"{name} rank {rank}")
        # every rank ends with the same whole params
        for name, t in got["params"].items():
            assert torch.equal(t, parallel_runs[0][case]["params"][name])
        # the ring ran in the ring case only (rollout and update forwards)
        assert (got["ring_calls"] > 0) == (use_ring and tp > 1)
        # under tp the wide leaves and their Adam moments are pieces
        pieces = got["pieces"]
        wide = {n for n, t in params.items()
                if param_shard_dim(n, t.shape) is not None}
        assert len(wide) == 6
        if tp == 1:
            assert not pieces
            continue
        assert {plain_name(n) for n in pieces} == wide
        for n, (shape, moment) in pieces.items():
            full = params[plain_name(n)].shape
            want = list(full)
            want[param_shard_dim(plain_name(n), full)] //= tp
            assert list(shape) == want == list(moment), n


@pytest.mark.parametrize("case", list(workers.ITERATION_CASES))
def test_finished_episode_metrics(parallel_runs, single_runs, case):
    _, metrics = single_runs[case]
    rets, rets_env = (metrics[k] for k in ("done_returns",
                                           "done_returns_env"))
    finished = ~torch.isnan(rets)
    assert int(metrics["done_count"]) == int(finished.sum()) > 0
    torch.testing.assert_close(metrics["done_sum"], rets[finished].sum())
    torch.testing.assert_close(metrics["done_sum_env"],
                               rets_env[finished].sum())
    got = parallel_runs[0][case]["metrics"]
    assert int(got["done_count"]) == int(metrics["done_count"])
    for key in ("done_sum", "done_sum_env", "reward_mean"):
        np.testing.assert_allclose(float(got[key]), float(metrics[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    # the batch's returns themselves, in env order
    np.testing.assert_allclose(got["done_returns"].numpy(), rets.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_noise_rows_are_the_slice_of_the_whole_draw():
    mean = torch.zeros(3, 2)
    logstd = torch.full((2,), -0.5)
    whole = distributions.sample(torch.zeros(8, 2), logstd,
                                 torch.Generator().manual_seed(3))
    part = distributions.sample(mean, logstd,
                                torch.Generator().manual_seed(3), (4, 8))
    assert torch.equal(part, whole[4:7])
