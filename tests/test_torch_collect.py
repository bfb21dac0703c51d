"""GST data collection: the port's ``env/collect.py`` and ``collect_data``
against the JAX package's.

The JAX collect envs are reset (3 envs, 4 humans), their state converted to
the port's (tests/test_torch_slice.py's ``to_port_state``) and both
packages step from it, the port fed the JAX goal draws (the coin and the
uniform goal of ``split(env.key, 3)``). Random and end goal changes are
off, so no other draw matters. Bounds: the goal redirection, the tracking
ids, the visibility and the frames exactly; positions after the ORCA step
to tests/test_torch_env_variants.py's ORCA bound (2e-4, one near-tied ego
allowed up to 2e-2). The crowd median is held bit for bit against
``jnp.median`` with the JAX package's NaN rule, and the files of both
packages' ``collect_data`` load into the same windows in both packages'
``load_dataset``.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crowdnav_prediction_attngraph_tpu import collect_data as j_collect_data
from crowdnav_prediction_attngraph_tpu import config as jconfig
from crowdnav_prediction_attngraph_tpu.env import collect as j_collect
from crowdnav_prediction_attngraph_tpu.models.gst import dataset as jds
from crowdnav_prediction_attngraph_tpu_torch import collect_data
from crowdnav_prediction_attngraph_tpu_torch import config as tconfig
from crowdnav_prediction_attngraph_tpu_torch.env import collect
from crowdnav_prediction_attngraph_tpu_torch.models.gst import dataset as tds
from test_torch_env_variants import assert_orca_close
from test_torch_slice import to_port_state

B = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tiny models run their ops on one thread: with the suite's
    workers sharing the cores, torch's intra-op threads only contend (a
    2 s training test took 80 s under load with them, 14 s without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(human_num=4):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.varnum_config(human_num=human_num)
        out.append(cfg.replace(humans=dataclasses.replace(
            cfg.humans, random_goal_changing=False, end_goal_changing=False)))
    return out


def port_state(js):
    env = to_port_state(js.env, [torch.Generator().manual_seed(i)
                                 for i in range(B)])
    return collect.CollectState(
        env=env,
        last_observability=torch.from_numpy(np.asarray(js.last_observability)),
        pred_id=torch.from_numpy(np.asarray(js.pred_id)).long(),
        max_id=torch.from_numpy(np.asarray(js.max_id)).long())


def assert_info_equal(info, j_info):
    np.testing.assert_array_equal(info.valid.numpy(), np.asarray(j_info.valid))
    np.testing.assert_array_equal(info.pred_id.numpy(),
                                  np.asarray(j_info.pred_id))
    np.testing.assert_array_equal(info.frame.numpy(), np.asarray(j_info.frame))


@pytest.fixture(scope="module")
def jax_states():
    """(configs, JAX reset state and info, the state 3 steps later, the
    vmapped JAX step)."""
    jc, tc = configs()
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(4), i))(
        jnp.arange(B))
    js0, info0 = jax.jit(jax.vmap(lambda k: j_collect.reset(jc, k)))(keys)
    j_step = jax.jit(jax.vmap(lambda s: j_collect.step(jc, s)))
    js = js0
    for _ in range(3):          # mid-run: velocities, beliefs, some ids out
        js, _ = j_step(js)
    return jc, tc, (js0, info0), js, j_step


def test_reset_emit_matches_jax(jax_states):
    """The reset's emit from the injected reset env: every id its slot
    index, max_id the human count, the first visibility."""
    _, tc, (js0, info0), _, _ = jax_states
    A = tc.sim.max_human_num
    env = port_state(js0).env
    state = collect.CollectState(
        env=env, last_observability=torch.zeros(B, A, dtype=torch.bool),
        pred_id=torch.arange(A).expand(B, A).clone(),
        max_id=env.human_num.clone())
    state, info = collect._emit(tc, state)
    assert_info_equal(info, info0)
    np.testing.assert_array_equal(state.max_id.numpy(),
                                  np.asarray(js0.max_id))
    np.testing.assert_array_equal(info.pos.numpy(), np.asarray(info0.pos))


def test_step_matches_jax(jax_states):
    jc, tc, _, js, j_step = jax_states
    # envs 0 and 1 sit on their goals: the step redirects them
    robot = js.env.robot
    goal = robot.goal.at[:2].set(robot.pos[:2])
    js = js.replace(env=js.env.replace(robot=robot.replace(goal=goal)))
    j_next, j_info = j_step(js)
    keys = jax.vmap(lambda k: jax.random.split(k, 3))(js.env.key)
    u = np.concatenate([
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(
            keys[:, 1]))[:, None],
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2,)))(
            keys[:, 2]))], axis=1)
    t_next, t_info = collect.step(tc, port_state(js), torch.from_numpy(u))
    j_goal = np.asarray(j_next.env.robot.goal)
    np.testing.assert_allclose(t_next.env.robot.goal.numpy(), j_goal,
                               atol=1e-6)
    assert not np.allclose(j_goal[:2], np.asarray(js.env.robot.goal[:2]))
    np.testing.assert_array_equal(j_goal[2], np.asarray(js.env.robot.goal[2]))
    assert_orca_close(t_next.env.robot.pos.numpy(),
                      np.asarray(j_next.env.robot.pos), "robot")
    assert_orca_close(t_next.env.humans.pos.numpy(),
                      np.asarray(j_next.env.humans.pos), "humans")
    assert_info_equal(t_info, j_info)
    np.testing.assert_array_equal(t_next.max_id.numpy(),
                                  np.asarray(j_next.max_id))


def test_fresh_ids_on_leaving_view(jax_states):
    """Slots seen last step and not now get max_id, max_id + 1, ... in slot
    order (the cumsum rule of ``collect.py:53-69``)."""
    jc, tc, _, js, _ = jax_states
    A = jc.sim.max_human_num
    last = np.zeros((B, A), bool)
    last[:, :] = True                       # every slot was seen
    js = js.replace(last_observability=jnp.asarray(last),
                    max_id=js.max_id + 7)
    j_state, j_info = jax.vmap(lambda s: j_collect._emit(jc, s))(js)
    t_state, t_info = collect._emit(tc, port_state(js))
    assert_info_equal(t_info, j_info)
    np.testing.assert_array_equal(t_state.max_id.numpy(),
                                  np.asarray(j_state.max_id))
    vis = t_info.valid.numpy()
    gone = ~vis
    assert gone.any()
    ids = t_info.pred_id.numpy()
    for b in range(B):
        fresh = ids[b][gone[b]]
        start = int(np.asarray(js.max_id)[b])
        np.testing.assert_array_equal(fresh, start + np.arange(gone[b].sum()))
    # a port run: every id a slot takes after leaving is new to its env
    cfg = configs(human_num=10)[1]
    state, info = collect.reset(cfg, [torch.Generator().manual_seed(i)
                                      for i in range(2)], "cpu")
    seen = [set(info.pred_id[b].tolist()) for b in range(2)]
    for _ in range(60):
        old = state.pred_id.clone()
        state, info = collect.step(cfg, state)
        changed = state.pred_id != old
        for b, slot in changed.nonzero().tolist():
            new = int(state.pred_id[b, slot])
            assert new not in seen[b]
            seen[b].add(new)
    assert sum(len(s) for s in seen) > 2 * cfg.sim.max_human_num


def test_median_goal_is_zero_with_an_inactive_slot(jax_states):
    """A robot at its goal whose coin picks the median, in a crowd with an
    inactive slot, is sent to (0, 0), as the JAX package's NaN median
    is."""
    _, tc, _, js, _ = jax_states
    env = port_state(js).env
    env.robot.goal = env.robot.pos.clone()
    env.human_num = env.human_num - torch.tensor([1, 0, 0])
    u = torch.tensor([[0.1, 0.9, 0.9]] * B)       # the median, for all
    goal = collect.redirect_goal(tc, env, u).robot.goal.numpy()
    np.testing.assert_array_equal(goal[0], [0.0, 0.0])
    exp = jax_median(js.env.humans.pos[1], jnp.ones(tc.sim.max_human_num,
                                                    bool))
    np.testing.assert_array_equal(goal[1], exp)
    assert np.any(exp != 0.0)


def jax_median(pos, active):
    med = jnp.median(jnp.where(active[:, None], pos, jnp.nan), axis=0)
    return np.asarray(jnp.nan_to_num(med))


@pytest.mark.parametrize("A", [20, 5])
def test_crowd_median_matches_jax(A):
    """An even count averages the two middle values, an odd one takes the
    middle; one inactive slot makes the median 0 (NaN, then nan_to_num)."""
    rng = np.random.RandomState(A)
    pos = rng.uniform(-6, 6, (B, A, 2)).astype(np.float32)
    active = np.ones((B, A), bool)
    active[2, -1] = False
    got = collect.crowd_median(torch.from_numpy(pos),
                               torch.from_numpy(active)).numpy()
    exp = np.stack([jax_median(jnp.asarray(pos[b]), jnp.asarray(active[b]))
                    for b in range(B)])
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got[2], [0.0, 0.0])
    if A % 2 == 0:
        s = np.sort(pos[0], axis=0)
        assert np.all(got[0] == (s[A // 2 - 1] + s[A // 2]) * np.float32(0.5))
        assert np.any(got[0] != torch.from_numpy(pos[0]).median(0).values
                      .numpy())


def test_collect_files_load_in_both_packages(tmp_path):
    """The port's CLI (2 envs x 64 steps on the CPU) and the JAX package's
    write files that both packages' load_dataset read into the same
    windows; the records pass tests/test_gst_training.py:24-32's checks."""
    args = ["--tot-steps", "64", "--num-envs", "2", "--human-num", "4"]
    data = collect_data.main(args + ["--out", str(tmp_path / "port"),
                                     "--device", "cpu"])
    j_collect_data.main(args + ["--out", str(tmp_path / "jax")])
    assert len(data) == 2 and sum(len(rows) for rows in data) > 50
    for rows in data:
        assert rows.shape[1] == 4
        assert np.all(np.diff(np.unique(rows[:, 0])) > 0)
        assert np.all(np.diff(rows[:, 0]) >= 0)
        assert np.all(rows[:, 1] >= 0)
        assert np.all(np.isfinite(rows[:, 2:]))
        assert np.all(np.abs(rows[:, 2:]) < 30)
    for which in ("port", "jax"):
        d = str(tmp_path / which / "train")
        assert sorted(os.listdir(d)) == ["0.txt", "1.txt"]
        t_w = tds.load_dataset(d, 5, 5, 8, cache=False)
        j_w = jds.load_dataset(d, 5, 5, 8, cache=False)
        assert len(t_w) == len(j_w) > 20
        for a, b in zip(t_w, j_w):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the port's file holds exactly the collected rows, printed as floats
    back = jds.read_txt(str(tmp_path / "port" / "train" / "0.txt"))
    np.testing.assert_array_equal(back, data[0])
