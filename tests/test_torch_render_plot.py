"""Rendering and plotting on the port (JAX tests/test_plot_cli.py):

* ``render_frame`` draws the same RGBA pixels as the JAX ``render_frame``
  for the same arrays, with and without predicted futures;
* the ``plot`` CLI writes a PNG pixel-equal to the JAX ``plot.py``'s on the
  same ``progress.csv`` files (one with an empty cell), with two metrics
  and with one;
* ``test --visualize --robot-policy orca --device cpu`` writes a GIF with one
  frame per step of the episode, and runs no suite;
* ``render_episode`` draws a ``record_episode`` trajectory of the GST env
  (predicted futures in ``pred_pos``) to a GIF;
* the gym adapter's ``rgb_array`` render equals the JAX adapter's pixel for
  pixel from the same (injected) state.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from crowdnav_prediction_attngraph_tpu import plot as jplot
from crowdnav_prediction_attngraph_tpu.env import gym_adapter as jgym
from crowdnav_prediction_attngraph_tpu.utils import render as jrender
from crowdnav_prediction_attngraph_tpu_torch import plot
from crowdnav_prediction_attngraph_tpu_torch import test as test_cli
from crowdnav_prediction_attngraph_tpu_torch.config import gst_config
from crowdnav_prediction_attngraph_tpu_torch.env import gym_adapter
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import load_gst
from crowdnav_prediction_attngraph_tpu_torch.utils import render
from test_torch_gym_adapter import GST_NPZ
from test_torch_slice import to_port_state


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame_pixels(draw, **kw):
    fig, ax = render.new_figure()
    draw(ax, **kw)
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


@pytest.mark.parametrize("with_pred", [False, True])
def test_render_frame_pixels_equal_jax(with_pred):
    rng = np.random.RandomState(0)
    kw = dict(robot_pos=np.array([0.5, -1.0]), robot_goal=np.array([0.0, 4.0]),
              robot_radius=0.3, human_pos=rng.uniform(-5, 5, (6, 2)),
              human_radius=rng.uniform(0.3, 0.5, 6),
              human_visible=rng.uniform(size=6) > 0.4, sensor_range=5.0,
              human_num=5,
              pred_pos=rng.uniform(-5, 5, (6, 5, 2)) if with_pred else None)
    got = _frame_pixels(render.render_frame, **kw)
    expect = _frame_pixels(jrender.render_frame, **kw)
    assert got.shape == expect.shape == (700, 700, 4)
    np.testing.assert_array_equal(got, expect)
    assert (got[..., :3] != 255).any()        # something was drawn


def _write_progress_csv(run_dir, n=5, offset=0.0, hole=False):
    os.makedirs(run_dir, exist_ok=True)
    lines = ["misc/total_timesteps,eprewmean,loss/value_loss"]
    for i in range(n):
        rew = "" if hole and i == 2 else f"{offset + 0.1 * i}"
        lines.append(f"{(i + 1) * 1000},{rew},{1.0 / (i + 1)}")
    with open(os.path.join(run_dir, "progress.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("metrics", [[], ["--metrics", "eprewmean"]])
def test_plot_png_equals_jax(tmp_path, metrics):
    runs = [str(tmp_path / "run_a"), str(tmp_path / "run_b")]
    _write_progress_csv(runs[0])
    _write_progress_csv(runs[1], offset=0.5, hole=True)
    out, out_j = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    plot.main([*runs, "--out", out, *metrics])
    jplot.main([*runs, "--out", out_j, *metrics])
    got, expect = (np.asarray(Image.open(p)) for p in (out, out_j))
    assert got.shape == expect.shape
    np.testing.assert_array_equal(got, expect)


def test_visualize_writes_one_frame_per_step(tmp_path):
    flags = ["--env-name", "CrowdSimVarNum", "--robot-policy", "orca",
             "--human-num", "5", "--device", "cpu", "--out-dir",
             str(tmp_path)]
    out = test_cli.main(flags + ["--visualize", "--test-case", "2"])
    assert out == str(tmp_path / "test" / "case_2.gif")
    assert not (tmp_path / "test" / "test_00000.log").exists()   # no suite
    cfg, _ = test_cli.load_config(test_cli._parser().parse_args(flags))
    traj = render.record_episode(cfg, case_idx=2, base_seed=cfg.ppo.seed,
                                 robot_policy="orca", device="cpu")
    with Image.open(out) as gif:
        assert gif.n_frames == len(traj["robot_pos"]) > 1


def test_render_episode_of_gst_trajectory(tmp_path):
    cfg = gst_config(human_num=4)
    gst = load_gst(cfg.pred, GST_NPZ, "cpu")
    traj = render.record_episode(cfg, None, gst, case_idx=1,
                                 robot_policy="orca", device="cpu")
    T = len(traj["robot_pos"])
    assert all(len(v) == T for k, v in traj.items() if k != "robot_radius")
    assert traj["pred_pos"][0].shape == (4, cfg.sim.predict_steps, 2)
    out = render.render_episode(traj, str(tmp_path / "ep.gif"), cfg,
                                max_frames=6)
    assert out == str(tmp_path / "ep.gif")
    with Image.open(out) as gif:
        assert gif.n_frames == min(T, 6)


def test_gym_rgb_array_equals_jax():
    kw = dict(human_num=5, human_num_range=0)
    jenv = jgym.make("CrowdSimVarNum-v0", **kw)
    tenv = gym_adapter.make("CrowdSimVarNum-v0", device="cpu", **kw)
    jenv.reset(seed=3)
    tenv.reset(seed=3)
    jenv.step(np.array([0.2, 0.1]))
    js = jax.tree.map(lambda x: np.asarray(x)[None], jenv._state)
    tenv._state = to_port_state(js, tenv._state.gens)
    got, expect = tenv.render(), jenv.render()
    assert got.dtype == np.uint8 and got.shape == expect.shape == (700, 700, 3)
    np.testing.assert_array_equal(got, expect)
    jenv.close()
    tenv.close()
