"""The GST forward's CUDA graph (``models/gst/predictor.py``).

On CUDA inputs without a caller-given ``noise``, ``gst_predict`` replays one
CUDA graph of ``gst_forward`` per model and input shape. The card tests
(marked ``cuda``, skipped where torch.cuda.is_available() is False) hold it
to the eager path bit for bit (``torch.equal``) on the committed GST weights
at the flagship's 64 envs x 20 humans and config 5's 256 x 50, over 30
calls with fresh inputs and switches between the shapes; a call's outputs
stay as they were after the next call; one capture a shape; replays make
no host sync; the edge selector's noise is drawn once a shape and gives
eager's bits; weights updated in place are read, replaced ones captured
again; the sparse GST of the ``sparsegst-train`` cell (4 edge heads, the
ghost, f32, the committed seeded weights) at 256 x 50: replays equal to
eager, with no host sync, the capture's time and its pool's memory
printed. The CPU tests: CPU calls run op by op and count only
``gst.edge_rows``; the graph's noise is ``draw_noise``'s default draw;
``profiling.readings`` reports ``gst_graph_share``. This file imports no
jax; on the card:

  python -m pytest --noconftest tests/test_torch_gst_graph.py -q -m cuda
"""

import dataclasses
import os
import time

import pytest
import torch

from crowdnav_prediction_attngraph_tpu_torch.config import PredConfig
from crowdnav_prediction_attngraph_tpu_torch.models.gst import predictor
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import (
    graph_noise, gst_forward, gst_predict, load_gst)
from crowdnav_prediction_attngraph_tpu_torch.models.gst.st_model import (
    draw_noise, init_gst)
from crowdnav_prediction_attngraph_tpu_torch.utils import profiling

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "crowdnav_prediction_attngraph_tpu_torch", "weights")
WEIGHTS = os.path.join(WEIGHTS_DIR, "gst_sj_tpu_r5_b64_epoch100.npz")
SPARSE_WEIGHTS = os.path.join(WEIGHTS_DIR, "gst_sparse_ghost_e4_seed2022.npz")
L = 5
# the flagship's envs x humans, then config 5's
SHAPES = [(64, 20), (256, 50)]


def pred_cfg(**kw):
    return dataclasses.replace(PredConfig(), **kw)


def history(B, A, seed, device):
    """``pretext_process``'s inputs: absolute positions and visibility as
    transposed views of (B, L, A, .) buffers, with gaps; one human never
    seen."""
    g = torch.Generator().manual_seed(seed)
    start = torch.rand(B, 1, A, 2, generator=g) * 10.0 - 5.0
    steps = (torch.rand(B, L, A, 2, generator=g) * 0.6 - 0.3).cumsum(1)
    mask = torch.rand(B, L, A, generator=g) > 0.2
    mask[:, :, -1] = False
    mask[:, 0] = True
    return ((start + steps).to(device).transpose(1, 2),
            mask.to(device).transpose(1, 2))


@pytest.fixture
def counters():
    """The port's counters, on and emptied; read with ``counters()``."""
    profiling.enable()
    profiling.reset()
    yield lambda: profiling.snapshot()["counters"]
    profiling.disable()
    profiling.reset()


def gst_counters(c):
    return {k: v for k, v in c.items() if k.startswith("gst.")}


def rows(cfg, B, A):
    """``gst.edge_rows`` of one call: B x A x 9 frames with the selector."""
    return B * A * 9 if cfg.spatial_num_heads_edges else 0


# --- the CPU: op by op ------------------------------------------------------

@pytest.mark.parametrize("edges,given", [(0, False), (2, False), (2, True)])
def test_cpu_calls_run_eager(counters, edges, given):
    cfg = pred_cfg(matmul_dtype="bf16", spatial_num_heads_edges=edges)
    model = (load_gst(cfg, WEIGHTS, "cpu") if not edges else
             init_gst(cfg, torch.Generator().manual_seed(5), "cpu").eval())
    traj, mask = history(3, 6, 1, "cpu")
    noise = (draw_noise(cfg, 3, 6, False, torch.Generator().manual_seed(2),
                        "cpu") if given else None)
    out, out_mask = gst_predict(model, traj, mask, noise)
    ref, ref_mask = gst_forward(model, traj, mask, noise)
    assert torch.equal(out, ref) and torch.equal(out_mask, ref_mask)
    assert gst_counters(counters()) == {"gst.edge_rows": rows(cfg, 3, 6)}
    assert model not in predictor._GRAPHS


@pytest.mark.parametrize("ghost", [False, True])
def test_graph_noise_is_the_default_draw(ghost):
    cfg = pred_cfg(spatial_num_heads_edges=2, ghost=ghost)
    got = graph_noise(cfg, 3, 6, "cpu")
    want = draw_noise(cfg, 3, 6, False, None, "cpu")
    assert sorted(got) == sorted(want) == ["gumbel_dec", "gumbel_obs"]
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # full connectivity draws nothing
    assert graph_noise(pred_cfg(), 3, 6, "cpu") == {}


@pytest.mark.parametrize("calls,share", [
    ({"gst.graph_captures": 1, "gst.graph_replays": 30}, 100.0),
    ({"gst.graph_replays": 3, "gst.eager": 1}, 75.0),
    ({"env.steps": 4}, None)])
def test_readings_report_gst_graph_share(counters, calls, share):
    for name, n in calls.items():
        profiling.count(name, n)
    r = profiling.readings(profiling.snapshot())
    assert r["gst_graph_share"] == share
    assert r["gst_graph"] == {
        "captures": calls.get("gst.graph_captures", 0),
        "replays": calls.get("gst.graph_replays", 0),
        "eager": calls.get("gst.eager", 0)}


def test_table_shows_the_gst_graph(counters):
    for _ in range(3):
        with profiling.span("gst.pretext"):
            profiling.count("gst.graph_replays")
    profiling.count("gst.graph_captures")
    table = profiling.per_step_table(profiling.snapshot())
    assert ("gst graph: 1 captures, 3 replays, 0 eager; 3 pretext calls; "
            "share 100.0%") in table


# --- the card: one graph a shape --------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_dtype", ["bf16", "f32"])
def test_graph_gives_eager_bits(cuda_device, counters, matmul_dtype):
    model = load_gst(pred_cfg(matmul_dtype=matmul_dtype), WEIGHTS,
                     cuda_device)
    last = None
    for i in range(30):
        B, A = SHAPES[i % 3 == 2]
        traj, mask = history(B, A, 100 + i, cuda_device)
        got = gst_predict(model, traj, mask)
        if last is not None:        # call k's outputs after call k + 1
            assert all(torch.equal(a, b) for a, b in zip(*last)), i - 1
        want = gst_forward(model, traj, mask)
        assert got[0].shape == (B, A, 5, 5) and got[1].shape == (B, A, 1)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), i
        last = got, want
    assert gst_counters(counters()) == {"gst.graph_captures": 2,
                                        "gst.graph_replays": 28,
                                        "gst.edge_rows": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("spans", [False, True])
def test_replays_make_no_host_sync(cuda_device, spans):
    model = load_gst(pred_cfg(matmul_dtype="bf16"), WEIGHTS, cuda_device)
    inputs = [history(64, 20, s, cuda_device) for s in range(3)]
    gst_predict(model, *inputs[0])          # the capture
    (profiling.enable if spans else profiling.disable)()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [gst_predict(model, *x) for x in inputs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        profiling.disable()
        profiling.reset()
    for x, got in zip(inputs, outs):
        assert all(torch.equal(a, b)
                   for a, b in zip(got, gst_forward(model, *x)))


@pytest.mark.cuda
@pytest.mark.parametrize("ghost", [False, True])
def test_edge_selector_noise_drawn_once(cuda_device, counters, ghost):
    cfg = pred_cfg(matmul_dtype="bf16", spatial_num_heads_edges=2,
                   ghost=ghost)
    model = init_gst(cfg, torch.Generator().manual_seed(11),
                     cuda_device).eval()
    noise = None
    for i in range(4):
        traj, mask = history(64, 20, 200 + i, cuda_device)
        got = gst_predict(model, traj, mask)
        # no noise: each eager call draws from a generator seeded 0
        want = gst_forward(model, traj, mask)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), i
        (graph,) = predictor._GRAPHS[model].values()
        noise = noise or graph.noise
        assert graph.noise is noise
    default = draw_noise(cfg, 64, 20, False, None, cuda_device)
    assert all(torch.equal(noise[k], default[k]) for k in default)
    assert gst_counters(counters()) == {"gst.graph_captures": 1,
                                        "gst.graph_replays": 3,
                                        "gst.edge_rows": 4 * rows(cfg, 64,
                                                                  20)}


@pytest.mark.cuda
def test_weights_in_place_read_replaced_captured(cuda_device, counters):
    model = load_gst(pred_cfg(matmul_dtype="bf16"), WEIGHTS, cuda_device)
    traj, mask = history(64, 20, 7, cuda_device)
    gst_predict(model, traj, mask)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.9)
    got = gst_predict(model, traj, mask)
    assert all(torch.equal(a, b)
               for a, b in zip(got, gst_forward(model, traj, mask)))
    model.load_state_dict({k: v * 1.1 for k, v in model.state_dict().items()},
                          assign=True)
    got = gst_predict(model, traj, mask)
    assert all(torch.equal(a, b)
               for a, b in zip(got, gst_forward(model, traj, mask)))
    assert gst_counters(counters()) == {"gst.graph_captures": 2,
                                        "gst.graph_replays": 1,
                                        "gst.edge_rows": 0}


@pytest.mark.cuda
def test_given_noise_runs_eager(cuda_device, counters):
    model = load_gst(pred_cfg(matmul_dtype="bf16"), WEIGHTS, cuda_device)
    traj, mask = history(64, 20, 9, cuda_device)
    got = gst_predict(model, traj, mask, noise={})
    assert all(torch.equal(a, b)
               for a, b in zip(got, gst_forward(model, traj, mask)))
    assert gst_counters(counters()) == {"gst.eager": 1, "gst.edge_rows": 0}
    assert model not in predictor._GRAPHS


@pytest.mark.cuda
def test_sparse_graph_at_config5_gives_eager_bits(cuda_device, counters):
    """The sparse GST at 256 envs x 50 humans: each replay equals eager bit
    for bit, replays make no host sync, and the capture's time and the
    memory its pool and its warm-up hold are printed."""
    cfg = pred_cfg(matmul_dtype="f32", spatial_num_heads_edges=4, ghost=True)
    model = load_gst(cfg, SPARSE_WEIGHTS, cuda_device)
    B, A = SHAPES[1]
    inputs = [history(B, A, 300 + i, cuda_device) for i in range(4)]
    torch.cuda.synchronize()
    reserved, t0 = torch.cuda.memory_reserved(), time.perf_counter()
    gst_predict(model, *inputs[0])                      # the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    grew = torch.cuda.memory_reserved() - reserved
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [gst_predict(model, *x) for x in inputs[1:]]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for x, got in zip(inputs[1:], outs):
        want = gst_forward(model, *x)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert gst_counters(counters()) == {"gst.graph_captures": 1,
                                        "gst.graph_replays": 3,
                                        "gst.edge_rows": 4 * rows(cfg, B, A)}
    print(f"sparse GST 256 x 50: capture {capture_s:.3f} s, reserved "
          f"+{grew / 2**30:.2f} GiB, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
