"""The port's spans and counters (``utils/profiling``) and where the port
records them.

On the CPU: off, the registry stays empty and a disabled span costs a flag
test; nesting gives each span its parent and self time is the duration less
its children's; a span's ``time.time_ns()`` stamps fall on its
``crowdnav.`` profiler range once placed on the trace's clock; one
flagship ``vec_step`` at 4 envs gives the span tree ``vec.step > env.step
> env.orca > orca.lp2``, ``orca.egos`` = 4 x 20, and each ``sync.*`` site
once per hit, in a step and in one that resets every env, for the flagship
and config 5: their sum equals the blocking host reads the step makes
(``Tensor.__bool__``, ``nonzero`` and ``tolist`` calls, and
``torch.tensor`` constants made on a device, counted by patching them);
states, observations, rewards and one tiny ``train_iteration`` are
bit-equal with the spans on and off; the launch tally appears in the
snapshot; ``ops/_build.launch`` refuses a wrong dtype, a wrong shape and
a CPU tensor, naming the argument, before it loads any library;
``train --spans`` and ``test --spans`` print the table;
``tools/profile_spans.py`` reads a synthetic trace as it should and gives
its readings at a tiny size (with no device ops on the CPU), DS-RNN's
among them with ``--config srnn``. DS-RNN's act and minibatch loss give
its five ``srnn.*`` spans, nested in ``policy.act`` and ``ppo.loss``, and
``srnn.gru_cells`` = 3 x T a forward; off, they leave the registry empty.

On the CPU, ``orca_velocity_batch`` runs its plain stages (their spans,
LP3's host read) and never loads the ORCA kernel's library; the spawn
passes run their plain rounds and never load theirs. The env step's events
run as on the card, with no host read (unconditionally, masked by the 5 s
mark and by the humans that reached their goals), and give the bits of the
benchmark's frozen plain copy (``benchmark/reference/crowd_sim.py``), whose
events read the host first, in the flagship and config 5.

On the card (marked ``cuda``, skipped here): a flagship env step, and one
in which every env resets, under ``torch.cuda.set_sync_debug_mode("warn")``
raise exactly as many synchronising-op warnings as the ``sync.*`` counters
add, none of them ORCA's. This file imports no jax:

  python -m pytest --noconftest tests/test_torch_profiling_spans.py -q -m cuda
"""

import collections
import importlib.util
import dataclasses
import json
import os
import time
import warnings

import pytest
import torch

import frozen_reference

from crowdnav_prediction_attngraph_tpu_torch import test as test_cli
from crowdnav_prediction_attngraph_tpu_torch import train as train_cli
from crowdnav_prediction_attngraph_tpu_torch.algo import ppo
from crowdnav_prediction_attngraph_tpu_torch.config import (
    config_from_snapshot, varnum_config)
from crowdnav_prediction_attngraph_tpu_torch.env import (
    crowd_sim, orca, spawn, vector)
from crowdnav_prediction_attngraph_tpu_torch.models import policy as pmod
from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import load_gst
from crowdnav_prediction_attngraph_tpu_torch.ops import _build
from crowdnav_prediction_attngraph_tpu_torch.utils import profiling
from crowdnav_prediction_attngraph_tpu_torch.utils.spawn_scenes import (
    circle_spawn_args, goal_resample_args)
from crowdnav_prediction_attngraph_tpu_torch.utils.orca_oracle import (
    scene_tensors)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the flagship recipe: the r5 run's snapshot
FLAGSHIP = os.path.join(ROOT, "trained_models",
                        "GST_predictor_rand_tpu_r5_selfgst", "config.json")
ENVS = 4
# every blocking host read on the train step's path: the two reads of the
# step, the reset's, and the host-to-device constants of the reset and the
# events
SYNC_SITES = ("sync.vec_done", "sync.orca_lp3", "sync.vec_reset_ids",
              "sync.reset_robot", "sync.reset_beliefs",
              "sync.observe_beliefs", "sync.vary_beliefs",
              "sync.truth_hidden")


@pytest.fixture(autouse=True)
def registry_off():
    """Every test starts and ends with the port's registry off and empty."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _fork(states):
    """The same env state with copies of its CPU generators."""
    gens = []
    for g in states.gens:
        c = torch.Generator()
        c.set_state(g.get_state())
        gens.append(c)
    return dataclasses.replace(states, gens=gens)


def _config(which: str):
    """The flagship recipe, or BASELINE config 5 on it (10-50 humans, as
    the train CLI's ``--human-num 30 --human-num-range 20`` builds it)."""
    cfg = config_from_snapshot(FLAGSHIP)
    if which == "config5":
        cfg = cfg.replace(sim=dataclasses.replace(
            cfg.sim, human_num=30, human_num_range=20))
    return cfg


def _setup(which, device="cpu"):
    cfg = _config(which)
    cfg = cfg.replace(ppo=dataclasses.replace(cfg.ppo, num_processes=ENVS))
    gst = load_gst(cfg.pred, test_cli.DEFAULT_GST_PARAMS, device)
    ts = ppo.init_train_state(cfg, gst, device)
    return cfg, gst, ts


@pytest.fixture(scope="module")
def flagship():
    return _setup("flagship")


def _step(cfg, gst, ts, spans: bool, timeout: bool = False):
    """One train-phase ``vec_step`` from the fixture's state; with
    ``timeout`` every env times out in it, so every env is reset."""
    states = _fork(ts.env_states)
    if timeout:
        states = dataclasses.replace(states, global_time=torch.full_like(
            states.global_time, cfg.env.time_limit))
    if spans:
        profiling.enable()
    try:
        action = torch.linspace(-1.0, 1.0, 2 * ENVS).reshape(ENVS, 2)
        return vector.vec_step(cfg, states, action, "train", gst)
    finally:
        profiling.disable()


def _by_id(snap):
    return {s["id"]: s for s in snap["spans"]}


def _path(snap, span) -> list:
    """The names from ``span`` up to its root."""
    ids, out = _by_id(snap), []
    while span is not None:
        out.append(span["name"])
        span = ids.get(span["parent"])
    return out


# ------------------------------------------------------------------- off

def test_off_leaves_registry_empty(flagship):
    cfg, gst, ts = flagship
    with profiling.span("x"):
        profiling.count("y", 3)
    _step(cfg, gst, ts, spans=False)
    snap = profiling.snapshot()
    assert snap["spans"] == [] and snap["totals"] == {}
    assert snap["counters"] == {"k1.launches": 0, "k2.launches": 0,
                                "k3.launches": 0, "orca.launches": 0,
                                "spawn.launches": 0}


def test_disabled_span_costs_a_flag_test():
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("env.step"):
            pass
        profiling.count("env.steps")
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 5e-6, per_call
    assert profiling.snapshot()["spans"] == []


# ----------------------------------------------------------------- nesting

def test_nesting_parents_and_self_time():
    profiling.enable()
    with profiling.span("a"):
        time.sleep(0.002)
        with profiling.span("b"):
            time.sleep(0.003)
            with profiling.span("c"):
                time.sleep(0.002)
        with profiling.span("b"):
            time.sleep(0.001)

    @profiling.spanned("d")
    def work():
        time.sleep(0.001)
    work()
    snap = profiling.snapshot()
    ids = _by_id(snap)
    names = {s["name"]: s for s in snap["spans"]}
    assert [(_path(snap, s)) for s in snap["spans"]] == [
        ["c", "b", "a"], ["b", "a"], ["b", "a"], ["a"], ["d"]]
    assert names["a"]["parent"] is None and names["d"]["parent"] is None
    assert {s["thread"] for s in snap["spans"]} == {
        snap["spans"][0]["thread"]}

    def dur(s):
        return (s["end_ns"] - s["start_ns"]) / 1e9
    for name, t in snap["totals"].items():
        mine = [s for s in snap["spans"] if s["name"] == name]
        kids = [s for s in snap["spans"]
                if s["parent"] is not None and ids[s["parent"]]["name"] == name]
        assert t["count"] == len(mine)
        assert t["total_s"] == pytest.approx(sum(map(dur, mine)), abs=1e-12)
        assert t["self_s"] == pytest.approx(
            sum(map(dur, mine)) - sum(map(dur, kids)), abs=1e-9)
    assert snap["totals"]["b"]["count"] == 2
    assert snap["totals"]["a"]["self_s"] >= 0.002
    assert snap["totals"]["c"]["self_s"] == snap["totals"]["c"]["total_s"]


def test_span_duration_ignores_wall_clock_steps(monkeypatch):
    """A span's start is a wall-clock stamp; its duration is monotonic, so
    a step of the wall clock inside it moves no total."""
    wall = iter([10_000_000_000, 5_000_000_000, 1])
    monkeypatch.setattr(time, "time_ns", lambda: next(wall))
    profiling.enable()
    with profiling.span("outer"):
        with profiling.span("inner"):
            time.sleep(0.002)
    profiling.disable()
    snap = profiling.snapshot()
    inner, outer = snap["spans"]
    assert outer["start_ns"] == 10_000_000_000
    assert inner["start_ns"] == 5_000_000_000
    assert 0.002 <= snap["totals"]["inner"]["total_s"] \
        <= snap["totals"]["outer"]["total_s"] < 1.0
    assert snap["totals"]["outer"]["self_s"] >= 0.0


def _stamp_offsets(tmp_path, attempt: int):
    """(start, end) offsets in us of every span against its range."""
    profiling.reset()
    profiling.enable()
    x = torch.ones(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("warm"):
            pass
        for _ in range(4):
            with profiling.span("outer"):
                x = x @ x / 64.0
                with profiling.span("inner"):
                    x = torch.tanh(x)
    profiling.disable()
    path = tmp_path / f"trace{attempt}.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    ranges = collections.defaultdict(list)
    for ev in trace["traceEvents"]:
        name = str(ev.get("name", ""))
        if ev.get("ph") == "X" and name.startswith(profiling.RANGE_PREFIX):
            ranges[name[len(profiling.RANGE_PREFIX):]].append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
    spans = [s for s in profiling.snapshot()["spans"] if s["name"] != "warm"]
    assert len(spans) == 8
    out = []
    for s in spans:
        start = profiling.trace_us(s["start_ns"], base)
        end = profiling.trace_us(s["end_ns"], base)
        r0, r1 = min(ranges[s["name"]], key=lambda r: abs(r[0] - start))
        out.append((start - r0, end - r1))
    return out


def test_stamps_match_profiler_ranges(tmp_path):
    # a descheduled thread between a stamp and its range moves one pair by
    # milliseconds, so three tries are allowed
    worst = []
    for attempt in range(3):
        offsets = _stamp_offsets(tmp_path, attempt)
        worst.append(max(max(abs(a), abs(b)) for a, b in offsets))
        if worst[-1] <= 50.0:
            break
    assert min(worst) <= 50.0, worst


# ------------------------------------------------------------- the env step

def test_vec_step_span_tree(flagship):
    cfg, gst, ts = flagship
    _step(cfg, gst, ts, spans=True)
    snap = profiling.snapshot()
    paths = {tuple(_path(snap, s)) for s in snap["spans"]}
    assert ("orca.lp2", "env.orca", "env.step", "vec.step") in paths
    for leaf in ("orca.lines", "orca.lp3"):
        assert (leaf, "env.orca", "env.step", "vec.step") in paths
    for child in ("env.draws", "env.reward", "env.observe", "env.events"):
        assert (child, "env.step", "vec.step") in paths
    for child in ("vec.auto_reset", "gst.pretext"):
        assert (child, "vec.step") in paths
    assert snap["totals"]["vec.step"]["count"] == 1
    assert snap["totals"]["env.events"]["count"] == 2
    for t in snap["totals"].values():
        assert 0.0 <= t["self_s"] <= t["total_s"]


def test_orca_egos_counted(flagship):
    cfg, gst, ts = flagship
    _step(cfg, gst, ts, spans=True)
    c = profiling.snapshot()["counters"]
    assert c["orca.egos"] == ENVS * cfg.sim.max_human_num == 4 * 20
    assert 0 <= c["orca.lp3_egos"] <= c["orca.egos"]
    assert c["env.steps"] == 1
    assert c["vec.resets"] == 0


def _blocking_reads(monkeypatch):
    """Patch ``Tensor.__bool__``, ``Tensor.nonzero`` and ``Tensor.tolist``
    (the host reads of the step path) and ``torch.tensor`` with a
    ``device`` (its host-to-device constants) to count their calls."""
    calls = collections.Counter()

    def counting(name, orig, counts=lambda *a, **k: True):
        def wrapper(*args, **kwargs):
            if counts(*args, **kwargs):
                calls[name] += 1
            return orig(*args, **kwargs)
        return wrapper
    for attr in ("__bool__", "nonzero", "tolist"):
        monkeypatch.setattr(torch.Tensor, attr,
                            counting(attr, getattr(torch.Tensor, attr)))
    monkeypatch.setattr(torch, "tensor", counting(
        "tensor", torch.tensor, lambda *a, **k: "device" in k))
    return calls


@pytest.mark.parametrize("timeout", [False, True], ids=["step", "resets"])
@pytest.mark.parametrize("which", ["flagship", "config5"])
def test_sync_counters_once_per_hit(which, timeout, flagship, monkeypatch):
    cfg, gst, ts = flagship if which == "flagship" else _setup(which)
    # the events' kept constant, made at its first use on a device
    monkeypatch.setattr(crowd_sim, "_KEPT", {})
    calls = _blocking_reads(monkeypatch)
    _step(cfg, gst, ts, spans=True, timeout=timeout)
    monkeypatch.undo()
    c = profiling.snapshot()["counters"]
    varies = cfg.sim.human_num_range > 0
    expected = dict.fromkeys(SYNC_SITES, 0)
    expected.update({"sync.vec_done": 1, "sync.orca_lp3": 1,
                     "sync.vary_beliefs": int(varies)})
    if timeout:
        # one batched reset of the done envs
        expected.update({"sync.vec_reset_ids": 1, "sync.reset_robot": 1,
                         "sync.reset_beliefs": 1, "sync.observe_beliefs": 1})
    assert {k: c.get(k, 0) for k in SYNC_SITES} == expected
    assert c["vec.resets"] == (ENVS if timeout else 0)
    assert sum(expected.values()) == sum(calls.values()), dict(calls)


@pytest.mark.parametrize("egos,n", [(40, 21), (30, 51)])
def test_orca_on_cpu_never_loads_the_kernel(egos, n, monkeypatch):
    """CPU tensors take the plain stages: the same bits as ``orca_lines``,
    ``_lp2`` and ``_lp3`` run by hand, LP3's host read counted, and the
    kernel's library never built or loaded."""
    def refuse(name):
        raise AssertionError(f"loaded {name} for CPU tensors")
    monkeypatch.setattr(_build, "load", refuse)
    args = scene_tensors(egos, n, 5, "cpu")
    launches = profiling.launches()
    profiling.enable()
    got = orca.orca_velocity_batch(*args[:9], 0.25, 5.0, args[9])
    profiling.disable()
    d, p, valid = orca.orca_lines(*args[:3], *args[5:9], 0.25, 5.0, args[9])
    result, fail = orca._lp2(d, p, valid, args[3], args[4], False)
    lp3 = orca._lp3(d, p, valid, fail, args[3], result)
    failed = fail < n
    assert failed.any()
    assert torch.equal(got, torch.where(failed[:, None], lp3, result))
    c = profiling.snapshot()["counters"]
    assert c["sync.orca_lp3"] == 1 and c["orca.egos"] == egos
    assert c["orca.lp3_egos"] == int(failed.sum())
    assert profiling.launches() == launches
    assert {s["name"] for s in profiling.snapshot()["spans"]} == {
        "orca.lines", "orca.lp2", "orca.lp3"}


@pytest.mark.parametrize("which", ["circle_spawn", "goal_resample"])
def test_spawn_on_cpu_never_loads_the_kernel(which, monkeypatch):
    """CPU tensors take the plain rounds: the reference functions' bits,
    nothing counted on the device, and the kernel's library never built or
    loaded."""
    def refuse(name):
        raise AssertionError(f"loaded {name} for CPU tensors")
    monkeypatch.setattr(_build, "load", refuse)
    launches = profiling.launches()
    profiling.enable()
    if which == "circle_spawn":
        args = circle_spawn_args(6, 20, 2, "cpu")
        got = spawn.batched_circle_spawn(*args)
        want = spawn.reference_circle_spawn(*args)
    else:
        args = goal_resample_args(6, 20, 2, "cpu")
        got = [spawn.batched_goal_resample(*args)]
        want = [spawn.reference_goal_resample(*args)]
    profiling.disable()
    assert args[1].any()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert profiling.launches() == launches
    assert "spawn.slots" not in profiling.snapshot()["counters"]


@pytest.mark.parametrize("which", ["flagship", "config5"])
def test_events_without_host_reads_keep_every_bit(which, flagship,
                                                  monkeypatch):
    """Three train-phase steps in which the 5 s events fire for half of the
    envs and a fifth of the humans stand on their goals: the events, run
    unconditionally and masked, give the bits of the frozen reference's
    ``step``, whose events read the host first, and read nothing: the
    step's only blocking reads are ORCA's LP3 (one a step) and the kept
    belief constant's first copy."""
    cfg, gst, ts = flagship if which == "flagship" else _setup(which)
    rconfig, rsim, rtypes = frozen_reference.modules()
    rcfg = rconfig.config_from_snapshot(FLAGSHIP)
    rcfg = rcfg.replace(sim=dataclasses.replace(
        rcfg.sim, human_num=cfg.sim.human_num,
        human_num_range=cfg.sim.human_num_range))
    steps_per_5s = int(round(5.0 / cfg.env.time_step))
    states = _fork(ts.env_states)
    h = states.humans
    g = torch.Generator().manual_seed(4)
    on_goal = torch.rand(h.radius.shape, generator=g) < 0.2
    states = dataclasses.replace(
        states, step_count=torch.tensor([steps_per_5s - 1, 3] * (ENVS // 2)),
        humans=dataclasses.replace(h, goal=torch.where(
            on_goal[..., None], h.pos, h.goal)))
    r_state = frozen_reference.copy_tree(states, rtypes)
    action = torch.linspace(-1.0, 1.0, 2 * ENVS).reshape(ENVS, 2)
    monkeypatch.setattr(crowd_sim, "_KEPT", {})
    calls = _blocking_reads(monkeypatch)
    profiling.enable()
    st, steps = _fork(states), []
    for _ in range(3):
        st, *rest = crowd_sim.step(cfg, st, action, "train")
        steps.append(frozen_reference.copy_tree([st, *rest]))
    profiling.disable()
    monkeypatch.undo()
    c = profiling.snapshot()["counters"]
    syncs = {k: v for k, v in c.items() if k.startswith("sync.")}
    varies = cfg.sim.human_num_range > 0
    assert syncs == {"sync.orca_lp3": 3, **(
        {"sync.vary_beliefs": 1} if varies else {})}
    assert sum(calls.values()) == sum(syncs.values()), dict(calls)
    for t, got in enumerate(steps):
        r_state, *r_rest = rsim.step(rcfg, r_state, action, "train")
        frozen_reference.assert_same_tree(got, [r_state, *r_rest],
                                          f"step {t}")


# ------------------------------------------------------------ bit-equality

def _flat(x):
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x) if f.name != "gens"
                for v in _flat(getattr(x, f.name))]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _flat(e)]
    return [x] if isinstance(x, torch.Tensor) else []


def _assert_bit_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb) and fa
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_spans_leave_env_bit_equal(flagship):
    cfg, gst, ts = flagship
    off = _step(cfg, gst, ts, spans=False)
    on = _step(cfg, gst, ts, spans=True)
    assert profiling.snapshot()["spans"]
    _assert_bit_equal(off, on)


def test_spans_leave_train_iteration_bit_equal():
    args = train_cli._parser().parse_args(
        ["--human-num", "4", "--num-processes", "4", "--num-steps", "3",
         "--device", "cpu", "--use-linear-lr-decay"])
    cfg = train_cli.build_config(args)
    cfg = cfg.replace(
        env=dataclasses.replace(cfg.env, time_limit=0.5),
        network=dataclasses.replace(cfg.network, attn_size=64))
    gst = load_gst(cfg.pred, test_cli.DEFAULT_GST_PARAMS, "cpu")
    outs = []
    for spans in (False, True):
        if spans:
            profiling.enable()
        ts = ppo.init_train_state(cfg, gst, "cpu")
        ts, metrics = ppo.train_iteration(cfg, ts, gst)
        profiling.disable()
        outs.append((ts.env_states, ts.obs, ts.hxs, metrics,
                     dict(ts.model.named_parameters())))
    _assert_bit_equal(outs[0], outs[1])
    snap = profiling.snapshot()
    assert snap["counters"]["vec.resets"] > 0
    for name in ("ppo.init_train_state", "ppo.rollout", "ppo.update",
                 "ppo.gae", "ppo.loss", "ppo.backward", "ppo.optimizer",
                 "policy.act", "vec.auto_reset"):
        assert snap["totals"][name]["count"] >= 1, name
    n_updates = cfg.ppo.ppo_epoch * cfg.ppo.num_mini_batch
    assert snap["totals"]["ppo.backward"]["count"] == n_updates
    assert {tuple(_path(snap, s)) for s in snap["spans"]
            if s["name"] == "ppo.backward"} == {("ppo.backward",
                                                 "ppo.update")}


# ------------------------------------------------------------------ DS-RNN

SRNN_SPANS = ("srnn.temporal_edge", "srnn.spatial_edge", "srnn.attention",
              "srnn.node", "srnn.heads")


@pytest.fixture(scope="module")
def srnn():
    """DS-RNN in CrowdSimVarNum at 4 envs x 3 steps, seeded, and one
    rollout's batch (made with the spans off)."""
    cfg = varnum_config(human_num=4)
    cfg = cfg.replace(
        robot=dataclasses.replace(cfg.robot, policy="srnn"),
        ppo=dataclasses.replace(cfg.ppo, num_processes=ENVS, num_steps=3))
    ts = ppo.init_train_state(cfg, None, "cpu")
    ts, batch = ppo.rollout(cfg, ts, None)
    return cfg, ts, batch


def _srnn_act_and_loss(cfg, ts, batch) -> int:
    """One act over every env, then one minibatch loss over half of them;
    returns ``srnn.gru_cells`` as it stood after the act."""
    pmod.act(ts.model, ts.obs, ts.hxs, ts.masks)
    after_act = profiling.snapshot()["counters"].get("srnn.gru_cells", 0)
    returns, adv = ppo.advantages(cfg, batch)
    ppo.ppo_loss(cfg, ts.model, batch, returns, adv,
                 torch.arange(ENVS // 2))
    return after_act


def test_srnn_off_leaves_registry_empty(srnn):
    assert _srnn_act_and_loss(*srnn) == 0
    snap = profiling.snapshot()
    assert snap["spans"] == [] and snap["totals"] == {}
    assert "srnn.gru_cells" not in snap["counters"]


def test_srnn_spans_nest_in_act_and_loss(srnn):
    cfg = srnn[0]
    profiling.enable()
    after_act = _srnn_act_and_loss(*srnn)
    profiling.disable()
    snap = profiling.snapshot()
    T = cfg.ppo.num_steps
    assert after_act == 3
    assert snap["counters"]["srnn.gru_cells"] == 3 + 3 * T
    inner = [s for s in snap["spans"] if s["name"].startswith("srnn.")]
    assert [tuple(_path(snap, s)) for s in inner] == (
        [(n, "policy.act") for n in SRNN_SPANS]
        + [(n, "ppo.loss") for n in SRNN_SPANS])
    for a, b in zip(inner, inner[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert all(snap["totals"][n]["count"] == 2 for n in SRNN_SPANS)
    assert "srnn.gru_cells" in profiling.per_step_table(snap)


# ------------------------------------------------- launches and the CLIs

def test_snapshot_reads_kernel_launch_counts():
    profiling.reset()
    for name in ("k1", "k1", "k1", "k2", "k2", "spawn"):
        profiling.launched(name)
    assert profiling.launches() == {"k1": 3, "k2": 2, "k3": 0, "orca": 0,
                                    "spawn": 1}
    c = profiling.snapshot()["counters"]
    assert (c["k1.launches"], c["k2.launches"], c["k3.launches"],
            c["orca.launches"], c["spawn.launches"]) == (3, 2, 0, 0, 1)
    profiling.zero_launches()
    assert set(profiling.launches().values()) == {0}
    profiling.launched("orca")
    profiling.reset()
    assert profiling.snapshot()["counters"]["orca.launches"] == 0


@pytest.mark.parametrize("case", ["dtype", "shape", "cpu", "devices"])
def test_launch_refuses_bad_arguments_before_loading(case, monkeypatch):
    """``_build.launch`` names the argument it refuses (its index in the
    entry's tensors) and raises before it builds or loads a library."""
    def refuse(name):
        raise AssertionError(f"loaded {name} for arguments it refuses")
    monkeypatch.setattr(_build, "load", refuse)
    f32 = torch.float32
    x, y = torch.zeros(4, 3), torch.zeros(4, dtype=torch.bool)
    tensors = [(x, f32, (4, 3)), (None, f32, (4, 3)), (y, torch.bool, (4,)),
               (x, f32, (4, 3))]
    if case == "dtype":
        tensors[2] = (y.int(), torch.bool, (4,))
        error, index = TypeError, 2
    elif case == "shape":
        tensors[3] = (x[:2], f32, (4, 3))
        error, index = ValueError, 3
    elif case == "cpu":
        error, index = ValueError, 0
    else:
        tensors[0] = (x.to("meta"), f32, (4, 3))
        error, index = ValueError, 2
    before = profiling.launches()
    with pytest.raises(error, match=f"k_entry argument {index} "):
        _build.launch("k", "k_entry", "k1", tensors, (4, 1.0))
    assert profiling.launches() == before


def test_cli_spans_tables(tmp_path, capsys):
    train_cli.main(["--device", "cpu", "--output-dir", str(tmp_path / "tr"),
                    "--human-num", "4", "--num-processes", "4",
                    "--num-steps", "3", "--num-env-steps", "24",
                    "--log-interval", "1", "--spans"])
    out = capsys.readouterr().out
    assert out.count("calls/step") == 2 and "orca.lp2" in out
    assert "sync.vec_done" in out and "ppo.backward" in out
    assert not profiling._ON
    test_cli.main(["--env-name", "CrowdSimVarNum", "--robot-policy", "orca",
                   "--human-num", "4", "--test-case-size", "2",
                   "--device", "cpu", "--out-dir", str(tmp_path / "ev"),
                   "--spans"])
    out = capsys.readouterr().out
    assert "eval.step" in out and "orca.lp2" in out
    assert not profiling._ON


# ---------------------------------------------------------------- the card

@pytest.mark.cuda
def test_sync_counters_match_sync_debug_warnings():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    device = torch.device("cuda")
    cfg = _config("flagship")
    gst = load_gst(cfg.pred, test_cli.DEFAULT_GST_PARAMS, device)
    model = pmod.load_policy(cfg, test_cli.DEFAULT_PARAMS, device)
    ts = ppo.init_train_state(cfg, gst, device, model)
    action = torch.zeros(cfg.ppo.num_processes, 2, device=device)
    states = _fork(ts.env_states)
    # a step with no env done, then one in which every env times out
    timed_out = dataclasses.replace(_fork(ts.env_states), global_time=(
        torch.full_like(states.global_time, cfg.env.time_limit)))
    vector.vec_step(cfg, _fork(states), action, "train", gst)
    torch.cuda.synchronize()
    profiling.reset()
    profiling.enable()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            vector.vec_step(cfg, states, action, "train", gst)
            vector.vec_step(cfg, timed_out, action, "train", gst)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    profiling.disable()
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    c = profiling.snapshot()["counters"]
    counted = sum(v for k, v in c.items() if k.startswith("sync."))
    sites = collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}"
                                for w in syncs)
    assert len(syncs) == counted, (dict(sites), c)
    assert c["vec.resets"] == cfg.ppo.num_processes and c["env.steps"] == 2
    # the ORCA kernel finds its LP3 egos on the device
    assert c.get("sync.orca_lp3", 0) == 0 and c["orca.launches"] == 2


# ------------------------------------------------ tools/profile_spans.py

def _tool():
    spec = importlib.util.spec_from_file_location(
        "profile_spans", os.path.join(ROOT, "tools", "profile_spans.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tool_trace_metrics_on_a_synthetic_trace(tmp_path):
    """Ops per range by the launching thread, the device's copy of each
    range left out, idle gaps put down to the innermost span."""
    def x(name, cat, ts, dur, tid, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "tid": tid, "args": args}
    base = 1_000_000_000_000
    events = [
        x("crowdnav.env.step", "user_annotation", 0.0, 100.0, 1),
        x("crowdnav.env.orca", "user_annotation", 10.0, 50.0, 1),
        x("crowdnav.env.orca", "gpu_user_annotation", 20.0, 65.0, 7),
        x("cudaLaunchKernel", "cuda_runtime", 15.0, 2.0, 1, correlation=1),
        x("cudaLaunchKernel", "cuda_runtime", 70.0, 2.0, 1, correlation=2),
        x("k_a", "kernel", 20.0, 5.0, 7, correlation=1),
        x("k_b", "kernel", 80.0, 5.0, 7, correlation=2)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": base,
                                "traceEvents": events}))
    snap = {"spans": [
        {"name": "env.step", "start_ns": base, "end_ns": base + 100_000},
        {"name": "env.orca", "start_ns": base + 10_000,
         "end_ns": base + 60_000}]}
    out = _tool().trace_metrics(str(path), snap, window_s=1e-4)
    assert out["orca_kernels"] == 1.0
    assert out["ops_per_range"] == {"env.orca": 1.0, "env.step": 2.0}
    assert out["idle_gaps_by_span"] == [["env.orca", pytest.approx(55e-6)]]
    assert out["idle_under_inner_spans"] == 100.0
    assert out["device_idle"] == pytest.approx(90.0)
    assert out["span_stamp_vs_range_us"]["start"]["max"] == 0.0


def test_tool_innermost_span_with_shared_boundaries():
    """A child that starts or ends with its parent is still the innermost
    span inside it, and the parent again after it."""
    times, labels = _tool()._innermost([
        (0.0, 10.0, "env.step"), (0.0, 4.0, "env.orca"),
        (6.0, 10.0, "env.observe"), (12.0, 20.0, "gst.pretext")])
    def at(t):
        i = max(i for i, x in enumerate(times) if x <= t)
        return labels[i]
    assert [at(t) for t in (1.0, 5.0, 7.0, 11.0, 13.0, 21.0)] == [
        "env.orca", "env.step", "env.observe", "no span", "gst.pretext",
        "no span"]


def test_tool_reports_the_readings_on_the_cpu(capsys):
    out = _tool().main(["--device", "cpu", "--envs", "4", "--steps", "3",
                        "--iterations", "1", "--cost-rounds", "0"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(out))
    assert out["device"] == "cpu" and out["init_state_s"] > 0.0
    s = out["spans"]
    # the CPU's reads each step: vec_done and ORCA's LP3 (the events read
    # nothing)
    assert s["env_steps"] == 3 and s["env_syncs"] >= 2.0
    assert 0.0 < s["orca_ms"] <= s["env_step_ms"]
    for key in ("auto_reset_ms", "orca_lp3_share", "backward_ms"):
        assert s[key] is not None and s[key] >= 0.0, key
    # no device ops on the CPU: no idle share, no ops per range
    assert out["traced"]["device_ops"] == 0
    assert out["traced"]["orca_kernels"] is None
    assert "idle_gaps_by_span" not in out["traced"]
    assert out["host_cost"]["span_us_off"] < out["host_cost"]["span_us_on"]
    assert not profiling._ON


def test_tool_reports_ds_rnn_spans_on_the_cpu(capsys):
    T = 3
    out = _tool().main(["--config", "srnn", "--device", "cpu", "--envs", "4",
                        "--steps", str(T), "--iterations", "1",
                        "--cost-rounds", "0"])
    capsys.readouterr()
    s = out["spans"]
    assert s["env_steps"] == T
    for name in SRNN_SPANS:
        assert name in s["spans_per_step"], name
    assert "gst.pretext" not in s["spans_per_step"]
    # an iteration: T acts and the bootstrap value (T = 1 each), then the
    # ppo_epoch x num_mini_batch minibatch forwards over T steps
    cells = 3 * (T + 1) + 5 * 2 * 3 * T
    assert s["counters_per_step"]["srnn.gru_cells"] == cells / T
