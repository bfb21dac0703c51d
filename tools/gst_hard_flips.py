"""How many of the edge selector's hard samples differ between the port and
the benchmark's plain reference, over the steps a benchmark run checks.

  python tools/gst_hard_flips.py [--workload sparsegst-train] --seeds 1,2,3

For each seed, runs the cell's set-up as a benchmark run does (the envs
reset from the seed and the first PPO iteration, every env step recorded),
then, for each recorded step, feeds the GST inputs that step's pretext pass
read (the pushed history buffers of the recorded state) to the port's GST
op by op (``gst_forward``) and through its CUDA graph (``gst_predict``),
and to the reference's (``benchmark/reference/predictor.py``) at the
reference's precision and at the control's (``reference/precision.py``),
all on the same device, so the selector's uniforms (drawn from a generator
seeded 0 there) are the same draws. Counts, over every edge-selector call,
the (target, head) rows whose hard sample differs from the reference's:
the port's, and the control's. Prints one JSON line a seed. Runs on the
card (``--device cpu`` at a tiny size for a try: ``--envs 4 --humans 4
--steps 3``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
sys.path.insert(0, BENCH)
sys.path.insert(1, REPO)

from crowdnav_prediction_attngraph_tpu_torch.models.gst.predictor import (  # noqa: E402
    gst_forward, gst_predict)


def _sampled(model, call):
    """The hard samples (bool, one-hot on the last axis) of every
    edge-selector call of ``call()``, and its output."""
    calls = []
    handle = model.gst.edge_selector.register_forward_hook(
        lambda mod, args, out: calls.append(out[1] > 0.5))
    try:
        out = call()
    finally:
        handle.remove()
    return calls, out


def _flips(a, b) -> int:
    """(target, head) rows whose chosen neighbour differs."""
    return sum(int((x.float().argmax(-1) != y.float().argmax(-1)).sum())
               for x, y in zip(a, b))


def config_path(cell, envs, humans, steps) -> str:
    """The cell's configuration file, or a copy cut to ``envs`` x
    ``humans`` x ``steps`` (a try on the CPU)."""
    from harness import spec
    path = os.path.join(spec.ROOT, cell.config_file)
    if not (envs or humans or steps):
        return path
    d = dict(cell.config)
    d["ppo"] = dict(d["ppo"], num_processes=envs or d["ppo"]["num_processes"],
                    num_steps=steps or d["ppo"]["num_steps"])
    if humans:
        d["sim"] = dict(d["sim"], human_num=humans,
                        human_num_range=min(d["sim"]["human_num_range"],
                                            humans - 1))
    fd, path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(d, f)
    return path


def flips(workload: str, seed: int, device, envs=0, humans=0,
          steps=0) -> dict:
    from harness import check, port, runner, spec
    import reference.predictor as rpred
    from reference import precision
    cell = spec.load_cell(workload)
    driver = spec.load_module("drivers", cell.mix["driver"])
    path = config_path(cell, envs, humans, steps)
    run = runner.Run(cell=cell, seed=int(seed), device=device, trace=False,
                     port=port.import_port(), config_path=path,
                     mix=dict(cell.mix))
    try:
        driver.setup(run)
        rec = driver.records(run)
        rcfg = check.ref_config(rec)
    finally:
        port.unwrap_all()
        if path != os.path.join(spec.ROOT, cell.config_file):
            os.remove(path)
    cfg, gst = run.state["cfg"], run.state["gst"]
    run.state.clear()
    gc.collect()
    out = {"workload": workload, "seed": seed, "steps": len(rec.steps),
           "rows": 0, "program_flips": 0, "control_flips": 0,
           "replay_equals_eager": True}
    refs = {}
    for mode in ("ref", "control"):
        with precision.mode(mode):
            refs[mode] = rpred.load_gst(rcfg.pred, rec.gst_path, device)
    for r in rec.steps:
        st = r["state_out"]
        traj = st["traj_buffer"][:, ::cfg.pred_interval].transpose(1, 2)
        mask = st["mask_buffer"][:, ::cfg.pred_interval].transpose(1, 2)
        prog, eager = _sampled(gst, lambda: gst_forward(gst, traj, mask))
        replay = gst_predict(gst, traj, mask)
        out["replay_equals_eager"] &= all(
            torch.equal(a, b) for a, b in zip(replay, eager))
        seen = {}
        for mode, model in refs.items():
            with precision.mode(mode), torch.no_grad():
                seen[mode], _ = _sampled(
                    model, lambda: rpred.gst_predict(model, traj, mask))
        out["rows"] += sum(int(x[..., 0].numel()) for x in seen["ref"])
        out["program_flips"] += _flips(prog, seen["ref"])
        out["control_flips"] += _flips(seen["control"], seen["ref"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="sparsegst-train")
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--envs", type=int, default=0)
    p.add_argument("--humans", type=int, default=0)
    p.add_argument("--steps", type=int, default=0)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = flips(args.workload, seed, device, args.envs, args.humans,
                    args.steps)
        res["seconds"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
