"""Readings that the limits of a cell's correctness check are set from.

  python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds <s> [--faults]

For each seed, runs the cell's set-up and a window of ``--seconds`` as a
benchmark run does, then reads on the records of that run the numbers of
the program, of the control (the reference in the program's place, one
step below the configuration's precision: ``reference/precision.py``) and,
with ``--faults``, of the reference with each fault of ``harness/check``
planted. Prints one JSON line a seed. All seeds run in one process, one
after another; the benchmark's own runs never run this.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".torch_build",
                                                  "extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".torch_build", "triton")
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)


def readings(cell_name: str, seed: int, seconds: float, device, faults,
             config_path=None, mix_overrides=None, root=ROOT) -> dict:
    """{"program": {...}, "control": {...}, <fault>: {...}} for one seed."""
    import torch
    from harness import check, port, runner, spec
    cell = spec.load_cell(cell_name, root)
    mix = dict(cell.mix, **(mix_overrides or {}))
    driver = spec.load_module("drivers", mix["driver"], root)
    run = runner.Run(cell=cell, seed=int(seed), device=device, trace=False,
                     port=port.import_port(),
                     config_path=config_path or os.path.join(
                         root, cell.config_file), mix=mix)
    try:
        driver.setup(run)
        driver.window(run, seconds)
        records = driver.records(run)
    finally:
        port.unwrap_all()
    run.state.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = check.calibrate(records, device, faults)
    out["attempted"] = run.attempted
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from harness import check
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = readings(args.workload, seed, args.seconds, device,
                       check.FAULTS if args.faults else ())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
