"""One run of one benchmark cell of the PyTorch/CUDA port.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up the cell (set-up), measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints the
result as one JSON line, the last line of standard output; each number the
check compared, beside its limit, ends standard error. With ``--trace 1``
the metrics are the cell's per-layer metrics, read from host spans and a
``torch.profiler`` trace of a slice of the window. Runs from the root of a
checkout, on the cards the cell asks for; exits non-zero, and prints no
result, without them.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# every build and kernel cache of the run at a fixed path in the checkout;
# nothing the port uses may load JAX
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".torch_build",
                                                  "extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".torch_build", "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    from harness import runner
    result = runner.execute(args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0),
                            T_PROCESS)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
