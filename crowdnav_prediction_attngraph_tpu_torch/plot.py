"""Training-curve plotting (JAX package ``plot.py``; reference plot.py:1-44):
reads the ``progress.csv`` of one or more runs of the port's ``train`` and
plots the chosen series (default eprewmean and the value loss) against
``misc/total_timesteps``, one panel per series.

  python -m crowdnav_prediction_attngraph_tpu_torch.plot \\
      trained_models/my_model [...] --out training_curves.png

The CSV is read with the ``csv`` module (an empty cell is NaN); matplotlib
is imported only by ``main``.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
from typing import Dict, List


def read_progress(path: str) -> Dict[str, List[float]]:
    """{column: values} of a progress.csv, every cell a float."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: [float(r[i]) if i < len(r) and r[i] != "" else math.nan
                   for r in body]
            for i, name in enumerate(header)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("runs", nargs="+", help="run directories with progress.csv")
    p.add_argument("--out", default="training_curves.png")
    p.add_argument("--metrics", nargs="+",
                   default=["eprewmean", "loss/value_loss"])
    args = p.parse_args(argv)

    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure
    fig = Figure(figsize=(6 * len(args.metrics), 4))
    FigureCanvasAgg(fig)
    axes = fig.subplots(1, len(args.metrics))
    if len(args.metrics) == 1:
        axes = [axes]
    for run in args.runs:
        cols = read_progress(os.path.join(run, "progress.csv"))
        label = os.path.basename(os.path.normpath(run))
        for ax, metric in zip(axes, args.metrics):
            ax.plot(cols["misc/total_timesteps"], cols[metric], label=label)
    for ax, metric in zip(axes, args.metrics):
        ax.set_xlabel("timesteps")
        ax.set_ylabel(metric)
        ax.legend()
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
