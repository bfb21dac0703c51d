"""Seeded weights of the sparse Gumbel Social Transformer, for the port.

  python tools/make_sparse_gst_weights.py [--seed 2022] [--out <path>.npz]

Draws an ``STModel`` with the edge selector (4 heads, the reference
``EdgeSelector``'s count) and its ghost node at the committed GST's widths
(embedding 64, 8 node heads, one spatial layer, feed-forward 128, LSTM 64,
obs 5 / pred 5) from a CPU generator seeded ``--seed`` with
``st_model.init_gst`` (flax's initializers), and writes it as a ``.npz``
under a top ``params`` level, the layout of the committed exports, which
``utils/params.load_npz`` and ``models/gst/predictor.load_gst`` read. No
sparse GST checkpoint was published; these weights cost the card the same
work as trained ones, since the selector scores every candidate edge before
its hard sample. Runs on the CPU in about a second; the committed file is
``crowdnav_prediction_attngraph_tpu_torch/weights/gst_sparse_ghost_e4_seed2022.npz``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from crowdnav_prediction_attngraph_tpu_torch.config import PredConfig  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.models.gst.st_model import init_gst  # noqa: E402
from crowdnav_prediction_attngraph_tpu_torch.utils.params import (  # noqa: E402
    flatten_tree, state_dict_to_tree)

SEED = 2022
EDGE_HEADS = 4
OUT = os.path.join(REPO, "crowdnav_prediction_attngraph_tpu_torch", "weights",
                   f"gst_sparse_ghost_e{EDGE_HEADS}_seed{SEED}.npz")


def sparse_config(edge_heads: int = EDGE_HEADS) -> PredConfig:
    """The committed GST's widths with the edge selector and its ghost."""
    return dataclasses.replace(PredConfig(), spatial_num_heads_edges=edge_heads,
                               ghost=True)


def write(path: str, seed: int = SEED, edge_heads: int = EDGE_HEADS) -> dict:
    """Draw the weights from ``seed`` and write them to ``path``; returns the
    flat ``{tree path: array}`` written."""
    model = init_gst(sparse_config(edge_heads),
                     torch.Generator().manual_seed(seed), "cpu")
    flat = flatten_tree({"params": state_dict_to_tree(model.state_dict())})
    np.savez(path, **flat)
    return flat


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--edge-heads", type=int, default=EDGE_HEADS)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    flat = write(args.out, args.seed, args.edge_heads)
    print(f"wrote {args.out}: {len(flat)} arrays, "
          f"{sum(v.size for v in flat.values())} floats")
    return 0


if __name__ == "__main__":
    sys.exit(main())
