"""Standalone GST predictor evaluation (JAX package ``models/gst/eval.py:42-239``;
reference gst_updated/scripts/experiments/eval.py).

The reference's two inference modes (eval.py:57-150):
  val  -- soft edges (hard=False), the decoder feeds back the predicted
          means (sampling=False); metrics normalised per pedestrian over the
          whole split: sum(aoe) / sum(full-period mask) (eval.py:139-147)
  test -- 20 stochastic decoder rollouts (hard=True, sampling=True unless
          --deterministic); per-window ped-summed aoe/foe -> mean, std
          (ddof 1) and min across samples, normalised by the split's mask
          sum (eval.py:84-117, 149-150)

and the checkpoint-consistency check (eval.py:36-41): the val metrics the
trainer stored beside the checkpoint are printed next to the recomputed
ones.

Usage:
  python -m crowdnav_prediction_attngraph_tpu_torch.models.gst.eval \\
      --data-dir data/orca20 --ckpt results/gst_run/epoch_100
  python -m crowdnav_prediction_attngraph_tpu_torch.models.gst.eval \\
      --dataset sj --torch-ckpt <reference run>/checkpoint/epoch_100.pt

``--torch-ckpt`` imports one of the reference's checkpoints
(``utils/torch_import.py``) and prints the val metrics stored in it
(``val_loss_epoch`` / ``val_aoe_epoch`` / ``val_foe_epoch``) beside the
recomputed ones.

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ...config import PredConfig
from ...utils.checkpoint import GST_PARAMS
from ...utils.device import resolve_device
from ...utils.torch_import import load_torch_checkpoint
from . import dataset as ds
from .predictor import load_gst
from .st_model import STModel
from .trainer import forward_batch, to_device


@torch.no_grad()
def evaluate_dataset(model: STModel, windows, batch_size: int = 16,
                     tau: float = 0.03, mode: str = "val",
                     num_samples: int = 20,
                     deterministic_loss: bool = False) -> dict:
    """Split metrics (eval.py:57-150) of ``model`` on ``windows``, batches
    built on the host and run on the model's device. The draws of batch i
    come from a generator seeded i (val) or 1000 + i (test)."""
    device = next(model.parameters()).device
    rng = np.random.RandomState(0)
    losses, weights, mask_sum = [], [], 0.0
    batches = ds.batches(windows, batch_size, rng, shuffle=False,
                         drop_last=False)
    if mode == "val":
        aoe_sum = foe_sum = 0.0
        for i, batch in enumerate(batches):
            gen = torch.Generator(device=device).manual_seed(i)
            loss, aoe, foe, full = forward_batch(
                model, to_device(batch, device), tau, False, False,
                deterministic_loss, gen)
            losses.append(loss.item())
            weights.append(batch["v"].shape[0])
            aoe_sum += aoe.sum().item()
            foe_sum += foe.sum().item()
            mask_sum += full.sum().item()
        d = max(mask_sum, 1.0)
        # per-window mean (the reference iterates at batch_size 1)
        return {"loss": float(np.average(losses, weights=weights)),
                "aoe": aoe_sum / d, "foe": foe_sum / d}
    if mode != "test":
        raise ValueError(f"mode must be 'val' or 'test', got {mode!r}")
    # test: num_samples stochastic rollouts, mean/std/min taken across the
    # samples PER WINDOW (the reference's batch_size-1 best-of-20 statistic,
    # summed over the split and normalised by its mask sum,
    # eval.py:84-117, 149-157)
    sampling = not deterministic_loss
    aoe_cols, foe_cols = [], []          # each (num_samples, B) per batch
    for i, batch in enumerate(batches):
        tb = to_device(batch, device)
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        batch_losses, aoe_s, foe_s = [], [], []
        for _ in range(num_samples):
            loss, aoe, foe, full = forward_batch(
                model, tb, tau, True, sampling, deterministic_loss, gen)
            batch_losses.append(loss)
            aoe_s.append(aoe.sum(dim=1))        # ped-summed, per window
            foe_s.append(foe.sum(dim=1))
        aoe_cols.append(torch.stack(aoe_s).double().cpu().numpy())
        foe_cols.append(torch.stack(foe_s).double().cpu().numpy())
        losses.append(float(torch.stack(batch_losses).mean()))
        weights.append(batch["v"].shape[0])
        mask_sum += full.sum().item()
    aoe_sw = np.concatenate(aoe_cols, axis=1)              # (S, num_windows)
    foe_sw = np.concatenate(foe_cols, axis=1)
    d = max(mask_sum, 1.0)
    return {"loss": float(np.average(losses, weights=weights)),
            "aoe": float(aoe_sw.mean(axis=0).sum()) / d,
            "foe": float(foe_sw.mean(axis=0).sum()) / d,
            "aoe_std": float(aoe_sw.std(axis=0, ddof=1).sum()) / d,
            "foe_std": float(foe_sw.std(axis=0, ddof=1).sum()) / d,
            "aoe_min": float(aoe_sw.min(axis=0).sum()) / d,
            "foe_min": float(foe_sw.min(axis=0).sum()) / d}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default=None,
                   help="named benchmark (eth/hotel/univ/zara1/zara2/sdd/sj)")
    p.add_argument("--data-root", default="datasets",
                   help="root holding the reference directory layout")
    p.add_argument("--data-dir", default=None,
                   help="flat dir of txt files (collect_data output)")
    p.add_argument("--split", default="val")
    p.add_argument("--mode", default=None, choices=["val", "test"],
                   help="inference mode (default: same as --split)")
    p.add_argument("--obs-len", type=int, default=None)
    p.add_argument("--pred-len", type=int, default=None)
    p.add_argument("--num-samples", type=int, default=20)
    p.add_argument("--ckpt", default=None,
                   help="epoch_N directory written by the port's trainer")
    p.add_argument("--torch-ckpt", default=None,
                   help="reference epoch_*.pt to import instead")
    p.add_argument("--max-peds", type=int, default=None,
                   help="cap on pedestrians per window; default: no cap for "
                        "--dataset benchmarks, 32 for --data-dir dumps "
                        "(matching the trainer)")
    p.add_argument("--edge-heads", type=int, default=0)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--stride", type=int, default=1,
                   help="window stride for --data-dir dumps")
    p.add_argument("--max-windows", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not (args.ckpt or args.torch_ckpt):
        raise SystemExit("provide --ckpt or --torch-ckpt")
    device = resolve_device(args.device)

    cfg = dataclasses.replace(PredConfig(),
                              spatial_num_heads_edges=args.edge_heads)
    obs_len = args.obs_len or cfg.obs_seq_len
    pred_len = args.pred_len or cfg.pred_seq_len
    cfg = dataclasses.replace(cfg, obs_seq_len=obs_len, pred_seq_len=pred_len)

    if args.dataset:
        windows = ds.load_benchmark(args.dataset, args.data_root, args.split,
                                    obs_len, pred_len, max_peds=args.max_peds)
        name = args.dataset
    elif args.data_dir:
        sub = os.path.join(args.data_dir, args.split)
        windows = ds.load_dataset(sub if os.path.isdir(sub) else args.data_dir,
                                  obs_len, pred_len,
                                  32 if args.max_peds is None
                                  else args.max_peds,
                                  stride=args.stride,
                                  max_windows=args.max_windows)
        name = args.data_dir
    else:
        raise SystemExit("provide --dataset or --data-dir")
    if not windows:
        raise SystemExit(f"no windows found for {name}:{args.split}")
    print(f"{len(windows)} {args.split} windows "
          f"({windows[0]['v'].shape[1]} ped slots)")

    stored = None
    if args.torch_ckpt:
        model = load_gst(cfg, args.torch_ckpt, device)
        raw = load_torch_checkpoint(args.torch_ckpt)
        stored = {k: float(raw[k]) for k in
                  ("val_loss_epoch", "val_aoe_epoch", "val_foe_epoch")
                  if k in raw}
    else:
        model = load_gst(cfg, os.path.join(args.ckpt, GST_PARAMS), device)
        meta_path = os.path.join(args.ckpt, "val_metrics.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                stored = json.load(f)

    mode = args.mode or ("test" if args.split == "test" else "val")
    m = evaluate_dataset(model, windows, batch_size=args.batch_size,
                         mode=mode, num_samples=args.num_samples,
                         deterministic_loss=args.deterministic)
    if stored:
        # checkpoint-consistency check (reference eval.py:36-41): on the
        # checkpoint's own val split these must match the recomputation
        print("Stored in checkpoint: "
              + " | ".join(f"{k} {v:.4f}" for k, v in stored.items()))
    print(f"{name}/{args.split} [{mode}]: " + " | ".join(
        f"{k} {v:.4f}" for k, v in m.items()))
    return m


if __name__ == "__main__":
    main()
