"""GST training-data collection (JAX package ``collect_data.py:36-101``;
reference collect_data.py:13-80).

Runs ``--num-envs`` collect envs as one batch on the device, keeps a
``(frame, track_id, x, y)`` record of every visible human every
``pred_interval`` steps, and writes one tab-separated txt per env in the
reference's format (``frame\\tid\\tx\\ty``), so datasets are interchangeable
between the packages.

Usage:
  python -m crowdnav_prediction_attngraph_tpu_torch.collect_data \\
      --tot-steps 40000 --num-envs 5 --out data/orca_20humans

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch

from .config import varnum_config
from .env import collect
from .utils.device import resolve_device


def env_generators(num_envs: int, seed: int) -> List[torch.Generator]:
    """One CPU generator per env, env i's seeded ``(seed << 32) + i``."""
    return [torch.Generator().manual_seed((seed << 32) + i)
            for i in range(num_envs)]


def collect_dataset(cfg, num_envs: int, tot_steps: int, seed: int = 0,
                    chunk: int = 64, device="cuda") -> List[np.ndarray]:
    """Per-env (N, 4) float64 arrays of (frame, id, x, y) rows, in step
    order and slot order within a step. Steps run in chunks of ``chunk *
    pred_interval``, until ``tot_steps`` is covered in units of ``chunk``
    (as the JAX package counts, :164-168); each chunk's records move to the
    host in one copy."""
    device = resolve_device(device)
    state, _ = collect.reset(cfg, env_generators(num_envs, seed), device)
    pred_interval = cfg.pred_interval
    parts = [[] for _ in range(num_envs)]
    remaining = int(tot_steps)
    while remaining > 0:
        infos = []
        for _ in range(chunk * pred_interval):
            state, info = collect.step(cfg, state)
            infos.append(info)
        # the kept steps (every pred_interval-th, from the chunk's first),
        # one device-to-host copy per field
        kept = infos[::pred_interval]
        frame = torch.stack([i.frame for i in kept]).cpu().numpy()  # (T, B, A)
        ids = torch.stack([i.pred_id for i in kept]).cpu().numpy()
        pos = torch.stack([i.pos for i in kept]).cpu().numpy()      # (T, B, A, 2)
        valid = torch.stack([i.valid for i in kept]).cpu().numpy()
        rows = np.stack([frame, ids.astype(float), pos[..., 0], pos[..., 1]],
                        axis=-1)                                   # (T, B, A, 4)
        for b in range(num_envs):
            parts[b].append(rows[:, b][valid[:, b]])
        remaining -= chunk
    return [np.concatenate(p, axis=0) for p in parts]


def write_records(out_dir: str, data: List[np.ndarray]):
    """``<out_dir>/<i>.txt`` per env, one ``frame\\tid\\tx\\ty`` line per
    row, each value printed as Python prints a float (the JAX package's
    format, :189-192)."""
    os.makedirs(out_dir, exist_ok=True)
    for i, rows in enumerate(data):
        with open(os.path.join(out_dir, f"{i}.txt"), "w") as f:
            f.writelines(f"{r[0]}\t{r[1]}\t{r[2]}\t{r[3]}\n"
                         for r in rows.tolist())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tot-steps", type=int, default=40000)
    p.add_argument("--num-envs", type=int, default=5)
    p.add_argument("--human-num", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--phase", default="train", choices=["train", "test"])
    p.add_argument("--out", default="data/orca_20humans")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = varnum_config(human_num=args.human_num)
    data = collect_dataset(cfg, args.num_envs, args.tot_steps, args.seed,
                           device=args.device)
    out_dir = os.path.join(args.out, args.phase)
    write_records(out_dir, data)
    print(f"wrote {sum(len(d) for d in data)} records to {out_dir}")
    return data


if __name__ == "__main__":
    main()
