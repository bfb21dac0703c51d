"""Training checkpoints in the port's own format (JAX package
``utils/checkpoint.py:14-46``, which uses orbax; the port's machines have
none).

``<dir>/<update:05d>.pt`` holds the policy's state_dict, the optimizer's
and the lr schedule's, the update index and the generator states (the
action/minibatch generator and every env's). Beside it, ``<update:05d>.npz``
holds the params alone in the flax-tree layout of the committed weight
files, which ``load_policy`` and the ``test`` CLI (``--params``) read.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .params import flatten_tree, state_dict_to_tree


def save_params(path: str, model: torch.nn.Module):
    """The model's params as a flax-tree ``.npz`` (tree paths joined with
    '/')."""
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **flatten_tree(state_dict_to_tree(model.state_dict())))
    os.replace(tmp, path)


def save_train_state(ckpt_dir: str, ts, step: int):
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{step:05d}.pt")
    payload = {
        "params": ts.model.state_dict(),
        "optimizer": ts.optimizer.state_dict(),
        "schedule": ts.schedule.state_dict(),
        "update": step,
        "generator": ts.generator.get_state(),
        "env_generators": [g.get_state() for g in ts.env_states.gens],
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    save_params(os.path.join(ckpt_dir, f"{step:05d}.npz"), ts.model)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(f[:-3]) for f in os.listdir(ckpt_dir)
             if f.endswith(".pt") and f[:-3].isdigit()]
    return max(steps) if steps else None


def restore_train_state(ckpt_dir: str, ts, step: Optional[int] = None
                        ) -> Tuple[object, int]:
    """Load params, optimizer, schedule and generator states into ``ts`` (in
    place) from checkpoint ``step`` (default: the latest); returns (ts, the
    next update index)."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    payload = torch.load(os.path.join(ckpt_dir, f"{step:05d}.pt"),
                         map_location="cpu", weights_only=True)
    ts.model.load_state_dict(payload["params"], strict=True)
    ts.optimizer.load_state_dict(payload["optimizer"])
    ts.schedule.load_state_dict(payload["schedule"])
    ts.generator.set_state(payload["generator"])
    if len(payload["env_generators"]) != len(ts.env_states.gens):
        raise ValueError(f"checkpoint has {len(payload['env_generators'])} "
                         f"env generators, the run {len(ts.env_states.gens)}")
    for g, state in zip(ts.env_states.gens, payload["env_generators"]):
        g.set_state(state)
    return ts, payload["update"] + 1
