"""Training checkpoints in the port's own format (JAX package
``utils/checkpoint.py:14-73``, which uses orbax; the port's machines have
none).

PPO: ``<dir>/<update:05d>.pt`` holds the policy's state_dict, the
optimizer's and the lr schedule's, the update index and the generator
states (the action/minibatch generator and every env's). Beside it,
``<update:05d>.npz`` holds the params alone in the flax-tree layout of the
committed weight files, which ``load_policy`` and the ``test`` CLI
(``--params``) read.

GST trainer: ``epoch_N/params.npz`` (the same flax-tree layout, which
``load_gst`` and the ``--gst-params`` flags read) and
``epoch_N/opt_state.pt`` (the Adam state and the schedule's step count).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .params import (flatten_tree, load_npz, state_dict_to_tree,
                     tree_to_state_dict)


def save_params(path: str, model):
    """A model's params (or a state_dict) as a flax-tree ``.npz`` (tree
    paths joined with '/')."""
    state = (model.state_dict() if isinstance(model, torch.nn.Module)
             else model)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **flatten_tree(state_dict_to_tree(state)))
    os.replace(tmp, path)


def write_train_state(ckpt_dir: str, payload: dict):
    """Write a checkpoint ``payload`` (the fields of
    :func:`save_train_state`'s) as ``<update>.pt`` and its params as
    ``<update>.npz``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    step = payload["update"]
    path = os.path.join(ckpt_dir, f"{step:05d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    save_params(os.path.join(ckpt_dir, f"{step:05d}.npz"), payload["params"])


def save_train_state(ckpt_dir: str, ts, step: int):
    write_train_state(ckpt_dir, {
        "params": ts.model.state_dict(),
        "optimizer": ts.optimizer.state_dict(),
        "schedule": ts.schedule.state_dict(),
        "update": step,
        "generator": ts.generator.get_state(),
        "env_generators": [g.get_state() for g in ts.env_states.gens],
    })


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(f[:-3]) for f in os.listdir(ckpt_dir)
             if f.endswith(".pt") and f[:-3].isdigit()]
    return max(steps) if steps else None


def load_train_state(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The payload of checkpoint ``step`` (default: the latest)."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return torch.load(os.path.join(ckpt_dir, f"{step:05d}.pt"),
                      map_location="cpu", weights_only=True)


def restore_train_state(ckpt_dir: str, ts, step: Optional[int] = None
                        ) -> Tuple[object, int]:
    """Load params, optimizer, schedule and generator states into ``ts`` (in
    place) from checkpoint ``step`` (default: the latest); returns (ts, the
    next update index)."""
    payload = load_train_state(ckpt_dir, step)
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


GST_PARAMS = "params.npz"
GST_OPT_STATE = "opt_state.pt"


def save_trainer_checkpoint(ck_dir: str, model: torch.nn.Module,
                            optimizer: torch.optim.Optimizer, step: int):
    """The GST trainer's checkpoint: ``params.npz`` and ``opt_state.pt``
    (the optimizer's state and ``step``, the count of Adam steps taken,
    which the lr schedule reads) under ``ck_dir``."""
    os.makedirs(ck_dir, exist_ok=True)
    save_params(os.path.join(ck_dir, GST_PARAMS), model)
    path = os.path.join(ck_dir, GST_OPT_STATE)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"optimizer": optimizer.state_dict(), "step": step}, tmp)
    os.replace(tmp, path)


def restore_trainer_checkpoint(ck_dir: str, model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer) -> int:
    """Load a :func:`save_trainer_checkpoint` into ``model`` and
    ``optimizer`` (in place); returns the saved step count."""
    sd = tree_to_state_dict(load_npz(os.path.join(ck_dir, GST_PARAMS)))
    model.load_state_dict(sd, strict=True)
    payload = torch.load(os.path.join(ck_dir, GST_OPT_STATE),
                         map_location="cpu", weights_only=True)
    optimizer.load_state_dict(payload["optimizer"])
    return int(payload["step"])
