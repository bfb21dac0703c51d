"""The data- and tensor-parallel PPO iteration (JAX package
``parallel/train_step.py``).

The JAX step is one program over the mesh, so its result is the
single-device one. The port runs one process per device and keeps that
global-batch meaning:

* rank (d, t) steps the envs of dp index d only, each from its own
  ``case_generator`` stream, and draws every step's action noise for all
  envs from the generator all ranks share, keeping its slice;
* the rollout batch (small: envs x steps) is gathered over dp, so the
  advantages are normalised over the whole batch and the minibatches follow
  the one permutation of all envs;
* each dp index takes its part of every minibatch and weighs its loss by
  its share; the gradients are summed over dp and clipped by the norm of
  the whole gradient (``algo/ppo.py::ppo_update``);
* under tp the 512-wide attention leaves and their Adam moments are tp
  pieces (``mesh.shard_params``), and ``use_ring_attention`` shards the
  agent axis of the einsum branch over tp (``edge_partition.py``).

The lr schedule and the unicycle's spin warmup read the global step count,
as in one process.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..algo import ppo as ppo_mod
from ..config import Config
from ..models import policy as policy_mod
from ..models.gst.st_model import STModel
from .mesh import Mesh, shard_params, use_mesh


def init_sharded(cfg: Config, mesh: Mesh, gst_model: Optional[STModel],
                 device, model: Optional[policy_mod.PolicyHead] = None
                 ) -> ppo_mod.TrainState:
    """This rank's TrainState: its dp index's envs only, the policy
    (default: ``init_params`` from ``ppo.seed``, the same on every rank)
    stored as tp pieces, and an optimizer over those pieces."""
    if model is None:
        model = policy_mod.init_params(
            cfg, torch.Generator().manual_seed(cfg.ppo.seed), device)
    shard_params(model, mesh)
    return ppo_mod.init_train_state(
        cfg, gst_model, device, model,
        env_ids=mesh.env_slice(cfg.ppo.num_processes))


def gather_batch(batch: ppo_mod.RolloutBatch, mesh: Mesh
                 ) -> ppo_mod.RolloutBatch:
    """Every dp index's rollout, concatenated along the env axis in env
    order (axis 1; axis 0 of the initial hidden state)."""
    out = {}
    for f in dataclasses.fields(batch):
        value, dim = getattr(batch, f.name), 0 if f.name == "hxs0" else 1
        out[f.name] = ({k: mesh.gather_dp(v, dim) for k, v in value.items()}
                       if isinstance(value, dict)
                       else mesh.gather_dp(value, dim))
    return ppo_mod.RolloutBatch(**out)


def train_iteration(cfg: Config, ts: ppo_mod.TrainState,
                    gst_model: Optional[STModel], mesh: Mesh
                    ) -> Tuple[ppo_mod.TrainState, Dict[str, torch.Tensor]]:
    """One PPO iteration of this rank (``algo/ppo.py::train_iteration`` over
    the mesh). The metrics are those of the whole batch, the same on every
    rank."""
    offset = mesh.env_slice(cfg.ppo.num_processes).start
    with use_mesh(mesh):
        ts, batch = ppo_mod.rollout(cfg, ts, gst_model, env_offset=offset)
        batch = gather_batch(batch, mesh)
        metrics = ppo_mod.ppo_update(cfg, ts.model, ts.optimizer,
                                     ts.schedule, batch, ts.generator,
                                     mesh=mesh)
    metrics.update(ppo_mod.batch_metrics(batch))
    return ts, metrics
