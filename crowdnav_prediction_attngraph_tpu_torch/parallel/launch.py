"""Multi-process launch (JAX package ``parallel/launch.py``): the process
group, the global mesh, each rank's share of the train state, and
checkpoints in the single-process layout.

One process per device. The same command on every process:

  python -m crowdnav_prediction_attngraph_tpu_torch.train --multihost \\
      --coordinator-address host0:29500 --num-hosts 8 --process-id $RANK ...

or, without the three flags, under ``torchrun`` (``env://``, as the JAX
package auto-detects its hosts):

  torchrun --nproc-per-node 8 -m crowdnav_prediction_attngraph_tpu_torch.train \\
      --multihost ...

``--num-hosts`` is the number of processes. On ``cuda`` the group is NCCL
and the process runs on ``cuda:LOCAL_RANK``; with ``--device cpu`` it is
gloo.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils import checkpoint as ckpt_util
from ..utils.device import resolve_device
from . import train_step
from .mesh import (Mesh, full_params, load_full_params, make_mesh,
                   plain_name, plain_order)

_OWNED = False


def free_port() -> int:
    """A free TCP port on this machine's loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               init_method: Optional[str] = None) -> int:
    """Start the process group and return this process's rank; a no-op when
    one is up already. NCCL on ``cuda`` (this process's card set from
    ``LOCAL_RANK``, else from its rank), gloo on the CPU. The rendezvous is
    ``init_method`` when given, ``tcp://coordinator_address`` with the
    process count and id, else ``env://`` under ``torchrun``, else a world
    of one."""
    global _OWNED
    if dist.is_initialized():
        return dist.get_rank()
    dev = resolve_device(device)
    if init_method is None:
        if coordinator_address:
            if num_processes is None or process_id is None:
                raise ValueError("--coordinator-address needs --num-hosts "
                                 "and --process-id")
            init_method = f"tcp://{coordinator_address}"
        elif "MASTER_ADDR" in os.environ:
            init_method = "env://"
        else:
            init_method = f"tcp://127.0.0.1:{free_port()}"
            num_processes, process_id = 1, 0
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = (process_id if process_id is not None
                     else os.environ.get("RANK", 0))
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    _OWNED = True
    return dist.get_rank()


def finalize():
    """Destroy the process group if :func:`initialize` started it."""
    global _OWNED
    if _OWNED and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED = False


def local_device(device="cuda") -> torch.device:
    """This process's device: its card on ``cuda``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def global_mesh(tp: int = 1) -> Mesh:
    """The mesh over every process of the world: ("dp", "tp")."""
    return make_mesh(dist.get_world_size(), tp=tp)


# this rank's share of the train state: only its own envs are built
init_sharded_global = train_step.init_sharded


def make_global_iteration(cfg, mesh: Mesh, gst_model=None):
    """ts -> (ts, metrics): ``train_step.train_iteration`` over ``mesh``."""
    def run(ts):
        return train_step.train_iteration(cfg, ts, gst_model, mesh)
    return run


def _is_moment(v, p) -> bool:
    return torch.is_tensor(v) and v.dim() > 0 and v.shape == p.shape


def _full_optimizer_state(ts, mesh: Mesh) -> dict:
    """The optimizer's state_dict in the single-process layout: indices in
    the single-process parameter order, tp pieces of the moments
    gathered."""
    sd = ts.optimizer.state_dict()
    order = plain_order(ts.model)
    state = {}
    for i, (name, p) in enumerate(ts.model.named_parameters()):
        st = sd["state"].get(i)
        if st is not None and hasattr(p, "tp_dim"):
            st = {k: mesh.gather_pieces(v, p.tp_dim) if _is_moment(v, p)
                  else v for k, v in st.items()}
        if st is not None:
            state[order.index(plain_name(name))] = st
    groups = [dict(g, params=list(range(len(order))))
              for g in sd["param_groups"]]
    return {"state": state, "param_groups": groups}


def _load_optimizer_state(ts, mesh: Mesh, full: dict):
    order = plain_order(ts.model)
    named = list(ts.model.named_parameters())
    state = {}
    for i, (name, p) in enumerate(named):
        st = full["state"].get(order.index(plain_name(name)))
        if st is None:
            continue
        if hasattr(p, "tp_dim"):
            shape = list(p.shape)
            shape[p.tp_dim] *= mesh.tp
            st = {k: v.chunk(mesh.tp, p.tp_dim)[mesh.tp_rank].clone()
                  if torch.is_tensor(v) and list(v.shape) == shape else v
                  for k, v in st.items()}
        state[i] = st
    groups = [dict(g, params=list(range(len(named))))
              for g in full["param_groups"]]
    ts.optimizer.load_state_dict({"state": state, "param_groups": groups})


def save_train_state(ckpt_dir: str, ts, step: int, mesh: Mesh):
    """Checkpoint ``step`` in the single-process layout (whole params and
    moments, every env's generator in env order), written by rank 0. Every
    rank must call it: it gathers over tp and dp."""
    params = full_params(ts.model, mesh)
    optimizer = _full_optimizer_state(ts, mesh)
    env_gens = [None] * mesh.dp
    dist.all_gather_object(env_gens, [g.get_state()
                                      for g in ts.env_states.gens],
                           group=mesh.dp_group)
    if dist.get_rank() == 0:
        ckpt_util.write_train_state(ckpt_dir, {
            "params": {n: params[n].cpu() for n in plain_order(ts.model)},
            "optimizer": optimizer,
            "schedule": ts.schedule.state_dict(),
            "update": step,
            "generator": ts.generator.get_state(),
            "env_generators": [s for part in env_gens for s in part],
        })


def restore_train_state(ckpt_dir: str, ts, mesh: Mesh,
                        step: Optional[int] = None) -> Tuple[object, int]:
    """Load a single-process-layout checkpoint into this rank's share of
    ``ts`` (in place); returns (ts, the next update index)."""
    payload = ckpt_util.load_train_state(ckpt_dir, step)
    load_full_params(ts.model, mesh, payload["params"])
    _load_optimizer_state(ts, mesh, payload["optimizer"])
    ts.schedule.load_state_dict(payload["schedule"])
    ts.generator.set_state(payload["generator"])
    gens = payload["env_generators"]
    n = len(ts.env_states.gens)
    if len(gens) != n * mesh.dp:
        raise ValueError(f"checkpoint has {len(gens)} env generators, the "
                         f"run {n * mesh.dp}")
    for g, state in zip(ts.env_states.gens,
                        gens[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]):
        g.set_state(state)
    return ts, payload["update"] + 1
