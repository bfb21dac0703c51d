"""The (dp, tp) process mesh and the tensor-parallel layout of the policy
(JAX package ``parallel/mesh.py``).

Where the JAX package builds a ``Mesh`` of devices with axes ("dp", "tp")
and lets XLA insert the collectives, the port runs one process per device
and builds the same layout as two families of ``torch.distributed`` process
groups, tp fastest: rank = d * tp + t, the order in which
``mesh_utils.create_device_mesh((dp, tp))`` lays out devices. The env batch
is split over dp (each dp index steps its own envs, replicated over its tp
ranks); the 512-wide projections of the human-human attention are stored
as tp shards (:func:`param_shard_dim`, the rule of the JAX ``param_spec``)
and gathered, under autograd, by every forward that reads them.

:func:`use_mesh` sets the ambient mesh that the policy reads to route
``use_ring_attention`` through the ring (``parallel/edge_partition.py``),
as ``jax.set_mesh`` / ``get_abstract_mesh`` do in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

# the JAX rule shards a leaf whose last flax dim is a multiple of this
SHARD_WIDTH = 512


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (dp, tp) mesh: its indices and its two process
    groups (the ranks that share its tp index, in dp order, and those that
    share its dp index, in tp order)."""
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: object
    tp_group: object

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    def rank_of(self, dp_rank: int, tp_rank: int) -> int:
        """The global rank at (dp_rank, tp_rank)."""
        return dp_rank * self.tp + tp_rank

    def env_slice(self, num_envs: int) -> range:
        """The envs of this rank's dp index: an even split in rank order."""
        if num_envs % self.dp:
            raise ValueError(f"{num_envs} envs do not split over dp = "
                             f"{self.dp}")
        n = num_envs // self.dp
        return range(self.dp_rank * n, (self.dp_rank + 1) * n)

    def gather_dp(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenate every dp index's ``x`` along ``dim``, in dp order."""
        return _all_gather(x, self.dp_group, self.dp, dim)

    def gather_pieces(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenate the tp ranks' pieces along ``dim`` (no autograd)."""
        return _all_gather(x.detach(), self.tp_group, self.tp, dim)

    def sum_dp_(self, tensors: Sequence[torch.Tensor]):
        """Sum each tensor over dp, in place, in one flat all-reduce."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.dp_group)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def grad_sq_norm(self, params: Sequence[torch.Tensor]) -> torch.Tensor:
        """The squared norm of the whole gradient: the replicated leaves'
        own, plus the tp shards' summed over tp, so that each shard counts
        once."""
        rep = [p.grad for p in params if not hasattr(p, "tp_dim")]
        shards = [p.grad for p in params if hasattr(p, "tp_dim")]
        sq = sum((g * g).sum() for g in rep)
        if shards:
            sq_shards = sum((g * g).sum() for g in shards).reshape(1)
            dist.all_reduce(sq_shards, group=self.tp_group)
            sq = sq + sq_shards[0]
        return sq


def make_mesh(n: Optional[int] = None, tp: int = 1) -> Optional[Mesh]:
    """The (n // tp, tp) mesh over the first ``n`` ranks of the world
    (default: all of them). Every rank of the world must call it, in the
    same order, since each group is made by all; a rank past ``n`` gets
    None."""
    world = dist.get_world_size()
    n = n or world
    assert n % tp == 0, (n, tp)
    assert n <= world, (n, world)
    dp = n // tp
    rank = dist.get_rank()
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)])
                 for d in range(dp)]
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)])
                 for t in range(tp)]
    if rank >= n:
        return None
    d, t = divmod(rank, tp)
    return Mesh(dp=dp, tp=tp, dp_rank=d, tp_rank=t, dp_group=dp_groups[t],
                tp_group=tp_groups[d])


_AMBIENT: List[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the ambient mesh inside the block."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh() -> Optional[Mesh]:
    return _AMBIENT[-1] if _AMBIENT else None


def _all_gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _GatherTP(torch.autograd.Function):
    """Forward: concatenate the tp ranks' pieces along ``dim``. Backward: the
    own piece of the gradient, which every tp rank holds whole, since what
    follows the gather runs replicated over tp."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, dim: int):
        ctx.mesh, ctx.dim = mesh, dim
        return _all_gather(x, mesh.tp_group, mesh.tp, dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return g.chunk(m.tp, ctx.dim)[m.tp_rank].contiguous(), None, None


class _SplitTP(torch.autograd.Function):
    """Forward: this tp rank's piece of a replicated tensor. Backward: the
    pieces' gradients gathered, so that what precedes the split gets the
    whole gradient on every tp rank."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, dim: int):
        ctx.mesh, ctx.dim = mesh, dim
        return x.chunk(mesh.tp, dim)[mesh.tp_rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return _all_gather(g, m.tp_group, m.tp, ctx.dim), None, None


def gather_tp(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    return x if mesh.tp == 1 else _GatherTP.apply(x, mesh, dim)


def split_tp(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    if x.shape[dim] % mesh.tp:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over tp = {mesh.tp}")
    return x if mesh.tp == 1 else _SplitTP.apply(x, mesh, dim)


def param_shard_dim(name: str, shape) -> Optional[int]:
    """The dim of the port's leaf ``name`` that tp shards, or None (JAX
    ``param_spec``, ``mesh.py:30-37``: the 2-D leaves under
    ``spatial_attn`` whose last flax dim is a multiple of 512). An
    ``nn.Linear`` ``weight`` is the flax kernel transposed, (out, in), so
    that dim is 0 here; the packed ``mha_in_proj_weight`` keeps the flax
    layout (D, 3D), dim 1."""
    parts = name.split(".")
    if "spatial_attn" not in parts or len(shape) != 2:
        return None
    dim = 0 if parts[-1] == "weight" else 1
    return dim if shape[dim] % SHARD_WIDTH == 0 else None


class _TPShard(nn.Module):
    """Parametrization of a sharded leaf: the stored tensor is this rank's
    piece; reading the leaf gathers the whole (with autograd)."""

    def __init__(self, mesh: Mesh, dim: int):
        super().__init__()
        self.mesh, self.dim = mesh, dim

    def forward(self, piece):
        return gather_tp(piece, self.mesh, self.dim)

    def right_inverse(self, full):
        return full.chunk(self.mesh.tp, self.dim)[self.mesh.tp_rank].clone()


def plain_name(name: str) -> str:
    """The single-process name of a (possibly sharded) parameter."""
    return name.replace(".parametrizations.", ".").removesuffix(".original")


def plain_order(model: nn.Module) -> List[str]:
    """The single-process names in the single-process parameter order (the
    order of a single-process optimizer's state)."""
    return getattr(model, "plain_names", None) or [
        n for n, _ in model.named_parameters()]


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Store each leaf that :func:`param_shard_dim` picks as this rank's tp
    piece (in place; nothing at tp = 1). A stored piece carries its dim as
    ``tp_dim``; the model keeps the single-process order as
    ``plain_names``. Build the optimizer afterwards, so that its moments
    are pieces too."""
    if mesh.tp == 1:
        return model
    model.plain_names = [n for n, _ in model.named_parameters()]
    for name, p in list(model.named_parameters()):
        dim = param_shard_dim(name, p.shape)
        if dim is None:
            continue
        if p.shape[dim] % mesh.tp:
            raise ValueError(f"{name} {tuple(p.shape)} does not split over "
                             f"tp = {mesh.tp}")
        owner, leaf = name.rsplit(".", 1)
        parametrize.register_parametrization(
            model.get_submodule(owner), leaf, _TPShard(mesh, dim),
            unsafe=True)
        model.get_submodule(owner).parametrizations[leaf].original.tp_dim = dim
    return model


@torch.no_grad()
def full_params(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """{single-process name: a copy of the whole tensor} in the model's
    parameter order; the tp pieces gathered (every tp rank must call
    it)."""
    return {plain_name(n): (mesh.gather_pieces(p, p.tp_dim)
                            if hasattr(p, "tp_dim") else p.detach().clone())
            for n, p in model.named_parameters()}


@torch.no_grad()
def load_full_params(model: nn.Module, mesh: Mesh,
                     state: Dict[str, torch.Tensor]):
    """Copy a single-process ``state`` into the model, each tp piece from
    its part of the whole."""
    for n, p in model.named_parameters():
        full = state[plain_name(n)].to(p.device)
        if hasattr(p, "tp_dim"):
            full = full.chunk(mesh.tp, p.tp_dim)[mesh.tp_rank]
        p.copy_(full)
