"""Edge-partitioned interaction-graph attention over the tp ranks (JAX
package ``parallel/edge_partition.py``).

Ring attention over the agent axis. Each tp rank owns A / tp agents: their
queries, and their keys, values and key mask, which rotate around the ring
to rank (t + 1) % tp. The rotation of the next chunk is posted
(``batch_isend_irecv``) before the current chunk's scores are computed, so
the exchange overlaps the local work; the scores accumulate in an online
(flash-style) softmax. Per rank the edge work is (A / tp)^2 x tp = A^2 / tp.

The numerics are the JAX function's: a finite sentinel ``NEG_INF`` for a
masked key and the denominator floored at 1e-30, so a row whose keys are
all masked returns the mean of all keys' v (the dense reference gives NaN
there, K1 gives 0). The ring carries gradients: the shift is an autograd
Function whose backward sends the gradient the inverse way, to rank t - 1.

Rows are the caller's own: under the data-parallel step each dp index
holds only its envs' rows, which is where the JAX function's row split over
dp happens in the port. At tp = 1 nothing is exchanged.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, current_mesh, gather_tp, split_tp

NEG_INF = -1e30


def _post_shift(x: torch.Tensor, mesh: Mesh, step: int):
    """Post the send of ``x`` to tp rank t + step and the receive from
    t - step; returns (the receive buffer, the requests)."""
    n, t, d = mesh.tp, mesh.tp_rank, mesh.dp_rank
    buf = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, mesh.rank_of(d, (t + step) % n),
                   mesh.tp_group),
        dist.P2POp(dist.irecv, buf, mesh.rank_of(d, (t - step) % n),
                   mesh.tp_group)])
    return buf, reqs


class _RingShift(torch.autograd.Function):
    """Forward: post x's shift to rank t + 1 and return the buffer that
    receives rank t - 1's, with the requests appended to ``pending`` (wait
    on them before reading it). Backward: the gradient goes to t - 1."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, pending: List):
        ctx.mesh = mesh
        buf, reqs = _post_shift(x.contiguous(), mesh, 1)
        pending.extend(reqs)
        return buf

    @staticmethod
    def backward(ctx, g):
        buf, reqs = _post_shift(g.contiguous(), ctx.mesh, -1)
        for r in reqs:
            r.wait()
        return buf, None, None


def edge_partitioned_attention(q, k, v, mask, num_heads: int,
                               mesh: Optional[Mesh] = None):
    """Masked multi-head attention with the agent axis over the tp ranks.

    q, k, v: (rows, A, D), replicated over tp; mask: (rows, A) bool, True =
    valid key. A must divide by tp. Returns (rows, A, D), replicated over
    tp. ``mesh`` defaults to the ambient mesh (:func:`mesh.use_mesh`)."""
    if mesh is None:
        mesh = current_mesh()
        if mesh is None:
            raise ValueError("edge_partitioned_attention: no ambient mesh "
                             "(run under parallel.mesh.use_mesh)")
    rows, A, D = q.shape
    hd = D // num_heads
    scale = 1.0 / math.sqrt(hd)
    n = mesh.tp
    assert A % n == 0, (A, n)
    a_loc = A // n

    qh = split_tp(q, mesh, 1).reshape(rows, a_loc, num_heads, hd)
    # k, v and the mask travel as one buffer
    kvm = split_tp(torch.cat([k, v, mask.to(k.dtype)[..., None]], dim=-1),
                   mesh, 1)
    m = torch.full((rows, num_heads, a_loc), NEG_INF, dtype=q.dtype,
                   device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qh)
    for step in range(n):
        pending: List = []
        nxt = _RingShift.apply(kvm, mesh, pending) if step < n - 1 else None
        kh = kvm[..., :D].reshape(rows, a_loc, num_heads, hd)
        vh = kvm[..., D:2 * D].reshape(rows, a_loc, num_heads, hd)
        valid = kvm[..., 2 * D] != 0
        s = torch.einsum("rqhd,rkhd->rhqk", qh, kh) * scale
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = (o * corr.transpose(1, 2)[..., None]
             + torch.einsum("rhqk,rkhd->rqhd", p, vh))
        m = m_new
        for r in pending:
            r.wait()
        kvm = nxt
    out = o / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
    return gather_tp(out.reshape(rows, a_loc, D), mesh, 1)
