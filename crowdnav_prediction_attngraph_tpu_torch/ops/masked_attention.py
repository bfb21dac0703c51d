"""Fused graph attention: QKV projection, per-row masked multi-head attention
and output projection (K1), its backward (K2), and the packed masked
attention over precomputed q, k, v (K3).

Port of ``crowdnav_prediction_attngraph_tpu/ops/masked_attention.py``:
  * ``fused_graph_attention`` (:495-515) with its ``custom_vjp``
    ``_fused_diffable`` (:261-295) becomes :class:`FusedGraphAttention`, a
    ``torch.autograd.Function``; :func:`fused_graph_attention` is its
    ``apply``;
  * the forward TPU kernel ``_fused_kernel`` (:175-230) becomes
    hand-written CUDA kernels for Hopper (``csrc/fused_graph_attention.cu``:
    two launches of the tiled tensor-core product of ``csrc/tc_gemm.cuh``
    around a per-(row, head) attention kernel), and
    ``reference_fused_graph_attention`` (:596-603) the plain PyTorch
    version :func:`reference_fused_graph_attention`, with the same math and
    the same bf16 rounding points;
  * the backward TPU kernel ``_bwd_kernel`` (:298-411, via
    ``_fused_backward`` :414-492) becomes ``csrc/fused_graph_attention_bwd.cu``
    (the same product for its five projections, a per-(row, head)
    attention backward, fixed-order column sums) behind
    :func:`fused_graph_attention_backward`, with the plain version
    :func:`reference_fused_graph_attention_backward`;
  * the TPU kernel ``_attn_kernel`` (:50-88, via ``packed_masked_attention``
    :91-143) becomes ``csrc/packed_masked_attention.cu`` behind
    :func:`packed_masked_attention`, and ``reference_masked_attention``
    (:606-616) the plain version :func:`reference_masked_attention`. The JAX
    K3 has no VJP, so neither has the port's: the wrapper raises where
    autograd would need one.

Gradients are those of the executed forward, in its compute dtype, as the
JAX docstring of ``_fused_diffable`` says: the backward recomputes q, k, v
and the softmax from the saved inputs instead of storing the probabilities.

The wrappers run the plain versions only for tensors on the CPU. For CUDA
tensors they launch the kernel or raise; they never fall back.

An all-masked row (no valid key) is defined to have a zero attention output
in both versions, so K1's result there is ``b_out``, K2's dx, dq, dk and dv
are 0, and K3's output is 0; valid rows never read it. Real callers never
send one (the policy's mask keeps detected >= 1).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

KERNEL = "fused_graph_attention"
KERNEL_BWD = "fused_graph_attention_bwd"
KERNEL_ATTN = "packed_masked_attention"


def _rounded(t: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``compute_dtype`` and carried in float32, so the
    products that follow accumulate in f32 as on the card."""
    if compute_dtype == torch.float32:
        return t
    return t.to(compute_dtype).to(torch.float32)


def reference_fused_graph_attention(x, mask, w_qkv, b_qkv, w_out, b_out,
                                    num_heads: int,
                                    compute_dtype: torch.dtype = torch.float32):
    """Plain PyTorch K1. x (rows, A, D) f32; mask (rows, A) bool, True = valid
    key; w_qkv (D, 3D); b_qkv (3D,); w_out (D, D); b_out (D,).
    ``compute_dtype=torch.bfloat16`` rounds x, the weights, q/k/v, the softmax
    weights and the attention output to bf16 where ``_fused_kernel`` casts."""
    rows, A, D = x.shape
    hd = D // num_heads
    cd = compute_dtype
    qkv = _rounded(x, cd) @ _rounded(w_qkv, cd) + b_qkv
    q = _rounded(qkv[..., :D] * (1.0 / math.sqrt(hd)), cd)
    k = _rounded(qkv[..., D:2 * D], cd)
    v = _rounded(qkv[..., 2 * D:], cd)
    qh = q.reshape(rows, A, num_heads, hd)
    kh = k.reshape(rows, A, num_heads, hd)
    vh = v.reshape(rows, A, num_heads, hd)
    logits = torch.einsum("rqhd,rkhd->rhqk", qh, kh)
    logits = logits.masked_fill(~mask[:, None, None, :], -math.inf)
    w = torch.softmax(logits, dim=-1)
    any_valid = mask.any(dim=-1)[:, None, None, None]
    w = torch.where(any_valid, w, torch.zeros_like(w))
    out = torch.einsum("rhqk,rkhd->rqhd", _rounded(w, cd), vh)
    out = _rounded(out.reshape(rows, A, D), cd)
    return out @ _rounded(w_out, cd) + b_out


def reference_fused_graph_attention_backward(
        x, mask, w_qkv, b_qkv, w_out, g, num_heads: int,
        compute_dtype: torch.dtype = torch.float32):
    """Plain PyTorch K2: the gradients of K1's output with respect to
    (x, w_qkv, b_qkv, w_out, b_out) for the output cotangent ``g``
    (rows, A, D) f32. Returns (dx, dw_qkv, db_qkv, dw_out, db_out).

    At bf16 it rounds where ``_bwd_kernel`` casts: x, the weights and g; the
    recomputed q, k, v (:330-333); q x scale (:375); p (:383); dattn and ds
    (:386, :391); the attention output (:396) and dqkv before the dx and dW
    products (:404-407). The bias gradients sum unrounded f32 values. In f32
    this is autograd through :func:`reference_fused_graph_attention`."""
    rows, A, D = x.shape
    H = num_heads
    hd = D // H
    cd = compute_dtype
    scale = 1.0 / math.sqrt(hd)
    scale_c = torch.tensor(scale, dtype=cd).item()

    def heads(t):
        return t.reshape(rows, A, H, hd)

    xc, gc = _rounded(x, cd), _rounded(g, cd)
    wq, wo = _rounded(w_qkv, cd), _rounded(w_out, cd)
    qkv = _rounded(xc @ wq + b_qkv, cd)
    qh = heads(_rounded(qkv[..., :D] * scale_c, cd))
    kh = heads(qkv[..., D:2 * D])
    vh = heads(qkv[..., 2 * D:])
    logits = torch.einsum("rqhd,rkhd->rhqk", qh, kh)
    logits = logits.masked_fill(~mask[:, None, None, :], -math.inf)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None, None, None], p,
                    torch.zeros_like(p))
    pc = _rounded(p, cd)
    attn = _rounded(torch.einsum("rhqk,rkhd->rqhd", pc, vh)
                    .reshape(rows, A, D), cd)
    da = heads(_rounded(gc @ wo.t(), cd))
    dv = torch.einsum("rhqk,rqhd->rkhd", pc, da)
    dp = torch.einsum("rqhd,rkhd->rhqk", da, vh)
    ds = _rounded(p * (dp - (dp * p).sum(dim=-1, keepdim=True)), cd)
    dq = torch.einsum("rhqk,rkhd->rqhd", ds, kh) * scale
    dk = torch.einsum("rhqk,rqhd->rkhd", ds, qh)
    dqkv = torch.cat([t.reshape(rows, A, D) for t in (dq, dk, dv)], dim=-1)
    dqkv_c = _rounded(dqkv, cd)
    dx = dqkv_c @ wq.t()
    dw_qkv = xc.reshape(-1, D).t() @ dqkv_c.reshape(-1, 3 * D)
    db_qkv = dqkv.reshape(-1, 3 * D).sum(dim=0)
    dw_out = attn.reshape(-1, D).t() @ gc.reshape(-1, D)
    db_out = g.reshape(-1, D).sum(dim=0)
    return dx, dw_qkv, db_qkv, dw_out, db_out


def _check(x, mask, num_heads, compute_dtype, dtypes=(torch.float32,),
           **tensors):
    """Shapes, devices and dtypes of the kernels' inputs: ``tensors`` are
    named as in the signatures (w_qkv, b_qkv, w_out, b_out, g; K3's k and v,
    with q as ``x``). x and ``tensors`` share one dtype out of ``dtypes``."""
    if x.dim() != 3:
        raise ValueError(f"x must be (rows, A, D), got {tuple(x.shape)}")
    rows, A, D = x.shape
    shapes = {"mask": (rows, A), "w_qkv": (D, 3 * D), "b_qkv": (3 * D,),
              "w_out": (D, D), "b_out": (D,), "g": (rows, A, D),
              "k": (rows, A, D), "v": (rows, A, D)}
    device = x.device
    for name, t in (("mask", mask), *tensors.items()):
        if t.shape != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, "
                             f"got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
    if x.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"x must be {names}, got {x.dtype}")
    for name, t in tensors.items():
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x {x.dtype}: mixed dtypes")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if D % num_heads:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")
    if A < 1 and device.type == "cuda":
        raise ValueError(f"the kernels take A >= 1, got A={A}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, "
                        f"got {compute_dtype}")


def _w_out_layout(w_out):
    """(tensor, transposed): w_out as the kernels read it, (in, out)
    row-major, or, when it is a transposed view such as an nn.Linear
    weight's ``.t()``, its (out, in) row-major storage ``w_out.t()`` (no
    copy either way)."""
    if not w_out.is_contiguous() and w_out.t().is_contiguous():
        return w_out.t(), 1
    return w_out, 0


def _aligned(t):
    """``t``, or a copy of it if its data does not start on 16 bytes (the
    products' tile copies move 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _scales(D, num_heads, compute_dtype):
    """float32(1 / sqrt(hd)), as the plain versions multiply by it, and the
    same rounded to the compute dtype (K2's q x scale_c), as C floats."""
    scale = 1.0 / math.sqrt(D // num_heads)
    return (ctypes.c_float(torch.tensor(scale, dtype=torch.float32).item()),
            ctypes.c_float(torch.tensor(scale, dtype=compute_dtype).item()))


def _scratch(device, *pieces):
    """One allocation carved into 16-byte aligned pieces, each (numel, dtype)
    or None: (the buffer, which must outlive the launches, and each piece's
    address as a C pointer, None for None). Freed after the call, the buffer goes back to
    PyTorch's caching allocator in stream order, so the launches already
    queued on the stream finish with it first."""
    offsets, total = [], 0
    for piece in pieces:
        if piece is None:
            offsets.append(None)
            continue
        numel, dtype = piece
        offsets.append(total)
        total += -(-numel * dtype.itemsize // 16) * 16
    buf = torch.empty(max(total, 16), dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    return buf, [None if o is None else ctypes.c_void_p(base + o)
                 for o in offsets]



class FusedGraphAttention(torch.autograd.Function):
    """K1 forward, K2 backward (``_fused_diffable`` :261-295). Saves the
    inputs, as ``_fused_diffable_fwd`` does, and recomputes in the
    backward."""

    @staticmethod
    def forward(ctx, x, mask, w_qkv, b_qkv, w_out, b_out, num_heads,
                compute_dtype):
        ctx.save_for_backward(x, mask, w_qkv, b_qkv, w_out)
        ctx.num_heads, ctx.compute_dtype = num_heads, compute_dtype
        if x.device.type == "cpu":
            return reference_fused_graph_attention(
                x, mask, w_qkv, b_qkv, w_out, b_out, num_heads, compute_dtype)
        return _launch_forward(x, mask, w_qkv, b_qkv, w_out, b_out,
                               num_heads, compute_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, mask, w_qkv, b_qkv, w_out = ctx.saved_tensors
        dx, dw_qkv, db_qkv, dw_out, db_out = fused_graph_attention_backward(
            x, mask, w_qkv, b_qkv, w_out, g, ctx.num_heads,
            ctx.compute_dtype)
        return dx, None, dw_qkv, db_qkv, dw_out, db_out, None, None


def fused_graph_attention(x, mask, w_qkv, b_qkv, w_out, b_out,
                          num_heads: int,
                          compute_dtype: torch.dtype = torch.bfloat16):
    """K1 forward: (rows, A, D) -> (rows, A, D) float32, differentiable in
    x and the weights through :class:`FusedGraphAttention`.

    CUDA tensors launch the Hopper kernels (any A >= 1 and any D that
    num_heads divides, as the JAX kernel; all contiguous but w_out, which
    may be any (D, D) view, such as an nn.Linear weight's ``.t()``); CPU
    tensors run the plain versions."""
    _check(x, mask, num_heads, compute_dtype, w_qkv=w_qkv, b_qkv=b_qkv,
           w_out=w_out, b_out=b_out)
    return FusedGraphAttention.apply(x, mask, w_qkv, b_qkv, w_out, b_out,
                                     num_heads, compute_dtype)


def _launch_forward(x, mask, w_qkv, b_qkv, w_out, b_out, num_heads,
                    compute_dtype):
    rows, A, D = x.shape
    tokens = rows * A
    bf16 = compute_dtype == torch.bfloat16
    w_out, w_out_t = _w_out_layout(w_out)
    x, w_qkv, w_out = _aligned(x), _aligned(w_qkv), _aligned(w_out)
    fl, cd = torch.float32, compute_dtype
    out = torch.empty(rows, A, D, device=x.device, dtype=fl)
    # bf16 copies of the f32 product operands (none in f32 mode), then the
    # rounded q|k|v and attention output between the three stages
    copies = ((tokens * D, cd), (3 * D * D, cd), (D * D, cd)) if bf16 \
        else (None,) * 3
    buf, ptrs = _scratch(x.device, *copies, (tokens * 3 * D, cd),
                         (tokens * D, cd))
    scale, _ = _scales(D, num_heads, compute_dtype)
    _build.launch(KERNEL, "fused_graph_attention_forward", "k1",
                  ((x, fl, (rows, A, D)), (mask, torch.bool, (rows, A)),
                   (w_qkv, fl, (D, 3 * D)), (b_qkv, fl, (3 * D,)),
                   (w_out, fl, (D, D)), (b_out, fl, (D,)),
                   (out, fl, (rows, A, D))),
                  (*ptrs, rows, A, D, num_heads, int(bf16), w_out_t, scale))
    return out


def fused_graph_attention_backward(x, mask, w_qkv, b_qkv, w_out, g,
                                   num_heads: int,
                                   compute_dtype: torch.dtype = torch.bfloat16):
    """K2: (dx, dw_qkv, db_qkv, dw_out, db_out) of K1 for the output
    cotangent ``g``. CUDA tensors launch the Hopper kernels (K1's shapes);
    CPU tensors run :func:`reference_fused_graph_attention_backward`."""
    _check(x, mask, num_heads, compute_dtype, w_qkv=w_qkv, b_qkv=b_qkv,
           w_out=w_out, g=g)
    if x.device.type == "cpu":
        return reference_fused_graph_attention_backward(
            x, mask, w_qkv, b_qkv, w_out, g, num_heads, compute_dtype)
    rows, A, D = x.shape
    tokens = rows * A
    bf16 = compute_dtype == torch.bfloat16
    w_out, w_out_t = _w_out_layout(w_out)
    x, g, w_qkv, w_out = (_aligned(t) for t in (x, g, w_qkv, w_out))

    def f32(*shape):
        return torch.empty(shape, device=x.device, dtype=torch.float32)
    dx, dw_qkv, db_qkv, dw_out, db_out = f32(rows, A, D), f32(D, 3 * D), \
        f32(3 * D), f32(D, D), f32(D)
    cd, fl = compute_dtype, torch.float32
    # bf16 copies of the f32 product operands (none in f32 mode); the
    # recomputed q|k|v, dattn, dq|dk|dv (f32 for the bias sums, and in the
    # compute dtype for the products; one buffer in f32 mode), the rounded
    # attention output, the bias sums' slice partials and the tiled
    # attention's per-query softmax statistics (3 a query and head)
    copies = ((tokens * D, cd), (tokens * D, cd), (3 * D * D, cd),
              (D * D, cd)) if bf16 else (None,) * 4
    buf, ptrs = _scratch(
        x.device, *copies, (tokens * 3 * D, cd), (tokens * D, cd),
        (tokens * 3 * D, fl), (tokens * 3 * D, cd) if bf16 else None,
        (tokens * D, cd), (_BIAS_SLICES * 4 * D, fl),
        (tokens * num_heads * 3, fl))
    scale, scale_c = _scales(D, num_heads, compute_dtype)
    _build.launch(KERNEL_BWD, "fused_graph_attention_backward", "k2",
                  ((x, fl, (rows, A, D)), (mask, torch.bool, (rows, A)),
                   (g, fl, (rows, A, D)), (w_qkv, fl, (D, 3 * D)),
                   (b_qkv, fl, (3 * D,)), (w_out, fl, (D, D)),
                   (dx, fl, (rows, A, D)), (dw_qkv, fl, (D, 3 * D)),
                   (db_qkv, fl, (3 * D,)), (dw_out, fl, (D, D)),
                   (db_out, fl, (D,))),
                  (*ptrs, rows, A, D, num_heads, int(bf16), w_out_t, scale,
                   scale_c))
    return dx, dw_qkv, db_qkv, dw_out, db_out


_BIAS_SLICES = 16       # kSlices of csrc/fused_graph_attention_bwd.cu


def reference_masked_attention(q, k, v, mask, num_heads: int):
    """Plain PyTorch K3: q, k, v (rows, A, D) f32 or bf16; mask (rows, A)
    bool, True = valid key. Per head softmax(q_h k_h^T / sqrt(hd), masked
    keys left out) v_h, in f32 on q, k and v cast to f32 (as ``_attn_kernel``
    casts them); a row with no valid key gives 0."""
    rows, A, D = q.shape
    hd = D // num_heads
    q, k, v = q.float(), k.float(), v.float()
    qh = q.reshape(rows, A, num_heads, hd)
    kh = k.reshape(rows, A, num_heads, hd)
    vh = v.reshape(rows, A, num_heads, hd)
    logits = torch.einsum("rqhd,rkhd->rhqk", qh, kh) / math.sqrt(hd)
    logits = logits.masked_fill(~mask[:, None, None, :], -math.inf)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(mask.any(dim=-1)[:, None, None, None], w,
                    torch.zeros_like(w))
    return torch.einsum("rhqk,rkhd->rqhd", w, vh).reshape(rows, A, D)


def packed_masked_attention(q, k, v, mask, num_heads: int):
    """K3: (rows, A, D) q, k, v, all f32 or all bf16, and a (rows, A) bool
    key mask -> (rows, A, D) f32. CUDA tensors launch the Hopper kernel (any
    A >= 1, any head dim, all contiguous); CPU tensors run
    :func:`reference_masked_attention`. It has no backward, as the JAX K3
    has none: with grad mode on, an input that requires grad raises."""
    _check(q, mask, num_heads, torch.float32,
           dtypes=(torch.float32, torch.bfloat16), k=k, v=v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("packed_masked_attention has no backward; call it "
                           "under torch.no_grad() or on tensors that do not "
                           "require grad")
    if q.device.type == "cpu":
        return reference_masked_attention(q, k, v, mask, num_heads)
    rows, A, D = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _build.launch(KERNEL_ATTN, "packed_masked_attention_forward", "k3",
                  ((q, q.dtype, q.shape), (k, q.dtype, q.shape),
                   (v, q.dtype, q.shape), (mask, torch.bool, (rows, A)),
                   (out, torch.float32, q.shape)),
                  (rows, A, D, num_heads, int(q.dtype == torch.bfloat16)))
    return out
