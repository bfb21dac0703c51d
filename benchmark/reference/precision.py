"""The precision the reference computes in, and the control's.

The reference runs in float32 with TF32 off (``reference_precision``). The
control is the same reference one step below the precision the
configuration states for each part (``control_precision``): operands of the
products stated in float32 are rounded to TF32 (10 mantissa bits), those of
the products stated in bfloat16 (the policy's human-human attention block,
the GST's products) to float8 e4m3 with one scale a tensor (the gradients that flow back through an operand are
rounded alike), and the env's
float32 state and the suite's accumulators are kept in bfloat16.

The copies of the port's modules call :func:`rnd` on every product's
operands, naming the precision that the configuration states for that
product, and :func:`store` on state they keep.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

_mode = ["ref"]
FP8_MAX = 448.0


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to TF32's 10 mantissa bits, to nearest."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its absolute
    maximum maps to 448), carried in float32."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _lower(t: torch.Tensor, stated: str) -> torch.Tensor:
    return fp8(t) if stated == "bf16" else tf32(t.float())


class _Lowered(torch.autograd.Function):
    """The operand rounded one step below its stated precision, and the
    gradient that flows back through it rounded the same way, so the
    backward's products take lowered operands too."""

    @staticmethod
    def forward(ctx, t, stated):
        ctx.stated = stated
        return _lower(t, stated)

    @staticmethod
    def backward(ctx, g):
        return _lower(g, ctx.stated), None


def rnd(t: torch.Tensor, stated: str) -> torch.Tensor:
    """A product's operand at the precision in force: unchanged for the
    reference; for the control, one step below ``stated`` ("f32" or
    "bf16")."""
    if _mode[0] == "ref" or not t.is_floating_point():
        return t
    return _Lowered.apply(t, stated)


def store(t):
    """Float32 state as the precision in force keeps it: unchanged for the
    reference, bfloat16 for the control."""
    if _mode[0] == "ref" or not isinstance(t, torch.Tensor) \
            or t.dtype != torch.float32:
        return t
    return t.to(torch.bfloat16).float()


def is_control() -> bool:
    return _mode[0] == "control"


@contextlib.contextmanager
def mode(name: str):
    """Run the block at the reference's precision ("ref") or the control's
    ("control"); TF32 stays off either way (the control rounds by hand)."""
    if name not in ("ref", "control"):
        raise ValueError(name)
    old = (_mode[0], torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    _mode[0] = name
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (_mode[0], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Linear(nn.Linear):
    """nn.Linear whose operands go through :func:`rnd` at the precision the
    configuration states for it."""

    def __init__(self, in_features: int, out_features: int,
                 stated: str = "f32"):
        super().__init__(in_features, out_features)
        self.stated = stated

    def forward(self, x):
        return F.linear(rnd(x, self.stated), rnd(self.weight, self.stated),
                        self.bias)
