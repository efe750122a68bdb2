"""The arithmetic of the reference's products: exact float32 (TF32 off),
or one step below what a configuration states, for the controls.

- ``f32``: float32 products with TF32 off;
- ``tf32``: float32 products in TF32 (the control of a float32 cell);
- ``fp8``: the operands of every product, forward and backward, rounded
  to float8 e4m3 with one scale per tensor (its largest magnitude to
  448), the products summed in float32: the control of a bfloat16 cell,
  as an fp8 training step computes.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad

MODES = ("f32", "tf32", "fp8")
FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at one scale for the tensor, back in
    its own dtype."""
    amax = t.abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = fp8(x), fp8(w)
        ctx.save_for_backward(xq, wq)
        ctx.has_bias = b is not None
        return F.linear(xq, wq, b)

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dyq = fp8(dy)
        dx = dyq @ wq
        dw = dyq.reshape(-1, dy.shape[-1]).T @ xq.reshape(-1, xq.shape[-1])
        db = dy.reshape(-1, dy.shape[-1]).sum(0) if ctx.has_bias else None
        return dx, dw, db


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = fp8(a), fp8(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, dy):
        aq, bq = ctx.saved_tensors
        dyq = fp8(dy)
        return dyq @ bq.transpose(-1, -2), aq.transpose(-1, -2) @ dyq


class _Conv1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, kw):
        xq, wq = fp8(x), fp8(w)
        ctx.save_for_backward(xq, wq)
        ctx.kw, ctx.has_bias = kw, b is not None
        return F.conv1d(xq, wq, b, **kw)

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dyq = fp8(dy)
        dx = nn_grad.conv1d_input(xq.shape, wq, dyq, **ctx.kw)
        dw = nn_grad.conv1d_weight(xq, wq.shape, dyq, **ctx.kw)
        db = dy.sum((0, 2)) if ctx.has_bias else None
        return dx, dw, db, None


class Numerics:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"numerics must be one of {MODES}, got {mode!r}")
        self.mode = mode

    @contextlib.contextmanager
    def context(self):
        """TF32 on for ``tf32``, off otherwise; the flags restored after."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def linear(self, x, w, b=None):
        if self.mode == "fp8":
            return _Linear.apply(x, w, b)
        return F.linear(x, w, b)

    def matmul(self, a, b):
        if self.mode == "fp8":
            return _Matmul.apply(a, b)
        return torch.matmul(a, b)

    def conv1d(self, x, w, b=None, **kw):
        if self.mode == "fp8":
            return _Conv1d.apply(x, w, b, kw)
        return F.conv1d(x, w, b, **kw)
