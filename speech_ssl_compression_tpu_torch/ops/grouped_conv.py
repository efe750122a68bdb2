"""Grouped 1-D convolution with JAX's numeric contract and backward: the
positional conv of every encoder (shallow and deep), of streaming and of
sequence parallel.

Port of ``speech_ssl_compression_tpu/ops/grouped_conv.py``
(``grouped_conv1d`` and its custom VJP). Layout as there: x (B, T, C)
feature-last, w (K, C/G, O) ("HIO"); output channel o belongs to group
o // (O/G); stride 1, pad = (lo, hi) frames of zeros.

    out[b, t, o] = sum_{k, i} x_pad[b, t + k, g(o) C/G + i] w[k, i, o]

For bf16 inputs the products are of the bf16 values and the sums are f32,
and the result is f32, as JAX's ``preferred_element_type``; the caller
casts it. So no bf16 conv runs: the operands are upcast to f32 and every
conv and product of the call runs in f32 with TF32 off, for this call
only. (cuDNN's TF32 forward on the upcast operands missed the f32 sums by
1.1e-5 rel. L2 on an H100 at K = 128, though a bf16 value fits TF32's
mantissa.) f32 inputs take the caller's TF32 setting, as any f32 conv.

The backward is JAX's: dX is the conv transpose in the accumulation dtype
(f32 for bf16 inputs), cast to x's dtype; dW is the (B T_out) contraction
of each tap,

    dw[k, i, o] = sum_{b, t} x_pad[b, t + k, g(o) C/G + i] dy[b, t, o],

in f32, cast to w's dtype. Its taps go in chunks: one ``bmm`` over the
groups per chunk, on an unfolded copy of x of at most DW_CHUNK_BYTES
(:func:`grouped_conv1d_dw`). These are library calls (cuDNN, cuBLAS) on
either device; JAX computes this with XLA convolutions, not Pallas.

A profile's trace names the call ``sslc.pos_conv.fwd`` and the backward
``sslc.pos_conv.bwd`` (``utils/profiling.py::span``; their device time:
``span_device_seconds``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.device import matmul_precision
from ..utils.profiling import span

DW_CHUNK_BYTES = 256 << 20  # the unfolded copy of x that one dW bmm reads


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _f32_sums(dtype: torch.dtype):
    """TF32 off for the f32 convs and products of bf16 inputs; f32 inputs
    take the caller's setting."""
    if dtype == torch.bfloat16:
        return matmul_precision("highest")
    return contextlib.nullcontext()


def _conv(x, w, groups: int, pad: tuple) -> torch.Tensor:
    """(B, T, C) x (K, C/G, O) -> (B, T_out, O) in x's dtype, the
    symmetric part of the pad through cuDNN's padding."""
    lo, hi = pad
    m = min(lo, hi)
    xt = x.transpose(1, 2)
    if lo != hi:
        xt = F.pad(xt, (lo - m, hi - m))
    return F.conv1d(xt, w.permute(2, 1, 0), padding=m,
                    groups=groups).transpose(1, 2)


def _conv_transpose(dy, w, groups: int, pad: tuple, t: int) -> torch.Tensor:
    """dX of :func:`_conv`: dy (B, T_out, O) through the transposed conv
    back to (B, T, C), the pad's rows cut."""
    lo, hi = pad
    m = min(lo, hi)
    dx = F.conv_transpose1d(dy.transpose(1, 2), w.permute(2, 1, 0),
                            padding=m, groups=groups)
    return dx[:, :, lo - m:lo - m + t].transpose(1, 2)


def grouped_conv1d_dw(x, dy, k: int, groups: int, pad: tuple,
                      chunk_bytes: int = DW_CHUNK_BYTES) -> torch.Tensor:
    """dW of :func:`grouped_conv1d` before its cast: (K, C/G, O) in the
    accumulation dtype (f32 for bf16 x), from x (B, T, C) and dy (B,
    T_out, O). The taps go in chunks of as many as fit ``chunk_bytes``
    of unfolded x; each chunk is one (B T_out)-contraction ``bmm`` over
    the G groups."""
    b, _, c = x.shape
    t_out, o = dy.shape[1], dy.shape[2]
    cg, og = c // groups, o // groups
    acc = _acc_dtype(x.dtype)
    x_pad = F.pad(x, (0, 0, *pad))
    # (G, B T_out, O/G): the right operand of every chunk's bmm
    dyg = dy.to(acc).reshape(b * t_out, groups, og).transpose(0, 1)
    per_tap = b * t_out * c * torch.finfo(acc).bits // 8
    step = max(1, min(k, chunk_bytes // per_tap))
    dw = torch.empty((k, cg, groups, og), dtype=acc, device=x.device)
    for k0 in range(0, k, step):
        kc = min(step, k - k0)
        # (B, kc, C, T_out): tap j of the chunk reads x_pad rows k0 + j ..
        xs = x_pad[:, k0:k0 + kc + t_out - 1].unfold(1, t_out, 1)
        # (G, kc C/G, B T_out), copied once, in the accumulation dtype
        xc = torch.empty((groups, kc, cg, b, t_out), dtype=acc,
                         device=x.device)
        xc.copy_(xs.reshape(b, kc, groups, cg, t_out).permute(2, 1, 3, 0, 4))
        with _f32_sums(x.dtype):
            part = torch.bmm(xc.view(groups, kc * cg, b * t_out), dyg)
        dw[k0:k0 + kc] = part.view(groups, kc, cg, og).permute(1, 2, 0, 3)
    return dw.reshape(k, cg, o)


class _GroupedConv1d(torch.autograd.Function):
    """JAX's custom VJP: the forward with f32 sums, dX by the conv
    transpose and dW tap by tap, both in the accumulation dtype."""

    @staticmethod
    def forward(ctx, x, w, groups, pad):
        ctx.save_for_backward(x, w)
        ctx.groups, ctx.pad = groups, pad
        acc = _acc_dtype(x.dtype)
        with _f32_sums(x.dtype):
            return _conv(x.to(acc), w.to(acc), groups, pad)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        groups, pad = ctx.groups, ctx.pad
        need_x, need_w = ctx.needs_input_grad[:2]
        dx = dw = None
        with span("sslc.pos_conv.bwd"):
            if need_x:
                acc = _acc_dtype(x.dtype)
                with _f32_sums(x.dtype):
                    dx = _conv_transpose(dy.to(acc), w.to(acc), groups, pad,
                                         x.shape[1])
                dx = dx.to(x.dtype)
            if need_w:
                dw = grouped_conv1d_dw(x, dy, w.shape[0], groups,
                                       pad).to(w.dtype)
        return dx, dw, None, None


def grouped_conv1d(x: torch.Tensor, w: torch.Tensor, groups: int,
                   pad: tuple) -> torch.Tensor:
    """The grouped conv of x (B, T, C) with w (K, C/G, O), stride 1,
    ``pad`` = (lo, hi): (B, T + lo + hi - K + 1, O), f32 when x is bf16
    (f32 sums), else x's dtype. Differentiable in x and w; the gradients
    come in their inputs' dtypes."""
    lo, hi = (int(p) for p in pad)
    with span("sslc.pos_conv.fwd"):
        return _GroupedConv1d.apply(x, w, int(groups), (lo, hi))
