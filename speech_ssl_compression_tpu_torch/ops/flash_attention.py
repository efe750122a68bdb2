"""Flash attention: the CUDA kernels' wrappers, their plain versions, and the
autograd Function that joins them.

Port of ``speech_ssl_compression_tpu/ops/flash_attention.py``
(``flash_attention`` and ``flash_attention_kv_full`` with their custom VJPs
``_flash`` and ``_flash_rect``). One ``torch.autograd.Function``,
:class:`_FlashAttention`, stands behind both. Its forward saves
(q, k, v, bias, segments, seed, lse), never the dropout mask; its
backward computes dQ and dK/dV with D = rowsum(Pd o dPd) / rowsum(P),
taken from the P the backward recomputes (the dQ kernel computes it;
:func:`reference_dd` is its plain version). JAX takes D = rowsum(dO o O)
from the forward's output (:func:`output_dd`), the same number in exact
arithmetic; the recomputed form keeps sum_j dS_ij at rounding, as the
softmax's own backward does (``csrc/flash_attn_bwd.cu`` says why).

Routing is by device, and only by device: for CUDA tensors the wrappers
launch the hand-written kernels (``csrc/flash_attn_fwd.cu``,
``csrc/flash_attn_bwd.cu``) or raise; CPU tensors go to the plain PyTorch
versions, :func:`_reference_fwd` and :func:`reference_bwd` (D by
:func:`reference_dd`, then :func:`reference_bwd_dq` and
:func:`reference_bwd_dkv`), which write the same formulas out in full
(B, H, Tq, Tk) matrices. ``chip_smoke.py`` holds each kernel against its
plain version on the card.

Masking semantics, kept exactly: padding is an additive ``NEG_INF`` bias,
segments and causality replace the score with ``NEG_INF``; the finite
-1e30 keeps fully masked rows finite. Attention dropout acts on the
normalized probabilities, with the keep bits of
``ops/dropout.py::attention_keep_mask`` (seed, b, h, row, col); the LSE
stays exact.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _kernels
from .dropout import attention_keep_mask, keep_threshold

NEG_INF = -1e30
HEAD_DIM = 64  # the only head dim the CUDA kernels take
KERNEL_BLOCK_K = 64  # keys per tile of the forward kernel's online softmax
DROPOUT_MAX_T = 4096  # flash_attention with dropout refuses longer T, as JAX

# launches of the CUDA kernels, counted where each is launched (read and
# reset by chip_smoke.py to show which path a run took)
launch_counts = {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 0,
                 "flash_attn_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _masks(k, key_padding_mask, segment_ids):
    """bias (B, Tk) f32 and segment ids (B, T) int32 or None, as
    ``flash_attention`` (JAX) builds them."""
    b, tk = k.shape[0], k.shape[2]
    # built on the device: a host scalar copied to the GPU would block the
    # host until the stream drains, once per attention call
    bias = torch.zeros((b, tk), dtype=torch.float32, device=k.device)
    if key_padding_mask is not None:
        bias.masked_fill_(key_padding_mask.to(torch.bool), NEG_INF)
    seg = None if segment_ids is None else segment_ids.to(torch.int32)
    return bias, seg


def _keep_scale(dropout_p: float) -> float:
    return 1.0 / (1.0 - dropout_p)


def _scores(q, k, bias, segq, segk, causal):
    """S = scale * (q . k) in f32 with the kernels' masks, (B, H, Tq, Tk)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias[:, None, None, :]
    if segq is not None:
        s = s.masked_fill(segq[:, None, :, None] != segk[:, None, None, :],
                          NEG_INF)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        above = torch.ones((tq, tk), dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    return s


def _keep(q, k, dropout_p, seed):
    """The dropout keep mask (B, H, Tq, Tk) on q's device, or None."""
    if dropout_p == 0.0:
        return None
    b, h, tq, _ = q.shape
    return attention_keep_mask(seed, b, h, tq, k.shape[2], dropout_p, q.device)


def _reference_fwd(q, k, v, bias, segq, segk, causal, block_k=None,
                   dropout_p=0.0, seed=None):
    """Plain version of the forward kernel: the whole score matrix, same
    masks, f32 statistics. Returns (out in q's dtype, lse (B, H, Tq) f32).

    With ``block_k``, the softmax and P.V walk the keys in tiles of that
    size by the online-softmax recurrence, as the kernel does, so that a
    bf16 P is rounded at the same points (``p = exp(s - running max)``).
    With dropout, as in the kernel, the row sum takes every p, P.V takes p
    where the keep bit is set, and the output is acc / l / (1 - p)."""
    s = _scores(q, k, bias, segq, segk, causal)
    keep = _keep(q, k, dropout_p, seed)

    def kept(p, k0=0):
        if keep is None:
            return p
        return p.masked_fill(~keep[..., k0:k0 + p.shape[-1]], 0.0)

    # the kernel rounds P to the input dtype before the P.V product
    if block_k is None:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.matmul(kept(p).to(q.dtype).float(), v.float())
    else:
        m = torch.full_like(s[..., :1], NEG_INF)
        l = torch.zeros_like(m)
        acc = s.new_zeros(s.shape[:-1] + v.shape[-1:])
        for k0 in range(0, s.shape[-1], block_k):
            st = s[..., k0:k0 + block_k]
            m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(st - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(
                kept(p, k0).to(q.dtype).float(),
                v[..., k0:k0 + block_k, :].float())
            m = m_new
    l_safe = l.clamp_min(1e-30)
    out = acc / l_safe
    if keep is not None:
        out = out * _keep_scale(dropout_p)
    return out.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def _reference_ds(q, k, v, bias, segq, segk, causal, dropout_p, seed, lse,
                  dout, dd):
    """(P, Pd, dS) of the backward, f32 (B, H, Tq, Tk): P = exp(S - LSE),
    Pd = P o M / (1 - p), dS = Pd o (dO V^T) - P o D."""
    p = torch.exp(_scores(q, k, bias, segq, segk, causal) - lse[..., None])
    keep = _keep(q, k, dropout_p, seed)
    pd = p if keep is None else torch.where(
        keep, p * _keep_scale(dropout_p), torch.zeros((), device=p.device))
    dpd = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, pd, pd * dpd - p * dd[..., None]


def output_dd(out, dout):
    """JAX's D = rowsum(dO o O) in f32, (B, H, Tq), as ``_flash_bwd_impl``
    takes it from the forward's output. The port's backward takes D from
    its own P instead (:func:`reference_dd`); tests hold the plain
    backward's formulas against JAX's with this D."""
    return (dout.float() * out.float()).sum(dim=-1)


def reference_dd(q, k, v, bias, segq, segk, causal, dropout_p, seed, lse,
                 dout):
    """Plain version of the D that the dQ kernel computes: D = rowsum(Pd o
    dPd) / rowsum(P) in f32, (B, H, Tq), from P = exp(S - LSE) as the
    backward recomputes it (0 for a row without keys). Dividing by
    rowsum(P), 1 up to the LSE's rounding, makes sum_j dS_ij cancel."""
    p = torch.exp(_scores(q, k, bias, segq, segk, causal) - lse[..., None])
    keep = _keep(q, k, dropout_p, seed)
    pd = p if keep is None else torch.where(
        keep, p * _keep_scale(dropout_p), torch.zeros((), device=p.device))
    dpd = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    l = p.sum(dim=-1)
    return torch.where(l > 0, (pd * dpd).sum(dim=-1) / l,
                       torch.zeros((), device=l.device))


def reference_bwd_dq(q, k, v, bias, segq, segk, causal, dropout_p, seed,
                     lse, dout, dd):
    """Plain version of the dQ kernel: scale * dS K, with dS cast to the
    input dtype before the product, as the Pallas kernel does."""
    _, _, ds = _reference_ds(q, k, v, bias, segq, segk, causal, dropout_p,
                             seed, lse, dout, dd)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.matmul(ds.to(q.dtype).float(), k.float())
    return (scale * dq).to(q.dtype)


def reference_bwd_dkv(q, k, v, bias, segq, segk, causal, dropout_p, seed,
                      lse, dout, dd):
    """Plain version of the dK/dV kernel: dK = scale * dS^T Q and
    dV = Pd^T dO, with dS and Pd cast to the input dtype first."""
    _, pd, ds = _reference_ds(q, k, v, bias, segq, segk, causal, dropout_p,
                              seed, lse, dout, dd)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dv = torch.matmul(pd.to(q.dtype).float().transpose(-1, -2), dout.float())
    return (scale * dk).to(k.dtype), dv.to(v.dtype)


def reference_bwd(q, k, v, bias, segq, segk, causal, dropout_p, seed, lse,
                  dout):
    """Plain version of :func:`launch_bwd`: (dq, dk, dv, D), with D from
    :func:`reference_dd`."""
    args = (q, k, v, bias, segq, segk, causal, dropout_p, seed, lse, dout)
    dd = reference_dd(*args)
    return ((reference_bwd_dq(*args, dd),) + reference_bwd_dkv(*args, dd)
            + (dd,))


def bf16_straddle_bounds(q, k, v, bias, segq, segk, causal, dropout_p, seed,
                         lse, dout):
    """Per entry of (dq, dk, dv), f32: how far a straddle can move the bf16
    backward kernels' gradients from :func:`reference_bwd`'s.

    Both round dS and Pd to bf16 before their sums, from f32 values that
    differ by at most e: two orders of a d-term dot by 2 d 2^-24 of its sum
    of |terms|, expf and torch.exp by 2 ulps each, each product and
    difference by one rounding a side, and D, which each side sums over the
    Tk keys in its own order, by 2 Tk 2^-24 of the sums of |terms| of its
    numerator and of rowsum(P), on top of the errors of those terms. Where
    [x - e, x + e] holds a bf16 rounding point, the two may round x to
    neighbouring values. The bound of an entry is the sum, over the terms
    of its sum, of
    |bf16(x + e) - bf16(x - e)| times the |operand| that x multiplies: the
    most that rounding those x the other way can move it. Built from the
    inputs alone, before any kernel runs."""
    u = 2.0 ** -24
    scale = 1.0 / math.sqrt(q.shape[-1])
    dot = 2 * q.shape[-1] * u
    qa, ka, va, da = (t.float().abs() for t in (q, k, v, dout))
    x = _scores(q, k, bias, segq, segk, causal) - lse[..., None]
    # relative error of P = exp(x): the dot, the subtraction, exp itself
    e_p = dot * scale * torch.matmul(qa, ka.mT) + 2 * u * x.abs() + 4 * u
    p = torch.exp(x)
    del x
    keep = _keep(q, k, dropout_p, seed)
    pd = p if keep is None else torch.where(
        keep, p * _keep_scale(dropout_p), torch.zeros((), device=p.device))
    e_pd = pd * (e_p + 2 * u)
    dpd = torch.matmul(dout.float(), v.float().mT)
    e_dpd = dot * torch.matmul(da, va.mT)
    # D = num / l: num = rowsum(Pd o dPd), l = rowsum(P)
    tk = k.shape[2]
    t = (pd * dpd).abs()
    l = p.sum(dim=-1)
    e_num = ((dpd.abs() * e_pd + pd * e_dpd + 2 * u * t).sum(dim=-1)
             + 2 * tk * u * t.sum(dim=-1))
    e_l = (p * e_p).sum(dim=-1) + 2 * tk * u * l
    dd = torch.where(l > 0, (pd * dpd).sum(dim=-1) / l,
                     torch.zeros((), device=l.device))
    e_dd = torch.where(l > 0, (e_num + dd.abs() * e_l)
                       / (l - e_l).clamp_min(l * 0.5) + 2 * u * dd.abs(),
                       torch.zeros((), device=l.device))
    del l, e_num, e_l
    pdd = p * dd.abs()[..., None]
    e_ds = (pd * e_dpd + dpd.abs() * e_pd + pdd * e_p
            + p * e_dd[..., None] + 4 * u * (t + pdd))
    del e_p, e_dpd, pdd, t
    ds = pd * dpd - p * dd[..., None]
    del p, dpd

    def width(y, e):
        return (y + e).to(q.dtype).float() - (y - e).to(q.dtype).float()

    w_ds, w_pd = width(ds, e_ds), width(pd, e_pd)
    return (scale * torch.matmul(w_ds, ka), scale * torch.matmul(w_ds.mT, qa),
            torch.matmul(w_pd.mT, da))


def _check_kernel_inputs(q, k, v, bias, segq, segk):
    dev = q.device
    for name, t in (("k", k), ("v", v), ("bias", bias), ("segq", segq),
                    ("segk", segk)):
        if t is not None and t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(
            f"flash_attention kernel takes head dim {HEAD_DIM}, got {q.shape[-1]}"
        )
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias),
                    ("segq", segq), ("segk", segk)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"flash_attention kernel needs a contiguous {name}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs {name} 16-byte aligned")
    if bias.dtype != torch.float32:
        raise TypeError("flash_attention: bias must be float32")


def _dropout_args(dropout_p, seed):
    """(use_dropout, keep_threshold, keep_scale, seed) for a C entry point."""
    if dropout_p == 0.0:
        return 0, 0, 1.0, 0
    return 1, keep_threshold(dropout_p), _keep_scale(dropout_p), int(seed)


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_fwd(q, k, v, bias, segq, segk, causal, dropout_p=0.0, seed=None):
    """The forward kernel on CUDA tensors: (out, lse)."""
    _check_kernel_inputs(q, k, v, bias, segq, segk)
    b, h, tq, _ = q.shape
    lib = _kernels.load()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sslc_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        _ptr(segq), _ptr(segk), out.data_ptr(), lse.data_ptr(),
        b, h, tq, k.shape[2], int(causal), int(q.dtype == torch.bfloat16),
        *_dropout_args(dropout_p, seed), q.device.index, stream,
    )
    _kernels.check(lib, err, "flash_attn_fwd launch")
    launch_counts["flash_attn_fwd"] += 1
    return out, lse


def _check_bwd_inputs(q, k, v, bias, segq, segk, lse, dout, dd):
    _check_kernel_inputs(q, k, v, bias, segq, segk)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("flash_attention backward: dout must be like q")
    for name, t in (("lse", lse), ("dd", dd)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"flash_attention backward: {name} must be "
                             "(B, H, Tq) float32")
    for name, t in (("dout", dout), ("lse", lse), ("dd", dd)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be a "
                             f"contiguous tensor on {q.device}")


def launch_bwd_dq(q, k, v, bias, segq, segk, causal, dropout_p, seed, lse,
                  dout):
    """The dQ kernel on CUDA tensors: (dq, D). The kernel computes D =
    rowsum(Pd o dPd) / rowsum(P) (plain version :func:`reference_dd`),
    uses it and writes it for :func:`launch_bwd_dkv`."""
    dd = torch.empty_like(lse)
    _check_bwd_inputs(q, k, v, bias, segq, segk, lse, dout, dd)
    b, h, tq, _ = q.shape
    lib = _kernels.load()
    dq = torch.empty_like(q)
    err = lib.sslc_flash_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        _ptr(segq), _ptr(segk), dout.data_ptr(), lse.data_ptr(),
        dd.data_ptr(), dq.data_ptr(),
        b, h, tq, k.shape[2], int(causal), int(q.dtype == torch.bfloat16),
        *_dropout_args(dropout_p, seed), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _kernels.check(lib, err, "flash_attn_bwd_dq launch")
    launch_counts["flash_attn_bwd_dq"] += 1
    return dq, dd


def launch_bwd_dkv(q, k, v, bias, segq, segk, causal, dropout_p, seed, lse,
                   dout, dd):
    """The dK/dV kernel on CUDA tensors, with the D that
    :func:`launch_bwd_dq` returned: (dk, dv)."""
    _check_bwd_inputs(q, k, v, bias, segq, segk, lse, dout, dd)
    b, h, tq, _ = q.shape
    lib = _kernels.load()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = lib.sslc_flash_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        _ptr(segq), _ptr(segk), dout.data_ptr(), lse.data_ptr(),
        dd.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, tq, k.shape[2], int(causal), int(q.dtype == torch.bfloat16),
        *_dropout_args(dropout_p, seed), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _kernels.check(lib, err, "flash_attn_bwd_dkv launch")
    launch_counts["flash_attn_bwd_dkv"] += 1
    return dk, dv


def launch_bwd(q, k, v, bias, segq, segk, causal, dropout_p, seed, lse,
               dout):
    """The dQ kernel, then the dK/dV kernel on its D: (dq, dk, dv, D)."""
    args = (q, k, v, bias, segq, segk, causal, dropout_p, seed, lse, dout)
    dq, dd = launch_bwd_dq(*args)
    return (dq,) + launch_bwd_dkv(*args, dd) + (dd,)


def _route(q):
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: no route for device {q.device}")
    return q.device.type == "cuda"


class _FlashAttention(torch.autograd.Function):
    """Port of the custom VJPs ``_flash`` and ``_flash_rect``: the forward
    kernel (or its plain version on the CPU) and, for the gradient, the dQ
    kernel, which also computes D, then the dK/dV kernel (or their plain
    versions). Returns (out, lse); lse carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, segq, segk, causal, dropout_p, seed):
        if _route(q):
            out, lse = launch_fwd(q, k, v, bias, segq, segk, causal,
                                  dropout_p, seed)
        else:
            out, lse = _reference_fwd(q, k, v, bias, segq, segk, causal,
                                      dropout_p=dropout_p, seed=seed)
        ctx.save_for_backward(q, k, v, bias, segq, segk, lse)
        ctx.causal, ctx.dropout_p, ctx.seed = causal, dropout_p, seed
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias, segq, segk, lse = ctx.saved_tensors
        dout = dout.contiguous()
        args = (q, k, v, bias, segq, segk, ctx.causal, ctx.dropout_p,
                ctx.seed, lse, dout)
        dq, dk, dv, _ = (launch_bwd if _route(q) else reference_bwd)(*args)
        return dq, dk, dv, None, None, None, None, None, None


def _fwd(q, k, v, bias, segq, segk, causal, dropout_p=0.0, seed=None):
    """Shape checks shared by both routes, then the autograd Function."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(
            f"flash_attention takes q (B,H,Tq,d) and k = v (B,H,Tk,d); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if tk == 0:
        raise ValueError("flash_attention needs at least one key")
    if causal and tq != tk:
        raise NotImplementedError(
            "causal attention requires square q/k (no global row-offset "
            f"support); got tq={tq} tk={tk}"
        )
    if tuple(bias.shape) != (b, tk):
        raise ValueError(f"bias must be (B, Tk) = {(b, tk)}, got {tuple(bias.shape)}")
    if (segq is None) != (segk is None):
        raise ValueError("segq and segk go together")
    if segq is not None and (tuple(segq.shape) != (b, tq)
                             or tuple(segk.shape) != (b, tk)):
        raise ValueError("segment ids must be (B, Tq) and (B, Tk)")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p > 0.0:
        if seed is None:
            raise ValueError("attention dropout requires a seed")
        if max(tq, tk) > DROPOUT_MAX_T:
            raise NotImplementedError(
                f"flash_attention with dropout supports T <= {DROPOUT_MAX_T} "
                f"(got T={max(tq, tk)}); dropout is a training feature — "
                "crop or bucket training data to at most 4096 frames"
            )
    _route(q)
    return _FlashAttention.apply(q, k, v, bias, segq, segk, bool(causal),
                                 float(dropout_p), seed)


def flash_attention(
    q: torch.Tensor,  # (B, H, T, d), unscaled
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, T) bool, True = PAD
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,  # (B, T) int; equal ids attend
    dropout_p: float = 0.0,
    dropout_seed: Optional[int] = None,  # required when dropout_p > 0
    return_lse: bool = False,
):
    """Port of ``flash_attention`` (JAX). Differentiable in q, k and v.
    Returns the output (B, H, T, d), or (output, lse (B, H, T) f32) with
    ``return_lse``. Attention dropout keeps each probability by the bits
    of ``attention_keep_mask(dropout_seed, ...)``."""
    bias, seg = _masks(k, key_padding_mask, segment_ids)
    out, lse = _fwd(q, k, v, bias, seg, seg, causal, dropout_p, dropout_seed)
    return (out, lse) if return_lse else out


def flash_attention_kv_full(
    q: torch.Tensor,  # (B, H, Tq, d), unscaled
    k: torch.Tensor,  # (B, H, Tk, d)
    v: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, Tk) bool
    return_lse: bool = False,
):
    """Port of ``flash_attention_kv_full`` (JAX): rectangular, non-causal,
    dropout-free attention of Tq query rows against Tk keys.
    Differentiable in q, k and v."""
    bias, _ = _masks(k, key_padding_mask, None)
    out, lse = _fwd(q, k, v, bias, None, None, False)
    return (out, lse) if return_lse else out


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    block_k: Optional[int] = None,
    dropout_p: float = 0.0,
    dropout_seed: Optional[int] = None,
):
    """The plain PyTorch forward, on any device: same arguments as
    :func:`flash_attention` (rectangular q/k allowed without segments), the
    same -1e30 masking and keep bits. Returns (out, lse).
    ``block_k=KERNEL_BLOCK_K`` rounds a bf16 P where the kernel does (see
    :func:`_reference_fwd`)."""
    bias, seg = _masks(k, key_padding_mask, segment_ids)
    return _reference_fwd(q, k, v, bias, seg, seg, causal, block_k,
                          dropout_p, dropout_seed)


def backward_args(
    q, k, v, lse, dout, *,
    key_padding_mask=None, causal=False, segment_ids=None,
    dropout_p: float = 0.0, dropout_seed: Optional[int] = None,
):
    """The argument tuple that :func:`launch_bwd`, :func:`launch_bwd_dq`,
    :func:`reference_bwd`, :func:`reference_dd` and
    :func:`bf16_straddle_bounds` take, for the forward's lse, the output
    gradient ``dout`` and the forward's arguments: (q, k, v, bias, segq,
    segk, causal, dropout_p, seed, lse, dout). :func:`launch_bwd_dkv`,
    :func:`reference_bwd_dq` and :func:`reference_bwd_dkv` take it with D
    appended."""
    bias, seg = _masks(k, key_padding_mask, segment_ids)
    return (q, k, v, bias, seg, seg, causal, dropout_p, dropout_seed, lse,
            dout)
