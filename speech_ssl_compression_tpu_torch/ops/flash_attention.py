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
launch the hand-written kernels (the C entry points of
``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu``, which send f32
inputs on to the split-TF32 tensor-core kernels of their ``_f32_sm90``
files and bf16 inputs to those of their ``_sm90`` files) or raise; CPU
tensors go to the plain PyTorch versions, :func:`_reference_fwd` and
:func:`reference_bwd` (D by :func:`reference_dd`, then
:func:`reference_bwd_dq` and :func:`reference_bwd_dkv`), which write the
same formulas out in full (B, H, Tq, Tk) matrices. ``chip_smoke.py`` holds
each kernel against its plain version on the card: in f32 against it run
in float64 (:func:`float64_args`); in bf16 within one ulp, where the
forward's entries past it must be p rounded the other way
(:func:`bf16_forward_straddle_bounds`,
:func:`bf16_forward_straddle_flips`) and the backward's within
:func:`bf16_straddle_bounds`.

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
# straddling p per row that bf16_forward_straddle_flips tries rounding the
# other way, in every subset (2^16 of them)
FLIP_KEYS = 16
# JAX's _STREAM_THRESHOLD: past it JAX streams K/V (or Q/dO) through the
# grid (``_fa_fwd_stream_kernel``, ``_fa_bwd_dq_stream_kernel``,
# ``_fa_bwd_dkv_stream_kernel``); the CUDA kernels take any T, and count
# their launches past it apart (long_launch_counts)
STREAM_THRESHOLD = 4096
# flash_attention with dropout refuses longer T, as JAX does (its dropout
# forward shares the whole-K/V-resident grid of its backward)
DROPOUT_MAX_T = STREAM_THRESHOLD

# launches of the CUDA kernels, counted where each is launched (read and
# reset by chip_smoke.py to show which path a run took): in all, per input
# dtype, and per input dtype those with max(Tq, Tk) > STREAM_THRESHOLD (the
# calls JAX sends to its streamed kernels)
launch_counts = {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 0,
                 "flash_attn_bwd_dkv": 0}
dtype_launch_counts = {name: {"f32": 0, "bf16": 0} for name in launch_counts}
long_launch_counts = {name: {"f32": 0, "bf16": 0} for name in launch_counts}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
        dtype_launch_counts[name] = {"f32": 0, "bf16": 0}
        long_launch_counts[name] = {"f32": 0, "bf16": 0}


def _count(name: str, q: torch.Tensor, tk: Optional[int] = None) -> None:
    """One launch of kernel ``name`` on q (B, H, Tq, d) against ``tk`` keys
    (Tq where not given)."""
    tag = "bf16" if q.dtype == torch.bfloat16 else "f32"
    launch_counts[name] += 1
    dtype_launch_counts[name][tag] += 1
    if max(q.shape[2], tk or q.shape[2]) > STREAM_THRESHOLD:
        long_launch_counts[name][tag] += 1


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


_NEG_INF_F32 = float(torch.tensor(NEG_INF, dtype=torch.float32))


def _wide(t):
    """``t`` in the plain versions' arithmetic: f32, or float64 for float64
    inputs (the exact evaluation, which the f32 kernels are held to)."""
    return t if t.dtype == torch.float64 else t.float()


def _scores(q, k, bias, segq, segk, causal):
    """S = scale * (q . k) in f32 (float64 for float64 inputs) with the
    kernels' masks, (B, H, Tq, Tk). A masked score is NEG_INF as f32 holds
    it in either type, so that a fully masked row meets the kernels' f32 LSE
    with exp(0) in float64 too."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * scale
    s = s + bias[:, None, None, :]
    if segq is not None:
        s = s.masked_fill(segq[:, None, :, None] != segk[:, None, None, :],
                          _NEG_INF_F32)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        above = torch.ones((tq, tk), dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, _NEG_INF_F32)
    return s


def _keep(q, k, dropout_p, seed):
    """The dropout keep mask (B, H, Tq, Tk) on q's device, or None."""
    if dropout_p == 0.0:
        return None
    b, h, tq, _ = q.shape
    return attention_keep_mask(seed, b, h, tq, k.shape[2], dropout_p, q.device)


def _tile_maxima(s, block_k):
    """The running row max of the kernels' online softmax after each key
    tile of ``block_k``: one (..., 1) tensor per tile. Tile t's p is
    exp(s - maxima[t]); the last is the row's max."""
    maxima, m = [], torch.full_like(s[..., :1], NEG_INF)
    for k0 in range(0, s.shape[-1], block_k):
        m = torch.maximum(m, s[..., k0:k0 + block_k].amax(dim=-1,
                                                          keepdim=True))
        maxima.append(m)
    return maxima


def _reference_fwd(q, k, v, bias, segq, segk, causal, block_k=None,
                   dropout_p=0.0, seed=None):
    """Plain version of the forward kernel: the whole score matrix, same
    masks, f32 statistics (float64 for float64 inputs: the exact evaluation
    that the f32 kernel is held to, :func:`_wide`). Returns (out in q's
    dtype, lse (B, H, Tq) f32, or float64).

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
        acc = torch.matmul(_wide(kept(p).to(q.dtype)), _wide(v))
    else:
        m = torch.full_like(s[..., :1], NEG_INF)
        l = torch.zeros_like(m)
        acc = s.new_zeros(s.shape[:-1] + v.shape[-1:])
        for k0, m_new in zip(range(0, s.shape[-1], block_k),
                             _tile_maxima(s, block_k)):
            st = s[..., k0:k0 + block_k]
            alpha = torch.exp(m - m_new)
            p = torch.exp(st - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(
                _wide(kept(p, k0).to(q.dtype)),
                _wide(v[..., k0:k0 + block_k, :]))
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
    dpd = torch.matmul(_wide(dout), _wide(v).transpose(-1, -2))
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
    dpd = torch.matmul(_wide(dout), _wide(v).transpose(-1, -2))
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
    dq = torch.matmul(_wide(ds.to(q.dtype)), _wide(k))
    return (scale * dq).to(q.dtype)


def reference_bwd_dkv(q, k, v, bias, segq, segk, causal, dropout_p, seed,
                      lse, dout, dd):
    """Plain version of the dK/dV kernel: dK = scale * dS^T Q and
    dV = Pd^T dO, with dS and Pd cast to the input dtype first."""
    _, pd, ds = _reference_ds(q, k, v, bias, segq, segk, causal, dropout_p,
                              seed, lse, dout, dd)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dk = torch.matmul(_wide(ds.to(q.dtype)).transpose(-1, -2), _wide(q))
    dv = torch.matmul(_wide(pd.to(q.dtype)).transpose(-1, -2), _wide(dout))
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
    _count("flash_attn_fwd", q, k.shape[2])
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
    _count("flash_attn_bwd_dq", q, k.shape[2])
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
    _count("flash_attn_bwd_dkv", q, k.shape[2])
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
                f"crop or bucket training data to at most {DROPOUT_MAX_T} "
                "frames"
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


def _forward_straddles(q, k, key_padding_mask, causal, segment_ids, block_k,
                       dropout_p, dropout_seed):
    """Yields, per key tile of ``block_k``, (k0, pb, lo, hi, w), each
    (B, H, Tq, tile) f32: pb, the plain version's p = exp(s - m) rounded
    to q's dtype; lo and hi, the two values the bf16 forward kernel may
    round its own p to; w, the weight of a rounded p in the output.

    Kernel and plain version round each key tile's p = exp(s - m) to bf16
    before P.V, from scores that differ by rounding: the kernel sums a
    score's d products on the tensor cores (truncating, within d 2^-23 of
    the sum of |terms|), the plain version in f32 (within d 2^-24), so the
    two differ by at most 3 d 2^-24 of it, and the running max m, one of
    the row's scores, by as much; x = s - m by one rounding a side; exp
    (expf in the kernel, torch.exp here) by 2 ulps a side. So the kernel's
    p lies within e of the plain one's and rounds to lo = bf16(p - e) or
    hi = bf16(p + e); where the two differ, p straddles a rounding point.
    w = exp(m - m_final) / l, times 1 / (1 - dropout_p) where the key is
    kept, 0 where it is dropped."""
    u = 2.0 ** -24
    bias, seg = _masks(k, key_padding_mask, segment_ids)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, bias, seg, seg, causal)
    e_s = (3 * q.shape[-1] * u * scale) * torch.matmul(q.float().abs(),
                                                       k.float().abs().mT)
    e_m = e_s.amax(dim=-1, keepdim=True)
    keep = _keep(q, k, dropout_p, seed=dropout_seed)
    tiles = list(zip(range(0, s.shape[-1], block_k), _tile_maxima(s, block_k)))
    m = tiles[-1][1]
    l = sum(torch.exp(s[..., k0:k0 + block_k] - mt).sum(dim=-1, keepdim=True)
            * torch.exp(mt - m) for k0, mt in tiles)
    l_safe = l.clamp_min(1e-30)
    for k0, mt in tiles:
        x = s[..., k0:k0 + block_k] - mt
        p = torch.exp(x)
        e = p * (e_s[..., k0:k0 + block_k] + e_m + 2 * u * x.abs() + 8 * u)
        lo, hi = ((p + sign * e).to(q.dtype).float() for sign in (-1, 1))
        w = (torch.exp(mt - m) / l_safe).expand_as(p)
        if keep is not None:
            w = w.masked_fill(~keep[..., k0:k0 + block_k], 0.0) * _keep_scale(
                dropout_p)
        yield k0, p.to(q.dtype).float(), lo, hi, w


def bf16_forward_straddle_bounds(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    block_k: int = KERNEL_BLOCK_K,
    dropout_p: float = 0.0,
    dropout_seed: Optional[int] = None,
):
    """Per output entry (B, H, Tq, d), f32: how far p rounded the other
    way can move the bf16 forward kernel's output from
    :func:`flash_attention_reference`'s with the same ``block_k``
    (arguments as there): the sum over the keys of (hi - lo) w |v|, with
    lo, hi and w of :func:`_forward_straddles`. The f32 sums (P.V, l)
    differ far below an ulp; the one ulp the check allows takes them.
    Built from the inputs alone, before any kernel runs."""
    bound = 0.0
    for k0, _, lo, hi, w in _forward_straddles(
            q, k, key_padding_mask, causal, segment_ids, block_k, dropout_p,
            dropout_seed):
        bound = bound + torch.matmul((hi - lo) * w,
                                     v[..., k0:k0 + block_k, :].float().abs())
    return bound


def bf16_forward_straddle_flips(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    rows: torch.Tensor,
    ulp: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    block_k: int = KERNEL_BLOCK_K,
    dropout_p: float = 0.0,
    dropout_seed: Optional[int] = None,
):
    """Whether straddling p rounded the other way account for the bf16
    forward kernel's output ``out`` (B, H, Tq, d) at ``rows``, (n, 3)
    indices (b, h, i) of query rows (other arguments as
    :func:`bf16_forward_straddle_bounds`). Each row of the plain output is
    recomputed from its bf16 p with every subset of its straddling p
    rounded the other way (hi for lo, lo for hi; the FLIP_KEYS that move
    the row most) and held against ``out`` in units of ``ulp``
    (B, H, Tq, d). Returns per row (number of straddling p, number flipped
    in the subset that comes closest, max |out - plain| / ulp with no p
    flipped, the same with that subset)."""
    b, h, i = rows.unbind(-1)
    parts = [tuple(t[b, h, i] for t in tile[1:]) for tile in _forward_straddles(
        q, k, key_padding_mask, causal, segment_ids, block_k, dropout_p,
        dropout_seed)]
    pb, lo, hi, w = (torch.cat(t, dim=-1) for t in zip(*parts))
    vals, got, ulps = v.float()[b, h], out.float()[b, h, i], ulp[b, h, i]
    base = torch.einsum("nk,nkd->nd", pb * w, vals)
    step = (torch.where(pb == hi, lo, hi) - pb) * w
    found = []
    for r in range(rows.shape[0]):
        keys = (hi[r] != lo[r]).nonzero().squeeze(-1)
        moves = step[r, keys, None] * vals[r, keys]
        moves = moves[moves.abs().amax(dim=-1).argsort(descending=True)
                      [:FLIP_KEYS]]
        n = moves.shape[0]
        subsets = ((torch.arange(2 ** n, device=out.device)[:, None]
                    >> torch.arange(n, device=out.device)) & 1).float()
        tried = (base[r] + subsets @ moves).to(out.dtype).float()
        err = ((tried - got[r]).abs() / ulps[r]).amax(dim=-1)
        best = int(err.argmin())
        found.append((len(keys), int(subsets[best].sum()), float(err[0]),
                      float(err[best])))
    return found


def forward_args(
    q, k, v, *,
    key_padding_mask=None, causal=False, segment_ids=None,
    dropout_p: float = 0.0, dropout_seed: Optional[int] = None,
):
    """The argument tuple that :func:`launch_fwd` and :func:`_reference_fwd`
    take for :func:`flash_attention`'s arguments: (q, k, v, bias, segq,
    segk, causal, dropout_p, seed)."""
    bias, seg = _masks(k, key_padding_mask, segment_ids)
    return (q, k, v, bias, seg, seg, causal, dropout_p, dropout_seed)


def float64_args(args):
    """A :func:`forward_args` or :func:`backward_args` tuple with its float
    tensors in float64: the plain forward or backward on it is the exact
    evaluation of the kernels' function (:func:`_wide`)."""
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def backward_args(
    q, k, v, lse, dout, *,
    key_padding_mask=None, causal=False, segment_ids=None,
    dropout_p: float = 0.0, dropout_seed: Optional[int] = None,
):
    """The argument tuple that :func:`launch_bwd`, :func:`launch_bwd_dq`,
    :func:`reference_bwd`, :func:`reference_dd` and
    :func:`bf16_straddle_bounds` take, for the forward's lse, the output
    gradient ``dout`` and the forward's arguments: :func:`forward_args`'s
    tuple with (lse, dout) appended. :func:`launch_bwd_dkv`,
    :func:`reference_bwd_dq` and :func:`reference_bwd_dkv` take it with D
    appended."""
    return forward_args(q, k, v, key_padding_mask=key_padding_mask,
                        causal=causal, segment_ids=segment_ids,
                        dropout_p=dropout_p,
                        dropout_seed=dropout_seed) + (lse, dout)
