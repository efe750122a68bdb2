"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Port of the forward of ``speech_ssl_compression_tpu/ops/flash_attention.py``
(``flash_attention`` and ``flash_attention_kv_full``). For a CUDA tensor
the wrapper launches the hand-written kernel in ``csrc/flash_attn_fwd.cu``
or raises; only a CPU tensor goes to the plain PyTorch version,
:func:`flash_attention_reference`. There is no backward kernel yet, so the
wrapper refuses inputs that require grad.

Masking semantics, kept exactly: padding is an additive ``NEG_INF`` bias,
segments and causality replace the score with ``NEG_INF``; the finite
-1e30 keeps fully masked rows finite.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _kernels

NEG_INF = -1e30
HEAD_DIM = 64  # the only head dim the CUDA kernel takes
KERNEL_BLOCK_K = 64  # keys per tile of the kernel's online softmax

# launches of the CUDA kernel, counted where it is launched (read and reset
# by chip_smoke.py to show which path a run took)
launch_counts = {"flash_attn_fwd": 0}


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


def _reference_fwd(q, k, v, bias, segq, segk, causal, block_k=None):
    """Plain version of the kernel: the whole score matrix, same masks,
    f32 statistics. Returns (out in q's dtype, lse (B, H, Tq) f32).

    With ``block_k``, the softmax and P.V walk the keys in tiles of that
    size by the online-softmax recurrence, as the kernel does, so that a
    bf16 P is rounded at the same points (``p = exp(s - running max)``)."""
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
    # the kernel rounds P to the input dtype before the P.V product
    if block_k is None:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.matmul(p.to(q.dtype).float(), v.float())
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
                p.to(q.dtype).float(), v[..., k0:k0 + block_k, :].float())
            m = m_new
    l_safe = l.clamp_min(1e-30)
    return (acc / l_safe).to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


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


def _launch(q, k, v, bias, segq, segk, causal):
    _check_kernel_inputs(q, k, v, bias, segq, segk)
    b, h, tq, _ = q.shape
    lib = _kernels.load()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sslc_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if segq is None else segq.data_ptr(),
        None if segk is None else segk.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        b, h, tq, k.shape[2], int(causal), int(q.dtype == torch.bfloat16),
        q.device.index, stream,
    )
    _kernels.check(lib, err, "flash_attn_fwd launch")
    launch_counts["flash_attn_fwd"] += 1
    return out, lse


def _fwd(q, k, v, bias, segq, segk, causal):
    """Shape checks shared by both routes, then the device decides: the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward kernel yet; it comes with the "
            "training slice (run inference under torch.no_grad())"
        )
    if q.device.type == "cuda":
        return _launch(q, k, v, bias, segq, segk, causal)
    if q.device.type == "cpu":
        return _reference_fwd(q, k, v, bias, segq, segk, causal)
    raise ValueError(f"flash_attention: no route for device {q.device}")


def flash_attention(
    q: torch.Tensor,  # (B, H, T, d), unscaled
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, T) bool, True = PAD
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,  # (B, T) int; equal ids attend
    return_lse: bool = False,
):
    """Port of ``flash_attention`` (JAX, dropout-free). Returns the output
    (B, H, T, d), or (output, lse (B, H, T) f32) with ``return_lse``."""
    bias, seg = _masks(k, key_padding_mask, segment_ids)
    out, lse = _fwd(q, k, v, bias, seg, seg, causal)
    return (out, lse) if return_lse else out


def flash_attention_kv_full(
    q: torch.Tensor,  # (B, H, Tq, d), unscaled
    k: torch.Tensor,  # (B, H, Tk, d)
    v: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, Tk) bool
    return_lse: bool = False,
):
    """Port of ``flash_attention_kv_full`` (JAX): rectangular, non-causal
    attention of Tq query rows against Tk keys."""
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
):
    """The plain PyTorch version, on any device: same arguments as
    :func:`flash_attention` (rectangular q/k allowed without segments), the
    same -1e30 masking. Returns (out, lse). ``block_k=KERNEL_BLOCK_K``
    rounds a bf16 P where the kernel does (see :func:`_reference_fwd`)."""
    bias, seg = _masks(k, key_padding_mask, segment_ids)
    return _reference_fwd(q, k, v, bias, seg, seg, causal, block_k)
