"""Multi-head self-attention for pruned transformer encoders.

Port of ``speech_ssl_compression_tpu/ops/attention.py``. Per-layer head
counts are plain shapes: after head pruning the q/k/v projections have
``num_heads * head_dim`` outputs, which may be fewer than the model width.

``impl`` keeps the JAX meanings: "flash" and "auto" go through
``ops/flash_attention.py::flash_attention`` (the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor); "dense" is the plain
O(T^2)-memory path below, and the only way a CUDA tensor reaches it.
Attention dropout (``dropout_p`` with a ``dropout_seed``) draws the same
keep bits on both paths (``ops/dropout.py::attention_keep_mask``), so the
dense path is the kernel's oracle with dropout on as well.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .activations import at_least_f32
from .dropout import attention_keep_mask
from .flash_attention import NEG_INF, flash_attention

IMPLS = ("auto", "flash", "dense")


def dense_attention(
    q: torch.Tensor,  # (B, H, T, d)
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, T) bool, True = PAD
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,  # (B, T) int; equal ids attend
    dropout_p: float = 0.0,
    dropout_seed: Optional[int] = None,  # required when dropout_p > 0
) -> torch.Tensor:
    """Port of ``dense_attention`` (JAX): scale q by 1/sqrt(d) in the input
    dtype, scores accumulated and kept in f32 (JAX's
    ``preferred_element_type=float32``), masks and softmax in f32,
    probabilities cast back to the input dtype, attention dropout on them,
    then the product with v."""
    b, h, t, d = q.shape
    # 0-dim CPU tensors in q's dtype: combined with a CUDA tensor as
    # scalars, with no copy to the device
    scale = torch.reciprocal(torch.sqrt(torch.tensor(float(d), dtype=q.dtype)))
    logits = torch.matmul(at_least_f32(q * scale),
                          at_least_f32(k).transpose(-1, -2))
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        # an additive bias in JAX; -1e30 + a score rounds to -1e30 in f32
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        logits = logits.masked_fill(~same, NEG_INF)
    if causal:
        above = torch.ones((t, t), dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(above, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        if dropout_seed is None:
            raise ValueError("attention dropout requires a seed")
        keep = attention_keep_mask(dropout_seed, b, h, t, k.shape[2],
                                   dropout_p, q.device)
        kept_scale = torch.tensor(1.0 / (1.0 - dropout_p), dtype=q.dtype)
        probs = torch.where(keep, probs * kept_scale,
                            torch.zeros((), dtype=q.dtype, device=q.device))
    return torch.matmul(probs, v)


def project_to_heads(x: torch.Tensor, proj: nn.Linear, num_heads: int,
                     head_dim: int) -> torch.Tensor:
    """One q/k/v projection + head split: (B, T, D) -> (B, H, T, d),
    contiguous (the layout the kernel takes)."""
    b, t = x.shape[0], x.shape[1]
    y = F.linear(x, proj.weight, proj.bias)
    return y.view(b, t, num_heads, head_dim).transpose(1, 2).contiguous()


def output_projection(context: torch.Tensor, proj: nn.Linear) -> torch.Tensor:
    """Merge heads and apply out_proj: (B, H, T, d) -> (B, T, D)."""
    b, h, t, d = context.shape
    flat = context.transpose(1, 2).reshape(b, t, h * d)
    return F.linear(flat, proj.weight, proj.bias)


class SelfAttention(nn.Module):
    """q/k/v/out projections under the reference names
    (``self_attn.{q,k,v,out}_proj``)."""

    def __init__(self, embed_dim: int, num_heads: int, head_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        proj_dim = num_heads * head_dim
        self.q_proj = nn.Linear(embed_dim, proj_dim)
        self.k_proj = nn.Linear(embed_dim, proj_dim)
        self.v_proj = nn.Linear(embed_dim, proj_dim)
        self.out_proj = nn.Linear(proj_dim, embed_dim)


def multi_head_self_attention(
    x: torch.Tensor,  # (B, T, D)
    attn: SelfAttention,
    *,
    num_heads: int,
    head_dim: int,
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, T) bool, True = PAD
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,  # (B, T): sequence packing
    impl: str = "auto",
    dropout_p: float = 0.0,
    dropout_seed: Optional[int] = None,  # required when dropout_p > 0
):
    """Port of ``multi_head_self_attention`` (JAX). Returns
    (out (B, T, D), context (B, H, T, d)); context is the pre-out-proj
    per-head tensor that head scoring reads."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    q = project_to_heads(x, attn.q_proj, num_heads, head_dim)
    k = project_to_heads(x, attn.k_proj, num_heads, head_dim)
    v = project_to_heads(x, attn.v_proj, num_heads, head_dim)
    attend = dense_attention if impl == "dense" else flash_attention
    context = attend(q, k, v, key_padding_mask=key_padding_mask,
                     causal=causal, segment_ids=segment_ids,
                     dropout_p=dropout_p, dropout_seed=dropout_seed)
    return output_projection(context, attn.out_proj), context
