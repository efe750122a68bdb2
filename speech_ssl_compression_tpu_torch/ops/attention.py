"""Multi-head self-attention for pruned transformer encoders.

Port of ``speech_ssl_compression_tpu/ops/attention.py``. Per-layer head
counts are plain shapes: after head pruning the q/k/v projections have
``num_heads * head_dim`` outputs, which may be fewer than the model width.

``impl`` keeps the JAX meanings: "flash" and "auto" go through
``ops/flash_attention.py::flash_attention`` (the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor); "dense" is the plain
O(T^2)-memory path below, and the only way a CUDA tensor reaches it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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
) -> torch.Tensor:
    """Port of ``dense_attention`` (JAX, dropout-free): scale q by
    1/sqrt(d), masks and softmax in f32, probabilities cast back to the
    input dtype for the product with v. With bf16 inputs the scores are
    rounded to bf16 before the f32 softmax (JAX keeps them in f32)."""
    t, d = q.shape[2], q.shape[3]
    scale = 1.0 / d**0.5
    logits = torch.matmul(q * scale, k.transpose(-1, -2)).float()
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
):
    """Port of ``multi_head_self_attention`` (JAX, dropout-free). Returns
    (out (B, T, D), context (B, H, T, d)); context is the pre-out-proj
    per-head tensor that head scoring reads."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    q = project_to_heads(x, attn.q_proj, num_heads, head_dim)
    k = project_to_heads(x, attn.k_proj, num_heads, head_dim)
    v = project_to_heads(x, attn.v_proj, num_heads, head_dim)
    attend = dense_attention if impl == "dense" else flash_attention
    context = attend(q, k, v, key_padding_mask=key_padding_mask,
                     causal=causal, segment_ids=segment_ids)
    return output_projection(context, attn.out_proj), context
