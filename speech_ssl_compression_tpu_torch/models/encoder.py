"""Transformer encoder with conv positional embedding.

Port of ``speech_ssl_compression_tpu/models/encoder.py``, for MelHuBERT and
HuBERT (both configs carry the encoder's fields). Parameters live in
``nn.Module``s under the reference state-dict names (``encoder.layers.{i}.
self_attn.q_proj.weight``, ``encoder.pos_conv.0.weight_v``, ...); the
forward is the plain functions below, each named after its JAX
counterpart. Per-layer head counts and FFN widths come from the config's
per-layer tuples, so head- and row-pruned checkpoints load.

Training (``deterministic=False``) adds the input dropout after the
prologue, the residual, activation and attention dropouts of every layer,
and LayerDrop. Randomness comes from one explicit host
``torch.Generator``: :func:`encoder_forward` seeds a generator on the
device from it for the dropout bits, and each layer draws its attention
seed (the key of the kernels' keep bits) and its LayerDrop coin from it.

``layer_norm`` is PyTorch's: in bf16 it takes its statistics in f32 and
rounds its output to bf16, where JAX's ``layer_norm`` rounds each step of
its bf16 arithmetic. The two agree to bf16 rounding.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import get_activation_fn
from ..ops.attention import SelfAttention, multi_head_self_attention
from ..ops.dropout import device_generator, draw_seed, dropout

LN_EPS = 1e-5


class PosConv(nn.Module):
    """Weight-normed grouped Conv1d: ``weight_g`` (1, 1, K), ``weight_v``
    (D, D // groups, K), ``bias`` (D,), the torch weight-norm layout."""

    def __init__(self, embed_dim: int, kernel_size: int, groups: int):
        super().__init__()
        self.groups = groups
        self.kernel_size = kernel_size
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel_size))
        self.weight_v = nn.Parameter(
            torch.zeros(embed_dim, embed_dim // groups, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(embed_dim))


class EncoderLayer(nn.Module):
    """One BERT layer's parameters (reference TransformerSentenceEncoderLayer)."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 head_dim: int):
        super().__init__()
        self.self_attn = SelfAttention(embed_dim, num_heads, head_dim)
        self.self_attn_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.fc1 = nn.Linear(embed_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed_dim)
        self.final_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)


class TransformerEncoder(nn.Module):
    """Encoder parameters: ``pos_conv.0``, ``layer_norm``, ``layers.{i}``."""

    def __init__(self, cfg):
        super().__init__()
        if getattr(cfg, "pos_emb_type", "conv") != "conv":
            raise NotImplementedError(
                f"unsupported pos_emb_type {cfg.pos_emb_type!r} (only 'conv')"
            )
        if getattr(cfg, "layer_type", "transformer") != "transformer":
            raise NotImplementedError(
                f"unsupported layer_type {cfg.layer_type!r} (only 'transformer')"
            )
        _check_ported(cfg)
        d = cfg.encoder_embed_dim
        self.pos_conv = nn.ModuleList(
            [PosConv(d, cfg.conv_pos, cfg.conv_pos_groups)]
        )
        self.layer_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.layers = nn.ModuleList(
            EncoderLayer(d, cfg.encoder_ffn_embed_dim[i],
                         cfg.encoder_attention_heads[i], cfg.head_dim)
            for i in range(cfg.encoder_layers)
        )


def _check_ported(cfg) -> None:
    if getattr(cfg, "pos_conv_depth", 1) > 1:
        raise NotImplementedError(
            "pos_conv_depth > 1 (pos_conv_embed_deep) is not ported yet"
        )


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, LN_EPS)


def pos_conv_weight(p: PosConv) -> torch.Tensor:
    """Materialize the weight-normed kernel (D, D // g, K): the norm is over
    dims (0, 1) for each tap k, floored at 1e-12."""
    v = p.weight_v
    norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
    return p.weight_g * v / norm.clamp_min(1e-12)


def _grouped_conv_samepad(x, w, bias, groups: int, kernel_size: int):
    """Grouped Conv1d over (B, T, D) with K // 2 padding on each side and the
    SamePad crop of one frame for an even K. ``w`` is in the torch layout
    (D, D // g, K), which ``F.conv1d`` takes as is."""
    out = F.conv1d(x.transpose(1, 2), w.to(x.dtype), bias.to(x.dtype),
                   padding=kernel_size // 2, groups=groups).transpose(1, 2)
    if kernel_size % 2 == 0:
        out = out[:, :-1, :]
    return out


def pos_conv_embed(x: torch.Tensor, p: PosConv) -> torch.Tensor:
    """Weight-normed grouped conv + SamePad crop + GELU. x: (B, T, D)."""
    out = _grouped_conv_samepad(x, pos_conv_weight(p), p.bias, p.groups,
                                p.kernel_size)
    return get_activation_fn("gelu")(out)


def encoder_layer_forward(
    x: torch.Tensor,  # (B, T, D)
    layer: EncoderLayer,
    *,
    layer_norm_first: bool,
    key_padding_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    activation_fn: str = "gelu",
    dropout_p: float = 0.0,
    attention_dropout: float = 0.0,
    activation_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,  # on x's device
    attention_seed: Optional[int] = None,
    deterministic: bool = True,
):
    """Post-LN (default) or pre-LN BERT layer (reference module.py:82-133).
    With ``deterministic=False`` the residual and activation dropouts draw
    from ``generator`` and attention dropout keys its bits on
    ``attention_seed``. Returns (x, context)."""
    attn = layer.self_attn
    act = get_activation_fn(activation_fn)

    def drop(h, p):
        return dropout(h, p, generator, deterministic)

    def self_attn(h):
        return multi_head_self_attention(
            h, attn, num_heads=attn.num_heads, head_dim=attn.head_dim,
            key_padding_mask=key_padding_mask, causal=causal,
            segment_ids=segment_ids, impl=attn_impl,
            dropout_p=0.0 if deterministic else attention_dropout,
            dropout_seed=attention_seed,
        )

    def ffn(h):
        return layer.fc2(drop(act(layer.fc1(h)), activation_dropout))

    if layer_norm_first:
        h, context = self_attn(layer_norm(x, layer.self_attn_layer_norm))
        x = x + drop(h, dropout_p)
        x = x + drop(ffn(layer_norm(x, layer.final_layer_norm)), dropout_p)
    else:
        h, context = self_attn(x)
        x = layer_norm(x + drop(h, dropout_p), layer.self_attn_layer_norm)
        x = layer_norm(x + drop(ffn(x), dropout_p), layer.final_layer_norm)
    return x, context


def encoder_prologue(
    x: torch.Tensor,  # (B, T, D)
    enc: TransformerEncoder,
    cfg,
    *,
    padding_mask: Optional[torch.Tensor] = None,  # (B, T) bool, True = PAD
    generator: Optional[torch.Generator] = None,  # on x's device
    deterministic: bool = True,
):
    """Everything before the layers: zero padded frames, add the conv
    positional embedding, the encoder LayerNorm (post-LN), then the input
    dropout. Split out so packed extraction can run it per utterance."""
    if padding_mask is not None:
        x = x.masked_fill(padding_mask[:, :, None], 0.0)
    x = x + pos_conv_embed(x, enc.pos_conv[0])
    if not cfg.layer_norm_first:
        x = layer_norm(x, enc.layer_norm)
    return dropout(x, cfg.dropout, generator, deterministic)


def encoder_layers_forward(
    x: torch.Tensor,  # (B, T, D)
    enc: TransformerEncoder,
    cfg,
    *,
    padding_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    get_hidden: bool = False,
    attn_impl: str = "auto",
    rng: Optional[torch.Generator] = None,  # host generator
    generator: Optional[torch.Generator] = None,  # on x's device
    deterministic: bool = True,
):
    """The layer stack + final (pre-LN) norm. Returns (x, layer_hiddens).
    The per-layer contexts, which only head scoring reads, are dropped.

    In training each layer draws its attention seed from the host ``rng``
    and, with ``encoder_layerdrop > 0``, a coin that skips the whole layer
    (reference module.py:242-250; JAX computes the layer and selects, a
    dropped layer here is not run). A dropped layer's input stands in its
    ``layer_hiddens`` slot, as in JAX."""
    layer_hiddens = []
    for i, layer in enumerate(enc.layers):
        seed = None
        if not deterministic:
            seed = draw_seed(rng)
            if cfg.encoder_layerdrop > 0.0 and float(
                    torch.rand((), generator=rng)) < cfg.encoder_layerdrop:
                if get_hidden:
                    layer_hiddens.append(x)
                continue
        x, _ = encoder_layer_forward(
            x, layer,
            layer_norm_first=cfg.layer_norm_first,
            key_padding_mask=padding_mask,
            causal=causal,
            segment_ids=segment_ids,
            attn_impl=attn_impl,
            activation_fn=cfg.activation_fn,
            dropout_p=cfg.dropout,
            attention_dropout=cfg.attention_dropout,
            activation_dropout=cfg.activation_dropout,
            generator=generator,
            attention_seed=seed,
            deterministic=deterministic,
        )
        if get_hidden:
            layer_hiddens.append(x)
    if cfg.layer_norm_first:
        x = layer_norm(x, enc.layer_norm)
    return x, layer_hiddens


def encoder_forward(
    x: torch.Tensor,  # (B, T, D)
    enc: TransformerEncoder,
    cfg,
    *,
    padding_mask: Optional[torch.Tensor] = None,  # (B, T) bool, True = PAD
    causal: bool = False,
    get_hidden: bool = False,
    attn_impl: str = "auto",
    rng: Optional[torch.Generator] = None,  # host generator
    deterministic: bool = True,
):
    """Prologue + layer stack. Returns (x, layer_hiddens). Training
    (``deterministic=False``) needs ``rng``, a host ``torch.Generator``.

    ``cfg.required_seq_len_multiple`` (the HuBERT/wav2vec 2.0 encoders) is
    kept as in JAX (reference module.py:492-541): after the prologue T is
    padded up to the next multiple, the padded tail is key-padding-masked
    through the layers, and the outputs are cut back to T."""
    generator = None
    if not deterministic:
        if rng is None:
            raise ValueError("training (deterministic=False) needs an rng")
        generator = device_generator(rng, x.device)
    x = encoder_prologue(x, enc, cfg, padding_mask=padding_mask,
                         generator=generator, deterministic=deterministic)
    t = x.shape[1]
    pad = -t % int(getattr(cfg, "required_seq_len_multiple", 1) or 1)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        if padding_mask is None:
            padding_mask = torch.zeros(x.shape[:1] + (t,), dtype=torch.bool,
                                       device=x.device)
        padding_mask = F.pad(padding_mask, (0, pad), value=True)
    x, layer_hiddens = encoder_layers_forward(
        x, enc, cfg, padding_mask=padding_mask, causal=causal,
        get_hidden=get_hidden, attn_impl=attn_impl, rng=rng,
        generator=generator, deterministic=deterministic,
    )
    if pad:
        x = x[:, :t]
        layer_hiddens = [h[:, :t] for h in layer_hiddens]
    return x, layer_hiddens
