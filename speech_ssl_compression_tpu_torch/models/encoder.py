"""Transformer encoder with conv positional embedding.

Port of ``speech_ssl_compression_tpu/models/encoder.py``, for MelHuBERT and
HuBERT (both configs carry the encoder's fields). Parameters live in
``nn.Module``s under the reference state-dict names (``encoder.layers.{i}.
self_attn.q_proj.weight``, ``encoder.pos_conv.0.weight_v``, ...); the
forward is the plain functions below, each named after its JAX
counterpart. Per-layer head counts and FFN widths come from the config's
per-layer tuples, so head- and row-pruned checkpoints load. With
``pos_conv_depth > 1`` the positional embedding is the deep stack of
grouped convs (``encoder.pos_conv.{i}.0.weight``; JAX
``pos_conv_embed_deep``). Every grouped pos-conv goes through
``ops/grouped_conv.py`` (JAX's ``grouped_conv1d``: f32 sums in bf16, and
JAX's backward).

Training (``deterministic=False``) adds the input dropout after the
prologue, the residual, activation and attention dropouts of every layer,
and LayerDrop. Randomness comes from one explicit host
``torch.Generator``: :func:`encoder_forward` seeds a generator on the
device from it for the dropout bits, and each layer draws its attention
seed (the key of the kernels' keep bits) and its LayerDrop coin from it.

With ``checkpoint_activations`` (HuBERT and wav2vec 2.0 configs; JAX's
``jax.checkpoint`` around each layer) a training forward keeps only each
layer's input and recomputes the layer in the backward
(:func:`checkpoint_layer`); ``remat=True`` does the same for any forward
that records a graph (MelHuBERT's grad step, JAX's ``remat=``).

Data and tensor parallel (``parallel/mesh.py::attach``): a rank's
replica folds its data index into every dropout seed, and a layer split
over the model group (``layer.tp``) runs this rank's heads and FFN units,
all-reduces the partial sums of ``out_proj`` and ``fc2`` over the model
group before their biases, and draws the attention keep bits and the
activation dropout of its own heads and units with the model index folded
in as well (:func:`~..ops.dropout.fold_seed`).

``layer_norm`` is PyTorch's: in bf16 it takes its statistics in f32 and
rounds its output to bf16, where JAX's ``layer_norm`` rounds each step of
its bf16 arithmetic. The two agree to bf16 rounding.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.activations import get_activation_fn
from ..ops.attention import SelfAttention, multi_head_self_attention
from ..ops.dropout import dropout, draw_seed, fold_seed, seeded_generator
from ..ops.grouped_conv import grouped_conv1d
from ..parallel.mesh import CopyToModel, ReduceFromModel

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
    """Encoder parameters: ``pos_conv``, ``layer_norm``, ``layers.{i}``.
    ``pos_conv`` is ``[PosConv]`` (``pos_conv.0.weight_g``, ...), or with
    ``pos_conv_depth > 1`` the deep stack, ``depth`` blocks that each hold
    one grouped ``Conv1d`` (``pos_conv.{i}.0.weight``, ``.bias``; the
    reference's ``nn.Sequential`` names) with torch's default init, which
    is what JAX ``init_pos_conv_deep`` draws."""

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
        d = cfg.encoder_embed_dim
        depth = getattr(cfg, "pos_conv_depth", 1)
        if depth > 1:
            k = pos_conv_kernel_size(cfg.conv_pos, depth)
            self.pos_conv = nn.ModuleList(
                nn.ModuleList([nn.Conv1d(d, d, k, groups=cfg.conv_pos_groups)])
                for _ in range(depth))
        else:
            self.pos_conv = nn.ModuleList(
                [PosConv(d, cfg.conv_pos, cfg.conv_pos_groups)])
        self.layer_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.layers = nn.ModuleList(
            EncoderLayer(d, cfg.encoder_ffn_embed_dim[i],
                         cfg.encoder_attention_heads[i], cfg.head_dim)
            for i in range(cfg.encoder_layers)
        )


def pos_conv_kernel_size(conv_pos: int, depth: int) -> int:
    """Per-layer kernel size of the deep positional-conv stack (JAX
    ``pos_conv_kernel_size``, reference module.py:148-149)."""
    return max(3, conv_pos // depth)


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
    SamePad crop of one frame for an even K, shared by the shallow and deep
    pos-convs (JAX ``_grouped_conv_samepad``). ``w`` is in the torch layout
    (D, D // g, K), taken to (K, D // g, D) for
    :func:`~..ops.grouped_conv.grouped_conv1d` (f32 sums in bf16); its
    result is cast to x's dtype before the bias is added, as in JAX."""
    half = kernel_size // 2
    out = grouped_conv1d(x, w.to(x.dtype).permute(2, 1, 0), groups,
                         (half, half))
    out = out.to(x.dtype) + bias.to(x.dtype)
    if kernel_size % 2 == 0:
        out = out[:, :-1, :]
    return out


def pos_conv_embed(x: torch.Tensor, p: PosConv) -> torch.Tensor:
    """Weight-normed grouped conv + SamePad crop + GELU. x: (B, T, D)."""
    out = _grouped_conv_samepad(x, pos_conv_weight(p), p.bias, p.groups,
                                p.kernel_size)
    return get_activation_fn("gelu")(out)


def pos_conv_embed_deep(x: torch.Tensor, blocks: nn.ModuleList) -> torch.Tensor:
    """The deep positional conv (JAX ``pos_conv_embed_deep``, reference
    module.py:147-173): each block is a grouped Conv1d + SamePad crop
    (even K) + LayerNorm over D without affine + GELU. x: (B, T, D)."""
    gelu = get_activation_fn("gelu")
    for block in blocks:
        conv = block[0]
        out = _grouped_conv_samepad(x, conv.weight, conv.bias, conv.groups,
                                    conv.kernel_size[0])
        x = gelu(F.layer_norm(out, out.shape[-1:], eps=LN_EPS))
    return x


def positional_embedding(x: torch.Tensor, enc: TransformerEncoder,
                         cfg) -> torch.Tensor:
    """The conv positional embedding the prologue adds: the weight-normed
    conv, or the deep stack with ``pos_conv_depth > 1``."""
    if getattr(cfg, "pos_conv_depth", 1) > 1:
        return pos_conv_embed_deep(x, enc.pos_conv)
    return pos_conv_embed(x, enc.pos_conv[0])


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
    attn_fn=None,
    activation_generator: Optional[torch.Generator] = None,
):
    """Post-LN (default) or pre-LN BERT layer (reference module.py:82-133).
    With ``deterministic=False`` the residual and activation dropouts draw
    from ``generator`` (the activation dropout from
    ``activation_generator`` where given) and attention dropout keys its
    bits on ``attention_seed``. A layer split over a model group
    (``layer.tp``, a ``parallel.mesh.Mesh``) all-reduces its attention and
    FFN outputs over it. Returns (x, context).

    ``attn_fn``, when given, replaces the built-in self-attention with a
    callable ``h -> (out, context)`` (the streaming KV-cache attention,
    ``streaming.py``); the residuals, norms and FFN stay the ones here."""
    attn = layer.self_attn
    act = get_activation_fn(activation_fn)
    tp = getattr(layer, "tp", None)
    group = None if tp is None else tp.model_group

    def drop(h, p, gen=generator):
        return dropout(h, p, gen, deterministic)

    def self_attn(h):
        if attn_fn is not None:
            return attn_fn(h)
        if tp is not None:
            h = CopyToModel.apply(h, group)
        out, context = multi_head_self_attention(
            h, attn, num_heads=attn.num_heads, head_dim=attn.head_dim,
            key_padding_mask=key_padding_mask, causal=causal,
            segment_ids=segment_ids, impl=attn_impl,
            dropout_p=0.0 if deterministic else attention_dropout,
            dropout_seed=attention_seed, out_bias=tp is None,
        )
        if tp is not None:
            out = ReduceFromModel.apply(out, group) + attn.out_proj.bias
        return out, context

    def ffn(h):
        if tp is not None:
            h = CopyToModel.apply(h, group)
        h = drop(act(layer.fc1(h)), activation_dropout,
                 activation_generator or generator)
        if tp is None:
            return layer.fc2(h)
        return (ReduceFromModel.apply(F.linear(h, layer.fc2.weight), group)
                + layer.fc2.bias)

    if layer_norm_first:
        h, context = self_attn(layer_norm(x, layer.self_attn_layer_norm))
        x = x + drop(h, dropout_p)
        x = x + drop(ffn(layer_norm(x, layer.final_layer_norm)), dropout_p)
    else:
        h, context = self_attn(x)
        x = layer_norm(x + drop(h, dropout_p), layer.self_attn_layer_norm)
        x = layer_norm(x + drop(ffn(x), dropout_p), layer.final_layer_norm)
    return x, context


@contextlib.contextmanager
def _holding(module: nn.Module, tensors: dict):
    """``module``'s parameters replaced by ``tensors`` (name -> tensor, as
    ``named_parameters`` gives them) for the duration."""
    swapped = []
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        swapped.append((sub, leaf, sub._parameters[leaf]))
        sub._parameters[leaf] = t
    try:
        yield
    finally:
        for sub, leaf, t in swapped:
            sub._parameters[leaf] = t


def checkpoint_layer(run, x: torch.Tensor, layer: nn.Module,
                     generator):
    """``run(x)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    layer's activations are freed after the forward and recomputed in the
    backward, which must see what the forward saw. Two things are not
    where checkpoint looks for them:

      * the residual and activation dropouts draw from ``generator``, an
        explicit device generator, which checkpoint's own RNG stash (the
        default generators only) does not cover: the recompute would draw
        new bits, and the loss would be right and the gradients wrong. So
        the generator's state before the layer is set again for the
        recompute, and its state of that moment put back after it;
      * ``run`` reads ``layer``'s parameters, which a grad step swaps for
        its masked, compute-dtype copies only while its forward runs
        (``torch.func.functional_call``): the backward would recompute on
        the f32 masters. So the tensors the layer held in the forward are
        put back into it for the recompute.

    Nothing in a layer draws from the default generators (the attention's
    keep bits are counter-based on a seed drawn before the layer), so none
    is stashed. ``generator`` may be a tuple of generators (a split
    layer's activation dropout has its own); each is restored."""
    gens = [g for g in (generator if isinstance(generator, tuple)
                        else (generator,)) if g is not None]
    states = [g.get_state() for g in gens]
    held = dict(layer.named_parameters())
    calls = []

    def wrapped(h):
        calls.append(1)
        if len(calls) == 1:
            return run(h)
        with _holding(layer, held):
            now = [g.get_state() for g in gens]
            for g, st in zip(gens, states):
                g.set_state(st)
            try:
                return run(h)
            finally:
                for g, st in zip(gens, now):
                    g.set_state(st)

    return checkpoint(wrapped, x, use_reentrant=False,
                      preserve_rng_state=False)


def rank_coords(module) -> tuple:
    """(data index, model index) a module folds into its dropout seeds:
    (0, 0) off a grid; the model index only in a layer stack split over
    the model group (``parallel/mesh.py::attach``)."""
    mesh = getattr(module, "mesh", None)
    if mesh is None:
        return (0, 0)
    split = getattr(module, "tp", None) is not None
    return (mesh.data_index, mesh.model_index if split else 0)


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
    positional embedding (the deep stack with ``pos_conv_depth > 1``), the
    encoder LayerNorm (post-LN), then the input dropout. Split out so packed extraction can run it per utterance."""
    if padding_mask is not None:
        x = x.masked_fill(padding_mask[:, :, None], 0.0)
    x = x + positional_embedding(x, enc, cfg)
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
    contexts: Optional[list] = None,
    remat: bool = False,
    activation_generator: Optional[torch.Generator] = None,
):
    """The layer stack + final (pre-LN) norm. Returns (x, layer_hiddens).
    A ``contexts`` list receives each layer's attention context (B, H_i,
    T, d), the tensor head scoring differentiates the loss to.

    In training each layer draws its attention seed from the host ``rng``
    and, with ``encoder_layerdrop > 0``, a coin that skips the whole layer
    (reference module.py:242-250; JAX computes the layer and selects, a
    dropped layer here is not run). A dropped layer's input stands in its
    ``layer_hiddens`` slot, as in JAX, and None in its ``contexts`` slot
    (its heads score 0: JAX computes the layer and selects its input, so
    the context's gradient is 0 there). With
    ``cfg.checkpoint_activations`` a training forward that records a
    graph runs each layer through :func:`checkpoint_layer`; with ``remat``
    (JAX's ``jax.checkpoint`` per layer, encoder.py:396-397) every forward
    that records a graph does."""
    layer_hiddens = []
    coords = rank_coords(enc)
    remat = ((remat or (getattr(cfg, "checkpoint_activations", False)
                        and not deterministic))
             and torch.is_grad_enabled())
    for i, layer in enumerate(enc.layers):
        seed = None
        if not deterministic:
            seed = fold_seed(draw_seed(rng), *coords)
            if cfg.encoder_layerdrop > 0.0 and float(
                    torch.rand((), generator=rng)) < cfg.encoder_layerdrop:
                if get_hidden:
                    layer_hiddens.append(x)
                if contexts is not None:
                    contexts.append(None)
                continue
        run = functools.partial(
            encoder_layer_forward, layer=layer,
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
            activation_generator=activation_generator,
        )
        x, context = (checkpoint_layer(run, x, layer,
                                       (generator, activation_generator))
                      if remat else run(x))
        if get_hidden:
            layer_hiddens.append(x)
        if contexts is not None:
            contexts.append(context)
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
    contexts: Optional[list] = None,
    remat: bool = False,
):
    """Prologue + layer stack. Returns (x, layer_hiddens). Training
    (``deterministic=False``) needs ``rng``, a host ``torch.Generator``.
    ``contexts`` and ``remat`` are passed to
    :func:`encoder_layers_forward`.

    ``cfg.required_seq_len_multiple`` (the HuBERT/wav2vec 2.0 encoders) is
    kept as in JAX (reference module.py:492-541): after the prologue T is
    padded up to the next multiple, the padded tail is key-padding-masked
    through the layers, and the outputs are cut back to T (the contexts
    are not: the padded rows' context gradient is 0)."""
    generator = activation_generator = None
    if not deterministic:
        if rng is None:
            raise ValueError("training (deterministic=False) needs an rng")
        seed = draw_seed(rng)
        coords = rank_coords(enc)
        generator = seeded_generator(fold_seed(seed, coords[0]), x.device)
        if getattr(enc, "tp", None) is not None:
            activation_generator = seeded_generator(
                fold_seed(seed, *coords, 1), x.device)
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
        generator=generator, deterministic=deterministic, contexts=contexts,
        remat=remat, activation_generator=activation_generator,
    )
    if pad:
        x = x[:, :t]
        layer_hiddens = [h[:, :t] for h in layer_hiddens]
    return x, layer_hiddens
