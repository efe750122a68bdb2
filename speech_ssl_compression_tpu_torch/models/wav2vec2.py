"""wav2vec 2.0: contrastive pre-training on Gumbel-quantized targets.

Port of ``speech_ssl_compression_tpu/models/wav2vec2.py`` (reference
model.py:467-954): :class:`Wav2Vec2Model` holds the parameters under the
reference names (``feature_extractor``, ``layer_norm``,
``post_extract_proj`` when the conv width differs from the encoder's,
``mask_emb``, ``encoder``, ``final_proj``, ``quantizer`` and
``project_q``), :func:`wav2vec2_forward` runs conv frontend -> span mask
-> encoder -> quantized targets -> negatives -> contrastive logits, and
:func:`wav2vec2_pretrain_loss` is the summed InfoNCE with the
prob-perplexity and feature-penalty terms.

Randomness is explicit. The span mask is drawn on the host
(``ops/masking.py::compute_mask_indices_np`` with the arguments JAX gives
its device sampler) unless the caller passes ``mask_indices``; the
dropouts, the Gumbel noise and the negatives draw from a generator on the
device seeded from the host ``rng``.

Negatives (reference sample_negatives, model.py:614-670): for every
frame, ``num_negatives`` draws, uniform over the OTHER masked frames of
its row (the +1 shift past its own rank). The dense formulation
("auto"/"dense", :func:`contrastive_dense`) needs only their
multiplicities: :func:`negative_counts` builds the (B, T, S) counts by a
scatter-add of ones over the (B, T, N) drawn frames, where JAX's
formulation compares a (B, T, N, S) tensor that XLA fuses and eager
PyTorch would hold (12 x 781 x 100 x 781 at the shipped recipe).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import Wav2Vec2Config
from ..ops.activations import at_least_f32
from ..ops.dropout import (
    draw_seed,
    fold_seed,
    host_mask_rng,
    seeded_generator,
)
from ..parallel.mesh import all_gather_seq, gather_parts, local_rows
from ..ops.masking import channel_mask, compute_mask_indices_np
from .conv_frontend import ConvFeatureExtractor, wave_frontend_forward
from .encoder import TransformerEncoder, encoder_forward, rank_coords
from .gumbel_vq import (
    GumbelVectorQuantizer,
    gumbel_vq_forward,
    sample_from_codebook,
)

_MAX_I32 = 2**31 - 1
CONTRASTIVE_IMPLS = ("auto", "dense", "index", "gathered")


class Wav2Vec2Model(nn.Module):
    """Parameters under the reference names: ``feature_extractor``,
    ``layer_norm``, ``post_extract_proj`` (conv width != encoder width),
    ``mask_emb``, ``encoder``, ``final_proj`` (D -> final_dim), and with
    ``quantize_targets`` the ``quantizer`` (on the conv features) and
    ``project_q`` (vq_dim -> final_dim; conv width -> final_dim
    without)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        if cfg.contrastive_impl not in CONTRASTIVE_IMPLS:
            raise ValueError(
                f"unknown contrastive_impl {cfg.contrastive_impl!r}")
        self.cfg = cfg
        embed = cfg.conv_feature_layers[-1][0]
        d = cfg.encoder_embed_dim
        final_dim = cfg.final_dim if cfg.final_dim > 0 else d
        self.feature_extractor = ConvFeatureExtractor(
            cfg.conv_feature_layers, cfg.extractor_mode, cfg.conv_bias)
        self.layer_norm = nn.LayerNorm(embed)
        if embed != d:
            self.post_extract_proj = nn.Linear(embed, d)
        self.mask_emb = nn.Parameter(torch.zeros(d))
        self.encoder = TransformerEncoder(cfg)
        self.final_proj = nn.Linear(d, final_dim)
        if cfg.quantize_targets:
            vq_dim = cfg.latent_dim if cfg.latent_dim > 0 else final_dim
            self.quantizer = GumbelVectorQuantizer(
                embed, cfg.latent_vars, cfg.latent_groups, vq_dim,
                weight_proj_depth=cfg.quantizer_depth,
                weight_proj_factor=cfg.quantizer_factor)
            self.project_q = nn.Linear(vq_dim, final_dim)
        else:
            self.project_q = nn.Linear(embed, final_dim)

    def forward(self, source, wave_lengths, compute_loss: bool = False,
                **kwargs):
        """:func:`wav2vec2_forward`; with ``compute_loss`` the output also
        holds ``loss``, ``sample_size`` and ``logs`` of
        :func:`wav2vec2_pretrain_loss` (so that one ``functional_call``
        runs both on the same parameters)."""
        out = wav2vec2_forward(self, source, wave_lengths, **kwargs)
        if compute_loss:
            out["loss"], out["sample_size"], out["logs"] = (
                wav2vec2_pretrain_loss(out, self.cfg))
        return out



def span_mask(cfg: Wav2Vec2Config, lengths, t: int,
              rng: np.random.Generator,
              shared_rounding: bool = False) -> np.ndarray:
    """(B, T) bool span mask with the arguments JAX ``wav2vec2_forward``
    gives its sampler: ``min_masks=2``, the config's
    ``require_same_masks`` and ``mask_dropout``, and with
    ``shared_rounding`` one span-count draw for the whole batch (the
    reference's padding_mask=None path for crop-collated batches,
    data_utils.py:57-62), each row then confined to its ``lengths``."""
    lengths = np.asarray(lengths)
    mask = compute_mask_indices_np(
        (len(lengths), t), None if shared_rounding else lengths,
        mask_prob=cfg.mask_prob, mask_length=cfg.mask_length,
        mask_selection=cfg.mask_selection, mask_other=cfg.mask_other,
        min_masks=2, no_overlap=cfg.no_mask_overlap,
        min_space=cfg.mask_min_space,
        require_same_masks=cfg.require_same_masks,
        mask_dropout=cfg.mask_dropout, rng=rng)
    return mask & (np.arange(t)[None, :] < lengths[:, None])


def _raw_draws(generator, shape, device) -> torch.Tensor:
    """Uniform int64 draws in [0, 2^31 - 1), JAX's randint range."""
    return torch.randint(0, _MAX_I32, shape, generator=generator,
                         device=device)


def _negative_draws(generator: Optional[torch.Generator], mask: torch.Tensor,
                    num_negatives: int):
    """Per frame (B, T), ``num_negatives`` ranks into its row's masked
    frames, uniform and never its own (JAX ``_negative_draws``). Returns
    (draws (B, T, N) int64, ordinal (B, T): a masked frame's rank among its
    row's masked frames)."""
    b, t = mask.shape
    n_masked = mask.sum(-1)
    ordinal = mask.long().cumsum(-1) - 1
    high = n_masked.clamp_min(2)[:, None, None] - 1
    draws = _raw_draws(generator, (b, t, num_negatives), mask.device) % high
    draws = draws + (draws >= ordinal[:, :, None])
    hi = (n_masked - 1).clamp_min(0)[:, None, None]
    return torch.minimum(draws.clamp_min(0), hi), ordinal


def _masked_first(mask: torch.Tensor) -> torch.Tensor:
    """Positions along the last axis with the masked ones first, in order
    (a stable argsort of ~mask)."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)


def negative_times(draws: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The frames (B, T, N) that ranks ``draws`` name in each row's masked
    frames."""
    b, t, n = draws.shape
    return torch.gather(_masked_first(mask), 1,
                        draws.reshape(b, t * n)).reshape(b, t, n)


def sample_negative_indices(generator, mask: torch.Tensor,
                            num_negatives: int) -> torch.Tensor:
    """(B, T, N) negative frames of each frame, drawn from its row's masked
    frames (JAX ``sample_negative_indices``); frames that are not masked
    get arbitrary valid indices (the loss masks them)."""
    draws, _ = _negative_draws(generator, mask, num_negatives)
    return negative_times(draws, mask)


def negative_counts(draws: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, T, S) f32 multiplicities of :func:`_negative_draws`' ranks:
    counts[b, t, s] = how many draws of frame (b, t) landed on masked frame
    s, by a scatter-add of ones (JAX's ``sample_negative_counts`` compares
    draws with every frame's rank, a (B, T, N, S) tensor). Rows with no
    masked frame get zeros."""
    b, t, _ = draws.shape
    counts = torch.zeros((b, t, t), dtype=torch.float32, device=draws.device)
    counts.scatter_add_(2, negative_times(draws, mask),
                        torch.ones(draws.shape, dtype=torch.float32,
                                   device=draws.device))
    return counts * mask[:, None, :].float()


def sample_negative_counts(generator, mask: torch.Tensor,
                           num_negatives: int) -> torch.Tensor:
    """:func:`negative_counts` of a fresh draw (JAX
    ``sample_negative_counts``)."""
    draws, _ = _negative_draws(generator, mask, num_negatives)
    return negative_counts(draws, mask)


def sample_cross_negative_indices(generator, mask: torch.Tensor,
                                  num_negatives: int) -> torch.Tensor:
    """Cross-utterance negatives (JAX ``sample_cross_negative_indices``,
    reference model.py:641-654): per frame, draws from the masked frames of
    ALL rows, as (B, T, N) indices into the flattened (B * T) batch. The
    reference's avoid-self shift against the frame's LOCAL rank is kept."""
    b, t = mask.shape
    flat = mask.reshape(-1)
    total = flat.sum()
    ordinal = mask.long().cumsum(-1) - 1
    high = total.clamp_min(2) - 1
    draws = _raw_draws(generator, (b, t, num_negatives), mask.device) % high
    draws = draws + (draws >= ordinal[:, :, None])
    draws = torch.minimum(draws.clamp_min(0), (total - 1).clamp_min(0))
    return _masked_first(flat)[draws]


def wav2vec2_forward(
    model: Wav2Vec2Model,
    source: torch.Tensor,  # (B, T_wave) padded waveform
    wave_lengths,          # (B,) host ints: valid samples per row
    *,
    mask: bool = True,
    features_only: bool = False,
    get_hidden: bool = False,
    mask_indices: Optional[torch.Tensor] = None,  # (B, T') bool
    mask_channel_indices: Optional[torch.Tensor] = None,  # (B, C) bool
    rng: Optional[torch.Generator] = None,  # host generator
    deterministic: bool = True,
    gumbel_temp: Optional[float] = None,  # None: latent_temp[0]
    attn_impl: str = "auto",
    mask_shared_rounding: bool = False,
    gumbel_uniform: Optional[torch.Tensor] = None,
    negative_counts: Optional[torch.Tensor] = None,
) -> dict:
    """Port of JAX ``wav2vec2_forward``. Returns ``x`` (the encoder
    output), ``padding_mask``, ``mask_indices``, ``features_pen``,
    ``layer_hiddens`` and ``frame_lengths`` (host numpy); with
    ``features_only`` also ``features`` (the encoder input) and nothing
    more; otherwise the perplexities, ``num_vars`` and ``temp`` (with
    ``quantize_targets``) and ``pos_logit`` with ``neg_lse`` and
    ``best_neg`` (the dense path) or ``neg_logit`` (B, T, N).

    A supplied ``mask_indices`` is used only when ``mask_prob > 0`` and is
    confined to the valid frames; without it the span mask is drawn on the
    host from ``rng`` (``mask_shared_rounding``: one span-count draw for
    the batch). With ``mask`` and ``mask_channel_prob > 0`` a (B, C)
    channel mask zeroes feature channels before the time mask
    (``mask_channel_before``) or after it, drawn from the same host
    stream in that order unless ``mask_channel_indices`` is given.
    ``deterministic=False`` turns the dropouts and LayerDrop
    on and the quantizer's Gumbel noise (its uniforms from
    ``gumbel_uniform`` when given) with ``gumbel_temp``. A supplied
    ``negative_counts`` (B, T, T) stands in for the dense path's draw
    (parity checks hold the mask, the noise and the counts fixed)."""
    cfg = model.cfg
    dev = source.device
    mesh = getattr(model, "mesh", None)
    generator = seed = None
    if rng is not None:
        seed = draw_seed(rng)
        generator = seeded_generator(fold_seed(seed, rank_coords(model)[0]),
                                     dev)
    elif not deterministic:
        raise ValueError("training (deterministic=False) needs an rng")
    x, unmasked_features, frame_valid, out_len, features_pen = (
        wave_frontend_forward(model, cfg, source, wave_lengths,
                              generator=generator,
                              deterministic=deterministic,
                              dropout_features=True))
    b, t_frames = x.shape[0], x.shape[1]

    host_rng = host_mask_rng(rng)
    channels = mask and cfg.mask_channel_prob > 0

    def zero_channels(x):
        nonlocal mask_channel_indices
        if mask_channel_indices is None:
            mask_channel_indices = torch.from_numpy(local_rows(
                mesh, lambda lens: channel_mask(cfg, len(lens), x.shape[-1],
                                                host_rng()), out_len))
        return x.masked_fill(mask_channel_indices.to(
            device=dev, dtype=torch.bool)[:, None, :], 0.0)

    if channels and cfg.mask_channel_before:
        x = zero_channels(x)
    if mask and cfg.mask_prob > 0:
        if mask_indices is None:
            mask_indices = torch.from_numpy(local_rows(
                mesh, lambda lens: span_mask(
                    cfg, lens, t_frames, host_rng(),
                    shared_rounding=mask_shared_rounding), out_len))
        mask_indices = (mask_indices.to(device=dev, dtype=torch.bool)
                        & frame_valid)
        x = torch.where(mask_indices[:, :, None],
                        model.mask_emb.to(x.dtype)[None, None, :], x)
    else:
        mask_indices = torch.zeros((b, t_frames), dtype=torch.bool, device=dev)
    if channels and not cfg.mask_channel_before:
        x = zero_channels(x)

    hidden, layer_hiddens = encoder_forward(
        x, model.encoder, cfg, padding_mask=~frame_valid,
        get_hidden=get_hidden, attn_impl=attn_impl, rng=rng,
        deterministic=deterministic)
    out = {"x": hidden, "padding_mask": ~frame_valid,
           "mask_indices": mask_indices, "features_pen": features_pen,
           "layer_hiddens": layer_hiddens, "frame_lengths": out_len}
    if features_only:
        out["features"] = x
        return out

    if generator is None:  # JAX's PRNGKey(0) for the negatives
        generator = torch.Generator(device=dev).manual_seed(0)
    targets = None
    if cfg.quantize_targets:
        q = gumbel_vq_forward(
            model.quantizer, unmasked_features, num_vars=cfg.latent_vars,
            groups=cfg.latent_groups,
            temperature=(cfg.latent_temp[0] if gumbel_temp is None
                         else gumbel_temp),
            training=not deterministic, generator=generator,
            uniform=gumbel_uniform, produce_targets=True, mesh=mesh)
        y, targets = q["x"], q["targets"]
        for key in ("prob_perplexity", "code_perplexity", "num_vars", "temp"):
            out[key] = q[key]
    else:
        y = unmasked_features
    y = model.project_q(y)  # (B, T, final_dim)
    x_proj = model.final_proj(hidden)

    neg_mask = (frame_valid if cfg.negatives_from_everywhere
                else mask_indices & frame_valid)
    n_cross, n_codebook = cfg.cross_sample_negatives, cfg.codebook_negatives
    if n_codebook > 0 and not cfg.quantize_targets:
        raise ValueError("codebook_negatives requires quantize_targets=true")
    impl = cfg.contrastive_impl

    if (targets is not None and n_cross == 0 and n_codebook == 0
            and impl in ("auto", "dense")):
        counts = (sample_negative_counts(generator, neg_mask,
                                         cfg.num_negatives)
                  if negative_counts is None else negative_counts)
        out["pos_logit"], out["neg_lse"], out["best_neg"] = (
            contrastive_dense(x_proj, y, counts, cfg.logit_temp, targets))
        return out

    if n_cross > 0 or n_codebook > 0:
        d = y.shape[-1]
        if n_cross > 0 and mesh is not None and mesh.dp > 1:
            # on data ranks every rank draws the global batch's negatives
            # from one generator state (the seed the 1-process run's
            # negatives start from) and takes its rows; the targets are
            # gathered over the data group, their gradients sent home by
            # the gather's backward
            rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
            glob = torch.cat(gather_parts(neg_mask, mesh))
            neg_gen = seeded_generator(0 if seed is None else seed, dev)
            neg_idx = sample_negative_indices(neg_gen, glob,
                                              cfg.num_negatives)[rows]
            cross = all_gather_seq(y, 0, mesh).reshape(-1, d)[
                sample_cross_negative_indices(neg_gen, glob, n_cross)[rows]]
        else:
            neg_idx = sample_negative_indices(generator, neg_mask,
                                              cfg.num_negatives)
            cross = (y.reshape(-1, d)[sample_cross_negative_indices(
                generator, neg_mask, n_cross)] if n_cross > 0 else None)
        parts = [_gather_frames(y, neg_idx)]
        if cross is not None:
            parts.append(cross)
        if n_codebook > 0:
            cb = sample_from_codebook(
                model.quantizer, generator, b * t_frames, n_codebook,
                num_vars=cfg.latent_vars, groups=cfg.latent_groups,
            ).reshape(b, t_frames, n_codebook, -1)
            parts.append(model.project_q(cb.to(y.dtype)))
        out["pos_logit"], out["neg_logit"] = contrastive_logits(
            x_proj, y, torch.cat(parts, dim=2), cfg.logit_temp)
        return out

    neg_idx = sample_negative_indices(generator, neg_mask, cfg.num_negatives)
    if targets is not None and impl != "gathered":
        out["pos_logit"], out["neg_logit"] = contrastive_logits_from_idx(
            x_proj, y, neg_idx, cfg.logit_temp, targets)
    else:
        out["pos_logit"], out["neg_logit"] = contrastive_logits(
            x_proj, y, _gather_frames(y, neg_idx), cfg.logit_temp)
    return out


def _gather_frames(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y (B, T, D) at idx (B, T, N) of the same row -> (B, T, N, D)."""
    b, t, n = idx.shape
    return torch.gather(y, 1, idx.reshape(b, t * n, 1).expand(
        -1, -1, y.shape[-1])).reshape(b, t, n, -1)


def _normalize(a: torch.Tensor) -> torch.Tensor:
    """a / max(|a|, 1e-8) over the last axis, in f32."""
    a = at_least_f32(a)
    return a / torch.linalg.vector_norm(a, dim=-1,
                                        keepdim=True).clamp_min(1e-8)


def _cosine_prologue(x_proj, y, logit_temp: float):
    """Shared by the index and dense formulations (JAX
    ``_cosine_prologue``): f32 normalization with a 1e-8 floor, the
    (B, T) positive logit and the raw (B, T, T) all-pairs cosines."""
    xn, yn = _normalize(x_proj), _normalize(y)
    pos_logit = (xn * yn).sum(-1) / logit_temp
    return pos_logit, torch.einsum("btd,bsd->bts", xn, yn)


def contrastive_logits_from_idx(x_proj, y, neg_idx, logit_temp: float,
                                code_targets):
    """JAX ``contrastive_logits_from_idx``: the (B, T, N) negative logits
    gathered as scalars from the (B, T, T) cosines; a negative whose
    quantizer codes equal the positive's gets -1e30. Returns (pos (B, T),
    neg (B, T, N))."""
    pos_logit, all_cos = _cosine_prologue(x_proj, y, logit_temp)
    neg_logit = torch.gather(all_cos, 2, neg_idx) / logit_temp
    neg_codes = _gather_frames(code_targets, neg_idx)  # (B, T, N, G)
    neg_is_pos = (neg_codes == code_targets[:, :, None, :]).all(-1)
    return pos_logit, neg_logit.masked_fill(neg_is_pos, -1e30)


def contrastive_dense(x_proj, y, counts, logit_temp: float, code_targets):
    """JAX ``contrastive_dense``, the gather- and scatter-free section:
    returns (pos_logit, neg_lse, best_neg), each (B, T), where
    neg_lse = log sum_s counts[b,t,s] exp(cos[b,t,s] / temp) over the frames
    whose codes differ from frame t's (-1e30, with a zero gradient, where
    none is left), shifted by the row max (no gradient: the shift
    cancels); best_neg, the best surviving negative logit, feeds the
    accuracy only."""
    pos_logit, all_cos = _cosine_prologue(x_proj, y, logit_temp)
    all_cos = all_cos / logit_temp
    code_eq = (code_targets[:, :, None, :]
               == code_targets[:, None, :, :]).all(-1)  # (B, T, S)
    eff = counts.masked_fill(code_eq, 0.0)
    has_neg = eff.sum(-1) > 0
    m = all_cos.amax(-1).detach()
    ssum = (eff * torch.exp(all_cos - m[:, :, None])).sum(-1)
    # JAX floors ssum at 1e-38, an f32 subnormal that XLA flushes to 0:
    # log(0) there, and NaN gradients for a whole row once one of its
    # frames has no negative left. The log of 1 in those frames instead:
    # the same values, and an exact zero gradient
    ssum = torch.where(has_neg, ssum, torch.ones_like(ssum))
    neg_lse = torch.where(has_neg, m + torch.log(ssum.clamp_min(1e-38)),
                          torch.full_like(m, -1e30))
    best_neg = all_cos.masked_fill(eff <= 0, -1e30).amax(-1).detach()
    return pos_logit, neg_lse, best_neg


def contrastive_logits(x_proj, y, negs, logit_temp: float):
    """JAX ``contrastive_logits`` (reference compute_preds, model.py:
    672-692): cosines against the positive and the gathered (B, T, N, D)
    negatives; a negative equal to the positive gets -1e30. Returns
    (pos (B, T), neg (B, T, N))."""
    pos_logit = (_normalize(x_proj) * _normalize(y)).sum(-1) / logit_temp
    neg_logit = (_normalize(x_proj)[:, :, None, :]
                 * _normalize(negs)).sum(-1) / logit_temp
    neg_is_pos = (negs == y[:, :, None, :]).all(-1)
    return pos_logit, neg_logit.masked_fill(neg_is_pos, -1e30)


def wav2vec2_pretrain_loss(out: dict, cfg: Wav2Vec2Config,
                           loss_weights=(0.1, 10.0)):
    """Port of JAX ``wav2vec2_pretrain_loss`` (Wav2vecCriterion,
    criterion.py:10-79): the InfoNCE cross entropy summed over the masked
    valid frames, plus ``loss_weights[0]`` times the prob-perplexity term
    and ``loss_weights[1]`` times the feature penalty, each scaled by the
    sample size. Returns (loss, sample_size, logs)."""
    select = out["mask_indices"] & ~out["padding_mask"]
    pos = out["pos_logit"]
    if "neg_lse" in out:
        neg_lse, best_neg = out["neg_lse"], out["best_neg"]
    else:
        neg_lse = torch.logsumexp(out["neg_logit"], -1)
        best_neg = out["neg_logit"].amax(-1)
    ce = torch.logaddexp(pos, neg_lse) - pos
    infonce = torch.where(select, ce, torch.zeros_like(ce)).sum()
    sample_size = select.sum()
    loss = infonce
    logs = {"loss_infonce": infonce, "sample_size": sample_size}
    if "prob_perplexity" in out and loss_weights[0] != 0:
        p = (out["num_vars"] - out["prob_perplexity"]) / out["num_vars"]
        loss = loss + loss_weights[0] * p * sample_size
        logs["loss_prob_perplexity"] = p
    if loss_weights[1] != 0:
        loss = loss + loss_weights[1] * out["features_pen"] * sample_size
        logs["loss_features_pen"] = out["features_pen"]
    corr = (select & (pos > best_neg)).sum()
    logs["accuracy"] = corr / sample_size.clamp_min(1)
    return loss, sample_size, logs
