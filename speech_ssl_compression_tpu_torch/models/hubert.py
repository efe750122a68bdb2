"""HuBERT: masked prediction of cluster labels from the raw waveform.

Port of ``speech_ssl_compression_tpu/models/hubert.py`` (reference
model.py:166-462): :class:`HuBERTModel` holds the parameters under the
reference names, :func:`hubert_forward` runs conv frontend -> span mask ->
encoder, and :func:`hubert_pretrain_loss` is the sum-reduced cosine NCE
over the masked frames with the feature penalty. Span masks are drawn on
the host (``ops/masking.py::compute_mask_indices_np`` with the arguments
JAX gives its device sampler) unless the caller passes ``mask_indices``.
Label alignment to conv frames (:func:`encode_aligned_targets_np`) is
host numpy, done by the trainer's collate step.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import HuBERTConfig
from ..ops.activations import at_least_f32
from ..ops.dropout import device_generator, draw_seed
from ..ops.masking import compute_mask_indices_np
from .conv_frontend import (
    ConvFeatureExtractor,
    conv_downsample_rate,
    wave_frontend_forward,
)
from .encoder import TransformerEncoder, encoder_forward


class HuBERTModel(nn.Module):
    """Parameters under the reference names: ``feature_extractor``,
    ``layer_norm``, ``post_extract_proj`` (when the conv width differs from
    the encoder's), ``mask_emb``, ``encoder``, ``final_proj``,
    ``label_embs_concat`` (sum(num_classes), final_dim) and ``target_glu.0``
    (with target_glu)."""

    def __init__(self, cfg: HuBERTConfig, num_classes: Sequence[int]):
        super().__init__()
        if cfg.mask_channel_prob > 0:
            raise NotImplementedError(
                "mask_channel_prob > 0 (channel masking) is not ported yet")
        if cfg.checkpoint_activations:
            raise NotImplementedError(
                "checkpoint_activations (remat) is not ported yet")
        self.cfg = cfg
        self.num_classes = tuple(int(n) for n in num_classes)
        embed = cfg.conv_feature_layers[-1][0]
        d = cfg.encoder_embed_dim
        final_dim = cfg.final_dim if cfg.final_dim > 0 else d
        n_proj = final_dim * (len(self.num_classes) if cfg.untie_final_proj
                              else 1)
        self.feature_extractor = ConvFeatureExtractor(
            cfg.conv_feature_layers, cfg.extractor_mode, cfg.conv_bias)
        self.layer_norm = nn.LayerNorm(embed)
        if embed != d:
            self.post_extract_proj = nn.Linear(embed, d)
        self.mask_emb = nn.Parameter(torch.zeros(d))
        self.encoder = TransformerEncoder(cfg)
        self.final_proj = nn.Linear(d, n_proj)
        self.label_embs_concat = nn.Parameter(
            torch.zeros(sum(self.num_classes), final_dim))
        if cfg.target_glu:
            self.target_glu = nn.Sequential(
                nn.Linear(final_dim, 2 * final_dim), nn.GLU())

    def forward(self, source, wave_lengths, target_list=None,
                target_valid=None, **kwargs):
        """:func:`hubert_forward`; given ``target_list``, the output also
        holds ``loss``, ``sample_size`` and ``logs`` of
        :func:`hubert_pretrain_loss` (so that one ``functional_call`` runs
        both on the same parameters)."""
        out = hubert_forward(self, source, wave_lengths, **kwargs)
        if target_list is not None:
            out["loss"], out["sample_size"], out["logs"] = (
                hubert_pretrain_loss(self, out, target_list,
                                     target_valid=target_valid))
        return out


def feat2tar_ratio(cfg: HuBERTConfig, sample_rate: int = 16000) -> float:
    return (cfg.label_rate * conv_downsample_rate(cfg.conv_feature_layers)
            / sample_rate)


def align_targets_np(labels: np.ndarray, n_frames: int, ratio: float):
    """Copy of JAX ``align_targets_np`` (reference forward_targets,
    model.py:292-305): the label at floor(frame * ratio) for each conv
    frame, frames past the labels trimmed. Returns (aligned, n_keep)."""
    keep = n_frames
    if ratio * n_frames > len(labels):
        keep = int(len(labels) / ratio)
    idx = (np.arange(keep, dtype=np.float64) * ratio).astype(np.int64)
    return labels[idx], keep


def encode_aligned_targets_np(labels_per_utt, t_frames: int, ratio: float,
                              lut: np.ndarray, unk: int):
    """Copy of JAX ``encode_aligned_targets_np``: align each utterance's
    label-rate frames to conv frames and map raw cluster ids to dictionary
    indices through ``lut`` (out-of-vocabulary ids become ``unk``).
    Returns (ids (B, t_frames) int32, valid (B, t_frames) bool)."""
    b = len(labels_per_utt)
    arr = np.zeros((b, t_frames), np.int32)
    valid = np.zeros((b, t_frames), bool)
    for bi, labs in enumerate(labels_per_utt):
        aligned, keep = align_targets_np(np.asarray(labs), t_frames, ratio)
        keep = min(keep, t_frames)
        raw = aligned[:keep].astype(np.int64)
        oob = (raw < 0) | (raw >= len(lut))
        arr[bi, :keep] = np.where(oob, unk, lut[np.clip(raw, 0, len(lut) - 1)])
        valid[bi, :keep] = True
    return arr, valid


def span_mask(cfg: HuBERTConfig, lengths: np.ndarray, t: int,
              rng: np.random.Generator) -> np.ndarray:
    """(B, T) bool span mask for rows of ``lengths`` valid frames, with the
    arguments JAX ``hubert_forward`` gives its sampler: ``min_masks=2`` and
    the reference's ``require_same_masks=True``."""
    return compute_mask_indices_np(
        (len(lengths), t), np.asarray(lengths),
        mask_prob=cfg.mask_prob, mask_length=cfg.mask_length,
        mask_selection=cfg.mask_selection, mask_other=cfg.mask_other,
        min_masks=2, no_overlap=cfg.no_mask_overlap,
        min_space=cfg.mask_min_space, require_same_masks=True, rng=rng)


def hubert_forward(
    model: HuBERTModel,
    source: torch.Tensor,  # (B, T_wave) padded waveform
    wave_lengths,          # (B,) host ints: valid samples per row
    *,
    mask: bool = True,
    features_only: bool = False,
    get_hidden: bool = False,
    mask_indices: Optional[torch.Tensor] = None,  # (B, T') bool
    rng: Optional[torch.Generator] = None,  # host generator
    deterministic: bool = True,
    attn_impl: str = "auto",
) -> dict:
    """Port of JAX ``hubert_forward``. Returns a dict with ``x`` (the
    encoder output), ``features`` (the encoder input, after masking),
    ``unmasked_features``, ``padding_mask``, ``mask_indices``,
    ``features_pen``, ``layer_hiddens`` and ``frame_lengths`` (host numpy).

    ``features_only`` keeps the reference signature; as in JAX it changes
    nothing (the encoder runs either way, and ``mask`` alone decides the
    masking). With ``mask`` and no ``mask_indices``, the span mask is drawn
    on the host from ``rng``. ``deterministic=False`` turns the dropouts on,
    drawing from ``rng``, a host ``torch.Generator``."""
    cfg = model.cfg
    generator = None
    if not deterministic:
        if rng is None:
            raise ValueError("training (deterministic=False) needs an rng")
        generator = device_generator(rng, source.device)
    x, unmasked_features, frame_valid, out_len, features_pen = (
        wave_frontend_forward(model, cfg, source, wave_lengths,
                              generator=generator,
                              deterministic=deterministic))
    b, t_frames = x.shape[0], x.shape[1]

    if mask and cfg.mask_prob > 0:
        if mask_indices is None:
            if rng is None:
                raise ValueError("drawing a span mask needs an rng (or pass "
                                 "mask_indices)")
            mask_indices = torch.from_numpy(span_mask(
                cfg, out_len, t_frames, np.random.default_rng(draw_seed(rng))))
        mask_indices = mask_indices.to(device=x.device, dtype=torch.bool)
        x = torch.where(mask_indices[:, :, None],
                        model.mask_emb.to(x.dtype)[None, None, :], x)
    else:
        mask_indices = torch.zeros((b, t_frames), dtype=torch.bool,
                                   device=x.device)

    hidden, layer_hiddens = encoder_forward(
        x, model.encoder, cfg, padding_mask=~frame_valid,
        get_hidden=get_hidden, attn_impl=attn_impl, rng=rng,
        deterministic=deterministic)
    return {
        "x": hidden,
        "features": x,
        "unmasked_features": unmasked_features,
        "padding_mask": ~frame_valid,
        "mask_indices": mask_indices,
        "features_pen": features_pen,
        "layer_hiddens": layer_hiddens,
        "frame_lengths": out_len,
    }


def hubert_nce_loss_terms(model: HuBERTModel, out: dict,
                          target_list: List[torch.Tensor],
                          select: torch.Tensor):
    """Port of JAX ``hubert_nce_loss_terms`` (reference compute_nce,
    model.py:264-274): per label set, cosine logits of the projected
    frames against every class embedding at ``logit_temp``, the positive
    taken out of the negatives as -inf, cross entropy with the positive as
    class 0, summed over the ``select`` frames. Returns (losses, count,
    accuracies)."""
    cfg = model.cfg
    num_classes = model.num_classes
    proj = model.final_proj(out["x"])
    proj_list = (torch.chunk(proj, len(num_classes), dim=-1)
                 if cfg.untie_final_proj else [proj] * len(num_classes))
    offsets = np.concatenate([[0], np.cumsum(num_classes)])
    count = select.sum()
    losses, accs = [], []
    for i, (proj_x, target) in enumerate(zip(proj_list, target_list)):
        embs = model.label_embs_concat[int(offsets[i]):int(offsets[i + 1])]
        glu = getattr(model, "target_glu", None)
        if glu is not None:
            embs = glu(embs)
        xn = F.normalize(at_least_f32(proj_x), dim=-1, eps=1e-8)
        en = F.normalize(at_least_f32(embs), dim=-1, eps=1e-8)
        sims = torch.matmul(xn, en.t()) / cfg.logit_temp  # (B, T, C)
        safe_t = torch.where(select, target, torch.zeros_like(target)).long()
        pos = torch.gather(sims, -1, safe_t[..., None])[..., 0]
        is_pos = F.one_hot(safe_t, sims.shape[-1]).bool()
        neg = sims.masked_fill(is_pos, float("-inf"))
        lse = torch.logaddexp(pos, torch.logsumexp(neg, dim=-1))
        ce = lse - pos
        losses.append(torch.where(select, ce, torch.zeros_like(ce)).sum())
        best_neg = neg.amax(dim=-1)
        corr = (select & (pos > best_neg)).sum()
        accs.append(corr / count.clamp_min(1))
    return losses, count, accs


def hubert_pretrain_loss(model: HuBERTModel, out: dict,
                         target_list: List[torch.Tensor],
                         pred_masked_weight: float = 1.0,
                         pred_nomask_weight: float = 0.0,
                         loss_weights: Sequence[float] = (10.0,),
                         target_valid: Optional[torch.Tensor] = None):
    """Port of JAX ``hubert_pretrain_loss`` (HubertCriterion,
    criterion.py:81-161): the summed NCE over masked (and, with a nomask
    weight, unmasked) valid frames, plus ``loss_weights[0]`` times the
    feature penalty times the sample size. Returns (loss, sample_size,
    logs)."""
    cfg = model.cfg
    valid = ~out["padding_mask"]
    if target_valid is not None:
        valid = valid & target_valid
    loss = 0.0
    sample_size = 0
    logs = {}
    if not cfg.skip_masked and pred_masked_weight > 0:
        losses_m, n_m, accs = hubert_nce_loss_terms(
            model, out, target_list, valid & out["mask_indices"])
        loss = loss + pred_masked_weight * sum(losses_m)
        sample_size = sample_size + n_m
        for i, (l, a) in enumerate(zip(losses_m, accs)):
            logs[f"loss_m_{i}"] = l
            logs[f"acc_m_{i}"] = a
    if not cfg.skip_nomask and pred_nomask_weight > 0:
        losses_u, n_u, _ = hubert_nce_loss_terms(
            model, out, target_list, valid & ~out["mask_indices"])
        loss = loss + pred_nomask_weight * sum(losses_u)
        sample_size = sample_size + n_u
        for i, l in enumerate(losses_u):
            logs[f"loss_u_{i}"] = l
    if loss_weights:
        loss = loss + loss_weights[0] * out["features_pen"] * sample_size
        logs["loss_features_pen"] = out["features_pen"]
    logs["sample_size"] = sample_size
    return loss, sample_size, logs
