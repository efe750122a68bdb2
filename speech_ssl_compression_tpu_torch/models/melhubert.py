"""MelHuBERT: masked cluster prediction over log-Mel input.

Port of ``speech_ssl_compression_tpu/models/melhubert.py``:
``melhubert_forward`` (``pre_extract_proj`` -> span mask -> encoder ->
``final_proj``, with ``no_pred``, ``get_hidden`` and the training forward),
``masked_cross_entropy`` and ``melhubert_pretrain_loss``. The trainers'
span masks are drawn on the host by :func:`span_mask`
(``ops/masking.py::compute_mask_indices_np``, with the arguments JAX passes
its device sampler) and handed to the forward as
``teacher_mask_indices``; the grad step does so from the batch's host
lengths, so its batches and resumes stay bitwise JAX's. A forward with
``mask=True`` and no mask draws one on the device, as JAX's does
(``ops/masking.py::compute_span_mask``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import MelHuBERTConfig

from ..ops.activations import gelu
from ..ops.dropout import draw_seed, seeded_generator
from ..ops.masking import compute_mask_indices_np, compute_span_mask
from .encoder import TransformerEncoder, encoder_forward


class MelHuBERTModel(nn.Module):
    """Parameters under the reference names: ``pre_extract_proj`` (when
    feat_emb_dim != encoder_embed_dim), ``encoder``, ``final_proj`` and
    ``mask_emb`` (with learnable_mask_emb)."""

    def __init__(self, cfg: MelHuBERTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder_embed_dim
        if cfg.feat_emb_dim != d:
            self.pre_extract_proj = nn.Linear(cfg.feat_emb_dim, d)
        if cfg.encoder_layers > 0:
            self.encoder = TransformerEncoder(cfg)
        self.final_proj = nn.Linear(d, cfg.num_cluster)
        if cfg.learnable_mask_emb:
            dim = cfg.feat_emb_dim if cfg.mask_before_proj else d
            self.mask_emb = nn.Parameter(torch.zeros(dim))

    def forward(self, feat, pad_mask, **kwargs):
        return melhubert_forward(self, feat, pad_mask, **kwargs)


def pre_project(model: MelHuBERTModel, feat: torch.Tensor) -> torch.Tensor:
    """``pre_extract_proj`` where the model has one, else the identity."""
    proj = getattr(model, "pre_extract_proj", None)
    return feat if proj is None else F.linear(feat, proj.weight, proj.bias)


def span_mask(cfg: MelHuBERTConfig, lengths: np.ndarray, t: int,
              rng: np.random.Generator) -> np.ndarray:
    """(B, T) bool span mask for rows of valid ``lengths``, with the
    arguments ``melhubert_forward`` (JAX) gives its sampler: ``min_masks=2``
    and ``require_same_masks=False``, which the reference MelHuBERT passes
    explicitly (model.py:76), so each row keeps its own mask count."""
    return compute_mask_indices_np(
        (len(lengths), t), np.asarray(lengths),
        mask_prob=cfg.mask_prob, mask_length=cfg.mask_length,
        mask_selection=cfg.mask_selection, mask_other=cfg.mask_other,
        min_masks=2, no_overlap=cfg.no_mask_overlap,
        min_space=cfg.mask_min_space, require_same_masks=False, rng=rng,
    )


def _apply_mask(x, mask_indices, model):
    """Masked frames become ``mask_emb`` (learnable_mask_emb) or zero."""
    mask_emb = getattr(model, "mask_emb", None)
    fill = (torch.zeros((), dtype=x.dtype, device=x.device) if mask_emb is None
            else mask_emb.to(x.dtype)[None, None, :])
    return torch.where(mask_indices[:, :, None], fill, x)


def melhubert_forward(
    model: MelHuBERTModel,
    feat: torch.Tensor,      # (B, T, feat_dim)
    pad_mask: torch.Tensor,  # (B, T): 1/True = valid frame
    *,
    mask: bool = False,
    no_pred: bool = False,
    get_hidden: bool = False,
    teacher_mask_indices: Optional[torch.Tensor] = None,  # (B, T) bool
    rng: Optional[torch.Generator] = None,  # host generator
    deterministic: bool = True,
    attn_impl: str = "auto",
    return_contexts: bool = False,
    remat: bool = False,
) -> Dict[str, Optional[object]]:
    """Returns a dict with keys
      hidden         (B, T, D) final encoder output
      logits         (B, T, num_cluster), or None with no_pred
      mask_indices   (B, T) bool span mask (all False without ``mask``)
      layer_hiddens  list of (B, T, D) with get_hidden
      pre_feat       (B, T, D) post-projection features (pre-encoder)
      contexts       list of (B, H_i, T, d) attention contexts, one per
                     layer (None where LayerDrop skipped it), with
                     ``return_contexts`` (head scoring); else empty

    ``mask=True`` masks the spans of ``teacher_mask_indices`` (drawn with
    :func:`span_mask`), or without them spans drawn on the device by
    ``compute_span_mask`` from a generator seeded by ``rng`` (JAX's
    arguments: ``min_masks=2``, ``require_same_masks=False``).
    ``deterministic=False`` turns the dropouts on,
    drawing from ``rng``, a host ``torch.Generator``. ``remat=True``
    recomputes each encoder layer in the backward instead of keeping its
    activations (``models/encoder.py::checkpoint_layer``; JAX's
    ``remat=``)."""
    cfg = model.cfg
    valid = pad_mask.to(torch.bool)
    mask_indices = torch.zeros_like(valid)
    if mask and cfg.mask_prob > 0:
        if teacher_mask_indices is not None:
            mask_indices = teacher_mask_indices.to(torch.bool)
        else:
            if rng is None:
                raise ValueError("masking requires an rng (or pass "
                                 "teacher_mask_indices)")
            mask_indices = compute_span_mask(
                seeded_generator(draw_seed(rng), feat.device),
                valid.sum(dim=-1, dtype=torch.int32), valid.shape[1],
                mask_prob=cfg.mask_prob, mask_length=cfg.mask_length,
                mask_selection=cfg.mask_selection,
                mask_other=cfg.mask_other, min_masks=2,
                no_overlap=cfg.no_mask_overlap,
                min_space=cfg.mask_min_space,
                # the reference MelHuBERT passes this explicitly
                # (model.py:76): each row keeps its own mask count
                require_same_masks=False)

    x = feat
    if mask and cfg.mask_before_proj:
        x = _apply_mask(x, mask_indices, model)
    pre_feat = pre_project(model, x)
    x = pre_feat
    if mask and not cfg.mask_before_proj:
        x = _apply_mask(x, mask_indices, model)

    layer_hiddens, contexts = [], []
    if cfg.encoder_layers > 0:
        hidden, layer_hiddens = encoder_forward(
            x, model.encoder, cfg,
            padding_mask=~valid,
            causal=cfg.attention_type == "causal",
            get_hidden=get_hidden,
            attn_impl=attn_impl,
            rng=rng,
            deterministic=deterministic,
            contexts=contexts if return_contexts else None,
            remat=remat,
        )
    else:
        hidden = gelu(x)
    out = {
        "hidden": hidden,
        "logits": None,
        "mask_indices": mask_indices,
        "layer_hiddens": layer_hiddens,
        "pre_feat": pre_feat,
        "contexts": contexts,
    }
    if not no_pred:
        out["logits"] = model.final_proj(hidden)
    return out


def masked_cross_entropy(
    logits: torch.Tensor,  # (B, T, C)
    labels: torch.Tensor,  # (B, T) int, -100 = ignore
    select: torch.Tensor,  # (B, T) bool: which frames to include
    total: Optional[torch.Tensor] = None,
):
    """Mean cross entropy over the selected frames with ignore_index -100,
    log-softmax in f32 (reference pretrain_expert.py:25,114-119 gathers the
    frames; JAX and the port mask them). ``total`` replaces the count as
    the divisor: the global batch's count, where a data-parallel rank
    holds a part of it (the ranks' losses then sum to the global mean).
    Returns (loss, count)."""
    valid = select & (labels != -100)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    count = valid.sum()
    den = count if total is None else total
    loss = (torch.where(valid, nll, torch.zeros_like(nll)).sum()
            / den.clamp_min(1))
    return loss, count


def loss_selections(mask_indices: Optional[torch.Tensor],
                    labels: torch.Tensor, pad_mask: torch.Tensor) -> dict:
    """The frames each term of :func:`melhubert_pretrain_loss` averages
    over, {"masked": (B, T) bool, "nomask": ...} (a missing span mask masks
    nothing)."""
    valid = pad_mask.to(torch.bool) & (labels != -100)
    if mask_indices is None:
        mask_indices = torch.zeros_like(valid)
    mask_indices = mask_indices.to(torch.bool)
    return {"masked": valid & mask_indices, "nomask": valid & ~mask_indices}


def melhubert_pretrain_loss(out: dict, labels: torch.Tensor,
                            pad_mask: torch.Tensor, cfg: MelHuBERTConfig,
                            totals: Optional[dict] = None):
    """pred_masked_weight * CE(masked) + pred_nomask_weight * CE(unmasked)
    (reference pretrain_expert.py:114-119). ``totals`` ({"masked",
    "nomask"}: the global batch's counts of :func:`loss_selections`) are
    the divisors of a data-parallel rank. Returns (loss, logs)."""
    totals = totals or {}
    valid = pad_mask.to(torch.bool)
    mask_indices = out["mask_indices"]
    loss = 0.0
    logs = {}
    if not cfg.skip_masked and cfg.pred_masked_weight > 0:
        l_m, n_m = masked_cross_entropy(out["logits"], labels,
                                        valid & mask_indices,
                                        totals.get("masked"))
        loss = loss + cfg.pred_masked_weight * l_m
        logs["loss_masked"] = l_m
        logs["n_masked"] = n_m
    if not cfg.skip_nomask and cfg.pred_nomask_weight > 0:
        l_u, n_u = masked_cross_entropy(out["logits"], labels,
                                        valid & ~mask_indices,
                                        totals.get("nomask"))
        loss = loss + cfg.pred_nomask_weight * l_u
        logs["loss_nomask"] = l_u
        logs["n_nomask"] = n_u
    return loss, logs
