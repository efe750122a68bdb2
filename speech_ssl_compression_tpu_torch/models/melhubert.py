"""MelHuBERT inference forward.

Port of the inference path of
``speech_ssl_compression_tpu/models/melhubert.py::melhubert_forward``:
``pre_extract_proj`` -> encoder -> ``final_proj``, with ``no_pred`` and
``get_hidden``. Span masking (``mask=True``) comes with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import MelHuBERTConfig

from ..ops.activations import gelu
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


def melhubert_forward(
    model: MelHuBERTModel,
    feat: torch.Tensor,      # (B, T, feat_dim)
    pad_mask: torch.Tensor,  # (B, T): 1/True = valid frame
    *,
    mask: bool = False,
    no_pred: bool = False,
    get_hidden: bool = False,
    attn_impl: str = "auto",
) -> Dict[str, Optional[object]]:
    """Returns a dict with keys
      hidden         (B, T, D) final encoder output
      logits         (B, T, num_cluster), or None with no_pred
      mask_indices   (B, T) bool, all False (no masking at inference)
      layer_hiddens  list of (B, T, D) with get_hidden
      pre_feat       (B, T, D) post-projection features (pre-encoder)
    """
    if mask:
        raise NotImplementedError(
            "span masking (mask=True) comes with the training slice"
        )
    cfg = model.cfg
    valid = pad_mask.to(torch.bool)
    pre_feat = pre_project(model, feat)
    layer_hiddens = []
    if cfg.encoder_layers > 0:
        hidden, layer_hiddens = encoder_forward(
            pre_feat, model.encoder, cfg,
            padding_mask=~valid,
            causal=cfg.attention_type == "causal",
            get_hidden=get_hidden,
            attn_impl=attn_impl,
        )
    else:
        hidden = gelu(pre_feat)
    out = {
        "hidden": hidden,
        "logits": None,
        "mask_indices": torch.zeros_like(valid),
        "layer_hiddens": layer_hiddens,
        "pre_feat": pre_feat,
    }
    if not no_pred:
        out["logits"] = model.final_proj(hidden)
    return out
