"""HuBERT Base (arXiv:2106.07447; fairseq's HubertModel) in plain
PyTorch, as feature extraction runs it: the waveform conv frontend (a
GroupNorm per channel over the row's time after the first conv, GELU after
each), LayerNorm over the conv features, the projection to the encoder's
width and the shared encoder. A padded row is normalised over its whole
padded length, as a batch pads it."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import encoder

NORM_EPS = 1e-5


def specs(cfg: dict, n_classes: int) -> list:
    out, in_d = [], 1
    for i, (dim, k, _) in enumerate(cfg["conv_feature_layers"]):
        out.append((f"feature_extractor.conv_layers.{i}.0.weight",
                    (dim, in_d, k), "normal", math.sqrt(2.0 / (in_d * k))))
        if i == 0:
            out += [("feature_extractor.conv_layers.0.2.weight", (dim,),
                     "unit", 0.05),
                    ("feature_extractor.conv_layers.0.2.bias", (dim,),
                     "normal", 0.05)]
        in_d = dim
    d, final = cfg["encoder_embed_dim"], cfg["final_dim"]
    return (out
            + [("layer_norm.weight", (in_d,), "unit", 0.05),
               ("layer_norm.bias", (in_d,), "normal", 0.05),
               ("post_extract_proj.weight", (d, in_d), "normal",
                1.0 / math.sqrt(in_d)),
               ("post_extract_proj.bias", (d,), "normal", 0.02),
               ("mask_emb", (d,), "normal", 1.0)]
            + encoder.specs(cfg)
            + [("final_proj.weight", (final, d), "normal", 0.02),
               ("final_proj.bias", (final,), "normal", 0.02),
               ("label_embs_concat", (n_classes, final), "normal", 1.0)])


def frontend(row: torch.Tensor, p: dict, cfg: dict, num) -> torch.Tensor:
    """(T_wave,) one padded row -> conv features (T', C)."""
    x = row.to(torch.float32)[None, None]
    for i, (_, _, stride) in enumerate(cfg["conv_feature_layers"]):
        x = num.conv1d(x, p[f"feature_extractor.conv_layers.{i}.0.weight"],
                       stride=stride)
        if i == 0:
            mean = x.mean(dim=2, keepdim=True)
            var = x.var(dim=2, keepdim=True, unbiased=False)
            x = ((x - mean) / torch.sqrt(var + NORM_EPS)
                 * p["feature_extractor.conv_layers.0.2.weight"][:, None]
                 + p["feature_extractor.conv_layers.0.2.bias"][:, None])
        x = F.gelu(x)
    return x[0].T


def serve(row: torch.Tensor, n_valid: int, p: dict, cfg: dict, num):
    """One utterance as its batch padded it (``row``, of which the first
    ``n_valid`` samples are the utterance) -> the encoder's output on its
    valid frames, (T_valid, D)."""
    feats = frontend(row, p, cfg, num)
    t = n_valid
    for _, k, s in cfg["conv_feature_layers"]:
        t = (t - k) // s + 1
    x = F.layer_norm(feats, feats.shape[-1:], p["layer_norm.weight"],
                     p["layer_norm.bias"], NORM_EPS)
    x = num.linear(x, p["post_extract_proj.weight"],
                   p["post_extract_proj.bias"])[:t]
    return encoder.encoder(x[None], p, cfg, num)[-1][0]
