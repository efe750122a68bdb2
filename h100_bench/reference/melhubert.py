"""MelHuBERT (arXiv:2211.09944) in plain PyTorch: log-Mel input, a linear
pre-projection to the encoder's width, the shared encoder, and the
cluster projection of pre-training."""

from __future__ import annotations

import math

import torch

from . import encoder, fbank


def specs(cfg: dict) -> list:
    d = cfg["encoder_embed_dim"]
    d_in, c = cfg["feat_emb_dim"], cfg["num_cluster"]
    return ([("pre_extract_proj.weight", (d, d_in), "normal",
              1.0 / math.sqrt(d_in)),
             ("pre_extract_proj.bias", (d,), "normal", 0.02)]
            + encoder.specs(cfg)
            + [("final_proj.weight", (c, d), "normal", 0.02),
               ("final_proj.bias", (c,), "normal", 0.02)])


def hidden_states(feat, p: dict, cfg: dict, num, key_pad=None, drop=None):
    """feat (B, T, feat_emb_dim) -> [pre-projected features] + every
    layer's output, each (B, T, D)."""
    pre = num.linear(feat, p["pre_extract_proj.weight"],
                     p["pre_extract_proj.bias"])
    return [pre] + encoder.encoder(pre, p, cfg, num, key_pad, drop)


def serve(wave: torch.Tensor, p: dict, cfg: dict, mean: torch.Tensor,
          std: torch.Tensor, num) -> list:
    """One utterance's waveform -> its hidden states, (T, D) each: the
    fbank in float64, the model in float32."""
    feat = fbank.melhubert_input(wave, mean, std).to(torch.float32)
    return [h[0] for h in hidden_states(feat[None], p, cfg, num)]
