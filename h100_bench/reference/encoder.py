"""The BERT encoder that MelHuBERT and HuBERT share, in plain PyTorch:
the weight-normed grouped positional conv, post-LN layers of multi-head
self-attention and a GELU FFN (fairseq's TransformerEncoder with
``layer_norm_first=False``).

Parameters are a dict under the reference names
(``encoder.layers.{i}.self_attn.q_proj.weight``, ``encoder.pos_conv.0.
weight_v``, ...). ``drop``, when given, is the training's dropout
(:class:`..reference.train.Dropout`): it applies the residual, activation
and input dropouts and the attention keep bits in the order the model
draws them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def specs(cfg: dict) -> list:
    """``(name, shape, kind, scale)`` of the encoder's parameters
    (:mod:`..weights`): BERT-normal linears with small biases, norms near
    one, the positional conv's kernel at its init's spread."""
    d, f = cfg["encoder_embed_dim"], cfg["encoder_ffn_embed_dim"]
    p = cfg["encoder_attention_heads"] * cfg["head_dim"]
    k, g = cfg["conv_pos"], cfg["conv_pos_groups"]
    out = [("encoder.pos_conv.0.weight_g", (1, 1, k), "wn_g", 0.0),
           ("encoder.pos_conv.0.weight_v", (d, d // g, k), "normal",
            math.sqrt(4.0 / (k * d))),
           ("encoder.pos_conv.0.bias", (d,), "normal", 0.02),
           ("encoder.layer_norm.weight", (d,), "unit", 0.05),
           ("encoder.layer_norm.bias", (d,), "normal", 0.05)]
    for i in range(cfg["encoder_layers"]):
        pre = f"encoder.layers.{i}."
        for proj, (n_out, n_in) in (("q_proj", (p, d)), ("k_proj", (p, d)),
                                    ("v_proj", (p, d)), ("out_proj", (d, p))):
            out += [(f"{pre}self_attn.{proj}.weight", (n_out, n_in),
                     "normal", 0.02),
                    (f"{pre}self_attn.{proj}.bias", (n_out,), "normal", 0.02)]
        out += [(f"{pre}self_attn_layer_norm.weight", (d,), "unit", 0.05),
                (f"{pre}self_attn_layer_norm.bias", (d,), "normal", 0.05),
                (f"{pre}fc1.weight", (f, d), "normal", 0.02),
                (f"{pre}fc1.bias", (f,), "normal", 0.02),
                (f"{pre}fc2.weight", (d, f), "normal", 0.02),
                (f"{pre}fc2.bias", (d,), "normal", 0.02),
                (f"{pre}final_layer_norm.weight", (d,), "unit", 0.05),
                (f"{pre}final_layer_norm.bias", (d,), "normal", 0.05)]
    return out


def gelu(x):
    return F.gelu(x)  # the exact erf form


def layer_norm(x, p: dict, name: str):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], LN_EPS)


def pos_conv(x, p: dict, cfg: dict, num):
    """The weight-normed grouped conv (norm over the kernel's first two
    axes, per tap), K // 2 zeros on each side, the last frame cut for an
    even K, and GELU. x: (B, T, D), padded frames already zero."""
    v = p["encoder.pos_conv.0.weight_v"]
    g = p["encoder.pos_conv.0.weight_g"]
    w = g * v / torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
    k = cfg["conv_pos"]
    y = num.conv1d(x.transpose(1, 2), w, p["encoder.pos_conv.0.bias"],
                   padding=k // 2, groups=cfg["conv_pos_groups"])
    if k % 2 == 0:
        y = y[:, :, :-1]
    return gelu(y.transpose(1, 2))


def self_attention(x, p: dict, pre: str, cfg: dict, num, key_pad=None,
                   drop=None, seed=None):
    """softmax(q k^T / sqrt(d)) v over the unpadded keys, per head; the
    attention dropout's keep bits come from ``drop`` under ``seed``."""
    b, t, _ = x.shape
    h, d = cfg["encoder_attention_heads"], cfg["head_dim"]

    def heads(name):
        y = num.linear(x, p[pre + name + ".weight"], p[pre + name + ".bias"])
        return y.view(b, t, h, d).transpose(1, 2)

    q, k, v = heads("q_proj"), heads("k_proj"), heads("v_proj")
    scores = num.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    if key_pad is not None:
        scores = scores.masked_fill(key_pad[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if drop is not None:
        probs = drop.attention(probs, cfg["attention_dropout"], seed)
    ctx = num.matmul(probs, v).transpose(1, 2).reshape(b, t, h * d)
    return num.linear(ctx, p[pre + "out_proj.weight"],
                      p[pre + "out_proj.bias"])


def encoder(x, p: dict, cfg: dict, num, key_pad=None, drop=None) -> list:
    """x (B, T, D) -> the output of every layer, a list of (B, T, D).
    ``key_pad`` (B, T) bool marks padded frames (True)."""
    if key_pad is not None:
        x = x.masked_fill(key_pad[:, :, None], 0.0)
    x = layer_norm(x + pos_conv(x, p, cfg, num), p, "encoder.layer_norm")
    if drop is not None:
        x = drop.apply(x, cfg["dropout"])
    outs = []
    for i in range(cfg["encoder_layers"]):
        pre = f"encoder.layers.{i}."
        seed = drop.layer_seed() if drop is not None else None
        h = self_attention(x, p, pre + "self_attn.", cfg, num, key_pad,
                           drop, seed)
        if drop is not None:
            h = drop.apply(h, cfg["dropout"])
        x = layer_norm(x + h, p, pre + "self_attn_layer_norm")
        f = gelu(num.linear(x, p[pre + "fc1.weight"], p[pre + "fc1.bias"]))
        if drop is not None:
            f = drop.apply(f, cfg["activation_dropout"])
        f = num.linear(f, p[pre + "fc2.weight"], p[pre + "fc2.bias"])
        if drop is not None:
            f = drop.apply(f, cfg["dropout"])
        x = layer_norm(x + f, p, pre + "final_layer_norm")
        outs.append(x)
    return outs
