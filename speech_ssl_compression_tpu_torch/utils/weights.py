"""The weight bridge: JAX-layout param trees -> the port's state dicts.

The port's modules use the reference state-dict names
(``encoder.layers.{i}.self_attn.q_proj.weight``, ...), so the JAX package's
own exporter ``utils/torch_convert.py::params_to_state_dict`` (jax-free)
turns any JAX param tree into a ``load_state_dict`` input. Per-layer head
counts and FFN widths of head- and row-pruned trees come from
``utils/torch_convert.py::infer_pruned_dims``.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import MelHuBERTConfig
from speech_ssl_compression_tpu.utils.torch_convert import (
    infer_pruned_dims,
    melhubert_state_dict_to_params,
    params_to_state_dict,
)

__all__ = [
    "apply_masks",
    "infer_pruned_dims",
    "init_params_np",
    "jax_tree_from_named",
    "load_model",
    "state_dict_from_jax_params",
]


def apply_masks(params: dict, masks: Optional[dict]) -> dict:
    """Mirror of ``speech_ssl_compression_tpu/compress/weight_pruning.py::apply_masks``
    on numpy trees: ``p * m`` on the masked leaves of
    ``masks["layer_{i}"][module][leaf]``. Returns a new tree."""
    if masks is None:
        return params
    out = copy.deepcopy(params)
    for lname, mods in masks.items():
        layer = out["encoder"]["layers"][int(lname.split("_")[1])]
        for mod, leaves in mods.items():
            for leaf, m in leaves.items():
                layer[mod][leaf] = np.asarray(layer[mod][leaf]) * np.asarray(m)
    return out


def state_dict_from_jax_params(
    params: dict, masks: Optional[dict] = None
) -> Dict[str, torch.Tensor]:
    """JAX-layout param tree (numpy leaves) -> float32 CPU state dict in the
    reference naming. Weight-pruning masks are folded in first, as
    ``prune.remove`` does."""
    sd = params_to_state_dict(apply_masks(params, masks))
    return {
        k: torch.tensor(np.asarray(v), dtype=torch.float32)
        for k, v in sd.items()
    }


def jax_tree_from_named(named: Dict[str, torch.Tensor]) -> dict:
    """Tensors under the model's parameter names (weights, or anything laid
    out like them: gradients, Adam moments) -> a JAX-layout numpy tree
    (kernels transposed to (in, out), ``scale`` for LayerNorm weights), the
    inverse of :func:`state_dict_from_jax_params`."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in named.items()}
    return melhubert_state_dict_to_params(sd, keep_masks=False)[0]


def load_model(params: dict, cfg: MelHuBERTConfig,
               masks: Optional[dict] = None):
    """A float32 CPU ``MelHuBERTModel`` for ``cfg`` holding ``params`` (a
    JAX-layout tree; ``cfg`` must carry its per-layer heads and FFN widths).
    Every parameter must be matched: the load is strict."""
    from ..models.melhubert import MelHuBERTModel

    model = MelHuBERTModel(cfg)
    model.load_state_dict(state_dict_from_jax_params(params, masks))
    return model


def init_params_np(cfg: MelHuBERTConfig, seed: int) -> dict:
    """Random MelHuBERT params in the JAX layout, made with numpy from
    ``seed``, drawn from the distributions of
    ``speech_ssl_compression_tpu/models/melhubert.py::init_melhubert_params``
    (the numbers differ: JAX's generator is not numpy's)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    d = cfg.encoder_embed_dim

    def uniform_linear(n_in, n_out):
        bound = 1.0 / np.sqrt(n_in)
        return {
            "kernel": rng.uniform(-bound, bound, (n_in, n_out)).astype(f32),
            "bias": rng.uniform(-bound, bound, (n_out,)).astype(f32),
        }

    def bert_linear(n_in, n_out):
        return {
            "kernel": (0.02 * rng.standard_normal((n_in, n_out))).astype(f32),
            "bias": np.zeros((n_out,), f32),
        }

    def ln():
        return {"scale": np.ones((d,), f32), "bias": np.zeros((d,), f32)}

    params = {}
    if cfg.feat_emb_dim != d:
        params["pre_extract_proj"] = uniform_linear(cfg.feat_emb_dim, d)
    if cfg.encoder_layers > 0:
        k = cfg.conv_pos
        std = np.sqrt(4.0 / (k * d))
        w = (std * rng.standard_normal((d, d // cfg.conv_pos_groups, k))
             ).astype(f32)
        layers = []
        for i in range(cfg.encoder_layers):
            proj = cfg.encoder_attention_heads[i] * cfg.head_dim
            ffn = cfg.encoder_ffn_embed_dim[i]
            layers.append({
                "q_proj": bert_linear(d, proj),
                "k_proj": bert_linear(d, proj),
                "v_proj": bert_linear(d, proj),
                "out_proj": bert_linear(proj, d),
                "self_attn_layer_norm": ln(),
                "fc1": bert_linear(d, ffn),
                "fc2": bert_linear(ffn, d),
                "final_layer_norm": ln(),
            })
        params["encoder"] = {
            "pos_conv": {
                "weight_g": np.sqrt((w.astype(np.float64) ** 2).sum(
                    axis=(0, 1), keepdims=True)).astype(f32),
                "weight_v": w,
                "bias": np.zeros((d,), f32),
            },
            "layer_norm": ln(),
            "layers": layers,
        }
    params["final_proj"] = uniform_linear(d, cfg.num_cluster)
    if cfg.learnable_mask_emb:
        dim = cfg.feat_emb_dim if cfg.mask_before_proj else d
        params["mask_emb"] = rng.uniform(0.0, 1.0, (dim,)).astype(f32)
    return params
