"""The weight bridge: JAX-layout param trees -> the port's state dicts.

The port's modules use the reference state-dict names
(``encoder.layers.{i}.self_attn.q_proj.weight``, ...), so the exporters of
``utils/torch_convert.py`` (the port's copy of the JAX package's) turn any
JAX param tree into a ``load_state_dict`` input. Per-layer head counts and
FFN widths of head- and row-pruned trees come from
``torch_convert.infer_pruned_dims``.

The mask bridge: weight-pruning masks are a JAX-layout tree
``masks["layer_{i}"][module]["kernel" | "bias"]`` in checkpoints and in
``compress/weight_pruning.py``'s host pass, and device tensors under the
state-dict names (kernels transposed to (out, in)) in the trainer
(:func:`named_masks`, :func:`masks_tree`, :func:`prunable_tree`).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import HuBERTConfig, MelHuBERTConfig, Wav2Vec2Config
from ..models.encoder import pos_conv_kernel_size
from .torch_convert import (
    infer_pruned_dims,
    kernel_from_weight,
    melhubert_state_dict_to_params,
    params_to_state_dict,
    wave_params_to_state_dict,
    wave_state_dict_to_params,
)

# the prunable encoder modules, in JAX's leaf order within a layer
PRUNABLE = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
_LEAF_NAMES = {"kernel": "weight", "bias": "bias"}

__all__ = [
    "PRUNABLE",
    "apply_masks",
    "infer_pruned_dims",
    "init_hubert_params_np",
    "init_params_np",
    "init_wav2vec2_params_np",
    "jax_tree_from_named",
    "load_wave_model",
    "load_model",
    "masks_tree",
    "model_from_named",
    "named_masks",
    "prunable_name",
    "prunable_names",
    "prunable_tree",
    "state_dict_from_jax_params",
    "wave_model_from_named",
    "wave_tree_from_named",
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


def prunable_name(layer: int, module: str, leaf: str) -> str:
    """The state-dict name of a prunable leaf (``leaf``: "kernel" or
    "bias"), e.g. ``encoder.layers.3.self_attn.q_proj.weight``."""
    attn = "" if module in ("fc1", "fc2") else "self_attn."
    return f"encoder.layers.{layer}.{attn}{module}.{_LEAF_NAMES[leaf]}"


def named_masks(masks: dict, device) -> Dict[str, torch.Tensor]:
    """A JAX-layout mask tree -> f32 tensors on ``device`` under the
    state-dict names, kernels transposed to (out, in)."""
    out = {}
    for lname, mods in masks.items():
        i = int(lname.split("_")[1])
        for mod, leaves in mods.items():
            for leaf, m in leaves.items():
                m = np.asarray(m, np.float32)
                out[prunable_name(i, mod, leaf)] = torch.from_numpy(
                    np.array(m.T if leaf == "kernel" else m, order="C")
                ).to(device)
    return out


def _split_name(name: str):
    """(layer, module, leaf) of a prunable state-dict name."""
    parts = name.split(".")
    leaf = "kernel" if parts[-1] == "weight" else "bias"
    return int(parts[2]), parts[-2], leaf


def masks_tree(named: Dict[str, torch.Tensor]) -> dict:
    """The trainer's named masks -> a JAX-layout numpy mask tree, the
    inverse of :func:`named_masks`."""
    tree: dict = {}
    for name, m in named.items():
        i, mod, leaf = _split_name(name)
        tree.setdefault(f"layer_{i}", {}).setdefault(mod, {})[leaf] = (
            kernel_from_weight(m) if leaf == "kernel"
            else m.detach().float().cpu().numpy())
    return tree


def _n_layers(named: Dict[str, torch.Tensor]) -> int:
    return 1 + max((int(k.split(".")[2]) for k in named
                    if k.startswith("encoder.layers.")), default=-1)


def prunable_names(named: Dict[str, torch.Tensor],
                   modules: Sequence[str] = PRUNABLE) -> list:
    """The state-dict names of the prunable leaves among ``named`` (of
    ``modules``, default all six), in JAX's leaf order (layer, PRUNABLE
    order, kernel before bias)."""
    return [prunable_name(i, mod, leaf) for i in range(_n_layers(named))
            for mod in PRUNABLE if mod in modules
            for leaf in ("kernel", "bias")]


def prunable_tree(named: Dict[str, torch.Tensor],
                  modules: Sequence[str] = PRUNABLE) -> dict:
    """The prunable leaves of named params (weights or anything laid out
    like them; of ``modules``, default all six) as a JAX-layout numpy tree
    ``{"encoder": {"layers": [{module: {"kernel": (in, out), "bias"}}]}}``,
    the view the pruning host passes rank ties in."""
    layers = [{} for _ in range(_n_layers(named))]
    for name in prunable_names(named, modules):
        i, mod, leaf = _split_name(name)
        a = named[name]
        layers[i].setdefault(mod, {})[leaf] = (
            kernel_from_weight(a) if leaf == "kernel"
            else a.detach().float().cpu().numpy())
    return {"encoder": {"layers": layers}}


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
    sd = {k: v.detach().float() for k, v in named.items()}
    return melhubert_state_dict_to_params(sd, keep_masks=False)[0]


def model_from_named(named: Dict[str, torch.Tensor], cfg: MelHuBERTConfig):
    """A ``MelHuBERTModel`` for ``cfg`` whose parameters are the tensors of
    ``named`` themselves (detached, on their device, no copy): the rebuild
    after a head- or row-prune event, where ``cfg`` carries the new
    per-layer heads and FFN widths. The model is built on the meta device,
    so nothing is initialised only to be overwritten. The load is strict."""
    from ..models.melhubert import MelHuBERTModel

    with torch.device("meta"):
        model = MelHuBERTModel(cfg)
    model.load_state_dict({k: v.detach() for k, v in named.items()},
                          assign=True)
    return model


def load_model(params: dict, cfg: MelHuBERTConfig,
               masks: Optional[dict] = None):
    """A float32 CPU ``MelHuBERTModel`` for ``cfg`` holding ``params`` (a
    JAX-layout tree; ``cfg`` must carry its per-layer heads and FFN widths).
    The model is built on the meta device and takes the converted tensors
    themselves, so nothing is initialised only to be overwritten. Every
    parameter must be matched: the load is strict."""
    from ..models.melhubert import MelHuBERTModel

    with torch.device("meta"):
        model = MelHuBERTModel(cfg)
    model.load_state_dict(state_dict_from_jax_params(params, masks),
                          assign=True)
    return model


def _encoder_params_np(cfg, rng: np.random.Generator) -> dict:
    """Random encoder params in the JAX layout, drawn from the
    distributions of the JAX ``init_encoder`` (BERT-normal linears, zero
    biases, unit LayerNorms, the weight-normed pos-conv or, with
    ``pos_conv_depth > 1``, the deep stack's torch-default convs)."""
    f32 = np.float32
    d = cfg.encoder_embed_dim

    def bert_linear(n_in, n_out):
        return {
            "kernel": (0.02 * rng.standard_normal((n_in, n_out))).astype(f32),
            "bias": np.zeros((n_out,), f32),
        }

    def ln():
        return {"scale": np.ones((d,), f32), "bias": np.zeros((d,), f32)}

    depth = getattr(cfg, "pos_conv_depth", 1)
    if depth > 1:
        # torch's default Conv1d init, JAX init_pos_conv_deep's
        # distribution: uniform, bound 1/sqrt(fan_in)
        k = pos_conv_kernel_size(cfg.conv_pos, depth)
        bound = 1.0 / np.sqrt((d // cfg.conv_pos_groups) * k)
        pos_conv = {"layers": [
            {"weight": rng.uniform(-bound, bound, (
                d, d // cfg.conv_pos_groups, k)).astype(f32),
             "bias": rng.uniform(-bound, bound, (d,)).astype(f32)}
            for _ in range(depth)]}
    else:
        k = cfg.conv_pos
        std = np.sqrt(4.0 / (k * d))
        w = (std * rng.standard_normal(
            (d, d // cfg.conv_pos_groups, k))).astype(f32)
        pos_conv = {
            "weight_g": np.sqrt((w.astype(np.float64) ** 2).sum(
                axis=(0, 1), keepdims=True)).astype(f32),
            "weight_v": w,
            "bias": np.zeros((d,), f32),
        }
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
    return {
        "pos_conv": pos_conv,
        "layer_norm": ln(),
        "layers": layers,
    }


def _uniform_linear(rng: np.random.Generator, n_in: int, n_out: int) -> dict:
    """torch nn.Linear's default init (uniform, bound 1/sqrt(in))."""
    bound = 1.0 / np.sqrt(n_in)
    return {
        "kernel": rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
        "bias": rng.uniform(-bound, bound, (n_out,)).astype(np.float32),
    }


def init_params_np(cfg: MelHuBERTConfig, seed: int) -> dict:
    """Random MelHuBERT params in the JAX layout, made with numpy from
    ``seed``, drawn from the distributions of
    ``speech_ssl_compression_tpu/models/melhubert.py::init_melhubert_params``
    (the numbers differ: JAX's generator is not numpy's)."""
    rng = np.random.default_rng(seed)
    d = cfg.encoder_embed_dim
    params = {}
    if cfg.feat_emb_dim != d:
        params["pre_extract_proj"] = _uniform_linear(rng, cfg.feat_emb_dim, d)
    if cfg.encoder_layers > 0:
        params["encoder"] = _encoder_params_np(cfg, rng)
    params["final_proj"] = _uniform_linear(rng, d, cfg.num_cluster)
    if cfg.learnable_mask_emb:
        dim = cfg.feat_emb_dim if cfg.mask_before_proj else d
        params["mask_emb"] = rng.uniform(0.0, 1.0, (dim,)).astype(np.float32)
    return params


def _frontend_params_np(cfg, rng: np.random.Generator) -> list:
    """The conv frontend's params in the JAX layout, drawn from the
    distributions of JAX ``init_conv_frontend``: Kaiming-normal convs, zero
    biases, unit norms."""
    f32 = np.float32
    frontend = []
    in_d = 1
    for i, (dim, k, _) in enumerate(cfg.conv_feature_layers):
        layer = {"weight": (np.sqrt(2.0 / (in_d * k)) * rng.standard_normal(
            (dim, in_d, k))).astype(f32)}
        if cfg.conv_bias:
            layer["bias"] = np.zeros((dim,), f32)
        norm = {"scale": np.ones((dim,), f32), "bias": np.zeros((dim,), f32)}
        if cfg.extractor_mode == "layer_norm":
            layer["layer_norm"] = norm
        elif i == 0:
            layer["group_norm"] = norm
        frontend.append(layer)
        in_d = dim
    return frontend


def init_hubert_params_np(cfg: HuBERTConfig, num_classes: Sequence[int],
                          seed: int) -> dict:
    """Random HuBERT params in the JAX layout, made with numpy from
    ``seed``, drawn from the distributions of
    ``speech_ssl_compression_tpu/models/hubert.py::init_hubert_params``:
    Kaiming-normal convs, unit norms, uniform ``mask_emb`` and label
    embeddings, the encoder's init and torch-default linears."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    frontend = _frontend_params_np(cfg, rng)
    embed = cfg.conv_feature_layers[-1][0]
    d = cfg.encoder_embed_dim
    final_dim = cfg.final_dim if cfg.final_dim > 0 else d
    n_proj = final_dim * (len(num_classes) if cfg.untie_final_proj else 1)
    params = {
        "feature_extractor": frontend,
        "layer_norm": {"scale": np.ones((embed,), f32),
                       "bias": np.zeros((embed,), f32)},
        "mask_emb": rng.uniform(0.0, 1.0, (d,)).astype(f32),
        "encoder": _encoder_params_np(cfg, rng),
        "final_proj": _uniform_linear(rng, d, n_proj),
        "label_embs_concat": rng.uniform(
            0.0, 1.0, (int(sum(num_classes)), final_dim)).astype(f32),
    }
    if embed != d:
        params["post_extract_proj"] = _uniform_linear(rng, embed, d)
    if cfg.target_glu:
        params["target_glu"] = _uniform_linear(rng, final_dim, 2 * final_dim)
    return params


def init_wav2vec2_params_np(cfg: Wav2Vec2Config, seed: int) -> dict:
    """Random wav2vec 2.0 params in the JAX layout, made with numpy from
    ``seed``, drawn from the distributions of
    ``speech_ssl_compression_tpu/models/wav2vec2.py::init_wav2vec2_params``
    (the numbers differ: JAX's generator is not numpy's): the frontend and
    encoder as HuBERT's, uniform ``mask_emb`` and codebook ``vars``, a
    N(0, 1) ``weight_proj`` with zero bias at depth 1 (torch-default
    linears past it) and torch-default linears elsewhere."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    embed = cfg.conv_feature_layers[-1][0]
    d = cfg.encoder_embed_dim
    final_dim = cfg.final_dim if cfg.final_dim > 0 else d
    params = {
        "feature_extractor": _frontend_params_np(cfg, rng),
        "layer_norm": {"scale": np.ones((embed,), f32),
                       "bias": np.zeros((embed,), f32)},
        "mask_emb": rng.uniform(0.0, 1.0, (d,)).astype(f32),
        "encoder": _encoder_params_np(cfg, rng),
        "final_proj": _uniform_linear(rng, d, final_dim),
    }
    if embed != d:
        params["post_extract_proj"] = _uniform_linear(rng, embed, d)
    if cfg.quantize_targets:
        vq_dim = cfg.latent_dim if cfg.latent_dim > 0 else final_dim
        n_logits = cfg.latent_groups * cfg.latent_vars
        if cfg.quantizer_depth > 1:
            inner = embed * cfg.quantizer_factor
            layers = [_uniform_linear(rng, embed if i == 0 else inner, inner)
                      for i in range(cfg.quantizer_depth - 1)]
            weight_proj = {"layers": layers
                           + [_uniform_linear(rng, inner, n_logits)]}
        else:
            weight_proj = {
                "kernel": rng.standard_normal((embed, n_logits)).astype(f32),
                "bias": np.zeros((n_logits,), f32)}
        params["quantizer"] = {
            "vars": rng.uniform(0.0, 1.0, (
                1, n_logits, vq_dim // cfg.latent_groups)).astype(f32),
            "weight_proj": weight_proj,
        }
        params["project_q"] = _uniform_linear(rng, vq_dim, final_dim)
    else:
        params["project_q"] = _uniform_linear(rng, embed, final_dim)
    return params


def load_wave_model(params: dict, cfg, upstream: str,
                    masks: Optional[dict] = None):
    """A float32 CPU model of ``upstream`` ("hubert": a ``HuBERTModel``
    whose class count comes from ``label_embs_concat``, one label set;
    "wav2vec2": a ``Wav2Vec2Model``) for ``cfg``, holding the JAX package's
    ``params`` (a JAX-layout tree of numpy arrays), through
    ``torch_convert.wave_params_to_state_dict``: the function that carries
    weights across. Weight-pruning masks are folded in first. Built on the
    meta device, as :func:`load_model`. The load is strict."""
    with torch.device("meta"):
        if upstream == "hubert":
            from ..models.hubert import HuBERTModel

            n_classes = int(np.shape(params["label_embs_concat"])[0])
            model = HuBERTModel(cfg, (n_classes,))
        else:
            from ..models.wav2vec2 import Wav2Vec2Model

            model = Wav2Vec2Model(cfg)
    sd = wave_params_to_state_dict(apply_masks(params, masks), upstream)
    model.load_state_dict({k: torch.tensor(np.asarray(v), dtype=torch.float32)
                           for k, v in sd.items()}, assign=True)
    return model


def wave_tree_from_named(named: Dict[str, torch.Tensor],
                         upstream: str) -> dict:
    """Tensors under the ``upstream`` model's parameter names (weights, or
    anything laid out like them: gradients, Adam moments) -> a JAX-layout
    numpy tree, the inverse of :func:`load_wave_model`'s mapping."""
    sd = {k: v.detach().float() for k, v in named.items()}
    return wave_state_dict_to_params(sd, upstream, keep_masks=False)[0]


def wave_model_from_named(named: Dict[str, torch.Tensor], cfg,
                          upstream: str,
                          num_classes: Optional[Sequence[int]] = None):
    """The waveform counterpart of :func:`model_from_named`: a
    ``HuBERTModel`` (of ``num_classes``; without them one label set, its
    class count from ``label_embs_concat``) or ``Wav2Vec2Model`` for
    ``cfg`` whose
    parameters are the tensors of ``named`` themselves (detached, on their
    device, no copy), built on the meta device; the rebuild after a head-
    or row-prune event. The load is strict."""
    if upstream == "hubert":
        from ..models.hubert import HuBERTModel

        if num_classes is None:
            num_classes = (int(named["label_embs_concat"].shape[0]),)
        with torch.device("meta"):
            model = HuBERTModel(cfg, num_classes)
    else:
        from ..models.wav2vec2 import Wav2Vec2Model

        with torch.device("meta"):
            model = Wav2Vec2Model(cfg)
    model.load_state_dict({k: v.detach() for k, v in named.items()},
                          assign=True)
    return model
