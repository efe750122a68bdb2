"""The weight bridge between state dicts in the reference naming and the
JAX-layout parameter trees (nested dicts of numpy arrays).

The port's copy of what it uses of
``speech_ssl_compression_tpu/utils/torch_convert.py``: the MelHuBERT
direction both ways (``params_to_state_dict``,
``melhubert_state_dict_to_params``), the reference ``.ckpt`` loader
(``load_reference_checkpoint``), the HuBERT and wav2vec 2.0 directions
both ways (``wave_state_dict_to_params``, ``wave_params_to_state_dict``;
wav2vec 2.0's ``quantizer.vars``, depth-1 and deep ``weight_proj`` and
``project_q`` included), their ``-i`` loaders
(``load_wave_initial_weight``, ``load_wave_reference_checkpoint``) and
``infer_pruned_dims``, and the pipeline's stage-split tree
(``split_pipeline_tree``, ``merge_pipeline_tree``: JAX's
``parallel/pipeline.py::split_pipeline_params`` and
``merge_pipeline_params`` on numpy trees). Linear
kernels are (in, out) in the trees and (out, in) in the state dicts;
weight-pruned state dicts hold ``weight_orig``/``weight_mask`` pairs.
Everything goes out as numpy.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import HuBERTConfig, MelHuBERTConfig, Wav2Vec2Config


def _to_np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def kernel_from_weight(w) -> np.ndarray:
    """A Linear's (out, in) weight (or anything laid out like it) -> its
    (in, out) kernel, float32 and C-contiguous, as JAX's host arrays are:
    a float32 sum over a slice rounds by the memory order it adds in. A
    tensor is transposed on its own device before it is copied to the
    host, which gives the same bytes as numpy's strided transpose on the
    host, in about half a full-width checkpoint save's time."""
    if isinstance(w, torch.Tensor):
        return w.detach().float().t().contiguous().cpu().numpy()
    return np.ascontiguousarray(_to_np(w).T, np.float32)


def _linear(sd: dict, prefix: str) -> dict:
    """torch Linear (out, in) -> {"kernel": (in, out), "bias": (out,)},
    folding a ``weight_orig``/``weight_mask`` pair."""
    out = {}
    for name, key in (("kernel", "weight"), ("bias", "bias")):
        if f"{prefix}.{key}" in sd:
            val = sd[f"{prefix}.{key}"]
        elif f"{prefix}.{key}_orig" in sd:
            val = _to_np(sd[f"{prefix}.{key}_orig"]) * _to_np(
                sd[f"{prefix}.{key}_mask"])
        else:
            raise KeyError(f"{prefix}.{key}")
        out[name] = (kernel_from_weight(val) if name == "kernel"
                     else np.ascontiguousarray(_to_np(val), np.float32))
    return out


def _linear_mask(sd: dict, prefix: str) -> Optional[dict]:
    if f"{prefix}.weight_mask" not in sd:
        return None
    m = {"kernel": kernel_from_weight(sd[f"{prefix}.weight_mask"])}
    if f"{prefix}.bias_mask" in sd:
        m["bias"] = _to_np(sd[f"{prefix}.bias_mask"]).astype(np.float32)
    return m


def _layer_norm(sd: dict, prefix: str) -> dict:
    return {
        "scale": _to_np(sd[f"{prefix}.weight"]).astype(np.float32),
        "bias": _to_np(sd[f"{prefix}.bias"]).astype(np.float32),
    }


def _encoder_from_sd(sd: dict) -> Tuple[dict, dict, bool, list, list]:
    """The shared encoder section (``encoder.pos_conv.0.*``,
    ``encoder.layers.{i}.*``, ``encoder.layer_norm``) as a tree. Returns
    (enc, masks, any_mask, qkv_out_dims, ffn_dims)."""
    layer_ids = sorted({int(m.group(1)) for k in sd
                        for m in [re.match(r"encoder\.layers\.(\d+)\.", k)]
                        if m})
    f32 = lambda key: _to_np(sd[key]).astype(np.float32)
    if "encoder.pos_conv.0.0.weight" in sd:
        # pos_conv_depth > 1: blocks encoder.pos_conv.{i}.0.*
        depth_ids = sorted(
            int(m.group(1)) for k in sd
            for m in [re.match(r"encoder\.pos_conv\.(\d+)\.0\.weight$", k)] if m)
        pos_conv = {"layers": [
            {"weight": f32(f"encoder.pos_conv.{i}.0.weight"),
             "bias": f32(f"encoder.pos_conv.{i}.0.bias")} for i in depth_ids]}
    else:
        pos_conv = {"weight_g": f32("encoder.pos_conv.0.weight_g"),
                    "weight_v": f32("encoder.pos_conv.0.weight_v"),
                    "bias": f32("encoder.pos_conv.0.bias")}
    enc = {"pos_conv": pos_conv,
           "layer_norm": _layer_norm(sd, "encoder.layer_norm"),
           "layers": []}
    masks: dict = {}
    qkv_out_dims, ffn_dims = [], []
    any_mask = False
    for i in layer_ids:
        pre = f"encoder.layers.{i}"
        prefixes = {
            "q_proj": f"{pre}.self_attn.q_proj",
            "k_proj": f"{pre}.self_attn.k_proj",
            "v_proj": f"{pre}.self_attn.v_proj",
            "out_proj": f"{pre}.self_attn.out_proj",
            "fc1": f"{pre}.fc1",
            "fc2": f"{pre}.fc2",
        }
        lp = {name: _linear(sd, p) for name, p in prefixes.items()}
        lp["self_attn_layer_norm"] = _layer_norm(sd, f"{pre}.self_attn_layer_norm")
        lp["final_layer_norm"] = _layer_norm(sd, f"{pre}.final_layer_norm")
        enc["layers"].append(lp)
        qkv_out_dims.append(lp["q_proj"]["kernel"].shape[1])
        ffn_dims.append(lp["fc1"]["kernel"].shape[1])
        lm = {}
        for name, p in prefixes.items():
            m = _linear_mask(sd, p)
            if m is not None:
                lm[name] = m
                any_mask = True
        masks[f"layer_{i}"] = lm
    return enc, masks, any_mask, qkv_out_dims, ffn_dims


def melhubert_state_dict_to_params(
    sd: Dict[str, "np.ndarray"], keep_masks: bool = True,
) -> Tuple[dict, Optional[dict], dict]:
    """Copy of the JAX ``melhubert_state_dict_to_params``: a MelHuBERT
    state dict -> (params, masks or None, arch_info with ``n_layers``,
    ``qkv_out_dims`` and ``ffn_per_layer``)."""
    params: dict = {}
    if "pre_extract_proj.weight" in sd:
        params["pre_extract_proj"] = _linear(sd, "pre_extract_proj")
    if "mask_emb" in sd:
        params["mask_emb"] = _to_np(sd["mask_emb"]).astype(np.float32)
    params["final_proj"] = _linear(sd, "final_proj")
    enc, masks, any_mask, qkv_out_dims, ffn_dims = _encoder_from_sd(sd)
    params["encoder"] = enc
    arch_info = {"n_layers": len(enc["layers"]), "qkv_out_dims": qkv_out_dims,
                 "ffn_per_layer": ffn_dims}
    return params, (masks if any_mask and keep_masks else None), arch_info


def load_reference_checkpoint(path: str, *, trust_pickle: bool = False):
    """Copy of the JAX ``load_reference_checkpoint``: a reference MelHuBERT
    ``.ckpt`` (a ``torch.save`` dict) -> (params, masks, MelHuBERTConfig
    with per-layer heads and FFN widths, extras). Loads with
    ``weights_only=True`` unless ``trust_pickle`` allows running code
    pickled in the file."""
    import torch

    try:
        all_states = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as safe_err:
        if not trust_pickle:
            raise ValueError(
                f"{path} needs full (unsafe) unpickling "
                f"({type(safe_err).__name__}: {safe_err}). Unpickling "
                "executes code embedded in the file; pass trust_pickle=True "
                "only for checkpoints from a source you trust."
            ) from safe_err
        all_states = torch.load(path, map_location="cpu", weights_only=False)
    up_cfg = all_states["Upstream_Config"]
    cfg_dict = dict(up_cfg.get("melhubert") or up_cfg.get("hubert")
                    or up_cfg.get("student"))
    params, mask_tree, arch_info = melhubert_state_dict_to_params(
        all_states["model"])
    cfg = MelHuBERTConfig.from_dict(cfg_dict)
    heads = tuple(d // cfg.head_dim for d in arch_info["qkv_out_dims"])
    cfg = cfg.with_heads(heads).with_ffn_dims(arch_info["ffn_per_layer"])
    extras = {k: all_states[k]
              for k in ("Pruned_heads", "Pruning", "Step", "TotalStep")
              if k in all_states}
    return params, mask_tree, cfg, extras


def _conv_frontend_from_sd(sd: dict, prefix: str = "feature_extractor") -> list:
    """Copy of the JAX ``_conv_frontend_from_sd``: the conv frontend's keys
    (``{prefix}.conv_layers.{i}.0.weight`` (O, I, K), optional ``.0.bias``,
    ``.2.weight``/``.2.bias`` for the GroupNorm of the default mode or
    ``.2.1.weight``/``.2.1.bias`` for the LayerNorm mode) as a list of
    per-layer dicts."""
    layer_ids = sorted({
        int(m.group(1)) for k in sd
        for m in [re.match(rf"{re.escape(prefix)}\.conv_layers\.(\d+)\.", k)]
        if m})
    layers = []
    for i in layer_ids:
        p = f"{prefix}.conv_layers.{i}"
        layer = {"weight": _to_np(sd[f"{p}.0.weight"]).astype(np.float32)}
        if f"{p}.0.bias" in sd:
            layer["bias"] = _to_np(sd[f"{p}.0.bias"]).astype(np.float32)
        if f"{p}.2.weight" in sd:
            layer["group_norm"] = _layer_norm(sd, f"{p}.2")
        elif f"{p}.2.1.weight" in sd:
            layer["layer_norm"] = _layer_norm(sd, f"{p}.2.1")
        layers.append(layer)
    return layers


def _quantizer_from_sd(sd: dict) -> dict:
    """wav2vec 2.0's ``quantizer.vars`` and ``quantizer.weight_proj``: a
    Linear at depth 1 (``weight_orig``/``weight_mask`` folded), or at
    depth > 1 the [Linear, GELU] blocks ``weight_proj.{i}.0.*`` and the
    logits Linear ``weight_proj.{depth - 1}.*`` (reference
    gumbel_vector_quantizer.py:64-76)."""
    block = re.compile(r"quantizer\.weight_proj\.(\d+)\.0\.weight(_orig)?$")
    ids = sorted(int(m.group(1)) for k in sd for m in [block.match(k)] if m)
    if ids:
        layers = [_linear(sd, f"quantizer.weight_proj.{i}.0") for i in ids]
        layers.append(_linear(sd, f"quantizer.weight_proj.{len(ids)}"))
        weight_proj = {"layers": layers}
    else:
        weight_proj = _linear(sd, "quantizer.weight_proj")
    return {"vars": _to_np(sd["quantizer.vars"]).astype(np.float32),
            "weight_proj": weight_proj}


def wave_state_dict_to_params(
    sd: Dict[str, "np.ndarray"], upstream: str, keep_masks: bool = True,
) -> Tuple[dict, Optional[dict], dict]:
    """Copy of the JAX ``wave_state_dict_to_params``: a HuBERT or wav2vec
    2.0 state dict (``feature_extractor``, ``layer_norm``, ``mask_emb``,
    ``final_proj``, optional ``post_extract_proj`` and ``target_glu.0``,
    the encoder; HuBERT's ``label_embs_concat``, wav2vec 2.0's
    ``quantizer`` and ``project_q``) -> (params, masks, arch_info)."""
    if upstream not in ("hubert", "wav2vec2"):
        raise NotImplementedError(f"upstream {upstream!r}")
    params: dict = {
        "feature_extractor": _conv_frontend_from_sd(sd),
        "layer_norm": _layer_norm(sd, "layer_norm"),
        "mask_emb": _to_np(sd["mask_emb"]).astype(np.float32),
        "final_proj": _linear(sd, "final_proj"),
    }
    if "post_extract_proj.weight" in sd:
        params["post_extract_proj"] = _linear(sd, "post_extract_proj")
    if "target_glu.0.weight" in sd:
        params["target_glu"] = _linear(sd, "target_glu.0")
    if upstream == "hubert":
        params["label_embs_concat"] = _to_np(
            sd["label_embs_concat"]).astype(np.float32)
    else:
        if "quantizer.vars" in sd:
            params["quantizer"] = _quantizer_from_sd(sd)
        params["project_q"] = _linear(sd, "project_q")
    enc, masks, any_mask, qkv_out_dims, ffn_dims = _encoder_from_sd(sd)
    params["encoder"] = enc
    arch_info = {"n_layers": len(enc["layers"]), "qkv_out_dims": qkv_out_dims,
                 "ffn_per_layer": ffn_dims}
    return params, (masks if any_mask and keep_masks else None), arch_info


def load_wave_initial_weight(path: str, upstream: str, cfg):
    """Copy of the JAX ``load_wave_initial_weight``: the full
    ``-i initial_weight`` load of the waveform trainer, from the JAX
    package's npz or a reference ``.ckpt``; the per-layer heads and FFN
    widths of a structurally pruned start come from the array shapes, and
    the weight-pruning masks are kept (training goes on at the
    checkpoint's sparsity).

    Returns (params, masks, cfg, meta, opt_leaves, opt_treedef) with numpy
    leaves; opt_leaves is None without optimizer state."""
    opt_leaves = opt_treedef = None
    if path.endswith(".npz"):
        from .checkpoint import load_checkpoint

        state = load_checkpoint(path)
        params, masks = state["params"], state["masks"]
        meta = state["meta"] or {}
        opt_leaves = state["opt_leaves"] or None
        opt_treedef = state["opt_treedef"]
        # "Config" is the exact (possibly pruned, per-layer) dataclass
        # dump; "Upstream_Config" the original YAML: the former first
        meta_cfg = meta.get("Config") or (
            meta.get("Upstream_Config", {}).get(upstream))
        if meta_cfg:
            cfg = type(cfg).from_dict(meta_cfg)
    else:
        params, masks, ckpt_cfg, meta = load_wave_reference_checkpoint(
            path, upstream)
        if ckpt_cfg is not None:
            cfg = ckpt_cfg
    heads, ffns = infer_pruned_dims(params, cfg.head_dim)
    cfg = cfg.with_heads(heads).with_ffn_dims(ffns)
    return params, masks, cfg, meta, opt_leaves, opt_treedef


def load_wave_reference_checkpoint(path: str, upstream: str, *,
                                   trust_pickle: bool = False):
    """Copy of the JAX ``load_wave_reference_checkpoint``: a reference
    ``.ckpt`` (a ``torch.save`` dict) -> (params, masks, HuBERTConfig or
    Wav2Vec2Config or None, extras), the architecture rebuilt from the
    checkpoint's metadata (reference upstream/hubert/pretrain_expert.py:
    41-90, upstream/wav2vec2/pretrain_expert.py:41-78). Loads with
    ``weights_only=True`` unless ``trust_pickle``."""
    import torch

    if upstream not in ("hubert", "wav2vec2"):
        raise NotImplementedError(f"upstream {upstream!r}")
    try:
        all_states = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as safe_err:
        if not trust_pickle:
            raise ValueError(
                f"{path} needs full (unsafe) unpickling "
                f"({type(safe_err).__name__}: {safe_err}). Unpickling "
                "executes code embedded in the file; pass trust_pickle=True "
                "only for checkpoints from a source you trust."
            ) from safe_err
        all_states = torch.load(path, map_location="cpu", weights_only=False)
    cfg_cls = HuBERTConfig if upstream == "hubert" else Wav2Vec2Config
    cfg = None
    up_cfg = all_states.get("Upstream_Config") or {}
    if up_cfg.get(upstream):
        cfg = cfg_cls.from_dict(dict(up_cfg[upstream]))
    params, mask_tree, arch_info = wave_state_dict_to_params(
        all_states["model"], upstream)
    if cfg is not None:
        heads = tuple(d // cfg.head_dim for d in arch_info["qkv_out_dims"])
        cfg = cfg.with_heads(heads).with_ffn_dims(arch_info["ffn_per_layer"])
    extras = {k: all_states[k]
              for k in ("Pruned_heads", "Pruning", "Step", "TotalStep")
              if k in all_states}
    return params, mask_tree, cfg, extras


def wave_params_to_state_dict(params: dict, upstream: str,
                              masks: Optional[dict] = None) -> dict:
    """Copy of the JAX ``wave_params_to_state_dict``: the inverse of
    :func:`wave_state_dict_to_params` (numpy, reference naming; masks give
    ``weight_orig``/``weight_mask`` pairs on encoder leaves)."""
    if upstream not in ("hubert", "wav2vec2"):
        raise NotImplementedError(f"upstream {upstream!r}")
    sd: dict = {}
    for i, layer in enumerate(params["feature_extractor"]):
        p = f"feature_extractor.conv_layers.{i}"
        sd[f"{p}.0.weight"] = np.asarray(layer["weight"])
        if "bias" in layer:
            sd[f"{p}.0.bias"] = np.asarray(layer["bias"])
        for norm, key in (("group_norm", f"{p}.2"), ("layer_norm", f"{p}.2.1")):
            if norm in layer:
                sd[f"{key}.weight"] = np.asarray(layer[norm]["scale"])
                sd[f"{key}.bias"] = np.asarray(layer[norm]["bias"])

    def put_linear(prefix, p):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])

    sd["layer_norm.weight"] = np.asarray(params["layer_norm"]["scale"])
    sd["layer_norm.bias"] = np.asarray(params["layer_norm"]["bias"])
    sd["mask_emb"] = np.asarray(params["mask_emb"])
    put_linear("final_proj", params["final_proj"])
    if "post_extract_proj" in params:
        put_linear("post_extract_proj", params["post_extract_proj"])
    if "target_glu" in params:
        put_linear("target_glu.0", params["target_glu"])
    if upstream == "hubert":
        sd["label_embs_concat"] = np.asarray(params["label_embs_concat"])
    else:
        if "quantizer" in params:
            sd["quantizer.vars"] = np.asarray(params["quantizer"]["vars"])
            wp = params["quantizer"]["weight_proj"]
            if "layers" in wp:  # quantizer_depth > 1
                *blocks, final = wp["layers"]
                for i, lp in enumerate(blocks):
                    put_linear(f"quantizer.weight_proj.{i}.0", lp)
                put_linear(f"quantizer.weight_proj.{len(blocks)}", final)
            else:
                put_linear("quantizer.weight_proj", wp)
        put_linear("project_q", params["project_q"])
    enc_sd = params_to_state_dict(
        {"encoder": params["encoder"], "final_proj": params["final_proj"]},
        masks)
    sd.update({k: v for k, v in enc_sd.items() if k.startswith("encoder.")})
    return sd


def params_to_state_dict(params: dict, masks: Optional[dict] = None) -> dict:
    """Copy of the JAX ``params_to_state_dict``: a MelHuBERT tree -> a
    numpy state dict in the reference naming, with
    ``weight_orig``/``weight_mask`` pairs for the leaves ``masks`` prunes."""
    sd = {}

    def put_linear(prefix, p, m=None):
        if m is None:
            sd[f"{prefix}.weight"] = np.ascontiguousarray(p["kernel"].T)
            sd[f"{prefix}.bias"] = np.asarray(p["bias"])
            return
        sd[f"{prefix}.weight_orig"] = np.ascontiguousarray(p["kernel"].T)
        sd[f"{prefix}.weight_mask"] = np.ascontiguousarray(m["kernel"].T)
        if "bias" in m:
            sd[f"{prefix}.bias_orig"] = np.asarray(p["bias"])
            sd[f"{prefix}.bias_mask"] = np.asarray(m["bias"])
        else:
            sd[f"{prefix}.bias"] = np.asarray(p["bias"])

    def put_ln(prefix, p):
        sd[f"{prefix}.weight"] = np.asarray(p["scale"])
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])

    if "pre_extract_proj" in params:
        put_linear("pre_extract_proj", params["pre_extract_proj"])
    if "mask_emb" in params:
        sd["mask_emb"] = np.asarray(params["mask_emb"])
    put_linear("final_proj", params["final_proj"])
    enc = params.get("encoder")
    if enc is None:  # a 0-layer student has no encoder subtree
        return sd
    if "layers" in enc["pos_conv"]:  # pos_conv_depth > 1
        for i, lp in enumerate(enc["pos_conv"]["layers"]):
            sd[f"encoder.pos_conv.{i}.0.weight"] = np.asarray(lp["weight"])
            sd[f"encoder.pos_conv.{i}.0.bias"] = np.asarray(lp["bias"])
    else:
        for leaf in ("weight_g", "weight_v", "bias"):
            sd[f"encoder.pos_conv.0.{leaf}"] = np.asarray(enc["pos_conv"][leaf])
    put_ln("encoder.layer_norm", enc["layer_norm"])
    for i, lp in enumerate(enc["layers"]):
        pre = f"encoder.layers.{i}"
        lm = (masks or {}).get(f"layer_{i}", {})
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put_linear(f"{pre}.self_attn.{name}", lp[name], lm.get(name))
        put_ln(f"{pre}.self_attn_layer_norm", lp["self_attn_layer_norm"])
        put_linear(f"{pre}.fc1", lp["fc1"], lm.get("fc1"))
        put_linear(f"{pre}.fc2", lp["fc2"], lm.get("fc2"))
        put_ln(f"{pre}.final_layer_norm", lp["final_layer_norm"])
    return sd


def infer_pruned_dims(params: dict, head_dim: int):
    """Copy of the JAX ``infer_pruned_dims``: per-layer (heads, ffn widths)
    from the parameter shapes of a head- or row-pruned tree."""
    layers = params.get("encoder", {}).get("layers", [])
    heads = tuple(int(l["q_proj"]["kernel"].shape[1]) // head_dim
                  for l in layers)
    ffns = tuple(int(l["fc1"]["kernel"].shape[1]) for l in layers)
    return heads, ffns


def _map_tree(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map_tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def split_pipeline_tree(params: dict, n_stages: int) -> dict:
    """A JAX-layout MelHuBERT tree -> JAX's pipeline tree ``{"rep": ...,
    "stages": ...}`` (``split_pipeline_params``): the encoder layers
    stacked into (S, L/S, ...) leaves, everything else under "rep"."""
    layers = params["encoder"]["layers"]
    if n_stages < 1 or len(layers) % n_stages != 0:
        raise ValueError(f"{len(layers)} encoder layers do not split into "
                         f"{n_stages} stages")
    per = len(layers) // n_stages
    stages = _map_tree(lambda *xs: np.stack([np.asarray(x) for x in xs])
                       .reshape((n_stages, per) + np.shape(xs[0])), *layers)
    rep = {k: v for k, v in params.items() if k != "encoder"}
    rep["encoder"] = {k: v for k, v in params["encoder"].items()
                      if k != "layers"}
    return {"rep": rep, "stages": stages}


def merge_pipeline_tree(pp: dict) -> dict:
    """Inverse of :func:`split_pipeline_tree` (JAX's
    ``merge_pipeline_params``)."""
    stages = pp["stages"]
    lead = next(iter(_leaves(stages))).shape
    n_layers = lead[0] * lead[1]
    flat = _map_tree(lambda a: np.asarray(a).reshape(
        (n_layers,) + np.shape(a)[2:]), stages)
    layers = [_map_tree(lambda a, i=i: a[i], flat) for i in range(n_layers)]
    params = {k: v for k, v in pp["rep"].items() if k != "encoder"}
    params["encoder"] = dict(pp["rep"]["encoder"], layers=layers)
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
