"""Configurations of the port, read without PyYAML.

``MelHuBERTConfig`` and ``HuBERTConfig`` are the port's own copies of the
JAX package's frozen dataclasses (``speech_ssl_compression_tpu/configs.py``)
with the same fields, defaults and ``from_dict``/``to_dict``, so a config
dict written by either package reads in the other.
:func:`read_yaml` reads the repository's YAML files (the model configs
under ``configs/*/config_model*.yaml`` with their ``melhubert:``,
``hubert:`` and ``task:`` sections, the runner configs with their nested
``runner:``, ``optimizer:``, ``datarc:``, ``lr_scheduler:``, ``task:`` and
``prune:`` sections and block lists such as ``betas:`` and ``sets:``) into
what ``yaml.safe_load`` gives, so a GPU machine running only the port needs
no PyYAML.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from dataclasses import dataclass
from typing import Tuple

__all__ = ["HuBERTConfig", "MelHuBERTConfig", "hubert_config_from_yaml",
           "melhubert_config_from_yaml", "read_yaml"]


def _per_layer(value, n_layers: int) -> Tuple[int, ...]:
    """Copy of the JAX ``configs._per_layer``: a scalar or a per-layer
    list as a tuple of ints."""
    if isinstance(value, (tuple, list)):
        assert len(value) == n_layers
        return tuple(int(v) for v in value)
    return tuple(int(value) for _ in range(n_layers))


def _resolve_head_dim(cfg: dict, heads, embed_dim: int) -> int:
    """Copy of the JAX ``configs._resolve_head_dim``: head_dim stays fixed
    under pruning, so per-layer head counts need an explicit head_dim."""
    if "head_dim" in cfg:
        return int(cfg["head_dim"])
    if isinstance(heads, int):
        return embed_dim // int(heads)
    raise ValueError(
        "config lists per-layer encoder_attention_heads "
        f"{list(heads)} without head_dim; set head_dim explicitly "
        "(it stays fixed under pruning, e.g. 64 for 768/12)"
    )


def _parse_conv_spec(spec: str):
    """Copy of the JAX ``configs._parse_conv_spec``: a fairseq-style conv
    spec such as "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2" as a
    list of triples, without eval()."""
    def ev(n):
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Add):
            return ev(n.left) + ev(n.right)
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult):
            return ev(n.left) * ev(n.right)
        if isinstance(n, (ast.List, ast.Tuple)):
            return [ev(e) for e in n.elts]
        if isinstance(n, ast.Constant) and isinstance(n.value, (int, float)):
            return n.value
        raise ValueError(f"unsupported conv spec node: {ast.dump(n)}")

    return [tuple(x) for x in ev(ast.parse(spec, mode="eval"))]


def _wave_config_to_dict(cfg) -> dict:
    """Copy of the JAX ``configs._wave_config_to_dict``: a JSON-friendly
    dict (lists for the tuple fields) that round-trips through
    ``from_dict``."""
    d = dataclasses.asdict(cfg)
    d["encoder_ffn_embed_dim"] = list(cfg.encoder_ffn_embed_dim)
    d["encoder_attention_heads"] = list(cfg.encoder_attention_heads)
    d["conv_feature_layers"] = [list(c) for c in cfg.conv_feature_layers]
    d["latent_temp"] = list(cfg.latent_temp)
    return d


@dataclass(frozen=True)
class MelHuBERTConfig:
    """Copy of the JAX ``configs.MelHuBERTConfig`` (reference
    model_config.py:1-47, defaults included)."""

    feat_emb_dim: int = 40  # 40 (10 ms) or 80 (20 ms frame-stacked)
    pos_emb_type: str = "conv"
    pos_conv_depth: int = 1
    conv_pos: int = 128
    conv_pos_groups: int = 16
    encoder_layers: int = 1
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: Tuple[int, ...] = (3072,)
    encoder_attention_heads: Tuple[int, ...] = (12,)
    head_dim: int = 64  # embed_dim // original head count; fixed under pruning
    activation_fn: str = "gelu"
    layer_norm_first: bool = False
    attention_type: str = "original"  # "original" | "causal"
    num_cluster: int = 512
    final_dim: int = 40
    pred_masked_weight: float = 1.0
    pred_nomask_weight: float = 0.0
    mask_prob: float = 0.8
    mask_length: int = 10
    mask_selection: str = "static"
    mask_other: float = 0.0
    no_mask_overlap: bool = False
    mask_min_space: int = 1
    skip_masked: bool = False
    skip_nomask: bool = True
    learnable_mask_emb: bool = False
    mask_before_proj: bool = True
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    encoder_layerdrop: float = 0.0

    @classmethod
    def from_dict(cls, cfg: dict) -> "MelHuBERTConfig":
        n_layers = int(cfg.get("encoder_layers", 1))
        embed_dim = int(cfg.get("encoder_embed_dim", 768))
        heads = cfg.get("encoder_attention_heads", 12)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in cfg.items() if k in known}
        kwargs["encoder_layers"] = n_layers
        kwargs["encoder_embed_dim"] = embed_dim
        kwargs["encoder_ffn_embed_dim"] = _per_layer(
            cfg.get("encoder_ffn_embed_dim", 3072), n_layers)
        kwargs["encoder_attention_heads"] = _per_layer(heads, n_layers)
        kwargs["head_dim"] = _resolve_head_dim(cfg, heads, embed_dim)
        return cls(**kwargs)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["encoder_ffn_embed_dim"] = list(self.encoder_ffn_embed_dim)
        d["encoder_attention_heads"] = list(self.encoder_attention_heads)
        return d

    def with_heads(self, heads_per_layer) -> "MelHuBERTConfig":
        return dataclasses.replace(
            self, encoder_attention_heads=tuple(int(h) for h in heads_per_layer))

    def with_ffn_dims(self, ffn_per_layer) -> "MelHuBERTConfig":
        return dataclasses.replace(
            self, encoder_ffn_embed_dim=tuple(int(f) for f in ffn_per_layer))


@dataclass(frozen=True)
class HuBERTConfig:
    """Copy of the JAX ``configs.HuBERTConfig`` (reference
    model_config.py:49-115). ``conv_frontend_impl`` keeps the JAX values:
    "tc_pallas" runs the frontend's strided convolutions through the
    port's CUDA kernels (``ops/conv1d.py``); every other value ("auto",
    "tc_conv", "nch" and the TPU layout variants "tc_fold", "tc_matmul",
    "tc_taps", which compute the same function) runs them through cuDNN.
    ``conv_frontend_barrier`` is a TPU compiler knob with no effect here."""

    label_rate: int = 50
    extractor_mode: str = "default"
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: Tuple[int, ...] = (3072,) * 12
    encoder_attention_heads: Tuple[int, ...] = (12,) * 12
    head_dim: int = 64
    activation_fn: str = "gelu"
    layer_type: str = "transformer"
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    encoder_layerdrop: float = 0.0
    dropout_input: float = 0.0
    dropout_features: float = 0.0
    final_dim: int = 0
    untie_final_proj: bool = False
    layer_norm_first: bool = False
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 2, 2), (512, 2, 2),
    )
    conv_bias: bool = False
    logit_temp: float = 0.1
    target_glu: bool = False
    feature_grad_mult: float = 1.0
    mask_length: int = 10
    mask_prob: float = 0.65
    mask_selection: str = "static"
    mask_other: float = 0.0
    no_mask_overlap: bool = False
    mask_min_space: int = 1
    mask_channel_length: int = 10
    mask_channel_prob: float = 0.0
    mask_channel_selection: str = "static"
    mask_channel_other: float = 0.0
    no_mask_channel_overlap: bool = False
    mask_channel_min_space: int = 1
    pos_emb_type: str = "conv"
    conv_pos: int = 128
    conv_pos_groups: int = 16
    pos_conv_depth: int = 1
    latent_temp: Tuple[float, float, float] = (2.0, 0.5, 0.999995)
    skip_masked: bool = False
    skip_nomask: bool = False
    checkpoint_activations: bool = False
    required_seq_len_multiple: int = 2
    conv_frontend_impl: str = "auto"
    conv_frontend_barrier: object = False

    @classmethod
    def from_dict(cls, cfg: dict) -> "HuBERTConfig":
        n_layers = int(cfg.get("encoder_layers", 12))
        embed_dim = int(cfg.get("encoder_embed_dim", 768))
        heads = cfg.get("encoder_attention_heads", 12)
        conv_spec = cfg.get(
            "conv_feature_layers",
            "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2")
        if isinstance(conv_spec, str):
            conv_spec = _parse_conv_spec(conv_spec)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in cfg.items() if k in known}
        kwargs["encoder_layers"] = n_layers
        kwargs["encoder_ffn_embed_dim"] = _per_layer(
            cfg.get("encoder_ffn_embed_dim", 3072), n_layers)
        kwargs["encoder_attention_heads"] = _per_layer(heads, n_layers)
        kwargs["head_dim"] = _resolve_head_dim(cfg, heads, embed_dim)
        kwargs["conv_feature_layers"] = tuple(tuple(c) for c in conv_spec)
        if "latent_temp" in cfg:
            kwargs["latent_temp"] = tuple(float(x) for x in cfg["latent_temp"])
        return cls(**kwargs)

    def to_dict(self) -> dict:
        return _wave_config_to_dict(self)

    def with_heads(self, heads_per_layer) -> "HuBERTConfig":
        return dataclasses.replace(
            self, encoder_attention_heads=tuple(int(h) for h in heads_per_layer))

    def with_ffn_dims(self, ffn_per_layer) -> "HuBERTConfig":
        return dataclasses.replace(
            self, encoder_ffn_embed_dim=tuple(int(f) for f in ffn_per_layer))

# PyYAML's (YAML 1.1) resolvers for the plain scalars the configs use
_BOOLS = {**dict.fromkeys("yes Yes YES true True TRUE on On ON".split(), True),
          **dict.fromkeys("no No NO false False FALSE off Off OFF".split(),
                          False)}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
_FLOAT = re.compile(
    r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?")
_SPECIAL_FLOATS = {
    **{s + inf: float(s + "inf") for s in ("", "+", "-")
       for inf in (".inf", ".Inf", ".INF")},
    **dict.fromkeys((".nan", ".NaN", ".NAN"), float("nan")),
}


def _scalar(text: str):
    text = text.strip()
    if text in _NULLS:
        return None
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        if "\\" in text:
            raise ValueError(f"escapes in double-quoted scalars: {text!r}")
        return text[1:-1]
    if text[0] in "[{|>&*!%@`":
        raise ValueError(f"unsupported YAML: {text!r}")
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _block(lines, i, indent):
    """Parse the mapping or block list at ``indent`` from line ``i``;
    returns (value, next line)."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out = []
        while i < len(lines) and lines[i][0] == indent \
                and lines[i][1].startswith("-"):
            item = lines[i][1][1:].strip()
            if ":" in item.split("'")[0].split('"')[0]:
                raise ValueError(f"mappings in lists: {lines[i][1]!r}")
            out.append(_scalar(item))
            i += 1
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        key, sep, rest = lines[i][1].partition(":")
        if not sep or key.startswith("-"):
            raise ValueError(f"not a 'key: value' line: {lines[i][1]!r}")
        i += 1
        if rest.strip():
            out[key.strip()] = _scalar(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[key.strip()], i = _block(lines, i, lines[i][0])
        else:
            out[key.strip()] = None
    return out, i


def read_yaml(path: str | os.PathLike):
    """The subset of YAML the repository's configs use: nested mappings,
    block lists of scalars, plain and quoted scalars, with
    PyYAML's resolution of booleans, integers, floats and nulls. Raises on
    anything else."""
    lines = []
    with open(path) as f:
        for raw in f:
            text = _strip_comment(raw.rstrip("\n")).rstrip()
            if text.strip():
                if "\t" in text[: len(text) - len(text.lstrip())]:
                    raise ValueError(f"{path}: tab indentation")
                lines.append((len(text) - len(text.lstrip()), text.strip()))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"{path}: cannot parse line {lines[i][1]!r}")
    return value


def melhubert_config_from_yaml(path: str | os.PathLike) -> MelHuBERTConfig:
    """The ``melhubert:`` section of a model YAML such as
    ``configs/melhubert/config_model_20ms.yaml``, as ``train.py`` reads it
    with ``yaml.safe_load``."""
    section = (read_yaml(path) or {}).get("melhubert")
    if not section:
        raise ValueError(f"{path}: no 'melhubert:' section")
    return MelHuBERTConfig.from_dict(section)


def hubert_config_from_yaml(path: str | os.PathLike) -> HuBERTConfig:
    """The ``hubert:`` section of a model YAML such as
    ``configs/hubert/config_model.yaml``, as ``train.py -u hubert`` reads
    it with ``yaml.safe_load``."""
    section = (read_yaml(path) or {}).get("hubert")
    if not section:
        raise ValueError(f"{path}: no 'hubert:' section")
    return HuBERTConfig.from_dict(section)
