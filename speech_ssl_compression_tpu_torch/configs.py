"""Configurations of the port, read without PyYAML.

``MelHuBERTConfig`` is the JAX package's own dataclass
(``speech_ssl_compression_tpu/configs.py``, a module that imports no JAX),
re-exported here so that callers of the port take it from the port.
:func:`read_yaml` reads the repository's YAML files (the model configs
under ``configs/*/config_model*.yaml`` with their ``melhubert:`` and
``task:`` sections, the runner configs with their nested ``runner:``,
``optimizer:``, ``datarc:``, ``lr_scheduler:`` and ``prune:`` sections and
block lists such as ``betas:`` and ``sets:``) into what ``yaml.safe_load``
gives, so a GPU machine running only the port needs no PyYAML.
"""

from __future__ import annotations

import os
import re

from speech_ssl_compression_tpu.configs import MelHuBERTConfig

__all__ = ["MelHuBERTConfig", "melhubert_config_from_yaml", "read_yaml"]

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
