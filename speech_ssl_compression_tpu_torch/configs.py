"""Model configurations of the port.

``MelHuBERTConfig`` is the JAX package's own dataclass
(``speech_ssl_compression_tpu/configs.py``, a module that imports no JAX),
re-exported here so that callers of the port take it from the port.
:func:`melhubert_config_from_yaml` reads the model YAMLs under
``configs/melhubert/`` without PyYAML, which a GPU machine running only the
port need not have.
"""

from __future__ import annotations

import os

from speech_ssl_compression_tpu.configs import MelHuBERTConfig

__all__ = ["MelHuBERTConfig", "melhubert_config_from_yaml"]


def _scalar(text: str):
    if text in ("true", "false"):
        return text == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def melhubert_config_from_yaml(path: str | os.PathLike) -> MelHuBERTConfig:
    """The ``melhubert:`` section of a model YAML such as
    ``configs/melhubert/config_model_20ms.yaml``, as ``train.py`` reads it
    with ``yaml.safe_load``. Takes the flat ``key: scalar`` layout those
    files have and raises on anything else (lists, nesting)."""
    section, out = None, {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            if not line[0].isspace():
                section = line.rstrip(":").strip()
                continue
            if section != "melhubert":
                continue
            key, sep, val = (s.strip() for s in line.partition(":"))
            if not sep or not val or val[0] in "[{|>&*!":
                raise ValueError(f"{path}: not a 'key: scalar' line: {line!r}")
            out[key] = _scalar(val)
    if not out:
        raise ValueError(f"{path}: no 'melhubert:' section")
    return MelHuBERTConfig.from_dict(out)
