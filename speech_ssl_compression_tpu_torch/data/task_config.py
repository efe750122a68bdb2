"""The HuBERT task config: the port's copy of ``HubertTaskConfig`` from
``speech_ssl_compression_tpu/data/task_config.py`` (reference
task_config/hubert_task_config.py:3-22), a typed view of a runner YAML's
``task:`` section."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class HubertTaskConfig:
    data: Optional[str] = None
    fine_tuning: bool = False
    labels: List[str] = field(default_factory=lambda: ["km"])
    label_dir: Optional[str] = None
    label_rate: float = -1.0
    sample_rate: int = 16000
    normalize: bool = False
    enable_padding: bool = False
    max_keep_size: Optional[int] = None
    max_sample_size: Optional[int] = None
    min_sample_size: Optional[int] = None
    single_target: bool = False
    random_crop: bool = True
    pad_audio: bool = False

    @classmethod
    def from_dict(cls, cfg: dict) -> "HubertTaskConfig":
        known = cls.__dataclass_fields__.keys()
        return cls(**{k: v for k, v in cfg.items() if k in known})
