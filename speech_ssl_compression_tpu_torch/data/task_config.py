"""The waveform task configs: the port's copies of ``HubertTaskConfig`` and
``Wav2vec2TaskConfig`` from ``speech_ssl_compression_tpu/data/task_config.py``
(reference task_config/hubert_task_config.py:3-22 and
task_config/wav2vec2_task_config.py:1-29), typed views of a runner YAML's
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


@dataclass
class Wav2vec2TaskConfig:
    """Copy of the JAX ``Wav2vec2TaskConfig`` (reference
    task_config/wav2vec2_task_config.py:1-29); with
    ``precompute_mask_config`` set the dataset draws block masks
    (``ops/block_masking.py``) per batch."""

    data: Optional[str] = None
    labels: Optional[str] = None
    binarized_dataset: bool = False
    sample_rate: int = 16000
    normalize: bool = False
    enable_padding: bool = False
    max_sample_size: Optional[int] = None
    min_sample_size: Optional[int] = None
    num_batch_buckets: int = 8
    text_compression_level: int = 0
    rebuild_batches: bool = True
    subsample: float = 1.0
    seed: int = 1337
    precompute_mask_config: Optional[dict] = None

    @classmethod
    def from_dict(cls, cfg: dict) -> "Wav2vec2TaskConfig":
        known = cls.__dataclass_fields__.keys()
        return cls(**{k: v for k, v in cfg.items() if k in known})
