"""S3PRL-style upstream expert, port of
``speech_ssl_compression_tpu/s3prl/expert.py`` (reference
s3prl_upstream/expert.py).

Same contract: ``forward(wavs)`` returns
``{"hidden_states": [pre_feat] + layer_hiddens, "last_hidden_state"}`` and
``get_downsample_rates`` gives 320 (20 ms) / 160 (10 ms). Accepts wavs as
numpy arrays, torch tensors or file paths; all five checkpoint flavors go
through the shared loader (weight masks folded, head counts inferred). The
expert runs on ``device``, the GPU unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..extract import MelHuBERTExtractor, read_wavs


def _to_numpy_wave(w):
    if isinstance(w, str):
        return read_wavs([w])[0]
    if torch.is_tensor(w):
        return w.detach().cpu().numpy().reshape(-1)
    return np.asarray(w).reshape(-1)


class UpstreamExpert:
    def __init__(self, ckpt: str, mode: str = "melhubert", fp: int = 20,
                 mean_std_npy_path: str = None, model_config=None,
                 packed: bool = False, featurizer: str = "host",
                 device="cuda", **kwargs):
        """packed=True serves batches with sequence packing (segment-masked
        attention): the same outputs, less padding on mixed-length batches.
        featurizer="device" runs fbank + normalize + stacking on ``device``.
        ``model_config`` and other keywords are accepted for the reference's
        signature and not read."""
        self.mode = mode
        self.fp = fp
        self.packed = packed
        self.featurizer = featurizer
        self.extractor = MelHuBERTExtractor(
            ckpt, fp=fp, mean_std_npy_path=mean_std_npy_path, device=device
        )
        self.upstream_config = self.extractor.cfg

    def get_downsample_rates(self, key: str = "") -> int:
        return self.extractor.get_downsample_rates(key)

    def forward(self, wavs: Sequence, no_pred: bool = True, norm: bool = True):
        # no_pred and norm are accepted for the reference's signature and,
        # as there (s3prl_upstream/expert.py:113,130), not read
        waves = [_to_numpy_wave(w) for w in wavs]
        if self.packed and len(waves) > 1:
            out = self.extractor.forward_packed(waves,
                                                featurizer=self.featurizer)
        else:
            out = self.extractor.forward(waves, featurizer=self.featurizer)
        return {
            "hidden_states": out["hidden_states"],
            "last_hidden_state": out["last_hidden_state"],
        }

    __call__ = forward
