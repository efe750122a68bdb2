"""Block masks for wav2vec 2.0's precomputed-mask data path, on the host.

The port's copy of ``speech_ssl_compression_tpu/ops/block_masking.py``
(reference fairseq_code/data_utils.py:190-311, ``compute_block_mask_1d``):
block centres drawn uniformly (overlapping) or as non-overlapping grid
cells, expanded to blocks of ``mask_length``; ``require_same_masks`` trims
or pads every row to exactly int(L * mask_prob) masked positions;
``inverse_mask`` flips the meaning. The numpy generator calls are JAX's,
so the same generator state gives the same mask bit for bit.
"""

from __future__ import annotations

import math

import numpy as np


def compute_block_mask_1d(
    shape,
    mask_prob: float,
    mask_length: int,
    mask_prob_adjust: float = 0.0,
    inverse_mask: bool = False,
    require_same_masks: bool = True,
    mask_dropout: float = 0.0,
    non_overlapping: bool = False,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """(B, L) bool block mask for ``shape`` = (B, L)."""
    b, l = shape
    rng = rng or np.random.default_rng()
    if inverse_mask:
        mask_prob = 1 - mask_prob

    if non_overlapping:
        sz = math.ceil(l / mask_length)
        n_pick = int(sz * (mask_prob + mask_prob_adjust) * (1 + mask_dropout))
        mask = np.zeros((b, sz * mask_length), np.float32)
        for i in range(b):
            cells = rng.choice(sz, size=min(n_pick, sz), replace=False)
            for c in cells:
                mask[i, c * mask_length:(c + 1) * mask_length] = 1
        mask = mask[:, :l]
    else:
        n_centers = int(l * ((mask_prob + mask_prob_adjust) / mask_length)
                        * (1 + mask_dropout))
        mask = np.zeros((b, l), np.float32)
        centers = rng.integers(0, l, size=(b, n_centers))
        offset = mask_length // 2
        for k in range(mask_length):
            idx = np.clip(centers + (k - offset), 0, l - 1)
            for i in range(b):
                mask[i, idx[i]] = 1

    if require_same_masks:
        final_target = int(l * mask_prob)
        for i in range(b):
            n = int(mask[i].sum())
            if n > final_target:
                on = np.flatnonzero(mask[i])
                off = rng.choice(on, size=n - final_target, replace=False)
                mask[i, off] = 0
            elif n < final_target:
                offp = np.flatnonzero(mask[i] == 0)
                on = rng.choice(offp, size=final_target - n, replace=False)
                mask[i, on] = 1

    if inverse_mask:
        mask = 1 - mask
    return mask.astype(bool)
