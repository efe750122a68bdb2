"""Prune-event schedules: a copy of
``speech_ssl_compression_tpu/compress/schedule.py`` (reference
head_pruning/hp_utils.py:9-18, row_pruning/rp_utils.py:8-17,
weight_pruning/wp_utils.py:75-82)."""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np


def set_prune_interval(
    prune_interval: Union[int, Sequence[int]],
    warm_up_steps: int,
    total_prune_steps: int,
) -> List[int]:
    """Head/row pruning: warm_up + i*interval (or explicit offsets)."""
    if isinstance(prune_interval, int):
        return [warm_up_steps + prune_interval * i
                for i in range(total_prune_steps)]
    if isinstance(prune_interval, (list, tuple)):
        return [warm_up_steps + int(p) for p in prune_interval]
    raise NotImplementedError(type(prune_interval))


def sparsity_ladder(sparsity, n_iters: int) -> List[float]:
    """Weight pruning: a float means a linear ramp to that final sparsity
    over n_iters events; a list is taken verbatim (wp_utils.py:75-80)."""
    if isinstance(sparsity, float):
        return [sparsity * (n + 1) / n_iters for n in range(n_iters)]
    if isinstance(sparsity, (list, tuple)):
        assert len(sparsity) == n_iters
        return [float(s) for s in sparsity]
    raise NotImplementedError(type(sparsity))


def weight_prune_steps(warmup: int, period: int, n_iters: int) -> List[int]:
    """warnup + arange(n_iters)*period (wp_utils.py:82)."""
    return list(warmup + np.arange(n_iters) * period)
