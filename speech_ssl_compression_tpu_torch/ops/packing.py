"""Sequence packing for extraction (host-side planning, NumPy).

Mirror of ``speech_ssl_compression_tpu/ops/packing.py``, which cannot be
imported without JAX (its package ``__init__`` loads the JAX featurizer).
Utterances are concatenated into fixed-capacity rows with 1-based segment
ids; attention is restricted to equal ids, so packed outputs equal the
unpacked forward. Packing happens after the encoder prologue, because the
conv positional embedding must not cross utterance boundaries.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def plan_packing(lengths: Sequence[int], capacity: int) -> List[List[int]]:
    """Mirror of ``ops/packing.py::plan_packing``: first-fit-decreasing bin
    packing. Returns rows of utterance indices."""
    order = np.argsort(np.asarray(lengths))[::-1]
    rows: List[List[int]] = []
    room: List[int] = []
    for idx in order:
        n = int(lengths[idx])
        for r in range(len(rows)):
            if room[r] >= n:
                rows[r].append(int(idx))
                room[r] -= n
                break
        else:
            rows.append([int(idx)])
            room.append(max(capacity - n, 0))
    return rows


def build_pack_arrays(
    lengths: Sequence[int],
    rows: List[List[int]],
    capacity: int,
    src_time: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mirror of ``ops/packing.py::build_pack_arrays``.

    Returns (gather_idx, segment_ids, unpack_idx), all int32:
      gather_idx   (R, capacity) flat indices into the (B*src_time) rows of
                   the padded source; padding slots point at 0.
      segment_ids  (R, capacity) 1-based utterance segment, 0 for padding.
      unpack_idx   (B, src_time) flat indices into (R*capacity) recovering
                   each utterance's frames; padding slots -> 0.
    """
    longest = max(int(l) for l in lengths)
    if longest > capacity:
        raise ValueError(
            f"capacity {capacity} < longest utterance {longest}: "
            "packing must not truncate"
        )
    for ri, row in enumerate(rows):
        row_sum = sum(int(lengths[u]) for u in row)
        if row_sum > capacity:
            raise ValueError(
                f"packed row {ri} holds {row_sum} frames > capacity "
                f"{capacity}: packing must not truncate"
            )
    r = len(rows)
    gather = np.zeros((r, capacity), np.int64)
    seg = np.zeros((r, capacity), np.int64)
    unpack = np.zeros((len(lengths), src_time), np.int64)

    seg_counter = 0
    for ri, row in enumerate(rows):
        col = 0
        for utt in row:
            n = int(lengths[utt])
            seg_counter += 1
            gather[ri, col:col + n] = utt * src_time + np.arange(n)
            seg[ri, col:col + n] = seg_counter
            unpack[utt, :n] = ri * capacity + np.arange(col, col + n)
            col += n
    return (
        gather.astype(np.int32),
        seg.astype(np.int32),
        unpack.astype(np.int32),
    )


def pack_rows_needed(lengths: Sequence[int], capacity: int) -> int:
    """Mirror of ``ops/packing.py::pack_rows_needed``: the rows
    :func:`plan_packing` fills."""
    return len(plan_packing(lengths, capacity))
