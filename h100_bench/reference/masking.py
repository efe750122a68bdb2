"""The span mask of MelHuBERT pre-training: a frozen copy of the host
sampler the port draws it with (``ops/masking.py::
compute_mask_indices_np``, fairseq's ``compute_mask_indices`` on an
explicit ``numpy.random.Generator``), so that the reference draws the same
mask from the same seed."""

from __future__ import annotations

from typing import Optional

import numpy as np


def _np_lengths(rng: np.random.Generator, n: int, mask_selection: str,
                mask_length: int, mask_other: float) -> np.ndarray:
    """Span lengths for the four selections of the reference."""
    if mask_selection == "static":
        return np.full(n, mask_length, np.int64)
    if mask_selection == "uniform":
        return rng.integers(int(mask_other), 2 * mask_length + 1, size=n)
    if mask_selection == "normal":
        x = np.round(rng.normal(mask_length, mask_other, size=n)).astype(np.int64)
        return np.maximum(x, 1)
    if mask_selection == "poisson":
        return np.round(rng.poisson(mask_length, size=n)).astype(np.int64)
    raise ValueError(f"unknown mask_selection {mask_selection!r}")


def _np_place_no_overlap(rng: np.random.Generator, sz: int,
                         span_lens: np.ndarray, min_space: int) -> np.ndarray:
    """The reference's recursive interval splitting (data_utils.py:103-124):
    spans placed longest first into free intervals picked in proportion to
    their usable size, ``min_space`` apart."""
    chosen: list = []
    free = [(0, sz)]
    shortest = int(span_lens.min()) if len(span_lens) else 0
    for length in sorted((int(x) for x in span_lens), reverse=True):
        usable = np.array(
            [e - s if (e - s) >= length + min_space else 0 for s, e in free],
            np.int64,
        )
        if usable.sum() == 0:
            break
        pick = rng.choice(len(free), p=usable / usable.sum())
        s, e = free.pop(pick)
        start = int(rng.integers(s, e - length))
        chosen.extend(range(start, start + length))
        if start - s - min_space >= shortest:
            free.append((s, start - min_space + 1))
        if e - start - length - min_space > shortest:
            free.append((start + length + min_space, e))
    return np.asarray(chosen, np.int64)


def compute_mask_indices_np(
    shape: tuple,
    lengths: Optional[np.ndarray],
    *,
    mask_prob: float,
    mask_length: int,
    mask_selection: str = "static",
    mask_other: float = 0.0,
    min_masks: int = 0,
    no_overlap: bool = False,
    min_space: int = 0,
    require_same_masks: bool = True,
    mask_dropout: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """(B, T) bool span mask: per-row probabilistic count rounding, the four
    length distributions, overlapping or recursive non-overlapping
    placement, clipping at the row's size, batch-min equalization and mask
    dropout. ``lengths`` is (B,) valid sizes (None: all full, with one
    shared count draw, as the reference does without a padding mask)."""
    rng = rng or np.random.default_rng()
    b, t = shape
    sizes = (np.full(b, t, np.int64) if lengths is None
             else np.asarray(lengths, np.int64))
    mask = np.zeros((b, t), bool)

    shared_num_mask = None
    if lengths is None:
        shared_num_mask = max(
            min_masks, int(mask_prob * t / float(mask_length) + rng.random())
        )

    rows: list = []
    for i in range(b):
        sz = int(sizes[i])
        if shared_num_mask is None:
            num_mask = int(mask_prob * sz / float(mask_length) + rng.random())
            num_mask = max(min_masks, num_mask)
        else:
            num_mask = shared_num_mask
        span_lens = _np_lengths(rng, num_mask, mask_selection, mask_length,
                                mask_other)
        if num_mask and span_lens.sum() == 0:
            span_lens[0] = min(mask_length, sz - 1)

        if no_overlap:
            idx = _np_place_no_overlap(rng, sz, span_lens, min_space)
        elif num_mask == 0:
            idx = np.empty(0, np.int64)
        else:
            shortest = int(span_lens.min())
            if sz - shortest <= num_mask:
                shortest = sz - num_mask - 1
            starts = rng.choice(max(sz - shortest, 1), num_mask, replace=False)
            idx = np.concatenate(
                [s + np.arange(l) for s, l in zip(starts, span_lens)]
            )
        rows.append(np.unique(idx[idx < sz]))

    fewest = min(len(r) for r in rows) if rows else 0
    for i, idx in enumerate(rows):
        if require_same_masks and len(idx) > fewest:
            idx = rng.choice(idx, fewest, replace=False)
        if mask_dropout > 0:
            holes = int(np.rint(len(idx) * mask_dropout))
            idx = rng.choice(idx, len(idx) - holes, replace=False)
        mask[i, idx.astype(np.int64)] = True
    return mask
