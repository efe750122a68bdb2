"""Span masks for masked prediction, on the host and on the device.

Port of ``speech_ssl_compression_tpu/ops/masking.py``, both halves.

The host half: ``compute_mask_indices_np`` with ``_np_lengths`` and
``_np_place_no_overlap``, the reference's semantics
(fairseq_code/data_utils.py:20-153) on an explicit
``numpy.random.Generator``. The same generator state gives the JAX
function's mask bit for bit. The trainers draw their span masks here, and
the waveform models their channel masks (:func:`compute_channel_mask_np`,
with JAX ``compute_channel_mask``'s settings).

The device half: :func:`compute_span_mask`, :func:`compute_channel_mask`
and :func:`max_spans_upper_bound`, JAX's static-budget sampler in torch
ops on the tensors' device, drawing from an explicit ``torch.Generator``
there. Per-row probabilistic rounding of the span count (or one shared
draw), span lengths by ``mask_selection``, the all-zero-length fallback
(applied twice: before and after short rows clamp the count), start
positions as the top-k of i.i.d. uniform scores over the valid starts (a
uniform sample without replacement), the span union by a +1/-1 boundary
scatter and a cumulative sum, and the rank-based subset for
``require_same_masks`` and ``mask_dropout``. The draws and the
deterministic rest are split: :func:`span_mask_from_draws` takes the
draws as arguments, so JAX's own draws give JAX's mask bit for bit.
``no_overlap=True`` runs the host generator seeded by one draw from the
device generator, as JAX's ``pure_callback`` does. Device and JAX streams
differ, so the device masks agree with JAX's in distribution.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

_SELECTIONS = ("static", "uniform", "normal", "poisson")
_I32_MAX = 2 ** 31 - 1


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


def compute_channel_mask_np(
    batch: int,
    channels: int,
    *,
    mask_prob: float,
    mask_length: int,
    mask_selection: str = "static",
    mask_other: float = 0.0,
    no_overlap: bool = False,
    min_space: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """(B, C) bool feature-channel mask, with the settings JAX
    ``compute_channel_mask`` fixes (the reference's channel calls,
    model.py:574-583): no padding mask, so one shared count draw for every
    row, ``min_masks=0``, ``require_same_masks=True``, no mask dropout."""
    return compute_mask_indices_np(
        (batch, channels), None, mask_prob=mask_prob,
        mask_length=mask_length, mask_selection=mask_selection,
        mask_other=mask_other, min_masks=0, no_overlap=no_overlap,
        min_space=min_space, require_same_masks=True, mask_dropout=0.0,
        rng=rng)


def channel_mask(cfg, batch: int, channels: int,
                 rng: np.random.Generator) -> np.ndarray:
    """(B, C) bool channel mask of a HuBERT or wav2vec 2.0 config's
    ``mask_channel_*`` fields, the arguments JAX's forwards give
    ``compute_channel_mask``."""
    return compute_channel_mask_np(
        batch, channels, mask_prob=cfg.mask_channel_prob,
        mask_length=cfg.mask_channel_length,
        mask_selection=cfg.mask_channel_selection,
        mask_other=cfg.mask_channel_other,
        no_overlap=cfg.no_mask_channel_overlap,
        min_space=cfg.mask_channel_min_space, rng=rng)


# ---------------------------------------------------------------------------
# the device sampler (JAX compute_span_mask's static-budget algorithm)
# ---------------------------------------------------------------------------

def max_spans_upper_bound(max_len: int, mask_prob: float, mask_length: int,
                          min_masks: int = 2) -> int:
    """The static upper bound on a row's span count."""
    return max(min_masks, int(mask_prob * max_len / float(mask_length)) + 1)


def _max_span_len(mask_selection: str, mask_length: int,
                  mask_other: float) -> int:
    """The clamp on one span's length (the normal and poisson tails past
    it are negligible)."""
    if mask_selection == "static":
        return mask_length
    if mask_selection == "uniform":
        return 2 * mask_length
    if mask_selection == "normal":
        return int(math.ceil(mask_length + 4.0 * max(mask_other, 0.0))) + 1
    if mask_selection == "poisson":
        return 3 * mask_length + 10
    raise ValueError(
        f"unknown mask_selection {mask_selection!r}; expected one of "
        f"{_SELECTIONS} (reference data_utils.py:92)")


def _draw_lengths(generator: torch.Generator, shape, mask_selection: str,
                  mask_length: int, mask_other: float) -> torch.Tensor:
    """Span lengths (int32) of the four selections, on the generator's
    device."""
    dev = generator.device
    if mask_selection == "static":
        return torch.full(shape, mask_length, dtype=torch.int32, device=dev)
    if mask_selection == "uniform":
        low = int(mask_other)
        if low > 2 * mask_length:
            raise ValueError(
                f"uniform mask_selection: mask_other ({low}) must be <= "
                f"2 * mask_length ({2 * mask_length})")
        return torch.randint(low, 2 * mask_length + 1, shape,
                             generator=generator, device=dev,
                             dtype=torch.int32)
    if mask_selection == "normal":
        x = (torch.randn(shape, generator=generator, device=dev) * mask_other
             + mask_length)
        return torch.clamp_min(torch.round(x), 1).to(torch.int32)
    if mask_selection == "poisson":
        rate = torch.full(shape, float(mask_length), device=dev)
        return torch.poisson(rate, generator=generator).to(torch.int32)
    raise ValueError(f"unknown mask_selection {mask_selection!r}")


def _apply_fallback(span_len, keep, fallback):
    """Slot 0 takes ``fallback`` in rows whose kept spans are all of
    length 0 (reference data_utils.py:95-96)."""
    total = torch.where(keep, span_len, 0).sum(dim=1)
    span_len = span_len.clone()
    span_len[:, 0] = torch.where(total == 0, fallback, span_len[:, 0])
    return span_len


def span_mask_from_draws(
    lengths: torch.Tensor,
    max_len: int,
    u_count: torch.Tensor,
    span_len: torch.Tensor,
    start_scores: torch.Tensor,
    subset_scores: Optional[torch.Tensor],
    *,
    mask_prob: float,
    mask_length: int,
    mask_selection: str = "static",
    mask_other: float = 0.0,
    min_masks: int = 2,
    require_same_masks: bool = True,
    mask_dropout: float = 0.0,
) -> torch.Tensor:
    """The deterministic part of :func:`compute_span_mask` (JAX's
    ``compute_span_mask`` past its draws, ops/masking.py:183-285), on
    given draws: ``u_count`` (B,) f32 uniforms of the count rounding,
    ``span_len`` (B, n_spans) int span lengths as drawn,
    ``start_scores`` and ``subset_scores`` (B, T) f32 uniforms (the latter
    read only with ``require_same_masks`` or ``mask_dropout``). Returns
    (B, T) bool; True = masked, nothing past a row's length."""
    b, t = lengths.shape[0], max_len
    dev = lengths.device
    lengths = lengths.to(torch.int32)
    n_spans = max_spans_upper_bound(t, mask_prob, mask_length, min_masks)
    lmax = _max_span_len(mask_selection, mask_length, mask_other)
    slots = torch.arange(n_spans, device=dev)[None, :]
    pos = torch.arange(t, device=dev)[None, :]

    # probabilistic rounding of the span count (reference :57-74)
    sz = lengths.to(torch.float32)
    num_mask = torch.floor(sz * mask_prob / float(mask_length)
                           + u_count).to(torch.int32)
    num_mask = num_mask.clamp(min=min_masks, max=n_spans)

    span_len = span_len.to(torch.int32).clamp(0, lmax)
    keep = slots < num_mask[:, None]
    fallback = torch.clamp_min(lengths - 1, 0).clamp_max(mask_length)
    span_len = _apply_fallback(span_len, keep, fallback)

    # valid starts [0, sz - min_len), with the reference's adjustment when
    # the range is too tight for a draw without replacement (:125-129)
    min_len = torch.where(keep, span_len, _I32_MAX).amin(dim=1)
    min_len = torch.where(num_mask > 0, min_len, mask_length)
    n_starts = lengths - min_len
    n_starts = torch.where(n_starts <= num_mask,
                           torch.minimum(num_mask + 1, lengths), n_starts)
    n_starts = n_starts.clamp_min(1)
    # short rows: no more spans than valid starts, and the fallback again
    # on the clamped slot set
    num_mask = torch.minimum(num_mask, n_starts)
    keep = slots < num_mask[:, None]
    span_len = _apply_fallback(span_len, keep, fallback)

    # top-k of uniform scores over the valid starts; a stable descending
    # sort puts the lower index first among equal scores, as top_k does
    scores = torch.where(pos < n_starts[:, None], start_scores,
                         float("-inf"))
    start_idx = torch.sort(scores, dim=1, descending=True,
                           stable=True).indices[:, :n_spans]

    # the union of [start, min(start + len, sz)) by +1/-1 at the bounds
    end_idx = torch.minimum(start_idx + span_len, lengths[:, None].long())
    end_idx = torch.maximum(end_idx, start_idx)
    inc = keep.to(torch.int32)
    delta = torch.zeros(b, t + lmax + 1, dtype=torch.int32, device=dev)
    delta.scatter_add_(1, start_idx, inc)
    delta.scatter_add_(1, end_idx, -inc)
    mask = (torch.cumsum(delta, dim=1)[:, :t] > 0) & (pos < lengths[:, None])

    if require_same_masks or mask_dropout > 0.0:
        count = mask.sum(dim=1, dtype=torch.int32)
        target = count.min().expand(b) if require_same_masks else count
        if mask_dropout > 0.0:
            target = target - torch.round(
                target.to(torch.float32) * mask_dropout).to(torch.int32)
        # keep exactly `target` masked positions a row, by rank
        sub = torch.where(mask, subset_scores, -1.0)
        order = torch.argsort(-sub, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        mask = mask & (rank < target[:, None]) & (target > 0)[:, None]
    return mask


def draw_host_seed(generator: torch.Generator) -> int:
    """One uint32 seed from the device generator for the host sampler
    (JAX draws ``jax.random.bits(rng, uint32)``)."""
    return int(torch.randint(0, 2 ** 32, (), generator=generator,
                             device=generator.device))


def host_span_mask(seed: int, lengths: torch.Tensor, max_len: int, *,
                   shared_rounding: bool = False, **kwargs) -> torch.Tensor:
    """:func:`compute_span_mask`'s ``no_overlap`` path (JAX's
    ``pure_callback``): :func:`compute_mask_indices_np` with recursive
    non-overlapping placement on ``np.random.default_rng(seed)``, on
    ``lengths``' device and confined to each row's length. ``kwargs`` are
    that function's mask arguments."""
    host = compute_mask_indices_np(
        (lengths.shape[0], max_len),
        None if shared_rounding else lengths.cpu().numpy(),
        no_overlap=True, rng=np.random.default_rng(seed), **kwargs)
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return torch.from_numpy(host).to(lengths.device) & (pos < lengths[:, None])


def compute_span_mask(
    generator: torch.Generator,
    lengths: torch.Tensor,
    max_len: int,
    *,
    mask_prob: float,
    mask_length: int,
    mask_selection: str = "static",
    mask_other: float = 0.0,
    min_masks: int = 2,
    no_overlap: bool = False,
    min_space: int = 1,
    require_same_masks: bool = True,
    mask_dropout: float = 0.0,
    shared_rounding: bool = False,
) -> torch.Tensor:
    """A (B, T) bool span mask drawn on the device (JAX
    ``compute_span_mask``): ``lengths`` (B,) valid lengths on
    ``generator``'s device, ``max_len`` the padded T; the other arguments
    as in the reference ``compute_mask_indices`` (require_same_masks
    defaults True there too). ``shared_rounding``: one count draw for
    every row, the reference's behaviour without a padding mask. No True
    falls past a row's length."""
    _max_span_len(mask_selection, mask_length, mask_other)  # validate early
    b, t = lengths.shape[0], max_len
    if no_overlap:
        return host_span_mask(
            draw_host_seed(generator), lengths, t, mask_prob=mask_prob,
            mask_length=mask_length, mask_selection=mask_selection,
            mask_other=mask_other, min_masks=min_masks, min_space=min_space,
            require_same_masks=require_same_masks,
            mask_dropout=mask_dropout, shared_rounding=shared_rounding)
    dev = generator.device
    n_spans = max_spans_upper_bound(t, mask_prob, mask_length, min_masks)
    u = torch.rand((1,) if shared_rounding else (b,), generator=generator,
                   device=dev).expand(b)
    span_len = _draw_lengths(generator, (b, n_spans), mask_selection,
                             mask_length, mask_other)
    start_scores = torch.rand((b, t), generator=generator, device=dev)
    subset_scores = (torch.rand((b, t), generator=generator, device=dev)
                     if require_same_masks or mask_dropout > 0.0 else None)
    return span_mask_from_draws(
        lengths, t, u, span_len, start_scores, subset_scores,
        mask_prob=mask_prob, mask_length=mask_length,
        mask_selection=mask_selection, mask_other=mask_other,
        min_masks=min_masks, require_same_masks=require_same_masks,
        mask_dropout=mask_dropout)


def compute_channel_mask(
    generator: torch.Generator,
    batch: int,
    channels: int,
    *,
    mask_prob: float,
    mask_length: int,
    mask_selection: str = "static",
    mask_other: float = 0.0,
    no_overlap: bool = False,
    min_space: int = 1,
) -> torch.Tensor:
    """(B, C) bool feature-channel mask on the device (JAX
    ``compute_channel_mask``): no padding mask, so one shared count draw,
    ``min_masks=0``, ``require_same_masks=True`` (reference
    model.py:574-583)."""
    lengths = torch.full((batch,), channels, dtype=torch.int32,
                         device=generator.device)
    return compute_span_mask(
        generator, lengths, channels, mask_prob=mask_prob,
        mask_length=mask_length, mask_selection=mask_selection,
        mask_other=mask_other, min_masks=0, no_overlap=no_overlap,
        min_space=min_space, require_same_masks=True, mask_dropout=0.0,
        shared_rounding=True)
