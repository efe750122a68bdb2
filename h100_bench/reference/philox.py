"""Attention dropout's keep bits: a frozen copy of the counter-based
Philox-4x32-10 rule the port's attention kernels compute in-kernel
(``ops/dropout.py``), so that the reference applies the same mask from the
same seed. Element (row, col) of head (b, h) keeps its probability iff
word col mod 4 of one Philox call at counter (col // 4, row, b * H + h,
0) and key (seed lo, seed hi) is below ``(1 - p) * (2**32 - 1)``."""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def keep_threshold(p: float) -> int:
    return int((1.0 - p) * 4294967295.0)


def _mulhilo(m: int, a: torch.Tensor):
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = (p_lo & _MASK32) + ((p_hi & 0xFFFF) << 16)
    hi = (p_lo >> 32) + (p_hi >> 16) + (t >> 32)
    return hi & _MASK32, t & _MASK32


def philox4x32(counter, key, rounds: int = 10):
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(seed: int, b: int, h: int, tq: int, tk: int, p: float,
              device=None) -> torch.Tensor:
    """(b, h, tq, tk) bool: True where the probability is kept."""
    i64 = dict(dtype=torch.int64, device=device)
    groups = (tk + 3) // 4
    col4 = torch.arange(groups, **i64).view(1, 1, 1, groups)
    row = torch.arange(tq, **i64).view(1, 1, tq, 1)
    bh = torch.arange(b * h, **i64).view(b, h, 1, 1)
    words = philox4x32((col4, row, bh, torch.zeros((), **i64)),
                       (seed & _MASK32, seed >> 32))
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    return bits.reshape(b, h, tq, 4 * groups)[..., :tk] < keep_threshold(p)
