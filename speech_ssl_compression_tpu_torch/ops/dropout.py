"""Dropout: the keep test, inverted dropout, and attention dropout's keep bits.

Port of ``speech_ssl_compression_tpu/ops/dropout.py``. The keep test is one
definition, :func:`keep_threshold`: an element is kept iff its uint32
random bits are below it. Only the keep distribution is semantics
(the reference's ``FairseqDropout``); the random stream is not, so the
port's bits are not JAX's.

Generators are explicit. :func:`dropout` draws its bits from a
``torch.Generator`` on the tensor's device. Attention dropout draws none:
:func:`attention_keep_mask` is a counter-based function of
(seed, b, h, row, col): one Philox-4x32-10 call at counter
(col // 4, row, b * H + h, 0) and key (seed lo, seed hi) serves four
adjacent keys, and key col takes its word col mod 4. The CUDA kernels
(``csrc/flash_common.cuh``) compute the same bits in-kernel, so the
forward, the backward kernels, this plain version and ``dense_attention``
all see one mask, whatever their tiles.

Data- and tensor-parallel training (``parallel/mesh.py``) folds the rank
into the seeds with :func:`fold_seed`: every rank draws the same seeds from
the same host generator, so the ranks of one data index fold nothing into
the dropouts of the replicated activations (their replicas must stay
equal), the data index into everything (their rows differ), and the model
index into the attention keep bits and the activation dropout of the
heads and FFN units a rank holds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox-4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Philox-4x32 key increments (Weyl)
_MASK32 = 0xFFFFFFFF
SEED_BOUND = 2**31 - 1  # seeds in [0, 2^31 - 1), the range JAX draws


def keep_threshold(p: float) -> int:
    """uint32 threshold with P(bits < threshold) = 1 - p up to 2^-32; the
    -1 keeps tiny p from overflowing uint32. Same value as the JAX
    ``keep_threshold``."""
    return int((1.0 - p) * 4294967295.0)


def draw_seed(generator: torch.Generator) -> int:
    """One seed in [0, 2^31 - 1) from a host generator (no device sync)."""
    return int(torch.randint(0, SEED_BOUND, (), generator=generator))


def host_mask_rng(generator: Optional[torch.Generator]):
    """A function that returns one ``numpy.random.Generator`` seeded by
    :func:`draw_seed` of ``generator``, drawn at its first call: the host
    stream a forward draws its span and channel masks from, in the order
    it applies them. A forward whose masks are all given draws nothing."""
    made = []

    def get() -> np.random.Generator:
        if not made:
            if generator is None:
                raise ValueError("drawing a span or channel mask needs an "
                                 "rng (or pass the mask)")
            made.append(np.random.default_rng(draw_seed(generator)))
        return made[0]

    return get


_FOLD = (0x1E3779B1, 0x05EBCA6B, 0x42B2AE35)  # one odd step per coordinate


def fold_seed(seed: int, *coords: int) -> int:
    """``seed`` with grid coordinates folded in (data index, model index,
    a stream tag): ``seed`` itself where all are 0, so one rank, or rank 0,
    draws what a single process draws."""
    for step, c in zip(_FOLD, coords):
        seed = (seed + step * int(c)) % SEED_BOUND
    return seed


def seeded_generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def device_generator(generator: torch.Generator, device: torch.device,
                     fold=()) -> torch.Generator:
    """A generator on ``device`` seeded from the host ``generator`` (with
    ``fold``'s coordinates folded in, :func:`fold_seed`): the source of
    :func:`dropout`'s bits on that device."""
    return seeded_generator(fold_seed(draw_seed(generator), *fold), device)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
            deterministic: bool = False) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - p (bits below
    :func:`keep_threshold`), scale kept values by 1/(1 - p). The bits come
    from ``generator``, which must live on ``x``'s device."""
    if deterministic or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with p > 0 and deterministic=False needs "
                         "a generator")
    bits = torch.randint(0, 2**32, x.shape, generator=generator,
                         device=x.device, dtype=torch.int64)
    scale = torch.tensor(1.0 / (1.0 - p), dtype=x.dtype)  # 0-dim, on the host
    return torch.where(bits < keep_threshold(p), x * scale,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * a, for a constant
    m < 2^32 and an int64 tensor a of uint32 values. The product is split
    on m's 16-bit halves so that nothing overflows int64."""
    p_lo = a * (m & 0xFFFF)          # < 2^48
    p_hi = a * (m >> 16)             # < 2^48
    t = (p_lo & _MASK32) + ((p_hi & 0xFFFF) << 16)  # < 2^33
    hi = (p_lo >> 32) + (p_hi >> 16) + (t >> 32)
    return hi & _MASK32, t & _MASK32


def philox4x32(counter, key, rounds: int = 10):
    """Philox-4x32 (Salmon et al., SC'11) on int64 tensors holding uint32
    values: ``counter`` is 4 broadcastable tensors, ``key`` 2 ints.
    Returns the 4 output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def attention_keep_bits(seed: int, b: int, h: int, tq: int, tk: int,
                        device=None) -> torch.Tensor:
    """(b, h, tq, tk) int64 tensor of uint32 bits of the attention
    probabilities: element (row, col) of head (bi, hi) is word col mod 4 of
    one Philox call at counter (col // 4, row, bi * h + hi, 0), so each call
    serves four adjacent keys."""
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be a uint64, got {seed}")
    i64 = dict(dtype=torch.int64, device=device)
    groups = (tk + 3) // 4
    col4 = torch.arange(groups, **i64).view(1, 1, 1, groups)
    row = torch.arange(tq, **i64).view(1, 1, tq, 1)
    bh = torch.arange(b * h, **i64).view(b, h, 1, 1)
    zero = torch.zeros((), **i64)
    words = philox4x32((col4, row, bh, zero), (seed & _MASK32, seed >> 32))
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    return bits.reshape(b, h, tq, 4 * groups)[..., :tk]


def attention_keep_mask(seed: int, b: int, h: int, tq: int, tk: int,
                        p: float, device=None) -> torch.Tensor:
    """(b, h, tq, tk) bool keep mask of attention dropout with rate ``p``:
    the mask the CUDA kernels apply in-kernel, materialized."""
    return attention_keep_bits(seed, b, h, tq, tk, device) < keep_threshold(p)
