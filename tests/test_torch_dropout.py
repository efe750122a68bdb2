"""The port's dropout (``speech_ssl_compression_tpu_torch/ops/dropout.py``):
the Philox-4x32-10 keep bits of attention dropout, their tiling-free
definition and keep rate, and inverted dropout. The random streams are not
JAX's (only the keep distribution is semantics); the keep test is."""

import math

import numpy as np
import pytest
import torch

from speech_ssl_compression_tpu.ops import dropout as jdrop
from speech_ssl_compression_tpu_torch.ops import dropout as tdrop

# Random123's known-answer vectors for philox4x32_10: (counter, key, out)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
SIGMAS = 5.0  # keep-rate bar: within 5 sigma of the binomial


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    out = tdrop.philox4x32(
        tuple(torch.tensor(c, dtype=torch.int64) for c in counter), key)
    assert tuple(int(o) for o in out) == want


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1e-9])
def test_keep_threshold_matches_jax(p):
    assert tdrop.keep_threshold(p) == int(jdrop.keep_threshold(p))


def test_keep_bits_are_one_philox_draw_per_element():
    # an element's bits are word col mod 4 of the one draw at counter
    # (col // 4, row, b * H + h, 0) that its group of four keys shares
    seed = (5 << 32) | 123  # both key words in use
    bits = tdrop.attention_keep_bits(seed, 2, 3, 5, 7)
    rng = np.random.default_rng(0)
    for _ in range(10):
        bi, hi, r, c = (int(rng.integers(n)) for n in (2, 3, 5, 7))
        want = tdrop.philox4x32(
            (torch.tensor(c // 4), torch.tensor(r), torch.tensor(bi * 3 + hi),
             torch.tensor(0)), (123, 5))[c % 4]
        assert int(bits[bi, hi, r, c]) == int(want)


@pytest.mark.parametrize("tk", [1, 4, 13, 64])
def test_one_philox_call_serves_four_adjacent_keys(tk):
    # every element, for key counts that do and do not fill the last group
    seed = (7 << 32) | 99
    b, h, tq = 2, 3, 6
    bits = tdrop.attention_keep_bits(seed, b, h, tq, tk)
    assert bits.shape == (b, h, tq, tk)
    i64 = dict(dtype=torch.int64)
    col = torch.arange(tk, **i64).view(1, 1, 1, tk)
    row = torch.arange(tq, **i64).view(1, 1, tq, 1)
    bh = torch.arange(b * h, **i64).view(b, h, 1, 1)
    words = tdrop.philox4x32((col // 4, row, bh, torch.zeros((), **i64)),
                             (99, 7))
    want = torch.zeros(b, h, tq, tk, **i64)
    for w in range(4):
        want = torch.where(col % 4 == w, words[w], want)
    assert torch.equal(bits, want)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_bits_of_one_call_are_independent(p):
    # the four words of one call are four keys: pairs of neighbours in a
    # group agree as often as two independent draws would (p^2 + (1-p)^2)
    mask = tdrop.attention_keep_mask(77, 2, 4, 128, 128, p)
    agree = (mask[..., 0::4] == mask[..., 1::4]).float()
    n = agree.numel()
    want = p * p + (1 - p) * (1 - p)
    assert abs(float(agree.mean()) - want) < SIGMAS * math.sqrt(
        want * (1 - want) / n)


def test_keep_mask_is_deterministic_and_tiling_free():
    a = tdrop.attention_keep_mask(11, 2, 3, 64, 64, 0.1)
    assert torch.equal(a, tdrop.attention_keep_mask(11, 2, 3, 64, 64, 0.1))
    # a larger (T_q, T_k) holds the smaller mask as its corner: an element's
    # bit does not depend on the shape (and so on no tile) it is drawn in
    big = tdrop.attention_keep_mask(11, 2, 3, 200, 130, 0.1)
    assert torch.equal(big[:, :, :64, :64], a)
    # and (b, h) enter only through b * H + h
    more_heads = tdrop.attention_keep_bits(11, 1, 6, 64, 64)
    assert torch.equal(more_heads[0, 3:],
                       tdrop.attention_keep_bits(11, 2, 3, 64, 64)[1])


def test_keep_mask_differs_across_seeds():
    a = tdrop.attention_keep_mask(1, 2, 2, 64, 64, 0.5)
    b = tdrop.attention_keep_mask(2, 2, 2, 64, 64, 0.5)
    assert 0.4 < float((a != b).float().mean()) < 0.6


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_within_binomial_bounds(p):
    mask = tdrop.attention_keep_mask(2024, 4, 3, 256, 256, p)
    n = mask.numel()
    rate = float(mask.float().mean())
    assert abs(rate - (1 - p)) < SIGMAS * math.sqrt(p * (1 - p) / n)
    # no structure along rows or columns: per-row rates spread binomially
    rows = mask.float().mean(dim=-1).flatten()
    assert float(rows.std()) < 2 * math.sqrt(p * (1 - p) / 256)


def test_seed_must_be_uint64():
    with pytest.raises(ValueError, match="uint64"):
        tdrop.attention_keep_bits(-1, 1, 1, 2, 2)


def test_dropout_keeps_scales_and_follows_its_generator():
    x = torch.ones(200, 300)
    g = torch.Generator().manual_seed(0)
    y = tdrop.dropout(x, 0.1, g)
    kept = y != 0
    rate = float(kept.float().mean())
    assert abs(rate - 0.9) < SIGMAS * math.sqrt(0.09 / x.numel())
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    y2 = tdrop.dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)


@pytest.mark.parametrize("p,gen,det", [(0.1, True, True), (0.0, True, False),
                                       (0.0, False, False)])
def test_dropout_passes_through(p, gen, det):
    x = torch.randn(4, 5)
    g = torch.Generator().manual_seed(0) if gen else None
    assert tdrop.dropout(x, p, g, deterministic=det) is x


def test_dropout_needs_a_generator_when_it_drops():
    with pytest.raises(ValueError, match="generator"):
        tdrop.dropout(torch.randn(4, 5), 0.1, None)


def test_draw_seed_and_device_generator_follow_the_host_generator():
    a = torch.Generator().manual_seed(3)
    b = torch.Generator().manual_seed(3)
    s = tdrop.draw_seed(a)
    assert s == tdrop.draw_seed(b) and 0 <= s < tdrop.SEED_BOUND
    ga = tdrop.device_generator(a, torch.device("cpu"))
    gb = tdrop.device_generator(b, torch.device("cpu"))
    assert torch.equal(torch.rand(5, generator=ga), torch.rand(5, generator=gb))
