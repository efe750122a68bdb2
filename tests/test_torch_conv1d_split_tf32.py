"""The arithmetic of the f32 strided-conv forward kernel
(``csrc/conv1d_f32_sm90.cu``), emulated on the CPU: split TF32.

The kernel walks the reduction over (tap j, channel c) in stages of 32
channels of one tap. Each stage's product x[b, s t + j, c0:c0 + 32] @
w[j, c0:c0 + 32, :] is taken as the three TF32 products hi_a lo_b +
lo_a hi_b + hi_a hi_b (hi = rna_tf32(x), lo = rna_tf32(x - hi)) into a
fresh accumulator, and joins the running sum with an f32 add. The
emulation sums each stage's products in float64 and rounds the stage to f32
once; the tensor cores sum in f32 in their own order, which the card tests
read. w enters as w^T (O, K C) in hi and lo, written by the kernel's split
kernel; ``split_w`` is its index map.

With the products emulated so, the plain forward holds the f32 conv bar
(max |d| / mean |ref| < 1e-5) against JAX's Pallas conv in interpret mode,
as ``tests/test_conv1d.py`` runs it, at C = O = 128 and strides 2 and 3. A
control with one TF32 product (hi_a hi_b) per stage must fail that bar."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from speech_ssl_compression_tpu.ops.conv1d import conv1d_strided as jax_conv
from speech_ssl_compression_tpu_torch.ops import conv1d as tconv
from tests.test_torch_flash_split_tf32 import one_tf32_mm, split, split_mm

BAR = 1e-5  # chip_smoke.py's CONV_F32_BAR, against an exact evaluation
STEP = 32  # channels of one stage of the kernel's reduction

CASES = [(3, 2, 301), (5, 3, 302)]  # (K, stride, T): strides 2 and 3


def _inputs(k, t, seed=0, b=2, c=128, o=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = (rng.standard_normal((k, c, o)) / np.sqrt(k * c)).astype(np.float32)
    return x, w


def split_w(w):
    """The split kernel's output for w (K, C, O): wt (2, O, K C) with
    wt[h, o, j C + c] = hi (h = 0) or lo (h = 1) of w[j, c, o]."""
    k, c, o = w.shape
    hi, lo = split(w.reshape(k * c, o).contiguous())
    return torch.stack([hi.T, lo.T])


def emulated_forward(mm, x, w, stride):
    """out[b, t, :] as the kernel sums it: per tap j and stage of STEP
    channels, mm(x rows, w stage), each stage rounded to f32 and added in
    f32 in the kernel's order (tap-major, channels within). The stage's
    split is checked against split_w's layout, where the kernel reads it."""
    k, c, o = w.shape
    t_out = tconv.output_length(x.shape[1], k, stride)
    wt = split_w(w)
    acc = torch.zeros((x.shape[0], t_out, o))
    for j in range(k):
        tap = x[:, j: j + (t_out - 1) * stride + 1: stride]
        for c0 in range(0, c, STEP):
            stage = w[j, c0:c0 + STEP]
            # the B operand the kernel reads from w^T is this stage's split
            rows = slice(j * c + c0, j * c + c0 + STEP)
            assert all(torch.equal(wt[h, :, rows].T, part)
                       for h, part in enumerate(split(stage)))
            acc = acc + mm(tap[..., c0:c0 + STEP], stage)
    return acc


def _errors(mm, k, s, t):
    x, w = _inputs(k, t)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), s, 64))
    got = emulated_forward(mm, torch.from_numpy(x), torch.from_numpy(w), s)
    assert got.shape == want.shape
    ref = np.asarray(want, np.float64)
    return float(np.abs(got.numpy() - ref).max() / np.abs(ref).mean())


def test_split_w_is_w_transposed_in_hi_and_lo():
    _, w = _inputs(3, 8)
    wt = split_w(torch.from_numpy(w))
    k, c, o = w.shape
    assert wt.shape == (2, o, k * c)
    for part in wt:  # both exact in TF32: 13 low bits clear
        assert not (part.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
    # hi + lo is w to within lo's rounding, 2^-22 |w|, at [h, o, j C + c]
    for j, ci, oi in ((0, 0, 0), (2, 127, 5), (1, 64, 127)):
        got = wt[0, oi, j * c + ci].double() + wt[1, oi, j * c + ci].double()
        assert abs(float(got) - float(w[j, ci, oi])) <= 2.0 ** -22 * abs(
            float(w[j, ci, oi]))


@pytest.mark.parametrize("k,s,t", CASES)
def test_split_tf32_conv_forward_holds_the_f32_bar(k, s, t):
    assert _errors(split_mm, k, s, t) < BAR


@pytest.mark.parametrize("k,s,t", CASES)
def test_one_tf32_product_conv_forward_fails_the_f32_bar(k, s, t):
    # the control: the bar tells split TF32 from plain TF32
    assert _errors(one_tf32_mm, k, s, t) > BAR
