"""The arithmetic of the f32 strided-conv kernels
(``csrc/conv1d_f32_sm90.cu``: forward, dW, dX), emulated on the CPU: split
TF32.

The forward walks the reduction over (tap j, channel c) in stages of 32
channels of one tap. Each stage's product x[b, s t + j, c0:c0 + 32] @
w[j, c0:c0 + 32, :] is taken as the three TF32 products hi_a lo_b +
lo_a hi_b + hi_a hi_b (hi = rna_tf32(x), lo = rna_tf32(x - hi)) into a
fresh accumulator, and joins the running sum with an f32 add. The
emulation sums each stage's products in float64 and rounds the stage to f32
once; the tensor cores sum in f32 in their own order, which the card tests
read. w enters as w^T (O, K C) in hi and lo, written by the kernel's split
kernel; ``split_w`` is its index map. dX runs one GEMM per stride phase r
in stages of 32 outputs o of one tap (``emulated_dx``), reading w's hi and
lo in w's own layout (``split_w_dx``); dW sums 32-row steps of one batch
per chunk of its plan, one slot a chunk, the slots added in chunk order
(``emulated_dw``).

With the products emulated so, each holds the f32 conv bar (forward and dX
max |d| / mean |ref|, dW rel. L2, < 1e-5) against JAX's Pallas conv and its
VJP (the Pallas dW and dX) in interpret mode, as ``tests/test_conv1d.py``
runs them, at C = O = 128 and strides 2 and 3; dW and dX also against the
plain version in float64. A control with one TF32 product (hi_a hi_b) per
stage must fail that bar."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from speech_ssl_compression_tpu.ops.conv1d import conv1d_strided as jax_conv
from speech_ssl_compression_tpu_torch.ops import conv1d as tconv
from tests.test_torch_flash_split_tf32 import one_tf32_mm, split, split_mm

BAR = 1e-5  # chip_smoke.py's CONV_F32_BAR, against an exact evaluation
STEP = 32  # depth of one stage of the kernels' reductions

CASES = [(3, 2, 301), (5, 3, 302)]  # (K, stride, T): strides 2 and 3
# dW and dX: long enough that dW's plan cuts the 32-row steps into 5 and 3
# chunks on 132 SMs
GRAD_CASES = [(3, 2, 1301), (5, 3, 1302)]


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


def split_w_dx(w):
    """The dX split kernel's output for w (K, C, O): ws (2, K C, O) with
    ws[h, j C + c, o] = hi (h = 0) or lo (h = 1) of w[j, c, o], in w's own
    layout (no transpose)."""
    k, c, o = w.shape
    return torch.stack(split(w.reshape(k * c, o).contiguous()))


def emulated_dx(mm, dy, w, t_in, stride):
    """dX as the kernel sums it: per phase r, input rows s u + r take, per
    tap q (j = s q + r) and stage of STEP outputs o, mm(dy rows u - q (zero
    outside [0, T_out)), w[j] stage^T), each stage rounded to f32 and added
    in f32 in the kernel's order (tap-major, outputs within). The stage's B
    operand is checked against split_w_dx's layout, where the kernel reads
    it."""
    b, t_out, o = dy.shape
    k, c, _ = w.shape
    ws = split_w_dx(w)
    dx = torch.zeros((b, t_in, c))
    for r in range(stride):
        n_r = (t_in - 1 - r) // stride + 1
        u = torch.arange(n_r)
        acc = torch.zeros((b, n_r, c))
        for q in range(-(-(k - r) // stride)):
            j = stride * q + r
            reached = (u - q >= 0) & (u - q < t_out)
            rows = torch.zeros((b, n_r, o))
            rows[:, reached] = dy[:, (u - q)[reached]]
            for o0 in range(0, o, STEP):
                stage = w[j, :, o0:o0 + STEP].contiguous()  # rows c
                assert all(torch.equal(ws[h, j * c:(j + 1) * c, o0:o0 + STEP],
                                       part)
                           for h, part in enumerate(split(stage)))
                acc = acc + mm(rows[..., o0:o0 + STEP], stage.T)
        dx[:, r::stride] = acc
    return dx


def emulated_dw(mm, x, dy, k, stride):
    """dW as the kernel sums it on 132 SMs: per chunk of the f32 plan
    (``dw_plan``), a slot summed over the chunk's 32-row steps of one batch
    in (b, t) order, per tap j mm(x rows s t + j transposed, dy rows t),
    each step rounded to f32 and added to the slot in f32; then the slots
    added in chunk order, as the reduce kernel does."""
    b, _, c = x.shape
    t_out, o = dy.shape[1:]
    chunk, n_split, _ = tconv.dw_plan(torch.float32, b, t_out, k, c, o, 132)
    s_b = -(-t_out // tconv.DW_F32_STEP)
    total = b * s_b
    slots = []
    for split_k in range(n_split):
        slot = torch.zeros((k, c, o))
        for i in range(split_k * chunk, min(total, (split_k + 1) * chunk)):
            bb, t0 = i // s_b, tconv.DW_F32_STEP * (i % s_b)
            t1 = min(t_out, t0 + tconv.DW_F32_STEP)
            for j in range(k):
                rows = x[bb, stride * t0 + j: stride * (t1 - 1) + j + 1: stride]
                slot[j] = slot[j] + mm(rows.T, dy[bb, t0:t1])
        slots.append(slot)
    dw = slots[0]
    for slot in slots[1:]:
        dw = dw + slot
    return dw, n_split


@functools.lru_cache(maxsize=None)
def _grads(k, s, t):
    """x, w and dy (numpy-seeded) at one case, with (dX, dW) from JAX's
    Pallas dX and dW in interpret mode and from the plain version in
    float64."""
    x, w = _inputs(k, t, seed=1)
    t_out = tconv.output_length(t, k, s)
    dy = np.random.default_rng(2).standard_normal((2, t_out, 128)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        gx, gw = jax.grad(
            lambda x, w: jnp.sum(jax_conv(x, w, s, 64) * dy), argnums=(0, 1),
        )(jnp.asarray(x), jnp.asarray(w))
    x, w, dy = map(torch.from_numpy, (x, w, dy))
    dx64, dw64 = tconv.plain_grads(x.double(), w.double(), s, dy.double())
    jax_refs = (torch.from_numpy(np.asarray(gx, np.float64)),
                torch.from_numpy(np.asarray(gw, np.float64)))
    return x, w, dy, jax_refs, (dx64, dw64)


def _dx_errors(mm, k, s, t):
    """max |d| / mean |ref| of emulated_dx against JAX's Pallas dX and the
    float64 plain dX."""
    x, w, dy, (jax_dx, _), (dx64, _) = _grads(k, s, t)
    got = emulated_dx(mm, dy, w, t, s)
    assert got.shape == x.shape
    assert not got[:, (dy.shape[1] - 1) * s + k:].any()  # rows never reached
    return [float((got.double() - ref).abs().max() / ref.abs().mean())
            for ref in (jax_dx, dx64)]


def _dw_errors(mm, k, s, t):
    """rel. L2 of emulated_dw against JAX's Pallas dW and the float64
    plain dW."""
    x, _, dy, (_, jax_dw), (_, dw64) = _grads(k, s, t)
    got, n_split = emulated_dw(mm, x, dy, k, s)
    assert n_split > 1  # the chunks and their fixed-order sum take part
    return [float(torch.linalg.vector_norm(got.double() - ref)
                  / torch.linalg.vector_norm(ref)) for ref in (jax_dw, dw64)]


def test_split_w_dx_is_w_in_hi_and_lo():
    _, w = _inputs(3, 8)
    ws = split_w_dx(torch.from_numpy(w))
    k, c, o = w.shape
    assert ws.shape == (2, k * c, o)
    for part in ws:  # both exact in TF32: 13 low bits clear
        assert not (part.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
    # hi + lo is w to within lo's rounding, 2^-22 |w|, at [h, j C + c, o]
    for j, ci, oi in ((0, 0, 0), (2, 127, 5), (1, 64, 127)):
        got = ws[0, j * c + ci, oi].double() + ws[1, j * c + ci, oi].double()
        assert abs(float(got) - float(w[j, ci, oi])) <= 2.0 ** -22 * abs(
            float(w[j, ci, oi]))


@pytest.mark.parametrize("k,s,t", GRAD_CASES)
def test_split_tf32_conv_dx_holds_the_f32_bar(k, s, t):
    assert max(_dx_errors(split_mm, k, s, t)) < BAR


@pytest.mark.parametrize("k,s,t", GRAD_CASES)
def test_one_tf32_product_conv_dx_fails_the_f32_bar(k, s, t):
    assert min(_dx_errors(one_tf32_mm, k, s, t)) > BAR


@pytest.mark.parametrize("k,s,t", GRAD_CASES)
def test_split_tf32_conv_dw_holds_the_f32_bar(k, s, t):
    assert max(_dw_errors(split_mm, k, s, t)) < BAR


@pytest.mark.parametrize("k,s,t", GRAD_CASES)
def test_one_tf32_product_conv_dw_fails_the_f32_bar(k, s, t):
    assert min(_dw_errors(one_tf32_mm, k, s, t)) > BAR
