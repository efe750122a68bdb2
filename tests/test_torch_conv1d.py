"""The port's strided conv (``ops/conv1d.py``) against the JAX package's
Pallas kernels, run in interpret mode on the CPU as ``tests/test_conv1d.py``
runs them: the forward, dX and dW of the plain version (the CPU route of
``conv1d_strided``) on the same numpy inputs, and the scope checks. The
CUDA kernels are held against the plain version in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from speech_ssl_compression_tpu.ops.conv1d import conv1d_strided as jax_conv
from speech_ssl_compression_tpu_torch.ops import conv1d as tconv

CASES = [(3, 2, 1000), (2, 2, 777), (3, 2, 515)]


def _inputs(k, t, seed=0, b=2, c=128, o=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, c, o))).astype(np.float32)
    return x, w, rng


@pytest.mark.parametrize("k,s,t", CASES)
def test_plain_forward_and_grads_match_jax_interpret(k, s, t):
    x, w, rng = _inputs(k, t)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), s, 64))
    dy = rng.standard_normal(want.shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        gx, gw = jax.grad(
            lambda x, w: jnp.sum(jax_conv(x, w, s, 64) * dy), argnums=(0, 1),
        )(jnp.asarray(x), jnp.asarray(w))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tconv.reset_launch_counts()
    got = tconv.conv1d_strided(xt, wt, s)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=2e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), atol=2e-4)
    # rows past the last one any output reaches get a zero gradient
    last = (got.shape[1] - 1) * s + k
    assert not xt.grad[:, last:].any()
    # the CPU route never counts a kernel launch
    assert not any(tconv.launch_counts.values())


FOLD_BAR = 1e-5  # max |d| / mean |ref|, f32


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).mean())


@pytest.mark.parametrize("k,s,t", [(9, 9, 777), (20, 9, 300)])
def test_stride_fold_matches_jax_interpret(k, s, t, monkeypatch):
    # past SM90_MAX_STRIDE conv1d_strided folds the stride into the
    # channels and runs the stride-1 route; forward, dX and dW against
    # JAX's Pallas conv and its VJP
    assert s > tconv.SM90_MAX_STRIDE
    x, w, rng = _inputs(k, t, seed=4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), s, 64))
    dy = rng.standard_normal(want.shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        gx, gw = jax.grad(
            lambda x, w: jnp.sum(jax_conv(x, w, s, 64) * dy), argnums=(0, 1),
        )(jnp.asarray(x), jnp.asarray(w))

    folds = []

    def counting_fold(x, w, stride):
        xf, wf = fold(x, w, stride)
        folds.append((tuple(xf.shape), tuple(wf.shape)))
        return xf, wf

    fold = tconv.fold_stride
    monkeypatch.setattr(tconv, "fold_stride", counting_fold)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = tconv.conv1d_strided(xt, wt, s)
    kq = -(-k // s)
    t_out = tconv.output_length(t, k, s)
    assert folds == [((2, t_out + kq - 1, s * 128), (kq, s * 128, 128))]
    assert got.shape == want.shape
    got.backward(torch.from_numpy(dy))
    assert _rel(got.detach().numpy(), want) < FOLD_BAR
    assert _rel(xt.grad.numpy(), np.asarray(gx)) < FOLD_BAR
    assert _rel(wt.grad.numpy(), np.asarray(gw)) < FOLD_BAR
    last = (t_out - 1) * s + k
    assert not xt.grad[:, last:].any()
    # the fold computes the same function as the unfolded plain version
    ref = tconv.conv1d_strided_plain(xt.detach().double(),
                                     wt.detach().double(), s)
    xf, wf = fold(xt.detach().double(), wt.detach().double(), s)
    assert torch.allclose(tconv.conv1d_strided_plain(xf, wf, 1), ref,
                          rtol=0, atol=1e-12)


@pytest.mark.parametrize("k,s,t", CASES)
def test_plain_grads_equal_autograd_through_the_function(k, s, t):
    x, w, rng = _inputs(k, t, seed=1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    dy = torch.from_numpy(rng.standard_normal(
        (2, tconv.output_length(t, k, s), 128)).astype(np.float32))
    dx, dw = tconv.plain_grads(xt, wt, s, dy)
    xg, wg = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    tconv.conv1d_strided(xg, wg, s).backward(dy)
    assert torch.equal(dx, xg.grad) and torch.equal(dw, wg.grad)


def by_phase_dx(dy, w, t_in, s):
    """dX as the bf16 dX kernel decomposes it: one GEMM per stride phase r.
    Input row s u + r, for u < n_r = (T_in - 1 - r) // s + 1, sums over the
    taps q < ceil((K - r) / s) dy row u - q (zero outside [0, T_out)) times
    w[s q + r] transposed."""
    b, t_out, o = dy.shape
    k, c, _ = w.shape
    dx = torch.zeros((b, t_in, c), dtype=dy.dtype)
    for r in range(s):
        n_r = (t_in - 1 - r) // s + 1
        u = torch.arange(n_r)
        acc = torch.zeros((b, n_r, c), dtype=dy.dtype)
        for q in range(-(-(k - r) // s)):
            reached = (u - q >= 0) & (u - q < t_out)
            rows = torch.zeros((b, n_r, o), dtype=dy.dtype)
            rows[:, reached] = dy[:, (u - q)[reached]]
            acc += rows @ w[s * q + r].T
        dx[:, r::s] = acc
    return dx


# CASES, taps over three phases, and one output row (B, T) = (2, 3)
BY_PHASE_CASES = [(k, s, t, 2) for k, s, t in CASES] + [(7, 3, 400, 2),
                                                         (3, 2, 3, 2)]


@pytest.mark.parametrize("k,s,t,b", BY_PHASE_CASES)
def test_by_phase_dx_equals_the_plain_dx(k, s, t, b):
    # the bf16 dX kernel's index maths (phases, rows per phase, taps per
    # phase, dy rows read as zeros outside [0, T_out)) give the plain dX,
    # which test_plain_forward_and_grads_match_jax_interpret holds against
    # JAX's Pallas dX; float64, so only the order of the additions differs
    x, w, rng = _inputs(k, t, seed=4, b=b)
    x64, w64 = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    t_out = tconv.output_length(t, k, s)
    dy = torch.from_numpy(rng.standard_normal((b, t_out, 128)))
    want = tconv.plain_grads(x64, w64, s, dy)[0]
    got = by_phase_dx(dy, w64, t, s)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert not got[:, (t_out - 1) * s + k:].any()


def test_plain_bf16_rounds_only_the_output():
    x, w, _ = _inputs(3, 301, seed=2)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    def differ(a, b):
        return float((a != b).float().mean())

    # the f32 sums and the float64 ones round to bf16 alike but where they
    # straddle a rounding point; rounding each tap's product first does not
    got = tconv.conv1d_strided_plain(xb, wb, 2)
    want = tconv.conv1d_strided_plain(xb.double(), wb.double(), 2)
    per_tap = sum(torch.matmul(xb[:, j: j + 299: 2].float(), wb[j].float())
                  .bfloat16().float() for j in range(3)).bfloat16()
    assert got.dtype == torch.bfloat16
    assert differ(got, want.bfloat16()) < 0.01 < 0.1 < differ(per_tap, got)
    dy = torch.from_numpy(np.random.default_rng(3).standard_normal(
        got.shape)).bfloat16()
    dx, dw = tconv.plain_grads(xb, wb, 2, dy)
    dx64, dw64 = tconv.plain_grads(xb.double(), wb.double(), 2, dy.double())
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert differ(dx, dx64.bfloat16()) < 0.01
    assert differ(dw, dw64.bfloat16()) < 0.01


@pytest.mark.parametrize("k,s,c,o,msg", [
    (3, 4, 128, 128, "stride <= K"),
    (17, 2, 128, 128, "K <= 8"),
    (3, 0, 128, 128, "stride >= 1"),
    (3, 2, 96, 128, "multiples of 128"),
    (3, 2, 128, 64, "multiples of 128"),
])
def test_scope_errors_as_in_jax(k, s, c, o, msg):
    x = torch.zeros((1, 64, c))
    w = torch.zeros((k, c, o))
    with pytest.raises(ValueError, match=msg) as port_err:
        tconv.conv1d_strided(x, w, s)
    with pytest.raises(ValueError) as jax_err:
        jax_conv(jnp.zeros((1, 64, c)), jnp.zeros((k, c, o)), s)
    assert str(port_err.value) == str(jax_err.value)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 64, 128))
    w = torch.zeros((3, 128, 128))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tconv.launch_fwd(x, w, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tconv.launch_dw(x, torch.zeros((1, 31, 128)), 3, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tconv.launch_dx(torch.zeros((1, 31, 128)), w, 64, 2)


# (B, T_out) of HuBERT's layers 1-6 in the training batch and of the card's
# ragged test shapes (one output row, one past a 64-row step, three batches)
TILE_CASES = [(4, 49151), (4, 24575), (4, 12287), (4, 6143), (4, 3071),
              (4, 1535), (2, 1), (2, 65), (3, 388), (1, 64), (1, 63)]


def _check_step_plan(b, t_out, blocks, step):
    """A dW kernel's plan in steps of ``step`` rows: step i is batch i //
    s_b, rows step (i % s_b) .. + step - 1, so a step never straddles two
    batches, and split k sums steps k chunk .. (k + 1) chunk - 1; together
    they cover every (b, t) row once."""
    chunk, n = tconv.dw_tile_splits(b, t_out, blocks, 132, step)
    s_b = -(-t_out // step)
    total = b * s_b
    order = [i for k in range(n)
             for i in range(k * chunk, min(total, (k + 1) * chunk))]
    assert order == list(range(total))  # every step once, in (b, t) order
    assert all(k * chunk < total for k in range(n))  # no empty split
    rows = [(i // s_b, t) for i in order
            for t in range(step * (i % s_b), min(t_out, step * (i % s_b + 1)))]
    assert rows == [(bb, t) for bb in range(b) for t in range(t_out)]
    # at least DW_MIN_CHUNK rows a split where there are that many, at most
    # DW_WAVES blocks per SM, and at least one block per SM where the steps
    # allow it (132 SMs, an H100 SXM)
    assert chunk * step >= min(tconv.DW_MIN_CHUNK, total * step)
    assert n * blocks <= max(blocks, tconv.DW_WAVES * 132)
    if total >= 132 * tconv.DW_MIN_CHUNK // step:
        assert n * blocks >= 132
    # the sum order is a function of the shape and the card alone
    assert tconv.dw_tile_splits(b, t_out, blocks, 132, step) == (chunk, n)


@pytest.mark.parametrize("b,t_out", TILE_CASES)
@pytest.mark.parametrize("blocks", [48, 16, 3])
def test_dw_tile_splits_cover_every_step_once_in_order(b, t_out, blocks):
    # the bf16 dW kernel's plan, in 64-row steps
    assert tconv.dw_tile_splits(b, t_out, blocks, 132) == \
        tconv.dw_tile_splits(b, t_out, blocks, 132, tconv.DW_STEP)
    _check_step_plan(b, t_out, blocks, tconv.DW_STEP)


@pytest.mark.parametrize("b,t_out", TILE_CASES)
@pytest.mark.parametrize("blocks", [48, 16, 3])
def test_dw_f32_plan_covers_every_32_row_step_once_in_order(b, t_out, blocks):
    # the f32 dW kernel's plan (csrc/conv1d_f32_sm90.cu), in 32-row steps,
    # as dw_plan gives it for f32 (K = blocks taps at C = O = 128)
    chunk, n, _ = tconv.dw_plan(torch.float32, b, t_out, blocks, 128, 128,
                                132)
    assert (chunk, n) == tconv.dw_tile_splits(b, t_out, blocks, 132,
                                              tconv.DW_F32_STEP)
    _check_step_plan(b, t_out, blocks, tconv.DW_F32_STEP)


@pytest.mark.parametrize("t_in,s", [(3, 2), (131, 2), (300, 2), (302, 2),
                                    (400, 3), (49152, 5), (64, 8), (9, 1)])
def test_phase_rows_hold_every_row_an_output_reads(t_in, s):
    # the bf16 kernels' per-phase TMA maps: phase r holds rows r, r + s, ...
    # of each batch; tap j = s q + r of output t reads phase row t + q, which
    # lies below n_r for every t < T_out and K the scope allows
    n = tconv.phase_rows(t_in, s)
    assert n == [len(range(r, t_in, s)) for r in range(s)]
    assert sum(n) == t_in
    for k in range(s, min(8 * s, t_in) + 1):
        t_out = tconv.output_length(t_in, k, s)
        for j in range(k):
            q, r = divmod(j, s)
            assert (t_out - 1) + q < n[r]
            assert s * (t_out - 1 + q) + r == s * (t_out - 1) + j < t_in


def test_phase_rows_refuse_strides_past_the_maps_a_launch_carries():
    assert len(tconv.phase_rows(100, tconv.SM90_MAX_STRIDE)) == 8
    with pytest.raises(ValueError, match="stride <= 8"):
        tconv.phase_rows(100, tconv.SM90_MAX_STRIDE + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t_out,k,c,o", [(4, 24575, 3, 512, 512),
                                           (2, 1, 3, 512, 512),
                                           (2, 257, 3, 256, 384),
                                           (1, 40, 2, 128, 128)])
def test_dw_plan_scratch_holds_one_slot_per_split(dtype, b, t_out, k, c, o):
    chunk, n, scratch = tconv.dw_plan(dtype, b, t_out, k, c, o, 132)
    blocks = k * (c // 128) * (o // 128)
    step = tconv.DW_STEP if dtype == torch.bfloat16 else tconv.DW_F32_STEP
    assert (chunk, n) == tconv.dw_tile_splits(b, t_out, blocks, 132, step)
    # one f32 (K, C, O) slot per split; none where one split writes dW
    assert scratch == ((n, k, c, o) if n > 1 else None)
    if scratch:
        assert np.prod(scratch) * 4 <= tconv.DW_WAVES * 132 * 128 * 128 * 4
