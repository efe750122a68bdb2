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


def test_dw_splits_cover_every_row():
    # blocks per split: K (C/128) (O/128) of HuBERT's layers 1-6 and of a
    # narrow layer; 132 SMs (an H100 SXM)
    for blocks in (48, 32, 1):
        for rows in (1, 7, 255, 256, 257, 2047, 2049, 3068, 98300, 600000):
            chunk, n = tconv.dw_splits(rows, blocks, 132)
            assert chunk % 8 == 0 and (n - 1) * chunk < rows <= n * chunk
            assert chunk >= min(tconv.DW_MIN_CHUNK, -(-rows // 8) * 8)
            # the scratch stays at what fills the SMs, whatever the rows
            assert n * blocks <= max(blocks, tconv.DW_WAVES * 132)
