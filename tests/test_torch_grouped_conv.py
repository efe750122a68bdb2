"""The port's grouped positional conv (``ops/grouped_conv.py``) against
JAX's ``grouped_conv1d`` through ``jax.vjp``: the forward, dX and dW and
their dtypes, f32 (within 1e-5 rel. L2) and bf16 (within 1e-2, f32 sums
out), at the 192-wide shapes where torch's CPU bf16 grouped ``conv1d``
goes wrong, at the tests' tiny widths and at the deep stack's K = 19,
SamePad and VALID; the encoder's ``_grouped_conv_samepad`` in bf16
against JAX's; and dW's tap chunks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_ssl_compression_tpu.models.encoder import (
    _grouped_conv_samepad as jax_samepad,
)
from speech_ssl_compression_tpu.ops.grouped_conv import (
    grouped_conv1d as jax_grouped_conv1d,
)
from speech_ssl_compression_tpu_torch.models.encoder import (
    _grouped_conv_samepad,
)
from speech_ssl_compression_tpu_torch.ops.grouped_conv import (
    grouped_conv1d,
    grouped_conv1d_dw,
)

F32_BAR = 1e-5   # rel. L2
BF16_BAR = 1e-2  # rel. L2
SHAPES = {"192_k16": (2, 96, 192, 16, 16), "192_k128": (2, 96, 192, 16, 128),
          "tiny": (2, 40, 32, 2, 8), "deep_k19": (1, 48, 64, 4, 19)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


def inputs(shape, pad, seed=0):
    """x (B, T_in, C), w (K, C/G, C), dy (B, T_out, C), seeded; a VALID
    conv reads a window of T + K - 1 frames, as a stream step does."""
    b, t, c, g, k = shape
    t_in = t if pad != (0, 0) else t + k - 1
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t_in, c)).astype(np.float32)
    w = (rng.standard_normal((k, c // g, c))
         / np.sqrt(k * c // g)).astype(np.float32)
    dy = rng.standard_normal(
        (b, t_in + pad[0] + pad[1] - k + 1, c)).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("padding", ["same", "valid"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_grouped_conv_matches_jax(name, padding, dtype):
    shape = SHAPES[name]
    groups, k = shape[3], shape[4]
    pad = (k // 2, k // 2) if padding == "same" else (0, 0)
    x, w, dy = inputs(shape, pad)
    jdt, tdt = DTYPES[dtype]

    y_j, pullback = jax.vjp(
        lambda a, b: jax_grouped_conv1d(a, b, groups, pad),
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt))
    dx_j, dw_j = pullback(jnp.asarray(dy).astype(y_j.dtype))

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    y = grouped_conv1d(xt, wt, groups, pad)
    dx, dw = torch.autograd.grad(y, (xt, wt),
                                 torch.from_numpy(dy).to(y.dtype))

    bar = F32_BAR if dtype == "f32" else BF16_BAR
    for got, ref in ((y, y_j), (dx, dx_j), (dw, dw_j)):
        assert str(got.dtype).removeprefix("torch.") == str(ref.dtype)
        assert tuple(got.shape) == ref.shape
        assert rel_l2(host(got), host(ref)) < bar
    # bf16 inputs give f32 sums out, and gradients in their inputs' dtype
    want = torch.float32 if dtype == "bf16" else tdt
    assert y.dtype == want and dx.dtype == tdt and dw.dtype == tdt


def test_samepad_bf16_matches_jax_at_192_wide():
    """The encoder's pos-conv in bf16 on the CPU, 192 wide in 16 groups of
    12 at an even K: torch's bf16 grouped conv1d lay ~1.16 rel. L2 from
    JAX here; the port now computes JAX's function."""
    b, t, c, g, k = SHAPES["192_k16"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = (rng.standard_normal((c, c // g, k))
         / np.sqrt(k * c // g)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = jax_samepad(*(jnp.asarray(a).astype(jnp.bfloat16)
                        for a in (x, w, bias)), g, k)
    got = _grouped_conv_samepad(*(torch.from_numpy(a).bfloat16()
                                  for a in (x, w, bias)), g, k)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    assert rel_l2(host(got), host(ref)) < BF16_BAR


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_tap_chunks_give_the_same_sums(dtype):
    """A chunk of one tap and a chunk of all taps sum the same products in
    the same order: the same f32 bits."""
    x, w, dy = inputs(SHAPES["deep_k19"], (9, 9), seed=2)
    x = torch.from_numpy(x).to(dtype)
    dy = torch.from_numpy(dy)
    whole = grouped_conv1d_dw(x, dy, 19, 4, (9, 9))
    for chunk_bytes in (1, 5 * x.shape[0] * dy.shape[1] * x.shape[2] * 4):
        part = grouped_conv1d_dw(x, dy, 19, 4, (9, 9), chunk_bytes)
        assert part.dtype == torch.float32
        assert torch.equal(part, whole)
