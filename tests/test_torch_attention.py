"""The port's multi-head self-attention against the JAX
``ops/attention.py::multi_head_self_attention`` (``impl="dense"``) on the
same weights: out and the pre-out-proj context."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.models.encoder import init_encoder_layer
from speech_ssl_compression_tpu.ops.attention import (
    multi_head_self_attention as jax_mhsa,
)
from speech_ssl_compression_tpu_torch.ops.attention import (
    SelfAttention,
    dense_attention,
    multi_head_self_attention,
)

BAR = 1e-4  # max |d| / mean |ref| on valid frames (tests/test_model_golden.py)
D, HEAD_DIM, T = 128, 64, 48


def _attention(num_heads, seed=0):
    p = jax.tree.map(np.asarray, init_encoder_layer(
        jax.random.PRNGKey(seed), D, 256, num_heads, HEAD_DIM))
    attn = SelfAttention(D, num_heads, HEAD_DIM)
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            mod = getattr(attn, name)
            mod.weight.copy_(torch.tensor(p[name]["kernel"].T))
            mod.bias.copy_(torch.tensor(p[name]["bias"]))
    return p, attn


def _masks(kind):
    if kind == "none":
        return None, None, False
    if kind == "padding":
        return np.arange(T)[None, :] >= np.array([[T], [30]]), None, False
    if kind == "causal":
        return None, None, True
    seg = np.zeros((2, T), np.int32)  # two packed rows, pad slots 0
    seg[0, :20], seg[0, 20:44] = 1, 2
    seg[1, :40] = 3
    return seg == 0, seg, False


def _rel(got, ref, valid):
    return np.abs(got - ref)[valid].max() / np.abs(ref)[valid].mean()


@pytest.mark.parametrize("impl", ["dense", "auto"])
@pytest.mark.parametrize("kind", ["none", "padding", "segments", "causal"])
@pytest.mark.parametrize("num_heads", [2, 1])
def test_mhsa_matches_jax_dense(impl, kind, num_heads):
    p, attn = _attention(num_heads)
    x = np.random.default_rng(1).standard_normal((2, T, D)).astype(np.float32)
    pad, seg, causal = _masks(kind)
    ref_out, ref_ctx = jax_mhsa(
        jnp.asarray(x), p, num_heads=num_heads, head_dim=HEAD_DIM,
        key_padding_mask=None if pad is None else jnp.asarray(pad),
        causal=causal,
        segment_ids=None if seg is None else jnp.asarray(seg),
        impl="dense",
    )
    with torch.no_grad():
        out, ctx = multi_head_self_attention(
            torch.from_numpy(x), attn, num_heads=num_heads, head_dim=HEAD_DIM,
            key_padding_mask=None if pad is None else torch.from_numpy(pad),
            causal=causal,
            segment_ids=None if seg is None else torch.from_numpy(seg),
            impl=impl,
        )
    valid = np.ones((2, T), bool) if seg is None else seg != 0
    assert out.shape == (2, T, D) and ctx.shape == (2, num_heads, T, HEAD_DIM)
    assert _rel(out.numpy(), np.asarray(ref_out), valid) < BAR
    ctx_valid = np.broadcast_to(valid[:, None, :], ctx.shape[:3])
    assert _rel(ctx.numpy(), np.asarray(ref_ctx), ctx_valid) < BAR


def test_dense_fully_masked_row_is_uniform_average():
    """A row with every key masked averages v uniformly (the JAX dense
    path's behaviour); packed serving drops such rows."""
    q, k, v = (torch.randn(1, 1, 8, 4, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    out = dense_attention(q, k, v,
                          key_padding_mask=torch.ones(1, 8, dtype=torch.bool))
    torch.testing.assert_close(out[0, 0], v[0, 0].mean(0).expand(8, 4))


def test_unknown_impl_raises():
    _, attn = _attention(1)
    with pytest.raises(ValueError, match="impl"):
        multi_head_self_attention(torch.zeros(1, 4, D), attn, num_heads=1,
                                  head_dim=HEAD_DIM, impl="pallas")


@pytest.mark.parametrize("kind", ["none", "padding", "causal"])
def test_dense_bf16_scores_stay_f32_as_in_jax(kind):
    """bf16 inputs: the scores are accumulated and kept in f32 (JAX's
    preferred_element_type=float32), so the port and JAX round only the
    probabilities and the output, and differ by at most one bf16 ulp of
    the output's scale in a few places. Rounding the scores to bf16 first
    (the fault this test guards against) moves most outputs."""
    from speech_ssl_compression_tpu.ops.attention import (
        dense_attention as jax_dense,
    )

    pad, _, causal = _masks(kind)
    rng = np.random.default_rng(7)
    q, k, v = (2.0 * rng.standard_normal((2, 2, T, HEAD_DIM))
               for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jax_dense(
        jq, jk, jv, causal=causal,
        key_padding_mask=None if pad is None else jnp.asarray(pad),
    ).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    kpm = None if pad is None else torch.from_numpy(pad)
    got = dense_attention(tq, tk, tv, key_padding_mask=kpm,
                          causal=causal).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(got - ref).max() <= ulp
    assert (got != ref).mean() < 0.01
    # the control: scores rounded to bf16 before the softmax
    scores = (torch.matmul(tq * 0.125, tk.transpose(-1, -2)).float())
    if kpm is not None:
        scores = scores.masked_fill(kpm[:, None, None, :], -1e30)
    if causal:
        scores = scores.masked_fill(
            torch.ones(T, T, dtype=torch.bool).triu(1), -1e30)
    control = torch.matmul(torch.softmax(scores, -1).to(torch.bfloat16),
                           tv).float().numpy()
    assert (control != ref).mean() > 0.2
