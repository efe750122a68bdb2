"""The port's flash-attention gradients on CPU tensors (the plain backward
behind the autograd Function) against ``jax.grad`` of the JAX Pallas
kernels in interpret mode, and against torch autograd through the plain
forward with the dropout mask materialized. Gradients are compared with
dO = 0 on padded query rows, as the model gives them."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from speech_ssl_compression_tpu.ops import flash_attention as jfa
from speech_ssl_compression_tpu_torch.ops import flash_attention as tfa
from speech_ssl_compression_tpu_torch.ops.attention import dense_attention
from speech_ssl_compression_tpu_torch.ops.dropout import attention_keep_mask

BAR = 1e-4  # max |d| / mean |ref| (the golden bar, tests/test_model_golden.py)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).mean()


def _arrays(b, h, tq, tk=None, d=64, seed=0):
    rng = np.random.default_rng(seed)
    tk = tk or tq
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    dout = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    return q, k, v, dout


def _segments(t):
    row0 = [1] * (t // 3) + [2] * (t // 2)
    row1 = [3] * (3 * t // 4)
    seg = np.zeros((2, t), np.int32)
    seg[0, : len(row0)] = row0
    seg[1, : len(row1)] = row1
    return seg


def _padding(lengths, t):
    return np.arange(t)[None, :] >= np.asarray(lengths)[:, None]


CASES = {
    # name: (b, h, t, key padding, segment ids, causal)
    "padding": (2, 2, 96, _padding([96, 70], 96), None, False),
    "segments": (2, 2, 192, _segments(192) == 0, _segments(192), False),
    "causal": (1, 2, 80, None, None, True),
    "causal_padding": (2, 2, 64, _padding([64, 40], 64), None, True),
    "one_head": (2, 1, 128, _padding([128, 33], 128), None, False),
}


def _valid_rows(b, t, seg):
    return np.ones((b, t), bool) if seg is None else seg != 0


def _torch_grads(q, k, v, dout, **kw):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(q, k, v, **kw)
    out.backward(torch.from_numpy(dout))
    return [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_grads_match_pallas_interpret(name):
    b, h, t, pad, seg, causal = CASES[name]
    q, k, v, dout = _arrays(b, h, t, seed=1)
    dout = dout * _valid_rows(b, t, seg)[:, None, :, None]

    def loss(q, k, v):
        out = jfa.flash_attention(
            q, k, v, key_padding_mask=None if pad is None else jnp.asarray(pad),
            causal=causal, segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(out * jnp.asarray(dout))

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _torch_grads(
        q, k, v, dout,
        key_padding_mask=None if pad is None else torch.from_numpy(pad),
        causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    for name_, g, r in zip("qkv", got, ref):
        assert _rel(g, r) < BAR, name_


def test_kv_full_grads_match_pallas_streamed_backward():
    q, k, v, dout = _arrays(2, 2, 64, tk=192, seed=2)
    pad = _padding([192, 150], 192)

    def loss(q, k, v):
        out = jfa.flash_attention_kv_full(q, k, v,
                                          key_padding_mask=jnp.asarray(pad))
        return jnp.sum(out * jnp.asarray(dout))

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention_kv_full(qt, kt, vt,
                                      key_padding_mask=torch.from_numpy(pad))
    out.backward(torch.from_numpy(dout))
    for name_, g, r in zip("qkv", (qt.grad, kt.grad, vt.grad), ref):
        assert _rel(g.numpy(), r) < BAR, name_


DROPOUT_CASES = {
    # name: (b, h, t, key padding, segment ids, causal, dropout_p)
    "padding_p0.1": (2, 3, 96, _padding([96, 70], 96), None, False, 0.1),
    "causal_p0.5": (1, 2, 80, None, None, True, 0.5),
    "segments_p0.1": (2, 2, 192, _segments(192) == 0, _segments(192), False,
                      0.1),
    "no_dropout": (2, 2, 64, _padding([64, 50], 64), None, False, 0.0),
}


@pytest.mark.parametrize("name", sorted(DROPOUT_CASES))
def test_plain_backward_matches_autograd_through_plain_forward(name):
    # autograd differentiates the plain forward, the mask materialized in
    # it; the plain backward must agree, and it uses Pd and P apart
    b, h, t, pad, seg, causal, p = DROPOUT_CASES[name]
    q, k, v, dout = _arrays(b, h, t, d=32, seed=3)
    kw = dict(key_padding_mask=None if pad is None else torch.from_numpy(pad),
              causal=causal,
              segment_ids=None if seg is None else torch.from_numpy(seg),
              dropout_p=p, dropout_seed=77 if p else None)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = tfa.flash_attention_reference(qt, kt, vt, **kw)
    dout_t = torch.from_numpy(dout) * torch.from_numpy(
        _valid_rows(b, t, seg))[:, None, :, None]
    out.backward(dout_t)
    args = tfa.backward_args(qt.detach(), kt.detach(), vt.detach(),
                             out.detach(), lse.detach(), dout_t, **kw)
    got = (tfa.reference_bwd_dq(*args),) + tfa.reference_bwd_dkv(*args)
    for name_, g, r in zip("qkv", got, (qt.grad, kt.grad, vt.grad)):
        assert _rel(g.numpy(), r.numpy()) < BAR, name_
    # and the autograd Function's backward is that plain backward on CPU
    func = _torch_grads(q, k, v, dout_t.numpy(), **kw)
    for g, r in zip(func, got):
        np.testing.assert_array_equal(g, r.numpy())


def test_dropout_forward_applies_the_keep_mask_to_normalized_probabilities():
    q, k, v, _ = _arrays(2, 2, 64, seed=4)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, dropout_p=0.1, dropout_seed=9)
    probs = torch.softmax(qt @ kt.transpose(-1, -2) / 8.0, dim=-1)
    keep = attention_keep_mask(9, 2, 2, 64, 64, 0.1)
    ref = (probs * keep / 0.9) @ vt
    assert _rel(out.numpy(), ref.numpy()) < BAR
    # the dense path draws the same bits
    dense = dense_attention(qt, kt, vt, dropout_p=0.1, dropout_seed=9)
    assert _rel(dense.numpy(), ref.numpy()) < BAR
    # another seed, another mask
    other = tfa.flash_attention(qt, kt, vt, dropout_p=0.1, dropout_seed=10)
    assert not torch.allclose(other, out)


@pytest.mark.parametrize("causal", [False, True])
def test_tiled_dropout_forward_matches_untiled_in_f32(causal):
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(1, 2, 150, seed=5))
    kw = dict(causal=causal, dropout_p=0.1, dropout_seed=3)
    out, lse = tfa.flash_attention_reference(q, k, v, **kw)
    out_t, lse_t = tfa.flash_attention_reference(
        q, k, v, block_k=tfa.KERNEL_BLOCK_K, **kw)
    np.testing.assert_allclose(out_t.numpy(), out.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lse_t.numpy(), lse.numpy(), atol=1e-5)


def test_dropout_refuses_long_sequences_and_a_missing_seed():
    q = torch.zeros(1, 1, tfa.DROPOUT_MAX_T + 1, 64)
    with pytest.raises(NotImplementedError, match="T <= 4096"):
        tfa.flash_attention(q, q, q, dropout_p=0.1, dropout_seed=1)
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="seed"):
        tfa.flash_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="dropout_p"):
        tfa.flash_attention(q, q, q, dropout_p=1.0, dropout_seed=1)
    with pytest.raises(TypeError):
        tfa.flash_attention_kv_full(q, q, q, dropout_p=0.1)


def _backward_f64(q, k, v, bias, segq, segk, causal, dropout_p, seed, lse,
                  dout, dd, round_inner=True):
    """The backward's formulas in float64 (no segments), dS and Pd rounded
    to the input dtype before the sums unless ``round_inner`` is False:
    a backward whose f32 values differ from the plain one's by rounding."""
    qd, kd, vd, dod = (t.double() for t in (q, k, v, dout))
    s = qd @ kd.mT / 8.0 + bias.double()[:, None, None, :]
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool).triu(1),
                          tfa.NEG_INF)
    p = torch.exp(s - lse.double()[..., None])
    pd = p
    if dropout_p:
        keep = attention_keep_mask(seed, *q.shape[:3], k.shape[2], dropout_p)
        pd = torch.where(keep, p / (1 - dropout_p), 0.0)
    ds = pd * (dod @ vd.mT) - p * dd.double()[..., None]
    if round_inner:
        ds, pd = (t.to(q.dtype).double() for t in (ds, pd))
    return tuple(t.to(q.dtype) for t in (ds @ kd / 8.0, ds.mT @ qd / 8.0,
                                         pd.mT @ dod))


def _beyond_ulp_and_bound(got, ref, bound):
    """Entries where |got - ref| exceeds one bf16 ulp of max(|ref|, mean
    |ref|) plus the straddle bound (chip_smoke.py's bar)."""
    got, ref = got.double(), ref.double()
    mag = ref.abs().clamp_min(float(ref.abs().mean()))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return int(((got - ref).abs() > ulp + bound.double()).sum())


@pytest.mark.parametrize("causal,dropout_p", [(False, 0.0), (False, 0.1),
                                              (True, 0.1)])
def test_bf16_straddle_bounds_hold_for_another_rounding(causal, dropout_p):
    # the bound is built from the inputs; a float64 backward rounds dS and
    # Pd from other f32-level values, and must stay within 1 ulp + bound of
    # the plain backward; skipping that rounding must not
    q, k, v, dout = (torch.from_numpy(a).bfloat16()
                     for a in _arrays(2, 3, 128, seed=7))
    kw = dict(key_padding_mask=torch.from_numpy(_padding([128, 90], 128)),
              causal=causal, dropout_p=dropout_p,
              dropout_seed=11 if dropout_p else None)
    out, lse = tfa.flash_attention_reference(q, k, v, **kw)
    args = tfa.backward_args(q, k, v, out, lse, dout, **kw)
    ref = (tfa.reference_bwd_dq(*args),) + tfa.reference_bwd_dkv(*args)
    bounds = tfa.bf16_straddle_bounds(*args)
    assert all(torch.isfinite(b).all() and (b >= 0).all() for b in bounds)
    for got, r, b in zip(_backward_f64(*args), ref, bounds):
        assert _beyond_ulp_and_bound(got, r, b) == 0
    unrounded = _backward_f64(*args, round_inner=False)
    assert sum(_beyond_ulp_and_bound(g, r, b)
               for g, r, b in zip(unrounded, ref, bounds)) > 0


def test_cpu_backward_counts_no_launches():
    q, k, v, dout = _arrays(1, 2, 40, d=16, seed=6)
    tfa.reset_launch_counts()
    _torch_grads(q, k, v, dout, causal=True, dropout_p=0.2, dropout_seed=1)
    assert set(tfa.launch_counts.values()) == {0}
