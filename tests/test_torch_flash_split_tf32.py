"""The arithmetic of the f32 flash-attention kernels
(``csrc/flash_attn_fwd_f32_sm90.cu``, ``csrc/flash_attn_bwd_f32_sm90.cu``),
emulated on the CPU: split TF32.

Each f32 operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
(round to nearest, ties away from zero, to TF32's 10 mantissa bits), and
each product (the forward's S = Q K^T and P V; the backward's S = Q K^T,
dPd = dO V^T, dQ = dS K, dK = dS^T Q, dV = Pd^T dO) is taken as
hi_a lo_b + lo_a hi_b + hi_a hi_b. The emulation sums those in float64 and
rounds each product to f32 once; the tensor cores sum in f32 in their own
order, which the card tests read. The forward's emulation walks the keys
in the kernel's 32-key tiles: each tile's P V is one such product, joined
to the running output by the online-softmax rescale in f32.

With the products emulated so, the plain versions hold the f32 bar
(max |d| / mean |ref| < 1e-4; the forward's LSE within 1e-4): the forward
against JAX's Pallas forward (``_fa_fwd_kernel``; its streamed kernel for
a rectangular case) and the backward against JAX's Pallas backward, both
in interpret mode, without dropout; with dropout, against the port's plain
version on the same keep bits (in float64 for the forward, in f32 for the
backward). A control with one TF32 product (hi_a hi_b) must fail that bar,
or the bar could not tell split TF32 from plain TF32."""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from speech_ssl_compression_tpu.ops import flash_attention as jfa
from speech_ssl_compression_tpu_torch.ops import flash_attention as tfa

BAR = 1e-4  # max |d| / mean |ref| (the golden bar, tests/test_model_golden.py)


def rna_tf32(x):
    """x (float32) rounded to TF32 on its bit pattern: add half of the 13
    dropped bits' range to the magnitude, then clear them (ties away from
    zero, as cvt.rna.tf32.f32)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    sign = bits & np.uint32(0x80000000)
    mag = ((bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) & np.uint32(
        0xFFFFE000)
    return (sign | mag).view(np.float32)


def split(x):
    """(hi, lo) of a float32 tensor, each exact in TF32."""
    hi = rna_tf32(x.numpy())
    lo = rna_tf32((x.numpy() - hi).astype(np.float32))
    return torch.from_numpy(hi), torch.from_numpy(lo)


def split_mm(a, b):
    """a @ b in split TF32: three TF32 products summed in float64, the
    result rounded to f32."""
    (ah, al), (bh, bl) = split(a.contiguous()), split(b.contiguous())
    d = [t.double() for t in (ah, al, bh, bl)]
    return (d[0] @ d[3] + d[1] @ d[2] + d[0] @ d[2]).float()


def one_tf32_mm(a, b):
    """The control: a @ b as one TF32 product, hi_a hi_b."""
    ah, bh = split(a.contiguous())[0], split(b.contiguous())[0]
    return (ah.double() @ bh.double()).float()


def emulated_backward(mm, q, k, v, bias, segq, segk, causal, dropout_p, seed,
                      lse, dout):
    """reference_bwd's arithmetic with its five products taken by ``mm``:
    (dq, dk, dv, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm(q, k.transpose(-1, -2)) * scale + bias[:, None, None, :]
    if segq is not None:
        s = s.masked_fill(segq[:, None, :, None] != segk[:, None, None, :],
                          tfa.NEG_INF)
    if causal:
        above = torch.ones(s.shape[-2:], dtype=torch.bool).triu(1)
        s = s.masked_fill(above, tfa.NEG_INF)
    p = torch.exp(s - lse[..., None])
    keep = tfa._keep(q, k, dropout_p, seed)
    pd = p if keep is None else torch.where(
        keep, p * tfa._keep_scale(dropout_p), torch.zeros(()))
    dpd = mm(dout, v.transpose(-1, -2))
    l = p.sum(dim=-1)
    dd = torch.where(l > 0, (pd * dpd).sum(dim=-1) / l, torch.zeros(()))
    ds = pd * dpd - p * dd[..., None]
    return (scale * mm(ds, k), scale * mm(ds.transpose(-1, -2), q),
            mm(pd.transpose(-1, -2), dout), dd)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).mean()


def _segments(t):
    row0 = [1] * (t // 3) + [2] * (t // 2)
    row1 = [3] * (3 * t // 4)
    seg = np.zeros((2, t), np.int32)
    seg[0, : len(row0)] = row0
    seg[1, : len(row1)] = row1
    return seg


CASES = {
    # name: (b, h, t, key padding, segment ids, causal, dropout_p)
    "segments_padding": (2, 2, 160, _segments(160) == 0, _segments(160),
                         False, 0.0),
    "causal_padding": (2, 2, 96, np.arange(96)[None, :] >= np.array(
        [[96], [61]]), None, True, 0.0),
    "padding_p0.1": (2, 3, 128, np.arange(128)[None, :] >= np.array(
        [[128], [90]]), None, False, 0.1),
}


def _inputs(name):
    """(numpy q, k, v, dO with padded rows zeroed, valid rows (B, T), the
    port's backward_args on CPU tensors)."""
    b, h, t, pad, seg, causal, p = CASES[name]
    rng = np.random.default_rng(7)
    q, k, v, dout = (rng.standard_normal((b, h, t, 64)).astype(np.float32)
                     for _ in range(4))
    valid = np.ones((b, t), bool) if seg is None else seg != 0
    dout = dout * valid[:, None, :, None]
    masks = dict(key_padding_mask=torch.from_numpy(pad), causal=causal,
                 segment_ids=None if seg is None else torch.from_numpy(seg))
    if p:
        masks.update(dropout_p=p, dropout_seed=11)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = tfa.flash_attention(qt, kt, vt, return_lse=True, **masks)
    args = tfa.backward_args(qt, kt, vt, lse, torch.from_numpy(dout), **masks)
    return (q, k, v, dout), valid, args


def _reference(name):
    """(dq, dk, dv, D) to hold the emulation against: JAX's Pallas backward
    in interpret mode and its D = rowsum(dO o O) without dropout (the two
    frameworks' random bits never match), the port's f32 plain backward
    on the same keep bits with dropout."""
    b, h, t, pad, seg, causal, p = CASES[name]
    (q, k, v, dout), _, args = _inputs(name)
    if p:
        return [r.numpy() for r in tfa.reference_bwd(*args)]
    kw = dict(key_padding_mask=jnp.asarray(pad), causal=causal,
              segment_ids=None if seg is None else jnp.asarray(seg))

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, **kw) * jnp.asarray(dout))

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        out = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    dd = np.sum(np.asarray(out, np.float64) * dout, axis=-1)
    return [np.asarray(g) for g in grads] + [dd]


def _errors(name, mm):
    _, valid, args = _inputs(name)
    got = emulated_backward(mm, *args)
    ref = _reference(name)
    rows = valid[:, None, :].repeat(args[0].shape[1], axis=1)
    return [_rel(g.numpy(), r) for g, r in zip(got[:3], ref[:3])] + [
        _rel(got[3].numpy()[rows], ref[3][rows])]


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),  # 1.0: already TF32
    (0x3F800FFF, 0x3F800000),  # below half of the dropped range: down
    (0x3F801000, 0x3F802000),  # a tie, kept lsb even: away from zero
    (0xBF801000, 0xBF802000),  # the negative tie: away from zero too
    (0x3F803000, 0x3F804000),  # a tie, kept lsb odd
    (0x3F801001, 0x3F802000),  # past half: up
    (0x3FFFF000, 0x40000000),  # the carry reaches the exponent
    (0x00000000, 0x00000000),
])
def test_rna_tf32_rounds_to_nearest_ties_away_from_zero(bits, want):
    x = np.array([bits], np.uint32).view(np.float32)
    assert int(rna_tf32(x).view(np.uint32)[0]) == want


def test_split_keeps_f32_accuracy_and_one_tf32_product_does_not():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32)
    hi, lo = split(torch.from_numpy(x))
    hi, lo = hi.numpy(), lo.numpy()
    for part in (hi, lo):  # both exact in TF32: 13 low bits clear
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    # hi + lo is x to within lo's rounding, 2^-22 |x|
    err = np.abs(hi.astype(np.float64) + lo - x)
    assert (err <= 2.0 ** -22 * np.abs(x)).all()
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    assert _rel(split_mm(a, b), exact) < 1e-6
    assert _rel(one_tf32_mm(a, b), exact) > 1e-4


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_tf32_backward_holds_the_f32_bar(name):
    errs = _errors(name, split_mm)
    assert max(errs) < BAR, dict(zip(("dq", "dk", "dv", "D"), errs))


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_tf32_product_fails_the_f32_bar(name):
    # the control: the bar tells split TF32 from plain TF32 in every
    # gradient
    errs = _errors(name, one_tf32_mm)
    assert min(errs[:3]) > BAR, dict(zip(("dq", "dk", "dv", "D"), errs))


FWD_BLOCK_K = 32  # keys per tile of the f32 forward kernel


def emulated_forward(mm, q, k, v, bias, segq, segk, causal, dropout_p,
                     seed):
    """_reference_fwd's arithmetic as the f32 forward kernel takes it: S by
    ``mm``, then the keys in FWD_BLOCK_K tiles, each tile's P V by ``mm``
    joined as acc = alpha acc + P V in f32. Returns (out, lse)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm(q, k.transpose(-1, -2)) * scale + bias[:, None, None, :]
    if segq is not None:
        s = s.masked_fill(segq[:, None, :, None] != segk[:, None, None, :],
                          tfa.NEG_INF)
    if causal:
        above = torch.ones(s.shape[-2:], dtype=torch.bool).triu(1)
        s = s.masked_fill(above, tfa.NEG_INF)
    keep = tfa._keep(q, k, dropout_p, seed)
    m = torch.full_like(s[..., :1], tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = s.new_zeros(s.shape[:-1] + v.shape[-1:])
    for k0 in range(0, s.shape[-1], FWD_BLOCK_K):
        st = s[..., k0:k0 + FWD_BLOCK_K]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if keep is not None:
            p = p.masked_fill(~keep[..., k0:k0 + FWD_BLOCK_K], 0.0)
        acc = acc * alpha + mm(p, v[..., k0:k0 + FWD_BLOCK_K, :])
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = acc / l_safe
    if keep is not None:
        out = out * tfa._keep_scale(dropout_p)
    return out, (m + torch.log(l_safe)).squeeze(-1)


FWD_CASES = {
    # name: (b, h, tq, tk, key padding, segment ids, causal, dropout_p);
    # tk differs from tq: flash_attention_kv_full, JAX's streamed kernel
    "segments_padding": (2, 2, 160, 160, _segments(160) == 0, _segments(160),
                         False, 0.0),
    "causal_padding": (2, 2, 96, 96, np.arange(96)[None, :] >= np.array(
        [[96], [61]]), None, True, 0.0),
    "padding_p0.1": (2, 3, 128, 128, np.arange(128)[None, :] >= np.array(
        [[128], [90]]), None, False, 0.1),
    "rectangular": (1, 2, 48, 200, np.arange(200)[None, :] >= 180, None,
                    False, 0.0),
}


def _fwd_inputs(name):
    """(numpy q, k, v, valid query rows (B, Tq), the port's forward_args
    on CPU tensors)."""
    b, h, tq, tk, pad, seg, causal, p = FWD_CASES[name]
    rng = np.random.default_rng(8)
    q = rng.standard_normal((b, h, tq, 64)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, tk, 64)).astype(np.float32)
            for _ in range(2))
    valid = np.ones((b, tq), bool) if seg is None else seg != 0
    masks = dict(key_padding_mask=torch.from_numpy(pad), causal=causal,
                 segment_ids=None if seg is None else torch.from_numpy(seg))
    if p:
        masks.update(dropout_p=p, dropout_seed=11)
    args = tfa.forward_args(*(torch.from_numpy(a) for a in (q, k, v)),
                            **masks)
    return (q, k, v), valid, args


def _fwd_reference(name):
    """(out, lse) to hold the emulation against: JAX's Pallas forward in
    interpret mode without dropout (the streamed kernel for the rectangular
    case), the port's plain forward in float64 on the same keep bits with
    dropout."""
    b, h, tq, tk, pad, seg, causal, p = FWD_CASES[name]
    (q, k, v), _, args = _fwd_inputs(name)
    if p:
        out, lse = tfa._reference_fwd(*tfa.float64_args(args[:7]), None,
                                      *args[7:])
        return out.numpy(), lse.numpy()
    bias = np.where(pad, jfa.NEG_INF, 0.0).astype(np.float32)
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        if tq != tk:
            out, lse = jfa._rect_fwd_impl(qj, kj, vj, jnp.asarray(bias))
        else:
            use_seg = seg is not None
            out, lse = jfa._flash_fwd_impl(
                qj, kj, vj, jnp.asarray(bias),
                jnp.asarray(seg if use_seg else np.zeros((b, tq), np.int32)),
                jnp.zeros((1,), jnp.int32), causal, 0.0, use_seg)
    lse = np.asarray(lse).reshape(b, h, -1)[:, :, :tq]
    return np.asarray(out), lse


def _fwd_errors(name, mm):
    _, valid, args = _fwd_inputs(name)
    out, lse = emulated_forward(mm, *args)
    ref_out, ref_lse = _fwd_reference(name)
    rows = valid[:, None, :].repeat(args[0].shape[1], axis=1)
    return (_rel(out.numpy()[rows], ref_out[rows]),
            float(np.abs(lse.numpy()[rows] - ref_lse[rows]).max()))


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_split_tf32_forward_holds_the_f32_bar(name):
    err, lse_err = _fwd_errors(name, split_mm)
    assert err < BAR and lse_err < BAR, (err, lse_err)


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_one_tf32_product_forward_fails_the_f32_bar(name):
    # the control: the bar tells split TF32 from plain TF32 in the output
    err, lse_err = _fwd_errors(name, one_tf32_mm)
    assert err > BAR, (err, lse_err)
