"""The port's flash-attention forward on CPU tensors (its plain version)
against the JAX Pallas kernels in interpret mode, plus the wrapper's
routing rules (the backward is in ``test_torch_flash_bwd.py``). Outputs are compared on rows that see at least one key; a
fully masked row legitimately differs between the two."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from speech_ssl_compression_tpu.ops import flash_attention as jfa
from speech_ssl_compression_tpu_torch.ops import _kernels
from speech_ssl_compression_tpu_torch.ops import flash_attention as tfa
from speech_ssl_compression_tpu_torch.ops.dropout import attention_keep_mask

RTOL, ATOL = 2e-4, 2e-5  # tests/test_model_golden.py flash-vs-dense bar
LSE_ATOL = 1e-4


def _arrays(b, h, tq, tk=None, d=64, seed=0):
    rng = np.random.default_rng(seed)
    tk = tk or tq
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    return q, k, v


def _segments(t):
    """Two packed rows: utterances as 1-based ids, pad slots as 0."""
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
    "segments": (2, 2, 256, _segments(256) == 0, _segments(256), False),
    "causal": (1, 2, 80, None, None, True),
    "causal_padding": (2, 2, 64, _padding([64, 40], 64), None, True),
    "one_head": (2, 1, 128, _padding([128, 33], 128), None, False),
}


# the key-tiled plain version also at the ragged edges of the CUDA
# kernels' 64-key tiles: one key past a tile, and a long ragged T
TILED_CASES = dict(
    CASES,
    t65=(1, 2, 65, None, None, False),
    ragged_777=(2, 1, 777, _padding([777, 600], 777), None, False),
)


def _jax_fwd(q, k, v, pad, seg, causal, dtype=jnp.float32):
    """(out as f32, lse (B, H, T)) of the Pallas forward, in interpret
    mode, with q, k and v cast to ``dtype``."""
    b, _, t, _ = q.shape
    q, k, v = (jnp.asarray(a, dtype) for a in (q, k, v))
    bias = (np.where(pad, jfa.NEG_INF, 0.0) if pad is not None
            else np.zeros((b, t))).astype(np.float32)
    use_seg = seg is not None
    seg_arr = seg if use_seg else np.zeros((b, t), np.int32)
    with pltpu.force_tpu_interpret_mode():
        out = jfa.flash_attention(
            q, k, v,
            key_padding_mask=None if pad is None else jnp.asarray(pad),
            causal=causal,
            segment_ids=None if seg is None else jnp.asarray(seg),
        )
        _, lse = jfa._flash_fwd_impl(
            q, k, v, jnp.asarray(bias),
            jnp.asarray(seg_arr), jnp.zeros((1,), jnp.int32), causal, 0.0,
            use_seg,
        )
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(lse)[:, :, 0, :t])


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_matches_pallas_interpret(name):
    b, h, t, pad, seg, causal = CASES[name]
    q, k, v = _arrays(b, h, t)
    ref_out, ref_lse = _jax_fwd(q, k, v, pad, seg, causal)
    out, lse = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_padding_mask=None if pad is None else torch.from_numpy(pad),
        causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        return_lse=True,
    )
    bi, ti = (np.ones((b, t), bool) if seg is None else seg != 0).nonzero()
    np.testing.assert_allclose(out.numpy()[bi, :, ti], ref_out[bi, :, ti],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy()[bi, :, ti], ref_lse[bi, :, ti],
                               atol=LSE_ATOL)


def _torch_kwargs(pad, seg, causal):
    return dict(
        key_padding_mask=None if pad is None else torch.from_numpy(pad),
        causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg),
    )


@pytest.mark.parametrize("name", sorted(TILED_CASES))
def test_tiled_plain_version_matches_untiled_in_f32(name):
    # the key-tiled walk (which rounds a bf16 P where the CUDA kernel does)
    # is the same attention as the whole-matrix softmax
    b, h, t, pad, seg, causal = TILED_CASES[name]
    q, k, v = (torch.from_numpy(a) for a in _arrays(b, h, t, seed=3))
    kw = _torch_kwargs(pad, seg, causal)
    out, lse = tfa.flash_attention_reference(q, k, v, **kw)
    out_t, lse_t = tfa.flash_attention_reference(
        q, k, v, block_k=tfa.KERNEL_BLOCK_K, **kw)
    bi, ti = (np.ones((b, t), bool) if seg is None else seg != 0).nonzero()
    np.testing.assert_allclose(out_t.numpy()[bi, :, ti], out.numpy()[bi, :, ti],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lse_t.numpy()[bi, :, ti], lse.numpy()[bi, :, ti],
                               atol=1e-5)


def test_tiled_plain_version_rounds_p_per_tile_in_bf16():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _arrays(1, 2, 128, seed=4))
    one_tile = tfa.flash_attention_reference(q[:, :, :64], k[:, :, :64],
                                             v[:, :, :64], block_k=64)[0]
    whole = tfa.flash_attention_reference(q[:, :, :64], k[:, :, :64],
                                          v[:, :, :64])[0]
    assert torch.equal(one_tile, whole)  # one tile: the same rounding points
    tiled = tfa.flash_attention_reference(q, k, v, block_k=64)[0].float()
    whole = tfa.flash_attention_reference(q, k, v)[0].float()
    # two tiles: P rounds differently, which moves some outputs by an ulp
    d = (tiled - whole).abs()
    assert (d > 0).float().mean() > 0.05
    assert (d <= 2 * 2.0 ** -7 * whole.abs().max()).all()


@pytest.mark.parametrize("name", ["padding", "segments"])
def test_tiled_plain_bf16_forward_matches_pallas_interpret(name):
    # The yardstick of the bf16 CUDA kernel, the plain version walked in its
    # 64-key tiles, against JAX's Pallas forward in bf16 (one whole-T key
    # block at these T). Both take f32 scores and statistics from the same
    # bf16 inputs and round each unnormalized p to bf16 before P.V, but at
    # different points (exp(s - running max) per 64-key tile here, per
    # block there): each side's p_j is within 2^-9 of exp(s_j - LSE) up to
    # f32 rounding, so the f32 outputs differ by at most 2^-8 (P |V|), and
    # each rounds to bf16 within 2^-8 of itself. Tolerance per entry: that,
    # with 1% for the f32 arithmetic.
    b, h, t, pad, seg, causal = CASES[name]
    q, k, v = _arrays(b, h, t, seed=5)
    ref_out, ref_lse = _jax_fwd(q, k, v, pad, seg, causal, jnp.bfloat16)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    kw = _torch_kwargs(pad, seg, causal)
    out, lse = tfa.flash_attention_reference(
        qt, kt, vt, block_k=tfa.KERNEL_BLOCK_K, **kw)
    # P |V| from the exact softmax of the same f32 scores
    bias, sg = tfa._masks(kt, kw["key_padding_mask"], kw["segment_ids"])
    p = torch.softmax(tfa._scores(qt, kt, bias, sg, sg, causal), dim=-1)
    p_abs_v = torch.matmul(p, vt.float().abs()).numpy()
    out = out.float().numpy()
    tol = 1.01 * 2.0 ** -8 * (p_abs_v + np.abs(out) + np.abs(ref_out))
    bi, ti = (np.ones((b, t), bool) if seg is None else seg != 0).nonzero()
    d = np.abs(out - ref_out)[bi, :, ti]
    assert (d <= tol[bi, :, ti]).all(), float((d / tol[bi, :, ti]).max())
    # the two round P at different points, so some outputs do differ
    assert (d > 0).mean() > 0.01
    np.testing.assert_allclose(lse.numpy()[bi, :, ti], ref_lse[bi, :, ti],
                               atol=LSE_ATOL)


def _tiled_f64(q, k, v, kw, block_k, round_p=True):
    """The tiled forward's formulas with the scores and sums in float64, p
    rounded to the input dtype before P.V unless ``round_p`` is False: a
    forward whose scores differ from the plain one's by rounding."""
    bias, seg = tfa._masks(k, kw.get("key_padding_mask"),
                           kw.get("segment_ids"))
    s = q.double() @ k.double().mT / 8.0 + bias.double()[:, None, None, :]
    if seg is not None:
        s = s.masked_fill(seg[:, None, :, None] != seg[:, None, None, :],
                          tfa.NEG_INF)
    if kw.get("causal"):
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool).triu(1),
                          tfa.NEG_INF)
    keep = None
    if kw.get("dropout_p"):
        keep = attention_keep_mask(kw["dropout_seed"], *q.shape[:3],
                                   k.shape[2], kw["dropout_p"])
    m = torch.full_like(s[..., :1], tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + v.shape[-1:], dtype=torch.float64)
    for k0 in range(0, s.shape[-1], block_k):
        st = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        p = torch.exp(st - m_new)
        l = l * torch.exp(m - m_new) + p.sum(dim=-1, keepdim=True)
        if round_p:
            p = p.to(q.dtype).double()
        if keep is not None:
            p = p.masked_fill(~keep[..., k0:k0 + block_k], 0.0)
        acc = acc * torch.exp(m - m_new) + p @ v[..., k0:k0 + block_k, :].double()
        m = m_new
    out = acc / l.clamp_min(1e-30)
    if keep is not None:
        out = out / (1 - kw["dropout_p"])
    return out.to(q.dtype)


def _beyond_ulp_and_bound(got, ref, bound):
    """Entries where |got - ref| exceeds one bf16 ulp of max(|ref|, mean
    |ref|) plus the straddle bound (chip_smoke.py's bar)."""
    got, ref = got.double(), ref.double()
    mag = ref.abs().clamp_min(float(ref.abs().mean()))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return int(((got - ref).abs() > ulp + bound.double()).sum())


_SEG = _segments(256)
STRADDLE_CASES = {
    # name: (b, h, t, key padding, segment ids, causal, dropout)
    "padding": (2, 3, 256, _padding([256, 180], 256), None, False, 0.0),
    "segments": (2, 2, 256, _SEG == 0, _SEG, False, 0.0),
    "segments_causal": (2, 2, 256, _SEG == 0, _SEG, True, 0.0),
    "segments_dropout": (2, 2, 256, _SEG == 0, _SEG, False, 0.1),
}


@pytest.mark.parametrize("name", sorted(STRADDLE_CASES))
def test_bf16_forward_straddle_bounds_hold_for_another_rounding(name):
    # the bound is built from the inputs; a tiled forward whose scores are
    # rounded otherwise (float64) must stay within 1 ulp + bound of the
    # plain one, and one that skips the rounding of P must not
    b, h, t, pad, seg, causal, dropout_p = STRADDLE_CASES[name]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _arrays(b, h, t, seed=8))
    kw = _torch_kwargs(pad, seg, causal)
    if dropout_p:
        kw.update(dropout_p=dropout_p, dropout_seed=3)
    ref, _ = tfa.flash_attention_reference(q, k, v, block_k=64, **kw)
    bound = tfa.bf16_forward_straddle_bounds(q, k, v, block_k=64, **kw)
    assert torch.isfinite(bound).all() and (bound >= 0).all()
    assert bound.max() > 0  # some p of these inputs lie near a rounding point
    bi, ti = (np.ones((b, t), bool) if seg is None else seg != 0).nonzero()
    rows = (torch.from_numpy(bi), slice(None), torch.from_numpy(ti))
    other = _tiled_f64(q, k, v, kw, 64)
    assert _beyond_ulp_and_bound(other[rows], ref[rows], bound[rows]) == 0
    unrounded = _tiled_f64(q, k, v, kw, 64, round_p=False)
    assert _beyond_ulp_and_bound(unrounded[rows], ref[rows], bound[rows]) > 0


@pytest.mark.parametrize("name", ["segments", "segments_dropout"])
def test_bf16_forward_straddle_flips_find_p_rounded_the_other_way(name):
    # A forward that rounds a few straddling p the other way stands for the
    # tensor-core kernel: the flip search brings those rows
    # back within one ulp. An entry moved past one ulp plus twice its
    # straddle bound, which no set of such p can reach, stays past it.
    b, h, t, pad, seg, causal, dropout_p = STRADDLE_CASES[name]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _arrays(b, h, t, seed=8))
    kw = _torch_kwargs(pad, seg, causal)
    if dropout_p:
        kw.update(dropout_p=dropout_p, dropout_seed=3)
    ref, _ = tfa.flash_attention_reference(q, k, v, block_k=64, **kw)
    ref = ref.float()
    pb, lo, hi, w = (torch.cat(x, dim=-1) for x in zip(*(
        tile[1:] for tile in tfa._forward_straddles(
            q, k, kw["key_padding_mask"], causal, kw["segment_ids"], 64,
            dropout_p, kw.get("dropout_seed")))))
    step = (torch.where(pb == hi, lo, hi) - pb) * w
    valid = torch.from_numpy(seg != 0)[:, None, :].expand(ref.shape[:3])
    # the four valid rows whose straddling p weigh most, each with its three
    # weightiest straddling p rounded the other way
    top = step.abs().topk(3, dim=-1)
    rows = top.values.sum(dim=-1).masked_fill(~valid, 0.0).flatten().topk(4)
    rows = torch.stack(torch.unravel_index(rows.indices, valid.shape), dim=-1)
    rb, rh, ri = rows.unbind(-1)
    p = (pb * w)[rb, rh, ri]
    p.scatter_add_(-1, top.indices[rb, rh, ri], top.values[rb, rh, ri]
                   * step[rb, rh, ri].gather(-1, top.indices[rb, rh, ri]).sign())
    got = ref.clone()
    got[rb, rh, ri] = torch.einsum("nk,nkd->nd", p,
                                   v.float()[rb, rh]).bfloat16().float()
    mean = float(ref[valid].abs().mean())
    mag = ref.abs().clamp_min(mean)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    found = tfa.bf16_forward_straddle_flips(q, k, v, got.bfloat16(), rows, ulp,
                                            block_k=64, **kw)
    assert max(before for *_, before, _ in found) > 1.0  # the rows moved
    for n, flipped, before, after in found:
        assert n > 0 and after <= 1.0 and after <= before
    # one entry past one ulp plus twice its bound: no flips explain it
    bound = tfa.bf16_forward_straddle_bounds(q, k, v, block_k=64, **kw)
    r = tuple(rows[0])
    got[r + (0,)] = ref[r + (0,)] + 2 * (ulp[r + (0,)] + bound[r + (0,)])
    (_, _, _, after), = tfa.bf16_forward_straddle_flips(
        q, k, v, got.bfloat16(), rows[:1], ulp, block_k=64, **kw)
    assert after > 1.0


def test_flash_kv_full_matches_pallas_interpret():
    q, k, v = _arrays(2, 2, 64, tk=192, seed=1)
    pad = _padding([192, 150], 192)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfa.flash_attention_kv_full(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            key_padding_mask=jnp.asarray(pad),
        ))
    out = tfa.flash_attention_kv_full(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_padding_mask=torch.from_numpy(pad),
    )
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_fully_masked_rows_stay_finite():
    q, k, v = _arrays(2, 1, 32, seed=2)
    pad = np.zeros((2, 32), bool)
    pad[1] = True
    out, lse = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_padding_mask=torch.from_numpy(pad), return_lse=True,
    )
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _arrays(1, 2, 40, d=16))
    tfa.reset_launch_counts()
    out = tfa.flash_attention(q, k, v, causal=True)
    ref, _ = tfa.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(out, ref)
    assert tfa.launch_counts["flash_attn_fwd"] == 0


def test_wrapper_refuses_grad_and_bad_shapes():
    # grad is no longer refused: the autograd Function carries it (the
    # plain backward on CPU tensors); what the kernels do not take still
    # raises
    q, k, v = (torch.from_numpy(a) for a in _arrays(1, 2, 16))
    out = tfa.flash_attention(q.requires_grad_(), k, v)
    out.sum().backward()
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).shape == q.shape
    q = q.detach()
    with pytest.raises(NotImplementedError, match="T <= 4096"):
        z = torch.zeros(1, 1, 4100, 64)
        tfa.flash_attention(z, z, z, dropout_p=0.1, dropout_seed=0)
    with pytest.raises(NotImplementedError, match="square"):
        tfa.flash_attention(q, k[:, :, :8].contiguous(),
                            v[:, :, :8].contiguous(), causal=True)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k[:, :1], v[:, :1])
    with pytest.raises(ValueError, match="no route"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_kernel_build_is_lazy_and_keyed_by_source():
    lib = _kernels.library_path()
    assert lib.parent == _kernels.BUILD_DIR
    assert lib.name.startswith("libsslc_kernels_") and lib.suffix == ".so"
    assert _kernels.library_path() == lib
    assert [p.name for p in _kernels._sources()[0]] == [
        "conv1d.cu", "conv1d_f32_sm90.cu", "conv1d_sm90.cu",
        "flash_attn_bwd.cu", "flash_attn_bwd_f32_sm90.cu",
        "flash_attn_bwd_sm90.cu", "flash_attn_fwd.cu",
        "flash_attn_fwd_f32_sm90.cu", "flash_attn_fwd_sm90.cu"]
    assert [p.name for p in _kernels._sources()[1]] == [
        "flash_common.cuh", "sm90_common.cuh", "split_tf32.cuh"]
