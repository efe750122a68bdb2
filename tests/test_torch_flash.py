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


def _jax_fwd(q, k, v, pad, seg, causal):
    """(out, lse (B, H, T)) of the Pallas forward, in interpret mode."""
    b, _, t, _ = q.shape
    bias = (np.where(pad, jfa.NEG_INF, 0.0) if pad is not None
            else np.zeros((b, t))).astype(np.float32)
    use_seg = seg is not None
    seg_arr = seg if use_seg else np.zeros((b, t), np.int32)
    with pltpu.force_tpu_interpret_mode():
        out = jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            key_padding_mask=None if pad is None else jnp.asarray(pad),
            causal=causal,
            segment_ids=None if seg is None else jnp.asarray(seg),
        )
        _, lse = jfa._flash_fwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
            jnp.asarray(seg_arr), jnp.zeros((1,), jnp.int32), causal, 0.0,
            use_seg,
        )
    return np.asarray(out), np.asarray(lse)[:, :, 0, :t]


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


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiled_plain_version_matches_untiled_in_f32(name):
    # the key-tiled walk (which rounds a bf16 P where the CUDA kernel does)
    # is the same attention as the whole-matrix softmax
    b, h, t, pad, seg, causal = CASES[name]
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
        "conv1d.cu", "flash_attn_bwd.cu", "flash_attn_bwd_sm90.cu",
        "flash_attn_fwd.cu"]
    assert [p.name for p in _kernels._sources()[1]] == ["flash_common.cuh"]
