"""The port's streaming causal extractors (``streaming.py``) against JAX's on
the same weights, carried over by the weight bridge (``load_model``), and
against the port's own full causal forward (``attn_impl="dense"``), at the
JAX streaming tests' tiny size (``tests/test_streaming.py``): 2 layers,
D 32, 2 heads of 16, ``conv_pos`` 8 in 2 groups. f32 to atol 2e-5, rtol
1e-5 (the JAX tests' bar); the featurizer and the chunk invariance
bitwise."""

import pathlib
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu import streaming as jax_streaming
from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.utils import checkpoint as jax_checkpoint
from speech_ssl_compression_tpu_torch import streaming
from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig as PortConfig,
)
from speech_ssl_compression_tpu_torch.extract import wav_to_mel
from speech_ssl_compression_tpu_torch.models import melhubert_forward
from speech_ssl_compression_tpu_torch.utils.weights import load_model

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

F32 = dict(atol=2e-5, rtol=1e-5)


def _tiny_cfg(**over):
    d = {
        "feat_emb_dim": 13,
        "encoder_layers": 2,
        "encoder_embed_dim": 32,
        "encoder_ffn_embed_dim": 48,
        "encoder_attention_heads": 2,
        "head_dim": 16,
        "num_cluster": 7,
        "attention_type": "causal",
        "conv_pos": 8,
        "conv_pos_groups": 2,
    }
    d.update(over)
    return MelHuBERTConfig.from_dict(d)


def _params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        init_melhubert_params(jax.random.PRNGKey(seed), cfg))


def _feat(seed, t, dim=13):
    return np.random.default_rng(seed).standard_normal((t, dim)).astype(
        np.float32)


def _pair(cls, cfg, params, **kw):
    """The JAX extractor and the port's, on the same weights."""
    ref = getattr(jax_streaming, cls.__name__)(params=params, cfg=cfg, **kw)
    if "dtype" in kw:
        kw["dtype"] = (torch.bfloat16 if kw["dtype"] is jnp.bfloat16
                       else torch.float32)
    ours = cls(params=params, cfg=PortConfig.from_dict(cfg.to_dict()),
               device="cpu", **kw)
    return ref, ours


def _cat(outs):
    out = streaming._merge_out(*outs)
    return {k: (np.asarray(v, np.float32) if k == "last_hidden_state"
                else [np.asarray(x, np.float32) for x in v])
            for k, v in out.items()}


def _stream(s, feat, pushes=(3, 11, 1, 7, 100)):
    """Ragged pushes, then flush; the concatenated outputs."""
    outs, i = [], 0
    for n in pushes:
        if i >= len(feat):
            break
        outs.append(s.push_feat(feat[i:i + n]))
        i += n
    outs.append(s.flush())
    return _cat(outs)


def _full_causal(cfg, params, feat):
    """The port's full causal forward of one utterance (dense attention)."""
    model = load_model(params, PortConfig.from_dict(cfg.to_dict()))
    with torch.no_grad():
        out = melhubert_forward(model, torch.from_numpy(feat[None]),
                                torch.ones(1, len(feat)), no_pred=True,
                                get_hidden=True, attn_impl="dense")
    return [out["pre_feat"][0].numpy()] + [
        h[0].numpy() for h in out["layer_hiddens"]], out["hidden"][0].numpy()


@pytest.mark.parametrize("t,chunk,heads", [
    (50, 16, 2), (16, 16, 2), (5, 8, 2), (37, 8, 2), (30, 8, [2, 1])])
def test_single_stream_matches_jax_and_the_full_forward(t, chunk, heads):
    """(30, 8) is a head-pruned model: ragged heads per layer."""
    cfg = _tiny_cfg(encoder_attention_heads=heads)
    params = _params(cfg)
    feat = _feat(t, t)
    ref, ours = _pair(streaming.StreamingCausalExtractor, cfg, params,
                      chunk_frames=chunk, max_frames=256, get_hidden=True)
    if heads != 2:
        assert [c["k"].shape[1] for c in ours._caches] == [2, 1]
    got, want = _stream(ours, feat), _stream(ref, feat)
    full_hidden, full_last = _full_causal(cfg, params, feat)
    assert got["last_hidden_state"].shape == (t, cfg.encoder_embed_dim)
    np.testing.assert_allclose(got["last_hidden_state"],
                               want["last_hidden_state"], **F32)
    np.testing.assert_allclose(got["last_hidden_state"], full_last, **F32)
    assert len(got["hidden_states"]) == cfg.encoder_layers + 1
    for a, b, c in zip(got["hidden_states"], want["hidden_states"],
                       full_hidden):
        np.testing.assert_allclose(a, b, **F32)
        np.testing.assert_allclose(a, c, **F32)


def test_chunk_boundary_invariance_is_bitwise():
    cfg = _tiny_cfg()
    params = _params(cfg, seed=1)
    feat = _feat(0, 40)
    s = streaming.StreamingCausalExtractor(
        params=params, cfg=PortConfig.from_dict(cfg.to_dict()),
        chunk_frames=8, max_frames=128, device="cpu")
    a = _stream(s, feat, [40])["last_hidden_state"]
    s.reset()
    b = _stream(s, feat, [1] * 40)["last_hidden_state"]
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fp", [10, 20])
def test_featurizer_is_bitwise_jax_and_whole_utterance(fp):
    """Ragged waveform pieces, bitwise JAX's featurizer; 203 frames of 10
    ms, an odd final frame that the 20 ms stacking zero-pads at flush."""
    rng = np.random.default_rng(3)
    wav = (rng.standard_normal(16000 * 2 + 731) * 0.1).astype(np.float32)
    mean, std = rng.standard_normal(40), rng.uniform(0.5, 2.0, 40)
    ours = streaming._StreamFeaturizer(fp, mean, std, "fast")
    ref = jax_streaming._StreamFeaturizer(fp, mean, std, "fast")
    got, want, i = [], [], 0
    for n in (1000, 16000, 3, 399, 161, 10**9):
        got.append(ours.push(wav[i:i + n]))
        want.append(ref.push(wav[i:i + n]))
        i += n
    got.append(ours.flush())
    want.append(ref.flush())
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the whole utterance's fbank in float32 rounds a few entries one ulp
    # apart (the matmul's blocking follows the frame count)
    np.testing.assert_allclose(got, wav_to_mel(wav, mean, std, fp=fp),
                               rtol=1e-6, atol=1e-5)
    assert len(got) == (102 if fp == 20 else 203)


def test_push_wav_from_a_checkpoint_matches_jax(tmp_path):
    """Both extractors read one JAX-written npz checkpoint and mean/std."""
    cfg = _tiny_cfg(feat_emb_dim=80)
    rng = np.random.default_rng(5)
    ckpt, mean_std = str(tmp_path / "causal.npz"), tmp_path / "ms.npy"
    jax_checkpoint.save_checkpoint(
        ckpt, _params(cfg, seed=2),
        meta={"Upstream_Config": {"melhubert": cfg.to_dict()}, "Step": 0})
    np.save(mean_std, np.stack([rng.standard_normal(40),
                                rng.uniform(0.5, 2.0, 40)]))
    wav = (rng.standard_normal(16000 + 555) * 0.1).astype(np.float32)
    kw = dict(mean_std_npy_path=str(mean_std), chunk_frames=16,
              max_frames=128)
    ref = jax_streaming.StreamingCausalExtractor(ckpt, **kw)
    ours = streaming.StreamingCausalExtractor(ckpt, device="cpu", **kw)
    got, want = [], []
    for lo, hi in ((0, 1000), (1000, 9000), (9000, 9003), (9003, len(wav))):
        got.append(ours.push_wav(wav[lo:hi]))
        want.append(ref.push_wav(wav[lo:hi]))
    got, want = _cat(got + [ours.flush()]), _cat(want + [ref.flush()])
    assert got["last_hidden_state"].shape == (51, 32)
    np.testing.assert_allclose(got["last_hidden_state"],
                               want["last_hidden_state"], **F32)


def test_rejections_and_the_final_partial_chunk():
    port = PortConfig.from_dict
    with pytest.raises(ValueError, match="causal"):
        cfg = _tiny_cfg(attention_type="original")
        streaming.StreamingCausalExtractor(
            params=_params(cfg), cfg=port(cfg.to_dict()), device="cpu")
    with pytest.raises(NotImplementedError, match="depth-1"):
        streaming.StreamingCausalBatchExtractor(
            params={}, cfg=port(dict(_tiny_cfg().to_dict(),
                                     pos_conv_depth=2)), device="cpu")
    with pytest.raises(ValueError, match="ckpt="):
        streaming.StreamingCausalExtractor(device="cpu")

    # chunk 8, max_frames 20 (not a multiple): 18 real frames fit and the
    # tail drains through a step that spans past max_frames
    cfg = _tiny_cfg()
    params = _params(cfg)
    feat = _feat(7, 18)
    ref, ours = _pair(streaming.StreamingCausalExtractor, cfg, params,
                      chunk_frames=8, max_frames=20)
    got = _stream(ours, feat, [18])["last_hidden_state"]
    assert got.shape == (18, 32)
    np.testing.assert_allclose(got, _stream(ref, feat, [18])[
        "last_hidden_state"], **F32)
    np.testing.assert_allclose(got, _full_causal(cfg, params, feat)[1],
                               **F32)

    # one frame past max_frames raises at push time and consumes nothing
    ours.reset()
    with pytest.raises(ValueError, match="max_frames"):
        ours.push_feat(_feat(8, 21))
    np.testing.assert_array_equal(
        _stream(ours, feat, [18])["last_hidden_state"], got)
    # flush finalizes: pushes raise, flush is idempotent, reset re-arms
    with pytest.raises(ValueError, match="flushed"):
        ours.push_feat(feat[:4])
    with pytest.raises(ValueError, match="flushed"):
        ours.push_wav(np.zeros(400, np.float32))
    assert ours.flush()["last_hidden_state"].shape == (0, 32)
    ours.reset()
    assert ours.push_feat(feat[:4])["last_hidden_state"].shape == (0, 32)
    with pytest.raises(ValueError, match="expected"):
        ours.push_feat(np.zeros((3, 12), np.float32))


def _batch_run(sb, feats, script):
    """Drive a batch extractor: ``script`` is a list of (slot, lo, hi) pushes
    or ("finish", slot), ("open", slot), ("poll",); returns each slot's
    streams' outputs, a new list entry after every open."""
    got = [[[]] for _ in range(sb.batch)]

    def take(outs):
        for i, o in enumerate(outs):
            got[i][-1].append(o)

    for op in script:
        if op[0] == "finish":
            sb.finish(op[1])
        elif op[0] == "open":
            sb.open_stream(op[1])
            got[op[1]].append([])
        elif op[0] == "poll":
            take(sb.poll())
        else:
            slot, key, lo, hi = op
            sb.push_feat(slot, feats[key][lo:hi])
    take(sb.flush())
    return [[_cat(outs)["last_hidden_state"] for outs in slot]
            for slot in got]


LOCKSTEP = [(0, "a", 0, 5), (1, "b", 0, 7), (2, "c", 0, 4), ("poll",),
            (0, "a", 5, 18), ("finish", 0), (1, "b", 7, 9), ("finish", 1),
            ("poll",), (2, "c", 4, 25), ("poll",), ("finish", 2)]
REUSE = [(0, "a", 0, 16), ("finish", 0), (1, "b", 0, 24), ("poll",),
         ("open", 0), (0, "c", 0, 16), ("finish", 0), (1, "b", 24, 40),
         ("finish", 1), ("poll",)]


@pytest.mark.parametrize("script,lengths,want", [
    (LOCKSTEP, dict(a=18, b=9, c=25), [["a"], ["b"], ["c"]]),
    (REUSE, dict(a=16, b=40, c=16), [["a", "c"], ["b"]]),
], ids=["lockstep", "slot_reuse"])
def test_batch_matches_jax_and_the_full_forward(script, lengths, want):
    cfg = _tiny_cfg()
    params = _params(cfg)
    feats = {k: _feat(11 + i, t) for i, (k, t) in enumerate(lengths.items())}
    ref, ours = _pair(streaming.StreamingCausalBatchExtractor, cfg, params,
                      batch=len(want), chunk_frames=8, max_frames=64)
    got, exp = _batch_run(ours, feats, script), _batch_run(ref, feats, script)
    for slot, keys in enumerate(want):
        for j, key in enumerate(keys):
            assert got[slot][j].shape == (lengths[key], 32), (slot, key)
            np.testing.assert_allclose(got[slot][j], exp[slot][j], **F32)
            np.testing.assert_allclose(
                got[slot][j], _full_causal(cfg, params, feats[key])[1],
                err_msg=f"slot {slot} stream {key}", **F32)
    assert ours.slot_finished(0)
    with pytest.raises(ValueError, match="finished"):
        ours.push_feat(0, feats["a"][:2])


def test_batch_lockstep_gating_and_overflow():
    cfg = _tiny_cfg()
    sb = streaming.StreamingCausalBatchExtractor(
        params=_params(cfg), cfg=PortConfig.from_dict(cfg.to_dict()),
        batch=2, chunk_frames=8, max_frames=16, device="cpu")
    sb.push_feat(0, _feat(17, 16))
    # slot 1 is live with no data: nothing may advance
    assert all(o["last_hidden_state"].shape[0] == 0 for o in sb.poll())
    sb.finish(1)  # an empty stream stops gating the batch
    outs = sb.poll()
    assert outs[0]["last_hidden_state"].shape[0] > 0
    assert outs[1]["last_hidden_state"].shape[0] == 0
    # the shared timeline past max_frames raises at push time
    with pytest.raises(ValueError, match="max_frames"):
        sb.push_feat(0, _feat(18, 9))
    sb.finish(0)
    assert sum(o["last_hidden_state"].shape[0] for o in sb.flush()) == 8
    with pytest.raises(ValueError, match="out of range"):
        sb.push_feat(2, _feat(18, 1))
    sb2 = streaming.StreamingCausalBatchExtractor(
        params=_params(cfg), cfg=PortConfig.from_dict(cfg.to_dict()),
        batch=1, chunk_frames=8, max_frames=64, device="cpu")
    with pytest.raises(ValueError, match="still streaming"):
        sb2.open_stream(0)
    sb2.push_feat(0, _feat(19, 16))
    sb2.finish(0)
    with pytest.raises(ValueError, match="undrained"):
        sb2.open_stream(0)


def test_bf16_matches_jax_bf16():
    """bf16 caches and compute; the port's LayerNorm takes its statistics in
    f32 where JAX's rounds each step, so the two agree to bf16 rounding
    carried through 2 layers: 8.3e-3 of max |ref| measured here, held to
    3e-2 (eight bf16 ulps of 2^-8); each stays within JAX's test's 0.1 of
    the f32 stream."""
    cfg = _tiny_cfg()
    params = _params(cfg)
    feat = _feat(23, 20)
    script = [(0, "x", 0, 20), ("finish", 0), ("poll",)]
    outs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        ref, ours = _pair(streaming.StreamingCausalBatchExtractor, cfg,
                          params, batch=1, chunk_frames=8, max_frames=32,
                          dtype=dt, matmul_precision="default")
        want_dtype = torch.bfloat16 if dt is jnp.bfloat16 else torch.float32
        assert ours._caches[0]["k"].dtype == want_dtype
        outs[dt] = (_batch_run(ours, {"x": feat}, script)[0][0],
                    _batch_run(ref, {"x": feat}, script)[0][0])
    f32, _ = outs[jnp.float32]
    got, want = outs[jnp.bfloat16]
    assert got.dtype == np.float32 and got.shape == (20, 32)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 3e-2
    for x in (got, want):
        assert np.abs(x - f32).max() / np.abs(f32).max() < 0.1


def _ring(cfg, params, feat, window, chunk):
    script = [(0, "x", 0, len(feat)), ("finish", 0), ("poll",)]
    ref, ours = _pair(streaming.StreamingCausalBatchExtractor, cfg, params,
                      batch=1, chunk_frames=chunk, window_frames=window)
    return (_batch_run(ours, {"x": feat}, script)[0][0],
            _batch_run(ref, {"x": feat}, script)[0][0])


def test_ring_window_past_its_wrap_with_a_reused_slot():
    """Window 16, chunk 8: ring capacity 24, wrapped many times by an
    80-frame stream; slot 1 opens a 40-frame stream after the wraps. Both
    against JAX's ring, and the stream against chip_smoke's dense windowed
    oracle (the card check's)."""
    cfg = _tiny_cfg()
    params = _params(cfg)
    feats = {"a": _feat(41, 80), "c": _feat(42, 40)}
    script = [(0, "a", 0, 48), ("finish", 1), ("poll",), (0, "a", 48, 80),
              ("finish", 0), ("open", 1), (1, "c", 0, 40), ("finish", 1),
              ("poll",)]
    ref, ours = _pair(streaming.StreamingCausalBatchExtractor, cfg, params,
                      batch=2, chunk_frames=8, window_frames=16)
    assert ours._cap == 24 and ours.max_frames is None
    got, want = _batch_run(ours, feats, script), _batch_run(ref, feats,
                                                            script)
    assert got[1][1].shape == (40, 32) and got[0][0].shape == (80, 32)
    for a, b in ((got[0][0], want[0][0]), (got[1][1], want[1][1])):
        np.testing.assert_allclose(a, b, atol=3e-5, rtol=1e-5)
    model = load_model(params, PortConfig.from_dict(cfg.to_dict()))
    for key, out in (("a", got[0][0]), ("c", got[1][1])):
        with torch.no_grad():
            oracle = chip_smoke.windowed_forward(
                model, model.cfg, torch.from_numpy(feats[key]), 16)
        np.testing.assert_allclose(out, oracle.numpy(), atol=3e-5,
                                   rtol=1e-5)


def test_a_window_no_shorter_than_the_stream_is_the_full_forward():
    cfg = _tiny_cfg()
    params = _params(cfg)
    feat = _feat(37, 30)
    got, want = _ring(cfg, params, feat, window=64, chunk=8)
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got, _full_causal(cfg, params, feat)[1],
                               **F32)


def test_cuda_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg()
    for cls in (streaming.StreamingCausalExtractor,
                streaming.StreamingCausalBatchExtractor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(params=_params(cfg), cfg=PortConfig.from_dict(cfg.to_dict()))
