"""Serving from waveforms in the port against the JAX package, on one
checkpoint the JAX package wrote (the tiny config of
``tests/test_torch_extract.py``): the batched fbank (``featurize_batch``,
``featurize_device``, ``_assemble_wave_batch``), ``forward``,
``forward_packed`` and ``forward_files`` with ``featurizer="device"``,
``forward_stream`` with both featurizers, and the S3PRL expert and hubconf.
Waveforms are synthetic and seeded, int16-exact and float.

Bars: the features within 1e-4 of max |ref|, n_valid, lengths and pad masks
exactly equal, rows past n_valid exactly 0, the assembled batch bitwise;
hidden states within the golden bar (max |d| / mean |ref| < 1e-4 on valid
frames); ``forward_stream`` bitwise the port's sequential
``forward_packed``."""

import pathlib
import threading
import time
import wave

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu import extract as jax_extract
from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.ops import fbank as jax_fbank
from speech_ssl_compression_tpu.s3prl import expert as jax_expert
from speech_ssl_compression_tpu.s3prl import hubconf as jax_hubconf
from speech_ssl_compression_tpu.utils import checkpoint as jax_ckpt
from speech_ssl_compression_tpu_torch import extract as port
from speech_ssl_compression_tpu_torch.ops import fbank
from speech_ssl_compression_tpu_torch.s3prl import expert as port_expert
from speech_ssl_compression_tpu_torch.s3prl import hubconf as port_hubconf

REPO = pathlib.Path(__file__).resolve().parent.parent
MEAN_STD = str(REPO / "example" / "libri-960-mean-std.npy")
BAR = 1e-4  # golden: max |d| / mean |ref| on valid frames
FEAT_BAR = 1e-4  # features: max |d| / max |ref|
TINY = dict(feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=128,
            encoder_ffn_embed_dim=256, encoder_attention_heads=2, head_dim=64,
            conv_pos=16, conv_pos_groups=4, num_cluster=32)
# 41300 samples: 256 frames of 10 ms, exactly 2 x 128 stacked frames, with
# 100 samples past the last frame's reach (the pad boundary)
LENGTHS = (16000, 9000, 41300, 4000, 23000)


def _wavs(seed=0, lengths=LENGTHS, int16=False):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        t = np.arange(n) / 16000.0
        w = (0.2 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
             + 0.05 * rng.standard_normal(n))
        if int16:  # 16-bit-sourced audio: exact integers once x 2**15
            w = np.round(w * 32767) / 32768
        out.append(w.astype(np.float32))
    return out


def _save(path, cfg_dict, seed=0):
    cfg = MelHuBERTConfig.from_dict(cfg_dict)
    params = jax.tree.map(np.asarray,
                          init_melhubert_params(jax.random.PRNGKey(seed), cfg))
    jax_ckpt.save_checkpoint(
        str(path), params,
        meta={"Upstream_Config": {"melhubert": cfg.to_dict()}, "Step": 0})
    return str(path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _save(tmp_path_factory.mktemp("ckpt") / "tiny.npz", TINY)


def _pair(ckpt, fp=20):
    """The JAX extractor and the port's (on the CPU) on one checkpoint."""
    ref = jax_extract.MelHuBERTExtractor(ckpt, fp=fp,
                                         mean_std_npy_path=MEAN_STD)
    ours = port.MelHuBERTExtractor(ckpt, fp=fp, mean_std_npy_path=MEAN_STD,
                                   device="cpu")
    return ref, ours


@pytest.fixture(scope="module")
def pair(ckpt):
    return _pair(ckpt)


def _valid(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _rel(got, ref, valid):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref)[valid].max() / np.abs(ref)[valid].mean()


def _states(out):
    return out["hidden_states"] + [out["last_hidden_state"]]


def _match_jax(out, ref):
    assert out["lengths"] == ref["lengths"]
    if "n_packed_rows" in ref:
        assert out["n_packed_rows"] == ref["n_packed_rows"]
    ours, theirs = _states(out), _states(ref)
    assert len(ours) == len(theirs)
    valid = _valid(out["lengths"], out["last_hidden_state"].shape[1])
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert tuple(a.shape) == tuple(b.shape), i
        assert _rel(a, b, valid) < BAR, i


@pytest.mark.parametrize("fp", [20, 10])
@pytest.mark.parametrize("int16", [False, True])
def test_device_featurizer_matches_jax(ckpt, fp, int16):
    ref_ext, ext = _pair(ckpt, fp)
    wavs = _wavs(seed=fp, int16=int16)
    batch, *rest = ext._assemble_wave_batch(wavs)
    ref_batch, *ref_rest = ref_ext._assemble_wave_batch(wavs)
    assert batch.dtype == ref_batch.dtype == (np.int16 if int16
                                              else np.float32)
    np.testing.assert_array_equal(batch, ref_batch)
    assert rest == ref_rest
    n_samp, max_frames, stack, lengths, t_pad = rest
    assert batch.shape[1] > (max_frames - 1) * 160 + 400  # the boundary

    feat, n_valid = fbank.featurize_batch(
        torch.from_numpy(batch), torch.tensor(n_samp), ext._mean, ext._std,
        max_frames, stack=stack)
    ref_feat, ref_n = jax_fbank.featurize_batch(
        jnp.asarray(batch), jnp.asarray(n_samp, jnp.int32),
        jnp.asarray(ref_ext.mean, jnp.float32),
        jnp.asarray(ref_ext.std, jnp.float32), max_frames, stack=stack)
    ref_feat = np.asarray(ref_feat)
    assert n_valid.dtype == torch.int32
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(ref_n))
    assert tuple(feat.shape) == ref_feat.shape
    assert feat.shape[1] == t_pad
    past = ~_valid(n_valid.numpy(), feat.shape[1])
    assert not feat.numpy()[past].any()
    assert (np.abs(feat.numpy() - ref_feat).max()
            <= FEAT_BAR * np.abs(ref_feat).max())

    got = ext.featurize_device(wavs)
    want = ref_ext.featurize_device(wavs)
    assert got[2] == want[2] == lengths
    np.testing.assert_array_equal(got[1], want[1])
    assert (np.abs(got[0].numpy() - ref_feat).max()
            <= FEAT_BAR * np.abs(ref_feat).max())
    # and against the host featurizer in float64
    host = [port.wav_to_mel(w, ext.mean, ext.std, fp, precision="high")
            for w in wavs]
    for i, m in enumerate(host):
        assert m.shape[0] == lengths[i]
        np.testing.assert_allclose(feat.numpy()[i, :len(m)], m,
                                   atol=2e-4, rtol=2e-4)


def test_featurize_batch_pads_a_short_buffer():
    """A buffer shorter than max_frames' reach: the rows it cannot fill lie
    past n_valid and stay zero, as JAX's clamped gather leaves them."""
    rng = np.random.default_rng(4)
    batch = (rng.standard_normal((2, 5000)) * 3000).astype(np.float32)
    n = [5000, 3000]
    mean = rng.standard_normal(40).astype(np.float32)
    std = (1 + rng.random(40)).astype(np.float32)
    feat, n_valid = fbank.featurize_batch(
        torch.from_numpy(batch), torch.tensor(n), torch.from_numpy(mean),
        torch.from_numpy(std), 64, stack=True)
    ref, ref_n = jax_fbank.featurize_batch(
        jnp.asarray(batch), jnp.asarray(n, jnp.int32), jnp.asarray(mean),
        jnp.asarray(std), 64, stack=True)
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(ref_n))
    ref = np.asarray(ref)
    assert np.abs(feat.numpy() - ref).max() <= FEAT_BAR * np.abs(ref).max()


@pytest.mark.parametrize("int16", [False, True])
def test_forward_and_forward_packed_device_featurizer_match_jax(pair, int16):
    ref_ext, ext = pair
    wavs = _wavs(seed=1, int16=int16)
    out = ext.forward(wavs, featurizer="device")
    assert len(_states(out)) == TINY["encoder_layers"] + 2
    _match_jax(out, ref_ext.forward(wavs, featurizer="device"))
    packed = ext.forward_packed(wavs, featurizer="device")
    _match_jax(packed, ref_ext.forward_packed(wavs, featurizer="device"))
    assert packed["n_packed_rows"] < len(wavs)


def _write_wav(path, wav):
    pcm = np.round(np.asarray(wav, np.float64) * 32768).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def wav_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    return [_write_wav(d / f"utt{i}.wav", w)
            for i, w in enumerate(_wavs(seed=2, int16=True))]


def test_forward_files_device_featurizer_matches_jax(pair, wav_paths):
    ref_ext, ext = pair
    batch, *_ = ext._assemble_wave_batch(port.read_wavs(wav_paths))
    assert batch.dtype == np.int16  # 16-bit files upload as int16
    _match_jax(ext.forward_files(wav_paths, featurizer="device"),
               ref_ext.forward_files(wav_paths, featurizer="device"))


def _batches():
    a, b = _wavs(seed=3), _wavs(seed=4, lengths=(7000, 12000), int16=True)
    return [a, b, a[::-1], [b[0]]]


@pytest.mark.parametrize("featurizer", ["host", "device"])
def test_forward_stream_is_sequential_forward_packed(pair, featurizer):
    ref_ext, ext = pair
    batches = _batches()
    got = list(ext.forward_stream(iter(batches), featurizer=featurizer))
    want = [ext.forward_packed(b, featurizer=featurizer) for b in batches]
    assert len(got) == len(want) == len(batches)
    for g, w in zip(got, want):
        assert g["lengths"] == w["lengths"]
        assert g["n_packed_rows"] == w["n_packed_rows"]
        for a, b in zip(_states(g), _states(w)):
            assert torch.equal(a, b)
    ref = list(ref_ext.forward_stream(iter(batches), featurizer=featurizer))
    for g, r in zip(got, ref):
        _match_jax(g, r)


def test_forward_stream_zero_layer_fallback(tmp_path):
    path = _save(tmp_path / "zero.npz", dict(TINY, encoder_layers=0))
    ref_ext, ext = _pair(path)
    batches = [_wavs(seed=5, lengths=(8000, 6000)), _wavs(seed=6)]
    for featurizer in ("host", "device"):
        got = list(ext.forward_stream(iter(batches), featurizer=featurizer))
        assert len(got) == 2
        for g, b in zip(got, batches):
            w = ext.forward(b, featurizer=featurizer)
            assert "n_packed_rows" not in g
            for x, y in zip(_states(g), _states(w)):
                assert torch.equal(x, y)
        ref = ref_ext.forward_stream(iter(batches), featurizer=featurizer)
        for g, r in zip(got, ref):
            _match_jax(g, r)


def test_forward_stream_refuses_an_unknown_featurizer(pair):
    _, ext = pair
    with pytest.raises(ValueError, match="featurizer"):
        list(ext.forward_stream(iter([_wavs()[:1]]), featurizer="gpu"))
    with pytest.raises(ValueError, match="featurizer"):
        ext.forward(_wavs()[:1], featurizer="Device")


def _workers():
    return [t for t in threading.enumerate()
            if t.name.endswith("(worker)") and t.is_alive()]


def test_forward_stream_early_exit_stops_the_prefetch_thread(pair):
    _, ext = pair
    before = set(_workers())
    batch = _wavs(seed=7, lengths=(4000, 5000))
    gen = ext.forward_stream(iter([batch] * 8), featurizer="device")
    first = next(gen)
    assert first["lengths"] == [-(-(1 + (n - 400) // 160) // 2)
                                for n in (4000, 5000)]
    started = set(_workers()) - before
    assert started  # the worker waits on its full queue
    gen.close()
    deadline = time.monotonic() + 10
    while any(t.is_alive() for t in started) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not any(t.is_alive() for t in started)


def test_forward_stream_raises_a_worker_error(pair):
    _, ext = pair

    def batches():
        yield _wavs(seed=8, lengths=(4000,))
        raise RuntimeError("bad batch")

    with pytest.raises(RuntimeError, match="bad batch"):
        list(ext.forward_stream(batches(), featurizer="device"))


def _factory_names(module):
    return sorted(n for n in vars(module) if n.startswith("compression_"))


def test_hubconf_exposes_jax_factories():
    names = _factory_names(port_hubconf)
    assert names == _factory_names(jax_hubconf)
    assert len(names) == 14
    for n in names:
        assert (getattr(port_hubconf, n).__name__
                == getattr(jax_hubconf, n).__name__)
    with pytest.raises(FileNotFoundError):
        port_hubconf.compression_20ms_melhubert_local("/nonexistent.npz")


@pytest.mark.parametrize("packed", [False, True])
def test_upstream_expert_matches_jax(ckpt, wav_paths, packed):
    ref = jax_hubconf.compression_20ms_melhubert_960hours_local(
        ckpt, packed=packed, featurizer="device")
    ours = port_hubconf.compression_20ms_melhubert_960hours_local(
        ckpt, packed=packed, featurizer="device", device="cpu")
    assert ours.extractor.mean.tolist() == ref.extractor.mean.tolist()
    assert ours.get_downsample_rates("x") == ref.get_downsample_rates() == 320
    wavs = _wavs(seed=9, lengths=(9000, 16000, 5000))
    for inputs in (wavs, [torch.from_numpy(w) for w in wavs], wav_paths):
        out, want = ours(inputs), ref(inputs)
        assert set(out) == {"hidden_states", "last_hidden_state"}
        lengths = [-(-(1 + (w.shape[-1] - 400) // 160) // 2) for w in
                   (port_expert._to_numpy_wave(x) for x in inputs)]
        _match_jax(dict(out, lengths=lengths), dict(want, lengths=lengths))


def test_upstream_expert_10ms_and_its_device(ckpt):
    ours = port_hubconf.compression_10ms_melhubert_local(ckpt, device="cpu")
    assert ours.get_downsample_rates() == 160
    assert ours.extractor.device.type == "cpu"
    assert ours.extractor.mean.shape == (40,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_expert.UpstreamExpert(ckpt)
