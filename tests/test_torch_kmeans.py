"""The port's mini-batch k-means (``ops/kmeans.py``), MFCC-39 and cluster
CLI against the JAX package's, on the CPU: the same seed picks the same
rows, assignments are equal away from ties, centers within 1e-5, and the
CLI chain extract_feature --featurizer device -> cluster writes the labels
the root ``cluster.py`` writes from the same dump."""

import os
import pathlib
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.ops import fbank as jax_fbank
from speech_ssl_compression_tpu.ops import kmeans as jax_kmeans
from speech_ssl_compression_tpu.utils import checkpoint as jax_ckpt
from speech_ssl_compression_tpu_torch import cluster
from speech_ssl_compression_tpu_torch.ops import fbank, kmeans

REPO = pathlib.Path(__file__).resolve().parent.parent
CENTER_TOL = 1e-5


def _blobs(seed, n_per, true, scale=0.05):
    rng = np.random.default_rng(seed)
    x = np.concatenate([c + scale * rng.standard_normal((n_per, len(c)))
                        for c in true]).astype(np.float32)
    rng.shuffle(x)
    return x


TRUE = np.asarray([[0, 0, 0, 0], [5, 5, 0, 0], [0, 5, 5, 0], [5, 0, 0, 5],
                   [2, 2, 2, 2], [0, 0, 5, 5]], np.float32)


def _margin(x, centers):
    """Each row's gap between its best and second-best score, float64."""
    x, c = np.asarray(x, np.float64), np.asarray(centers, np.float64)
    score = 2 * x @ c.T - (c ** 2).sum(-1)[None]
    top = np.sort(score, axis=-1)
    return top[:, -1] - top[:, -2]


def test_kmeans_assign_matches_jax_away_from_ties():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1000, 32)).astype(np.float32)
    centers = rng.standard_normal((50, 32)).astype(np.float32)
    ours = kmeans.kmeans_assign(torch.from_numpy(x), torch.from_numpy(centers))
    ref = np.asarray(jax_kmeans.kmeans_assign(jnp.asarray(x),
                                              jnp.asarray(centers)))
    assert ours.dtype == torch.int32
    away = _margin(x, centers) > 1e-3
    assert away.mean() > 0.99
    np.testing.assert_array_equal(ours.numpy()[away], ref[away])


def test_kmeans_assign_breaks_ties_on_the_first_center():
    """Duplicate centers tie exactly: torch.argmax takes the first, as
    jnp.argmax does."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    c = rng.standard_normal((5, 8)).astype(np.float32)
    centers = np.concatenate([c, c])  # ids i and i + 5 tie
    ours = kmeans.kmeans_assign(torch.from_numpy(x),
                                torch.from_numpy(centers)).numpy()
    ref = np.asarray(jax_kmeans.kmeans_assign(jnp.asarray(x),
                                              jnp.asarray(centers)))
    assert (ours < 5).all()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("k", [6, 12])
def test_seed_rows_match_jax(k):
    x = _blobs(2, 100, TRUE)
    ours = kmeans._dsq_seed(np.random.default_rng(5), x, k)
    ref = np.asarray(jax_kmeans._dsq_seed(np.random.default_rng(5), x, k))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("padded", [False, True])
def test_kmeans_fit_matches_jax(padded):
    x = _blobs(3, 150, TRUE)
    chunks = [x[i:i + 128] for i in range(0, len(x), 128)]
    if padded:  # (x, n_valid) chunks of one shape
        chunks = [(np.pad(c, ((0, 128 - len(c)), (0, 0))), len(c))
                  for c in chunks]
    ours, inertia = kmeans.kmeans_fit(0, chunks, 6, epochs=3,
                                      reseed_every=4, device="cpu")
    ref, ref_inertia = jax_kmeans.kmeans_fit(0, chunks, 6, epochs=3,
                                             reseed_every=4)
    assert ours.dtype == np.float32 and ours.shape == (6, 4)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0,
                               atol=CENTER_TOL)
    assert abs(inertia - ref_inertia) <= 1e-5 * max(ref_inertia, 1e-3)
    got = kmeans.kmeans_assign(torch.from_numpy(x), torch.from_numpy(ours))
    want = jax_kmeans.kmeans_assign(jnp.asarray(x), jnp.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_minibatch_step_matches_jax():
    x = _blobs(4, 40, TRUE)
    centers = x[:6].copy()
    counts = np.arange(6, dtype=np.float32)
    valid = np.arange(len(x)) < len(x) - 7
    ours = kmeans._minibatch_step(torch.from_numpy(centers),
                                  torch.from_numpy(counts),
                                  torch.from_numpy(x), torch.from_numpy(valid))
    ref = jax_kmeans._minibatch_step(jnp.asarray(centers), jnp.asarray(counts),
                                     jnp.asarray(x), jnp.asarray(valid))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                               atol=CENTER_TOL)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(float(ours[3]), float(ref[3]), rtol=1e-6)


def test_dead_centers_reseed_like_jax():
    """A chunk with dead centers: both packages put the same rows into the
    same slots, and the input tensors stay as they were (the host arrays
    are copies)."""
    x = _blobs(5, 30, TRUE[:2])
    centers = np.random.default_rng(6).standard_normal((8, 4)).astype(
        np.float32)
    counts = np.asarray([3, 0, 2, 0, 0, 1, 0, 5], np.float32)
    c_t, n_t = torch.from_numpy(centers.copy()), torch.from_numpy(counts.copy())
    ours = kmeans._reseed_dead(np.random.default_rng(0), c_t, n_t, x)
    ref = jax_kmeans._reseed_dead(np.random.default_rng(0),
                                  jnp.asarray(centers), jnp.asarray(counts), x)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    assert not np.array_equal(ours[0].numpy(), centers)
    np.testing.assert_array_equal(c_t.numpy(), centers)
    np.testing.assert_array_equal(n_t.numpy(), counts)


def test_dead_center_reseed_executes_in_a_fit():
    x = (0.01 * np.random.default_rng(7).standard_normal((64, 4))).astype(
        np.float32)
    chunks = [(x, 64)] * 6
    ours, _ = kmeans.kmeans_fit(0, chunks, 16, epochs=1, reseed_every=1,
                                device="cpu")
    ref, _ = jax_kmeans.kmeans_fit(0, chunks, 16, epochs=1, reseed_every=1)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, np.asarray(ref), atol=CENTER_TOL)


def test_kmeans_fit_refuses_a_one_shot_generator():
    x = np.random.default_rng(8).standard_normal((256, 4)).astype(np.float32)
    gen = (x[i:i + 64] for i in range(0, 256, 64))
    with pytest.raises(ValueError, match="re-iterable"):
        kmeans.kmeans_fit(0, gen, 4, epochs=2, device="cpu")
    with pytest.raises(ValueError, match="rows < k"):
        kmeans.kmeans_fit(0, [x[:3]], 4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            kmeans.kmeans_fit(0, [x], 4)


def _write_wav(path, wav):
    pcm = np.round(np.asarray(wav, np.float64) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    return str(path)


def _tone(seed, n):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
            + 0.05 * rng.standard_normal(n))


def test_mfcc39_matches_jax(tmp_path):
    wav = np.random.default_rng(0).standard_normal(16000) * 2**13
    np.testing.assert_array_equal(fbank.mfcc39_np(wav),
                                  jax_fbank.mfcc39_np(wav))
    np.testing.assert_array_equal(fbank._dct_matrix(13, 23),
                                  jax_fbank._dct_matrix(13, 23))
    ramp = np.outer(np.arange(50, dtype=np.float64), np.ones(3))
    np.testing.assert_array_equal(fbank._deltas(ramp),
                                  jax_fbank._deltas(ramp))
    # the CLI's --audio mfcc loader: the WAV read back, x 2**15, MFCC-39
    path = _write_wav(tmp_path / "a.wav", _tone(1, 12000))
    feats = cluster._make_loader("mfcc")(path)
    assert feats.shape == (73, 39) and feats.dtype == np.float32
    from speech_ssl_compression_tpu.data.audio import read_audio

    want = jax_fbank.mfcc39_np(read_audio(path)[0][0].astype(np.float64)
                               * 2**15, dtype=np.float32)
    np.testing.assert_array_equal(feats, want)


def test_chunks_carry_rows_and_pad_the_last():
    xs = [np.full((n, 2), i, np.float32) for i, n in enumerate((5, 9, 2))]
    chunks = list(cluster._Chunks(range(3), 4, lambda i: xs[i]))
    assert [n for _, n in chunks] == [4, 4, 4, 4]
    assert all(c.shape == (4, 2) for c, _ in chunks)
    flat = np.concatenate([c[:n] for c, n in chunks])
    np.testing.assert_array_equal(flat, np.concatenate(xs)[:16])
    assert list(cluster._Chunks(range(3), 20, lambda i: xs[i]))[0][1] == 16


def test_cli_extract_device_featurizer_to_cluster_matches_root_cli(tmp_path):
    """extract_feature --featurizer device --dump-dir -> cluster (the
    port's, on the CPU) gives the labels the root cluster.py (JAX, CPU)
    gives from the same dump."""
    cfg = MelHuBERTConfig.from_dict(dict(
        feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=64,
        encoder_ffn_embed_dim=128, encoder_attention_heads=1, head_dim=64,
        conv_pos=16, conv_pos_groups=4, num_cluster=32))
    params = jax.tree.map(np.asarray,
                          init_melhubert_params(jax.random.PRNGKey(0), cfg))
    ckpt = str(tmp_path / "tiny.npz")
    jax_ckpt.save_checkpoint(ckpt, params, meta={
        "Upstream_Config": {"melhubert": cfg.to_dict()}, "Step": 0})
    wavs = [_write_wav(tmp_path / f"u{i}.wav", _tone(i, n))
            for i, n in enumerate((24000, 16000, 31000, 9000))]
    dump = tmp_path / "dump"
    env = dict(os.environ, PYTHONPATH=str(REPO))

    def run(*cmd):
        proc = subprocess.run([sys.executable, *cmd], capture_output=True,
                              text=True, cwd=REPO, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    run("-m", "speech_ssl_compression_tpu_torch.extract_feature", "-c", ckpt,
        "--device", "cpu", "--featurizer", "device", "--wav", *wavs,
        "--dump-dir", str(dump))
    csv = str(dump / "features.csv")
    args = ["-f", csv, "-k", "4", "--epochs", "3", "--chunk-rows", "64"]
    out = run("-m", "speech_ssl_compression_tpu_torch.cluster", *args,
              "-o", str(tmp_path / "port"), "--device", "cpu")
    assert "on cpu" in out
    run("cluster.py", *args, "-o", str(tmp_path / "jax"), "--backend", "cpu")
    for name in ("labels.km", "labels.len"):
        got = (tmp_path / "port" / name).read_text()
        assert got == (tmp_path / "jax" / name).read_text(), name
    lens = [int(v) for v in (tmp_path / "port" / "labels.len").read_text()
            .split()]
    assert lens == [-(-(1 + (n - 400) // 160) // 2)
                    for n in (24000, 16000, 31000, 9000)]
    np.testing.assert_allclose(np.load(tmp_path / "port" / "centers.npy"),
                               np.load(tmp_path / "jax" / "centers.npy"),
                               atol=CENTER_TOL)
