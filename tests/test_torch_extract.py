"""The port's extraction slice against the JAX package: the checkpoint
reader, the host featurizer and packing mirrors, ``forward_packed`` end to
end on one npz checkpoint, packed against unpacked, and the CLI."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.extract import (
    MelHuBERTExtractor as JaxExtractor,
    load_any_checkpoint as jax_load_any_checkpoint,
    wav_to_mel as jax_wav_to_mel,
)
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.ops import packing as jax_packing
from speech_ssl_compression_tpu.utils import checkpoint as jax_ckpt
from speech_ssl_compression_tpu_torch import extract as port
from speech_ssl_compression_tpu_torch.ops import packing
from speech_ssl_compression_tpu_torch.utils import checkpoint as port_ckpt

REPO = pathlib.Path(__file__).resolve().parent.parent
MEAN_STD = REPO / "example" / "libri-960-mean-std.npy"
BAR = 1e-4         # max |d| / mean |ref| on valid frames
PACKED_BAR = 2e-4  # packed vs unpacked (README: packed == unpacked to 2e-4)
TINY = dict(feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=128,
            encoder_ffn_embed_dim=256, encoder_attention_heads=2, head_dim=64,
            conv_pos=16, conv_pos_groups=4, num_cluster=32)


def _wavs(seed=0, n_samples=(16000, 9000, 23000, 4000, 12000, 30000)):
    rng = np.random.default_rng(seed)
    out = []
    for n in n_samples:
        t = np.arange(n) / 16000.0
        tone = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
        out.append((tone + 0.05 * rng.standard_normal(n)).astype(np.float32))
    return out


def _tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_tree_equal, a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def _params(cfg, seed):
    return jax.tree.map(np.asarray,
                        init_melhubert_params(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A dense and a weight-pruned (masked) npz, written by the JAX package."""
    d = tmp_path_factory.mktemp("ckpt")
    cfg = MelHuBERTConfig.from_dict(TINY)
    meta = {"Upstream_Config": {"melhubert": cfg.to_dict()}, "Step": 0}
    dense, masked = str(d / "dense.npz"), str(d / "masked.npz")
    params = _params(cfg, 0)
    jax_ckpt.save_checkpoint(dense, params, meta=meta)
    rng = np.random.default_rng(3)
    masks = {"layer_1": {
        "fc1": {"kernel": (rng.random((128, 256)) > 0.5).astype(np.float32)},
        "q_proj": {"kernel": (rng.random((128, 128)) > 0.3).astype(np.float32),
                   "bias": (rng.random(128) > 0.3).astype(np.float32)},
    }}
    jax_ckpt.save_checkpoint(masked, params, masks=masks, meta=meta)
    return {"dense": dense, "masked": masked, "params": params, "masks": masks}


def test_checkpoint_reader_matches_jax(ckpts):
    for kind in ("dense", "masked"):
        ours = port_ckpt.load_checkpoint(ckpts[kind])
        ref = jax_ckpt.load_checkpoint(ckpts[kind])
        assert _tree_equal(ours["params"], ref["params"])
        assert ours["meta"] == ref["meta"]
        assert (ours["masks"] is None) == (kind == "dense")
        if kind == "masked":
            assert _tree_equal(ours["masks"], ref["masks"])


@pytest.mark.parametrize("kind", ["dense", "masked"])
def test_load_any_checkpoint_folds_like_jax(ckpts, kind):
    params, cfg, meta = port.load_any_checkpoint(ckpts[kind])
    ref_params, ref_cfg, ref_meta = jax_load_any_checkpoint(ckpts[kind])
    # the port's config is its own class with JAX's fields
    assert cfg.to_dict() == ref_cfg.to_dict() and meta == ref_meta
    assert _tree_equal(params, jax.tree.map(np.asarray, ref_params))
    if kind == "masked":
        fc1 = params["encoder"]["layers"][1]["fc1"]["kernel"]
        mask = ckpts["masks"]["layer_1"]["fc1"]["kernel"]
        assert np.all(fc1[mask == 0] == 0)


def test_port_writes_what_jax_reads(ckpts, tmp_path):
    path = str(tmp_path / "port.npz")
    meta = {"Step": 7}
    port_ckpt.save_checkpoint(path, ckpts["params"], masks=ckpts["masks"],
                              meta=meta)
    ref = jax_ckpt.load_checkpoint(path)
    assert ref["meta"] == meta
    assert _tree_equal(jax.tree.map(np.asarray, ref["params"]), ckpts["params"])
    assert _tree_equal(jax.tree.map(np.asarray, ref["masks"]), ckpts["masks"])


@pytest.mark.parametrize("fp", [10, 20])
@pytest.mark.parametrize("precision", ["high", "fast"])
def test_wav_to_mel_matches_jax(precision, fp):
    mean, std = port.load_mean_std(str(MEAN_STD))
    for wav in _wavs(seed=1)[:3]:
        ours = port.wav_to_mel(wav, mean, std, fp, precision=precision)
        ref = jax_wav_to_mel(wav, mean, std, fp, precision=precision)
        assert ours.shape == ref.shape and ours.dtype == ref.dtype
        if precision == "high":
            np.testing.assert_array_equal(ours, ref)
        else:
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packing_mirrors_match_jax(seed):
    rng = np.random.default_rng(seed)
    lengths = list(rng.integers(1, 200, size=int(rng.integers(1, 20))))
    cap = max(256, max(lengths))
    rows = packing.plan_packing(lengths, cap)
    assert rows == jax_packing.plan_packing(lengths, cap)
    for a, b in zip(packing.build_pack_arrays(lengths, rows, cap, 256),
                    jax_packing.build_pack_arrays(lengths, rows, cap, 256)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="truncate"):
        packing.build_pack_arrays([cap + 1], [[0]], cap, cap + 1)


def _valid(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _rel(got, ref, valid):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref)[valid].max() / np.abs(ref)[valid].mean()


@pytest.fixture(scope="module")
def port_extractor(ckpts):
    return port.MelHuBERTExtractor(ckpts["masked"],
                                   mean_std_npy_path=str(MEAN_STD),
                                   device="cpu")


def test_forward_packed_matches_jax(ckpts, port_extractor):
    wavs = _wavs()
    ref = JaxExtractor(ckpts["masked"], mean_std_npy_path=str(MEAN_STD),
                       dtype=jnp.float32).forward_packed(wavs)
    out = port_extractor.forward_packed(wavs)
    assert out["lengths"] == ref["lengths"]
    assert out["n_packed_rows"] == ref["n_packed_rows"]
    assert len(out["hidden_states"]) == len(ref["hidden_states"]) == 3
    t = out["last_hidden_state"].shape[1]
    valid = _valid(out["lengths"], t)
    pairs = list(zip(out["hidden_states"], ref["hidden_states"]))
    pairs.append((out["last_hidden_state"], ref["last_hidden_state"]))
    for i, (a, b) in enumerate(pairs):
        assert a.shape == tuple(b.shape)
        assert _rel(a.numpy(), b, valid) < BAR, i
    # packed outputs are zero on invalid frames (pre_feat excepted)
    assert not out["last_hidden_state"].numpy()[~valid].any()


def test_forward_packed_matches_unpacked(port_extractor):
    wavs = _wavs(seed=4)
    packed = port_extractor.forward_packed(wavs)
    plain = port_extractor.forward(wavs)
    assert packed["n_packed_rows"] < len(wavs)
    valid = _valid(packed["lengths"], packed["last_hidden_state"].shape[1])
    for a, b in zip(packed["hidden_states"] + [packed["last_hidden_state"]],
                    plain["hidden_states"] + [plain["last_hidden_state"]]):
        assert _rel(a.numpy(), b.numpy(), valid) < PACKED_BAR


def test_extractor_refuses_what_it_cannot_do(ckpts, port_extractor):
    with pytest.raises(ValueError, match="featurizer"):
        port_extractor.forward_packed(_wavs()[:1], featurizer="gpu")
    with pytest.raises(ValueError, match="matmul_precision"):
        port.MelHuBERTExtractor(ckpts["dense"], device="cpu",
                                matmul_precision="bf16")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.MelHuBERTExtractor(ckpts["dense"], device="cuda")


def test_matmul_precision_restores_flags():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with port.matmul_precision("highest"):
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    with port.matmul_precision("default"):
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


def test_cli_extracts_on_cpu(ckpts, tmp_path):
    from scipy.io import wavfile

    paths = []
    for i, wav in enumerate(_wavs(seed=5)[:2]):
        p = tmp_path / f"utt{i}.wav"
        wavfile.write(p, 16000, (wav * 32767).astype(np.int16))
        paths.append(str(p))
    dump = tmp_path / "dump"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "speech_ssl_compression_tpu_torch.extract_feature",
         "-c", ckpts["dense"], "--device", "cpu", "--wav", *paths,
         "--dump-dir", str(dump)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "is extracted" in proc.stdout
    feats = sorted(dump.glob("*.npy"))
    assert len(feats) == 2
    assert all(np.load(f).shape[1] == 128 for f in feats)
    assert (dump / "features.csv").read_text().startswith("file_path,length")


@pytest.mark.parametrize("name", ["config_model_10ms.yaml",
                                  "config_model_20ms.yaml"])
def test_model_yaml_reader_matches_yaml_safe_load(name):
    import yaml

    from speech_ssl_compression_tpu_torch.configs import (
        melhubert_config_from_yaml,
    )

    path = REPO / "configs" / "melhubert" / name
    with open(path) as f:
        want = MelHuBERTConfig.from_dict(yaml.safe_load(f)["melhubert"])
    assert melhubert_config_from_yaml(path).to_dict() == want.to_dict()
