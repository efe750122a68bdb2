"""The port's measuring modules against the JAX package's: ``utils/flops.py``
(the same integers for every shipped model YAML; the card's peaks in place
of JAX's v5e figure, an unknown card refused, ``chip_smoke.py``'s bounds
taken from them), ``utils/profiling.py`` (a trace file written on the CPU,
annotated spans in it) and ``train/wave_bench.py`` (the recipe's
constants and its numpy-seeded arrays bitwise JAX's; its grad step the
runners' own)."""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch
import yaml

from speech_ssl_compression_tpu import configs as jconfigs
from speech_ssl_compression_tpu.train import wave_bench as jbench
from speech_ssl_compression_tpu.utils import flops as jflops
from speech_ssl_compression_tpu_torch import configs as tconfigs
from speech_ssl_compression_tpu_torch.models.conv_frontend import (
    conv_output_length,
)
from speech_ssl_compression_tpu_torch.train import wave_bench as tbench
from speech_ssl_compression_tpu_torch.utils import flops as tflops
from speech_ssl_compression_tpu_torch.utils.profiling import span, trace

REPO = pathlib.Path(__file__).resolve().parent.parent
SECTIONS = {"melhubert": "MelHuBERTConfig", "student": "MelHuBERTConfig",
            "teacher": "MelHuBERTConfig", "hubert": "HuBERTConfig",
            "wav2vec2": "Wav2Vec2Config"}
MODEL_YAMLS = sorted(
    str(p.relative_to(REPO)) for p in REPO.glob("configs/**/*.yaml")
    if set(yaml.safe_load(p.read_text())) & set(SECTIONS))


@pytest.mark.parametrize("path", MODEL_YAMLS)
def test_flops_are_jax_integers_for_every_shipped_model(path):
    jtree = yaml.safe_load((REPO / path).read_text())
    ttree = tconfigs.read_yaml(REPO / path)
    checked = 0
    for section, cls in SECTIONS.items():
        if section not in jtree:
            continue
        jcfg = getattr(jconfigs, cls).from_dict(jtree[section])
        tcfg = getattr(tconfigs, cls).from_dict(ttree[section])
        for length in (1, 750, 3068):
            got = tflops.encoder_fwd_flops(tcfg, length)
            assert got == jflops.encoder_fwd_flops(jcfg, length)
            assert isinstance(got, int) and got > 0
        if cls == "MelHuBERTConfig":
            for d_in in (40, 80):
                assert tflops.melhubert_fwd_flops(tcfg, 750, d_in) == (
                    jflops.melhubert_fwd_flops(jcfg, 750, d_in))
        else:
            t_wave = 245760
            t_frames = conv_output_length(t_wave, tcfg.conv_feature_layers)
            assert tflops.conv_frontend_fwd_flops(
                tcfg.conv_feature_layers, t_wave) == (
                jflops.conv_frontend_fwd_flops(jcfg.conv_feature_layers,
                                               t_wave))
            assert tflops.wave_fwd_flops(tcfg, t_wave, t_frames) == (
                jflops.wave_fwd_flops(jcfg, t_wave, t_frames))
        checked += 1
    assert checked


def test_peaks_are_the_cards_and_an_unknown_card_raises(monkeypatch):
    h100 = "NVIDIA H100 80GB HBM3"
    assert tflops.peak_flops(torch.bfloat16, h100) == 989e12
    assert tflops.peak_flops(torch.float32, h100) == 495e12 / 3
    assert tflops.peak_bytes(h100) == 3.35e12
    assert not hasattr(tflops, "PEAK_TFLOPS")  # JAX's v5e figure
    with pytest.raises(ValueError, match="no peak rates"):
        tflops.peak_flops(torch.bfloat16, "NVIDIA A100-SXM4-80GB")
    assert tflops.peak_flops(torch.float32, h100, cuda_cores=True) == 67e12
    with pytest.raises(ValueError, match="float32 only"):
        tflops.peak_flops(torch.bfloat16, h100, cuda_cores=True)
    sys.path.insert(0, str(REPO))
    import chip_smoke

    # chip_smoke's bounds read the same table, for the current card
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *args: h100)
    ms, by = chip_smoke.bound(989e9, 1.0, torch.bfloat16)
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, by = chip_smoke.bound(67e9, 1.0, torch.float32, cuda_cores=True)
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, by = chip_smoke.bound(1.0, 3.35e9, torch.float32)
    assert ms == pytest.approx(1.0) and by == "bytes"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *args: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="no peak rates"):
        chip_smoke.bound(1.0, 1.0, torch.bfloat16)


def test_trace_writes_a_chrome_trace_with_annotated_spans(tmp_path):
    def step(x):
        with span("port_step"):
            return (x @ x).sum()

    with trace(str(tmp_path / "trace")) as prof:
        for _ in range(2):
            step(torch.ones(8, 8))
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert sum(e.get("name") == "port_step" for e in events) == 2
    assert sum(e.name == "port_step" for e in prof.events()) == 2
    # without a directory nothing is written, the events are still read
    with trace(None) as prof:
        step(torch.ones(2, 2))
    assert any(e.name == "port_step" for e in prof.events())


def test_wave_bench_recipe_is_jax():
    assert tbench.BASE_CONV_SPEC == jbench.BASE_CONV_SPEC
    assert tbench.BASE_COMMON == jbench.BASE_COMMON


NARROW = dict(encoder_layers=1, encoder_embed_dim=64,
              encoder_ffn_embed_dim=128, encoder_attention_heads=1,
              conv_feature_layers="[(32,10,5)] + [(32,3,2)] * 2",
              final_dim=16, conv_pos=16, conv_pos_groups=4)


@pytest.mark.parametrize("model", ["hubert", "wav2vec2"])
def test_wave_bench_arrays_are_jax_and_its_step_runs(monkeypatch, model):
    # both recipes at a narrow width (the arrays depend on the seed, B,
    # t_wave and the conv spec alone)
    for mod in (jbench, tbench):
        monkeypatch.setattr(mod, "BASE_COMMON",
                            dict(mod.BASE_COMMON, **NARROW))
    b, t_wave = 2, 6000
    ref = jbench.wave_bench_setup(model, b=b, t_wave=t_wave, seed=3)
    got = tbench.wave_bench_setup(model, b=b, t_wave=t_wave, seed=3,
                                  device="cpu")
    assert got["t_frames"] == ref["t_frames"]
    for key in ("source", "lengths"):
        assert got[key].dtype == np.asarray(ref[key]).dtype
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]))
    if model == "hubert":
        assert got["num_classes"] == ref["num_classes"]
        np.testing.assert_array_equal(got["targets"][0],
                                      np.asarray(ref["targets"][0]))
    port_cls = getattr(tconfigs, type(got["cfg"]).__name__)
    assert got["cfg"].to_dict() == port_cls.from_dict(
        ref["cfg"].to_dict()).to_dict()
    step = tbench.make_wave_bench_grad_step(model, got, torch.float32)
    params = dict(got["model"].named_parameters())
    grads = step(params, torch.Generator().manual_seed(0))
    assert len(grads) == len(params)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(bool(g.abs().sum() > 0) for g in grads)


def test_wave_bench_setup_asks_for_the_card_by_default(monkeypatch):
    # like every entry point of the port: the card unless the caller asks
    # for the CPU, and without CUDA that request raises, never a CPU run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.wave_bench_setup("hubert", b=1, t_wave=400)
