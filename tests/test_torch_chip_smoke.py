"""The pieces of ``chip_smoke.py`` that need no GPU: the attention kernels'
work and bounds per dtype (the kernels line's bound_ms and bound_by), the
layout of an attention kernel's entry in that line, the launches per dtype
and path in it, and the check that the attention kernels (forward, dQ,
dK/dV; bf16, and f32 in split TF32), the f32 conv forward (split TF32) and
the bf16 conv forward, dW and dX run on the tensor cores (HGMMA in their
SASS); and the wave serve phase end to end at a tiny width."""

import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from speech_ssl_compression_tpu_torch.utils.flops import (  # noqa: E402
    peak_bytes, peak_flops,
)

KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")


@pytest.fixture(autouse=True)
def an_h100(monkeypatch):
    # the bounds read the current card's peaks from utils/flops.py: here
    # the card is an H100 SXM
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *args: "NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("dtype,size,peak", [(torch.float32, 4, 495e12 / 3),
                                             (torch.bfloat16, 2, 989e12)])
def test_attention_bounds_per_dtype(dtype, size, peak):
    assert peak_flops(dtype) == peak
    b, h, t, d = chip_smoke.TRAIN_SHAPE
    pairs = float(t * sum(chip_smoke.TRAIN_LENGTHS))
    work = chip_smoke.attention_work(chip_smoke.TRAIN_SHAPE, t, pairs, dtype)
    # 4 d, 6 d and 8 d FLOPs per (query, key) pair and head
    for name, per_pair in zip(KERNELS, (4, 6, 8)):
        assert work[name][0] == per_pair * d * h * pairs
    # q/k/v/dO and their outputs at the dtype's size, statistics in f32:
    # forward 4 tensors, dQ 5 (q, k, v, dO, dq), dK/dV 6
    tensor, rows, keys = b * h * t * d, b * h * t * 4, b * t * 4
    assert work["flash_attn_fwd"][1] == 4 * tensor * size + keys + rows
    assert work["flash_attn_bwd_dq"][1] == 5 * tensor * size + keys + 2 * rows
    assert work["flash_attn_bwd_dkv"][1] == 6 * tensor * size + keys + 2 * rows
    bounds = chip_smoke.attention_bounds(dtype)
    for name in KERNELS:
        flops, n_bytes = work[name]
        want = max(flops / peak, n_bytes / peak_bytes()) * 1e3
        ms, by = bounds[name, "training_dropout"]
        assert ms == pytest.approx(want, rel=1e-12)
        assert by == "operations"  # 64 dims: above the ridge in both dtypes
    # the pair's bf16 bounds at the training shape, ~0.01 ms each
    if dtype == torch.bfloat16:
        assert bounds["flash_attn_bwd_dq", "training_dropout"][0] == (
            pytest.approx(0.0097, rel=0.01))
        assert bounds["flash_attn_bwd_dkv", "training_dropout"][0] == (
            pytest.approx(0.0129, rel=0.01))
    # every timed case has a bound; the serving batch only the forward's
    assert set(bounds) == {(n, c) for n in KERNELS
                           for c in chip_smoke.TIMED_CASES
                           if c != "serving" or n == "flash_attn_fwd"}
    # the long shape is more work than the training shape
    assert bounds["flash_attn_fwd", "long"][0] > bounds[
        "flash_attn_fwd", "training_dropout"][0]


def test_attention_entry_has_both_dtypes_and_every_timed_case():
    record, bounds, library = {}, {}, {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        bounds[dtype] = chip_smoke.attention_bounds(dtype)
        library[dtype] = {("flash_attn_bwd_dq", c): 1.0
                          for c in ("training_dropout", "long")}
        for case in ("training_dropout", "long", "training"):
            record["flash_attn_bwd_dq", case, tag] = dict(max_abs_err=0.1)
            if case != "training":  # timed
                record["flash_attn_bwd_dq", case, tag].update(ms=2.0,
                                                              plain_ms=3.0)
    e = chip_smoke.attention_entry("flash_attn_bwd_dq", record, bounds,
                                   library)
    for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in e and key + "_bf16" in e
    assert e["source"].endswith("csrc/flash_attn_bwd_f32_sm90.cu")
    assert e["replaces"].endswith("ops/flash_attention.py:473")
    assert e["bound_ms"] > e["bound_ms_bf16"]
    assert set(e["cases"]) == {"long"}  # untimed cases stay out
    assert set(e["cases"]["long"]) == {"f32", "bf16"}
    assert e["cases"]["long"]["bf16"]["library_ms"] == 1.0


class _Kernels:
    def __init__(self, counts):
        self.counts = counts

    def sass_instruction_counts(self, opcode):
        assert opcode == "HGMMA"
        return self.counts


FWD = ("_ZN4sslc12_GLOBAL__N_126flash_attn_fwd_bf16_kernelILb{}ELb{}EEEv"
       "14CUtensorMap")
FWD_F32 = ("_ZN4sslc12_GLOBAL__N_125flash_attn_fwd_f32_kernelILb{}ELb{}EEEv"
           "14CUtensorMap")
FWD_FLAGS = ((0, 0), (0, 1), (1, 0), (1, 1))
SM90 = "_ZN4sslc47_GLOBAL__N__0f33a512_14_conv1d_sm90_cu_9b4ff5a7"
PHASE_MAPS = "ENS0_9PhaseMapsE14CUtensorMap_st"
F32_SM90 = "_ZN4sslc51_GLOBAL__N__3c1f27aa_18_conv1d_f32_sm90_cu_5e1d2b1a"
CONV = {"fwd": SM90 + "22conv1d_fwd_bf16_kernel" + PHASE_MAPS,
        "dw": SM90 + "21conv1d_dw_bf16_kernel" + PHASE_MAPS,
        "dx": SM90 + "21conv1d_dx_bf16_kernelE14CUtensorMapS1_P13__nv_bfloat16"
                     "iiiiiii",
        "fwd_f32": F32_SM90 + "21conv1d_fwd_f32_kernelENS0_12F32PhaseMapsE14"
                              "CUtensorMapPfiiiiii",
        "dw_f32": F32_SM90 + "20conv1d_dw_f32_kernelENS0_12F32PhaseMapsE14"
                             "CUtensorMapPfiiiiiii",
        "dx_f32": F32_SM90 + "20conv1d_dx_f32_kernelE14CUtensorMapS1_Pfiiiiiii"
                             "i"}


def _bwd_counts(missing=None):
    """HGMMA counts of the four backward kernels (bf16 and f32 dQ, dK/dV),
    0 in the one named by ``missing`` ("dq", "dkv", "dq_f32", "dkv_f32")."""
    return {f"_ZN4sslc12_GLOBAL__N_1flash_attn_bwd_{k}_{t}_kernelE":
            0 if missing == (k if t == "bf16" else f"{k}_f32") else 8
            for k in ("dq", "dkv") for t in ("bf16", "f32")}


def _conv_counts(fwd=4, dw=4, dx=4, fwd_f32=12, dw_f32=12, dx_f32=12):
    # the library's conv kernels: the six on the tensor cores, and dW's
    # reduce kernel and w's two split kernels, which have no products
    return {CONV["fwd"]: fwd, CONV["dw"]: dw, CONV["dx"]: dx,
            CONV["fwd_f32"]: fwd_f32, CONV["dw_f32"]: dw_f32,
            CONV["dx_f32"]: dx_f32,
            "_ZN41_GLOBAL__N__c3d384cc_9_conv1d_cu_d3ed901e23conv1d_dw_reduce"
            "_kernelEPKfPfxi": 0,
            F32_SM90 + "21conv1d_split_w_kernelEPKfPfii": 0,
            F32_SM90 + "24conv1d_split_w_dx_kernelEPKfPfx": 0}


def test_tensor_core_check_counts_hgmma_per_backward_kernel(capsys):
    # and per forward: its four instances (with and without dropout and
    # segment ids) summed
    counts = {"_ZN4sslc12_GLOBAL__N_129flash_attn_bwd_dq_bf16_kernelE": 12,
              "_ZN4sslc12_GLOBAL__N_130flash_attn_bwd_dkv_bf16_kernelE": 16,
              "_ZN4sslc12_GLOBAL__N_128flash_attn_bwd_dq_f32_kernelE": 72,
              "_ZN4sslc12_GLOBAL__N_129flash_attn_bwd_dkv_f32_kernelE": 70}
    counts.update({FWD.format(*f): 8 for f in FWD_FLAGS})
    counts.update({FWD_F32.format(*f): 36 for f in FWD_FLAGS})
    counts.update(_conv_counts(fwd=4, dw=6, dx=8, fwd_f32=12, dw_f32=24,
                               dx_f32=36))
    got = chip_smoke.check_tensor_cores(_Kernels(counts))
    assert got == {("flash_attn_fwd", "f32"): 144,
                   ("flash_attn_fwd", "bf16"): 32,
                   ("flash_attn_bwd_dq", "bf16"): 12,
                   ("flash_attn_bwd_dkv", "bf16"): 16,
                   ("flash_attn_bwd_dq", "f32"): 72,
                   ("flash_attn_bwd_dkv", "f32"): 70,
                   ("conv1d_fwd", "f32"): 12, ("conv1d_dw", "f32"): 24,
                   ("conv1d_dx", "f32"): 36,
                   ("conv1d_fwd", "bf16"): 4, ("conv1d_dw", "bf16"): 6,
                   ("conv1d_dx", "bf16"): 8}
    out = capsys.readouterr().out
    assert "4 HGMMA in conv1d_fwd_bf16_kernel" in out
    assert "6 HGMMA in conv1d_dw_bf16_kernel" in out
    assert "8 HGMMA in conv1d_dx_bf16_kernel" in out
    assert "0 HGMMA in conv1d_dw_reduce_kernel" in out  # CUDA cores
    assert "0 HGMMA in conv1d_split_w_dx_kernel" in out
    assert "16 HGMMA in flash_attn_bwd_dkv_bf16_kernel" in out
    assert "72 HGMMA in flash_attn_bwd_dq_f32_kernel" in out
    assert "8 HGMMA in flash_attn_fwd_bf16_kernel<dropout, segments>" in out
    assert ("8 HGMMA in flash_attn_fwd_bf16_kernel<no dropout, no segments>"
            in out)
    assert ("36 HGMMA in flash_attn_fwd_f32_kernel<dropout, no segments>"
            in out)
    assert "12 HGMMA in conv1d_fwd_f32_kernel" in out
    assert "24 HGMMA in conv1d_dw_f32_kernel" in out
    assert "36 HGMMA in conv1d_dx_f32_kernel" in out


@pytest.mark.parametrize("missing", ["fwd", "dq", "dkv", "dq_f32", "dkv_f32",
                                     "conv_fwd", "conv_dw", "conv_dx",
                                     "fwd_f32", "conv_fwd_f32", "conv_dw_f32",
                                     "conv_dx_f32"])
def test_tensor_core_check_fails_without_hgmma(missing):
    counts = _bwd_counts(missing)
    counts.update({FWD.format(*f): 0 if missing == "fwd" else 8
                   for f in FWD_FLAGS})
    counts.update({FWD_F32.format(*f): 0 if missing == "fwd_f32" else 36
                   for f in FWD_FLAGS})
    counts.update(_conv_counts(fwd=0 if missing == "conv_fwd" else 4,
                               dw=0 if missing == "conv_dw" else 4,
                               dx=0 if missing == "conv_dx" else 4,
                               fwd_f32=0 if missing == "conv_fwd_f32" else 12,
                               dw_f32=0 if missing == "conv_dw_f32" else 12,
                               dx_f32=0 if missing == "conv_dx_f32" else 12))
    with pytest.raises(AssertionError, match="tensor cores"):
        chip_smoke.check_tensor_cores(_Kernels(counts))


@pytest.mark.parametrize("absent", ["fwd", "dw", "dx"])
def test_tensor_core_check_fails_without_a_conv_bf16_kernel(absent):
    # a library whose bf16 conv forward, dW or dX is not the tensor-core
    # kernel at all (only the CUDA-core template instance, no HGMMA) fails
    # too
    counts = _bwd_counts()
    counts.update({FWD.format(*f): 8 for f in FWD_FLAGS})
    counts.update({FWD_F32.format(*f): 36 for f in FWD_FLAGS})
    counts.update(_conv_counts())
    del counts[CONV[absent]]
    counts[f"_ZN12_GLOBAL__N_117conv1d_{absent}_kernelI13__nv_bfloat16EEv"] = 0
    with pytest.raises(AssertionError,
                       match=f"conv1d_{absent}_bf16_kernel has no HGMMA"):
        chip_smoke.check_tensor_cores(_Kernels(counts))


@pytest.mark.parametrize("fwd,tag", [(FWD, "bf16"), (FWD_F32, "f32")])
def test_tensor_core_check_fails_when_one_forward_instance_has_none(fwd, tag):
    counts = _bwd_counts()
    counts.update({FWD.format(*f): 8 for f in FWD_FLAGS})
    counts.update({FWD_F32.format(*f): 36 for f in FWD_FLAGS})
    counts.update(_conv_counts())
    counts[fwd.format(1, 0)] = 0
    with pytest.raises(AssertionError, match=f"{tag} flash_attn_fwd"):
        chip_smoke.check_tensor_cores(_Kernels(counts))


@pytest.mark.parametrize("absent", ["fwd", "dw", "dx"])
def test_tensor_core_check_fails_without_the_f32_conv_forward(absent):
    # a library whose f32 conv forward, dW or dX is not the split-TF32
    # kernel at all (a CUDA-core instance, no HGMMA) fails
    counts = _bwd_counts()
    counts.update({FWD.format(*f): 8 for f in FWD_FLAGS})
    counts.update({FWD_F32.format(*f): 36 for f in FWD_FLAGS})
    counts.update(_conv_counts())
    del counts[CONV[f"{absent}_f32"]]
    counts[f"_ZN12_GLOBAL__N_117conv1d_{absent}_kernelIfEEvPKT_S2_PS0_"
           "iiiiiiii"] = 0
    with pytest.raises(AssertionError,
                       match=f"conv1d_{absent}_f32_kernel has no HGMMA"):
        chip_smoke.check_tensor_cores(_Kernels(counts))


def test_launch_fields_count_per_dtype_and_path():
    # the kernels line's launches: in all, per dtype and per path and dtype;
    # a kernel a path never counted has 0 there
    paths = {"melhubert serve": {"flash_attn_fwd": {"f32": 12, "bf16": 0}},
             "melhubert train": {"flash_attn_fwd": {"f32": 0, "bf16": 288},
                                 "conv1d_fwd": {"f32": 0, "bf16": 0}},
             "hubert serve": {"flash_attn_fwd": {"f32": 12, "bf16": 0},
                              "conv1d_fwd": {"f32": 6, "bf16": 0}}}
    fwd = chip_smoke.launch_fields("flash_attn_fwd", paths)
    assert fwd["launches"] == 312
    assert fwd["launches_by_dtype"] == {"f32": 24, "bf16": 288}
    assert fwd["launches_by_path"]["melhubert train"] == {"f32": 0,
                                                           "bf16": 288}
    conv = chip_smoke.launch_fields("conv1d_fwd", paths)
    assert conv["launches"] == 6
    assert conv["launches_by_dtype"] == {"f32": 6, "bf16": 0}
    assert conv["launches_by_path"]["melhubert serve"] == {"f32": 0,
                                                           "bf16": 0}


def test_launch_fields_count_launches_past_the_stream_threshold_apart():
    # the long phase's paths carry the attention kernels' launches past
    # T = 4096 beside their launches in all; a path without them has none
    paths = {"melhubert train": {"flash_attn_fwd": {"f32": 0, "bf16": 288}},
             "melhubert long serve": {"flash_attn_fwd": {"f32": 36,
                                                         "bf16": 12}},
             "melhubert long distill": {"flash_attn_fwd": {"f32": 54,
                                                           "bf16": 54}}}
    long_paths = {"melhubert long serve": {"flash_attn_fwd": {"f32": 24,
                                                              "bf16": 12}},
                  "melhubert long distill": {"flash_attn_fwd": {"f32": 54,
                                                                "bf16": 54}}}
    fwd = chip_smoke.launch_fields("flash_attn_fwd", paths, long_paths)
    assert fwd["launches"] == 444
    assert fwd["launches_past_4096"] == {"f32": 78, "bf16": 66}
    assert set(fwd["launches_past_4096_by_path"]) == set(long_paths)
    dq = chip_smoke.launch_fields("flash_attn_bwd_dq", paths, long_paths)
    assert dq["launches"] == 0
    assert dq["launches_past_4096"] == {"f32": 0, "bf16": 0}
    # without long paths (the conv kernels) there are no such fields
    assert "launches_past_4096" not in chip_smoke.launch_fields(
        "conv1d_fwd", paths)


def test_long_phase_shapes_are_benchs():
    # one utterance of LONG_SAMPLES gives LONG_T frames of 10 ms with snip
    # edges, (N - 400) // 160 + 1, as bench.py's long-form rows; the bound
    # of the forward at (1, 12, 8192, 64) is its 4 H T^2 d FLOPs
    from speech_ssl_compression_tpu_torch.ops.fbank import num_frames

    assert num_frames(chip_smoke.LONG_SAMPLES) == chip_smoke.LONG_T == 8192
    assert chip_smoke.LONG_T > 4096
    flops = chip_smoke.attention_work((1, 12, 8192, 64), 8192, 8192.0 ** 2,
                                      torch.float32)["flash_attn_fwd"][0]
    assert flops == pytest.approx(206.2e9, rel=1e-3)
    ms, by = chip_smoke.attention_bounds(torch.float32)[
        "flash_attn_fwd", "long_8192"]
    assert by == "operations" and ms == pytest.approx(1.2496, rel=1e-3)
    ms_bf16, _ = chip_smoke.attention_bounds(torch.bfloat16)[
        "flash_attn_fwd", "long_8192"]
    assert ms_bf16 == pytest.approx(0.2085, rel=1e-3)


@pytest.mark.parametrize("which,tflop,bound_ms", [
    ("f32", 0.599, 8.94), ("bf16", 1.817, 1.837)])
def test_stream_step_work_counts_attention_at_the_cache_capacity(
        which, tflop, bound_ms):
    # bench.py's count (JAX package, :513-523) at the stream phase's two
    # shapes: f32 B = 16 against 3072 cached frames, 67 TFLOP/s with TF32
    # off; the bf16 ring B = 64 against its 1152 (window 1024 + a chunk)
    from speech_ssl_compression_tpu_torch.configs import (
        melhubert_config_from_yaml,
    )

    cfg = melhubert_config_from_yaml(chip_smoke.CONFIG_YAML)
    shape = chip_smoke.STREAM_F32 if which == "f32" else chip_smoke.STREAM_BF16
    cap = shape.get("max_frames") or (-(-(shape["window_frames"] + 128)
                                        // 128) * 128)
    dtype = shape["dtype"]
    flops, n_bytes = chip_smoke.stream_work(cfg, shape["batch"],
                                            shape["chunk_frames"], cap, dtype)
    assert flops / 1e12 == pytest.approx(tflop, rel=1e-3)
    peak = 67e12 if dtype == torch.float32 else 989e12
    ops_ms = flops / peak * 1e3
    assert ops_ms == pytest.approx(bound_ms, rel=1e-3)
    assert ops_ms > n_bytes / peak_bytes() * 1e3  # operations bound
    # the stream phase's bound: f32 on the CUDA cores, bf16 on the tensor
    # cores
    assert chip_smoke.bound(flops, n_bytes, dtype,
                            cuda_cores=dtype == torch.float32) == (
        pytest.approx(ops_ms, rel=1e-12), "operations")
    # the caches dominate the bytes: 2 x 12 layers x B x 768 x cap x size
    size = 4 if which == "f32" else 2
    assert n_bytes > 24 * shape["batch"] * 768 * cap * size


def test_wave_serve_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    # the wave serve phase end to end at 2 layers of 64 and short
    # utterances, the plain attention counted as the kernel's launches and
    # the CUDA synchronisation and profiler stubbed: its launch counts per
    # path, its checks (fbank, featurizers, expert, stream, k-means labels)
    from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
    from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import init_params_np

    plain = fa._reference_fwd

    def counted(q, *args, **kwargs):
        fa._count("flash_attn_fwd", q)
        return plain(q, *args, **kwargs)

    monkeypatch.setattr(fa, "_reference_fwd", counted)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "profile_calls",
                        lambda label, fn, gpu, **kw: (fn(), (0.0, 1.0))[1])
    monkeypatch.setattr(chip_smoke, "SERVE_LENGTHS", (21, 21, 92, 92))
    monkeypatch.setattr(chip_smoke, "WAVE_BATCHES", 2)
    monkeypatch.setattr(chip_smoke, "KMEANS_K", 8)
    monkeypatch.setattr(chip_smoke, "KMEANS_CHUNK", 64)
    cfg = MelHuBERTConfig.from_dict(dict(
        feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=64,
        encoder_ffn_embed_dim=128, encoder_attention_heads=1, head_dim=64,
        conv_pos=16, conv_pos_groups=4, num_cluster=32))
    ckpt = str(tmp_path / chip_smoke.SLICE_CKPT)
    save_checkpoint(ckpt, init_params_np(cfg, seed=0),
                    meta={"Upstream_Config": {"melhubert": cfg.to_dict()}})
    extractors = {
        (tag, "kernel"): MelHuBERTExtractor(
            ckpt, mean_std_npy_path=str(chip_smoke.MEAN_STD), dtype=dtype,
            device="cpu")
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    serve, stream = chip_smoke.phase_wave_serve(
        torch.device("cpu"), "cpu", str(tmp_path), extractors)
    assert serve["flash_attn_fwd"] == {"f32": 4, "bf16": 2}
    assert stream["flash_attn_fwd"] == {"f32": 2 * chip_smoke.WAVE_BATCHES,
                                        "bf16": 0}
    labels = (tmp_path / "wave_labels" / "labels.km").read_text().split()
    assert len(labels) == chip_smoke.WAVE_BATCHES * sum(
        chip_smoke.SERVE_LENGTHS)


def test_long_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    # the long phase end to end at 2 layers of 64 (one head) and T = 4160,
    # past the stream threshold: the 10 ms recipe cut to 2 micro-batches of
    # B = 2 and dropout 0 (the plain Philox is slow on the CPU), the plain
    # attention counted as the kernels' launches (its bf16 forward walked
    # in the kernel's key tiles), the CUDA timing and memory calls stubbed,
    # and the per-case kernel checks (the kernels and backward phases' own,
    # each seconds at this T on the CPU) recorded: its launch counts per
    # path, those past the threshold, its model checks, the kernel checks
    # it asks for and the kernels line's long_8192 records
    from speech_ssl_compression_tpu_torch.configs import read_yaml
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    plain_fwd, plain_bwd = fa._reference_fwd, fa.reference_bwd

    def counted_fwd(q, k, v, *args, **kwargs):
        # the autograd route's call (bias, segments, causal; the keep
        # arguments by name): a bf16 P rounded per key tile, as the kernel
        if len(args) == 4 and q.dtype == torch.bfloat16:
            kwargs["block_k"] = fa.KERNEL_BLOCK_K
        fa._count("flash_attn_fwd", q, k.shape[2])
        return plain_fwd(q, k, v, *args, **kwargs)

    def counted_bwd(q, k, *args):
        for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
            fa._count(name, q, k.shape[2])
        return plain_bwd(q, k, *args)

    def launch_fwd(q, k, v, bias, segq, segk, causal, dropout_p=0.0,
                   seed=None):
        block = fa.KERNEL_BLOCK_K if q.dtype == torch.bfloat16 else None
        return plain_fwd(q, k, v, bias, segq, segk, causal, block,
                         dropout_p, seed)

    def launch_bwd_dq(*args):
        dd = fa.reference_dd(*args)
        return fa.reference_bwd_dq(*args, dd), dd

    monkeypatch.setattr(fa, "_reference_fwd", counted_fwd)
    monkeypatch.setattr(fa, "reference_bwd", counted_bwd)
    monkeypatch.setattr(fa, "launch_fwd", launch_fwd)
    monkeypatch.setattr(fa, "launch_bwd", plain_bwd)
    monkeypatch.setattr(fa, "launch_bwd_dq", launch_bwd_dq)
    monkeypatch.setattr(fa, "launch_bwd_dkv", fa.reference_bwd_dkv)
    for name, value in (("synchronize", None), ("reset_peak_memory_stats",
                                                None),
                        ("max_memory_allocated", 1), ("memory_allocated", 0),
                        ("memory_reserved", 0),
                        ("mem_get_info", (2**36, 2**36))):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _v=value, **k: _v)
    timed = set()

    def cuda_ms(fn, reps=3, inner=1, warm=True):
        # each timed call once (by where it is written), for its errors
        if fn.__code__ not in timed:
            timed.add(fn.__code__)
            fn()
        return 1.0

    monkeypatch.setattr(chip_smoke, "cuda_ms", cuda_ms)
    checks = []

    def check_forward(fa_, name, qs, ks, masks, valid, dtype, gen,
                      straddles=False, inputs=None):
        checks.append(("forward", name, qs, dtype, inputs is not None))
        q, k, v = inputs or (torch.randn(qs, generator=gen).to(dtype)
                             for _ in "qkv")
        assert straddles and q.dtype == dtype and tuple(q.shape) == qs
        return q, k, v, 0.0

    def check_backward(fa_, name, qs, ks, masks, valid_q, valid_k, dtype,
                       gen, inputs=None):
        checks.append(("backward", name, qs, dtype, inputs is not None))
        q, k, v, dout = inputs or (torch.randn(qs, generator=gen).to(dtype)
                                   for _ in "qkvd")
        assert q.dtype == dtype and tuple(q.shape) == qs
        lse = torch.zeros(qs[:3])
        return fa.backward_args(q, k, v, lse, dout, **masks), [0.0] * 3

    def backward_timing(args, case, tag, record, gpu, inner=5):
        for name in KERNELS[1:]:
            record.setdefault((name, case, tag), {}).update(ms=1.0,
                                                            plain_ms=1.0)

    monkeypatch.setattr(chip_smoke, "check_forward", check_forward)
    monkeypatch.setattr(chip_smoke, "check_backward", check_backward)
    monkeypatch.setattr(chip_smoke, "backward_timing", backward_timing)
    # the remat check wants less peak memory with it than without
    peaks = iter([2, 1])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: next(peaks, 1))
    narrow = dict(encoder_layers=2, encoder_embed_dim=64,
                  encoder_ffn_embed_dim=128, encoder_attention_heads=1,
                  conv_pos=16, conv_pos_groups=4)
    model = read_yaml(chip_smoke.TEN_MS_MODEL_YAML)
    model["melhubert"].update(narrow, dropout=0.0, attention_dropout=0.0,
                              activation_dropout=0.0)
    runner = read_yaml(chip_smoke.TEN_MS_RUNNER_YAML)
    runner["runner"].update(gradient_accumulate_steps=2)
    runner["datarc"].update(train_batch_size=2)
    distill = read_yaml(chip_smoke.DISTILL_10MS_YAML)
    distill["student"].update(narrow, encoder_layers=1)
    for name, tree in (("model", model), ("runner", runner),
                       ("distill", distill)):
        (tmp_path / f"{name}.yaml").write_text(chip_smoke.to_yaml(tree)
                                               + "\n")
    monkeypatch.setattr(chip_smoke, "TEN_MS_MODEL_YAML",
                        tmp_path / "model.yaml")
    monkeypatch.setattr(chip_smoke, "TEN_MS_RUNNER_YAML",
                        tmp_path / "runner.yaml")
    monkeypatch.setattr(chip_smoke, "DISTILL_10MS_YAML",
                        tmp_path / "distill.yaml")
    monkeypatch.setattr(chip_smoke, "LONG_T", 4160)
    monkeypatch.setattr(chip_smoke, "LONG_SAMPLES", 4159 * 160 + 400)
    monkeypatch.setattr(chip_smoke, "LONG_DISTILL_STEPS", 1)
    chip_smoke.write_dataset(tmp_path / "train" / "data", n_utts=8)
    record = {}
    # two threads: the test's products are large, and the suite's workers
    # share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        paths, long_paths, refs = chip_smoke.phase_long(
            torch.device("cpu"), "cpu", str(tmp_path), record)
    finally:
        torch.set_num_threads(threads)
    # the parallel phase's sequence-parallel yardsticks: the 10 ms
    # checkpoint kept, the served utterance's f32 output, and the student's
    # 1-process f32 grad steps of both loss types
    assert pathlib.Path(refs["ckpt"]).exists()
    assert tuple(refs["serve"].shape) == (1, 4224, 64)
    assert set(refs["distill"]) == {"nomasked", "masked"}
    for loss, logs, grads in refs["distill"].values():
        assert np.isfinite(loss) and {"hard_loss", "soft_loss"} <= set(logs)
        assert all(bool(g.isfinite().all()) for g in grads.values())
    assert refs["distill"]["masked"][0] != refs["distill"]["nomasked"][0]
    assert set(paths) == set(long_paths) == {
        "melhubert 10ms train", "melhubert long serve",
        "melhubert long distill"}
    # the 10 ms run: 2 layers x 2 micro-batches, f32 on the CPU, none past
    # the threshold
    assert paths["melhubert 10ms train"]["flash_attn_bwd_dq"] == {
        "f32": 4, "bf16": 0}
    assert long_paths["melhubert 10ms train"]["flash_attn_fwd"] == {
        "f32": 0, "bf16": 0}
    # T = 4160: three f32 forwards and one bf16 past it, the batch not
    assert paths["melhubert long serve"]["flash_attn_fwd"] == {
        "f32": 6, "bf16": 2}
    assert long_paths["melhubert long serve"]["flash_attn_fwd"] == {
        "f32": 4, "bf16": 2}
    # one update a dtype: teacher 2 + student 1 forwards, 1 of each backward
    assert long_paths["melhubert long distill"] == {
        "flash_attn_fwd": {"f32": 3, "bf16": 3},
        "flash_attn_bwd_dq": {"f32": 1, "bf16": 1},
        "flash_attn_bwd_dkv": {"f32": 1, "bf16": 1}}
    for name in KERNELS:
        for tag in ("f32", "bf16"):
            assert {"max_abs_err", "ms", "plain_ms"} <= set(
                record[name, "long_8192", tag])
    # the served utterance's first and last layers' attention calls as
    # captured (T padded to 4224), the kernels at (1, H, T, 64) on random
    # inputs, and the student layer's captured call, f32 and bf16
    shape, served = (1, 1, 4160, 64), (1, 1, 4224, 64)
    assert checks == [
        ("forward", "long_serve_layer0", served, torch.float32, True),
        ("forward", "long_serve_layer1", served, torch.float32, True),
        ("forward", "long_serve_layer0", served, torch.bfloat16, True),
        ("forward", "long_serve_layer1", served, torch.bfloat16, True),
        ("forward", "long_8192", shape, torch.float32, False),
        ("backward", "long_8192", shape, torch.float32, False),
        ("forward", "long_8192", shape, torch.bfloat16, False),
        ("backward", "long_8192", shape, torch.bfloat16, False),
        ("backward", "long_distill_layer0", shape, torch.float32, True),
        ("backward", "long_distill_layer0", shape, torch.bfloat16, True)]


def test_parallel_phase_runs_after_wave_prune_and_counts_as_a_main_path():
    import inspect

    src = inspect.getsource(chip_smoke.main)
    # the ranks start before the w2v2 train phase and run the first spec
    # while it and wave prune run; the rest after wave prune
    assert (src.index("parallel_ranks(tmp)")
            < src.index('"parallel", start_parallel')
            < src.index('"w2v2 train", phase_w2v2_train')
            < src.index('"wave prune", phase_wave_prune')
            < src.index('"parallel", phase_parallel'))
    assert "**parallel}" in src
    assert "child_main(args.child)" in src
    # a child returns before anything is built or printed
    assert src.index("child_main(args.child)") < src.index("_kernels.build()")


def test_parallel_child_command_is_a_torchrun_rank(tmp_path):
    argv, env = chip_smoke.parallel_child_command(tmp_path / "spec.json", 1,
                                                  29123)
    assert argv == [sys.executable, str(REPO / "chip_smoke.py"), "--child",
                    str(tmp_path / "spec.json")]
    assert {k: env[k] for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                "WORLD_SIZE", "LOCAL_RANK",
                                "LOCAL_WORLD_SIZE")} == {
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29123", "RANK": "1",
        "WORLD_SIZE": str(chip_smoke.PAR_RANKS), "LOCAL_RANK": "1",
        "LOCAL_WORLD_SIZE": str(chip_smoke.PAR_RANKS)}


def test_parallel_runs_are_cli_argvs(tmp_path):
    from speech_ssl_compression_tpu_torch.configs import read_yaml
    from speech_ssl_compression_tpu_torch.train.__main__ import get_args

    hubert = tmp_path / "hubert"
    hubert.mkdir()
    (hubert / "config_model.yaml").write_text("hubert: {}\n")
    (hubert / "config_runner.yaml").write_text(
        chip_smoke.HUBERT_RUNNER_YAML.format(
            accum=chip_smoke.HUBERT_ACCUM, batch=4, data=tmp_path,
            samples=245760))
    starts = {"f32": "s32.npz", "bf16": "s16.npz"}
    runs = chip_smoke.parallel_runs(tmp_path, starts, "train.csv", hubert,
                                    "ten_ms.npz")
    assert [r["tag"] for r in runs] == ["dp_f32", "dp_bf16", "tp_f32",
                                        "hubert_dp_bf16", "pp_f32", "pp_bf16",
                                        "seqpar", "seqpar_timing",
                                        "pp_timing"]
    # the runs timed with the card to the ranks come after wave prune
    assert [r["tag"] for r in runs if r["tag"] in chip_smoke.PAR_LATE] == [
        "seqpar_timing", "pp_timing"]
    # the sequence-parallel work and the timing of the bf16 pipeline run
    # (kept by its rank) run no CLI: the long phase's checkpoint
    assert runs.pop() == dict(tag="pp_timing", kind="timing", of="pp_bf16",
                              updates=chip_smoke.PAR_BF16_UPDATES)
    assert runs.pop() == dict(tag="seqpar_timing", kind="seqpar",
                              mode="timing", ckpt="ten_ms.npz")
    assert runs.pop() == dict(tag="seqpar", kind="seqpar", mode="parity",
                              ckpt="ten_ms.npz",
                              out=str(tmp_path / "seqpar.pt"))
    assert [r.get("keep", False) for r in runs] == [False] * 5 + [True]
    one = chip_smoke.PAR_ONE_UPDATES
    want = {"dp_f32": (1, 1, "s32.npz", chip_smoke.PAR_F32_UPDATES, False),
            "dp_bf16": (1, 1, "s16.npz", chip_smoke.PAR_BF16_UPDATES, True),
            "tp_f32": (2, 1, "s32.npz", one, False),
            "hubert_dp_bf16": (1, 1, None, 1, True),
            "pp_f32": (1, 2, "s32.npz", one, False),
            "pp_bf16": (1, 2, "s16.npz", chip_smoke.PAR_BF16_UPDATES, True)}
    for run in runs:
        args = get_args(run["argv"])
        tp, pp, start, updates, bf16 = want[run["tag"]]
        assert args.multi_host and args.dist_backend == "gloo"
        assert args.device == "cuda" and args.seed == 0
        assert args.model_parallel == tp and args.initial_weight == start
        assert args.pipeline_parallel == pp
        if pp > 1:
            assert args.pp_microbatches == chip_smoke.PAR_PP_MICROBATCHES
        # only the data-parallel f32 run dumps the control leaf's own
        # gradient (a pipeline stage may not hold it)
        assert run.get("control", False) == (run["tag"] == "dp_f32")
        assert not pathlib.Path(args.expdir).is_absolute()  # the rank's cwd
        assert run["updates"] == updates and not run["tf32"]
        assert (run["dump"] is not None) == run["tag"].endswith("f32")
        assert run["save"] == (["last-step.npz"] if run["dump"] else [])
        assert run.get("bf16_step", False) == (run["tag"] == "tp_f32")
        rc = read_yaml(args.runner_config)
        assert rc["runner"]["total_steps"] == updates
        assert rc["runner"]["gradient_accumulate_steps"] == 1
        assert rc["runner"]["bf16"] is bf16
        assert args.upstream == ("hubert" if "hubert" in run["tag"]
                                 else "melhubert")


def test_parallel_launches_sum_the_ranks_into_the_kernels_line():
    rec = lambda n, past=0, tag="f32": {
        "counts": {"flash_attn_fwd": {"f32": n, "bf16": 0},
                   "conv1d_fwd": {"f32": 0, "bf16": n}},
        "long_counts": {"flash_attn_fwd": {"f32": 0, "bf16": 0,
                                           tag: past}}}
    records = [{"dp_f32": rec(12), "hubert_dp_bf16": rec(3),
                "pp_f32": rec(2), "pp_bf16": rec(1),
                "seqpar_serve": rec(4, 4), "seqpar_distill": rec(5, 5,
                                                                 "bf16"),
                "seqpar_timing": {"times": {}}}  # no launches counted
               for _ in range(2)]
    paths, long_paths = chip_smoke.parallel_paths(records)
    assert paths["parallel dp_f32"]["flash_attn_fwd"] == {"f32": 24,
                                                          "bf16": 0}
    assert paths["parallel hubert_dp_bf16"]["conv1d_fwd"] == {"f32": 0,
                                                              "bf16": 6}
    # the pipeline's two runs are one path; the sequence-parallel work two
    assert set(paths) == set(long_paths) == {
        "parallel dp_f32", "parallel hubert_dp_bf16",
        "melhubert pipeline train", "melhubert seqpar serve",
        "melhubert seqpar distill"}
    assert paths["melhubert pipeline train"]["flash_attn_fwd"] == {
        "f32": 6, "bf16": 0}
    assert long_paths["melhubert seqpar distill"]["flash_attn_fwd"] == {
        "f32": 0, "bf16": 10}
    fields = chip_smoke.launch_fields("flash_attn_fwd", {
        "melhubert train": {"flash_attn_fwd": {"f32": 0, "bf16": 5}},
        **paths}, long_paths)
    assert fields["launches"] == 5 + 24 + 6 + 6 + 8 + 10
    assert fields["launches_by_path"]["parallel dp_f32"] == {"f32": 24,
                                                             "bf16": 0}
    assert fields["launches_past_4096"] == {"f32": 8, "bf16": 10}
    assert set(fields) == {"launches", "launches_by_dtype",
                           "launches_by_path", "launches_past_4096",
                           "launches_past_4096_by_path"}


HYPER = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
             clip=10.0)
LEAVES = {"encoder.layers.0.fc1.weight": (48, 16),
          "encoder.layers.0.final_layer_norm.bias": (16,),
          "encoder.layers.0.self_attn.k_proj.bias": (16,)}


def _sound_runs(updates=3):
    """start, and the gradients and parameters (each update through the
    port's fused apply) of a 1-process run and of a parallel one whose
    gradients differ by rounding: 1e-7 of each entry, and where the
    1-process run's gradient is within rounding of 0 (one fc1 entry, the
    k_proj bias, as softmax's shift invariance leaves it) of the other
    sign."""
    from speech_ssl_compression_tpu_torch.train.steps import fused_apply

    gen = torch.Generator().manual_seed(0)
    start = {k: 0.05 * torch.randn(shape, generator=gen)
             for k, shape in LEAVES.items()}
    grads = {"ref": [], "got": []}
    for _ in range(updates):
        g = {k: torch.randn(shape, generator=gen)
             for k, shape in LEAVES.items()}
        g["encoder.layers.0.self_attn.k_proj.bias"] *= 1e-6
        g["encoder.layers.0.fc1.weight"][3, 5] = 1e-9
        r = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
             for k, v in g.items()}
        r["encoder.layers.0.fc1.weight"][3, 5] = -1e-9
        r["encoder.layers.0.self_attn.k_proj.bias"] = (
            1e-6 * torch.randn(16, generator=gen))
        grads["ref"].append((g, 1.0))
        grads["got"].append((r, 1.0))
    runs = {}
    for tag, seq in grads.items():
        params = [v.clone() for v in start.values()]
        state = ([torch.zeros((), dtype=torch.int32)]
                 + [torch.zeros_like(v) for v in params]
                 + [torch.zeros_like(v) for v in params])
        for g, n in seq:
            fused_apply(HYPER, params, state, [g[k] for k in LEAVES], n)
        runs[tag] = dict(zip(LEAVES, params))
    return start, runs, grads


def test_plain_adam_is_the_fused_apply():
    """The check's own Adam and the port's fused apply, clip and L2 on."""
    from speech_ssl_compression_tpu_torch.train.steps import fused_apply

    gen = torch.Generator().manual_seed(1)
    start = {k: torch.randn(shape, generator=gen)
             for k, shape in LEAVES.items()}
    seq = [({k: 30 * torch.randn(shape, generator=gen)
             for k, shape in LEAVES.items()}, 2.0) for _ in range(3)]
    hyper = dict(HYPER, weight_decay=0.01)
    params = [v.clone() for v in start.values()]
    state = ([torch.zeros((), dtype=torch.int32)]
             + [torch.zeros_like(v) for v in params]
             + [torch.zeros_like(v) for v in params])
    for g, n in seq:
        norm = fused_apply(hyper, params, state, [g[k] for k in LEAVES], n)
        assert float(norm) > hyper["clip"]  # the clip is on
    plain = chip_smoke.plain_adam(start, seq, hyper)
    for k, p in zip(LEAVES, params):
        torch.testing.assert_close(plain[k], p, rtol=1e-6, atol=1e-9)


def test_update_check_passes_rounding_and_counts_what_it_decides():
    start, runs, grads = _sound_runs()
    check = chip_smoke.update_check(start, runs["got"], runs["ref"],
                                    grads["got"], grads["ref"], HYPER)
    assert chip_smoke.update_failures(check) == []
    assert check["n"] == 48 * 16 + 16 + 16
    assert check["follow_got"] == check["follow_ref"] == 0
    # the fc1 entry and k_proj bias entries step apart past JAX's bar,
    # and rounding decides each of them
    assert 2 <= check["past"] <= check["decided"] <= 1 + 16
    assert check["unexplained"] == 0
    assert check["grad_err"] < chip_smoke.GRAD_BAR
    assert "rounding decides" in chip_smoke.describe_update_check(check)


@pytest.mark.parametrize("fault", ["unreduced", "unreduced_sound_grads",
                                   "uncorrected", "one_step_skipped"])
def test_update_check_fails_planted_faults(fault):
    """A LayerNorm bias left at one data rank's gradient (half the batch:
    judged on the gradients such a run dumps, and on the sound ones), Adam
    without its bias corrections, and one leaf's last update not applied."""
    start, runs, grads = _sound_runs()
    leaf = "encoder.layers.0.final_layer_norm.bias"
    seq = grads["got"]
    gen = torch.Generator().manual_seed(2)
    if fault.startswith("unreduced"):
        half = [({**g, leaf: 0.5 * g[leaf] + 0.5 * torch.randn(
            16, generator=gen)}, n) for g, n in seq]
        params = chip_smoke.plain_adam(start, half, HYPER)
        if fault == "unreduced":
            seq = half
    elif fault == "uncorrected":
        params = chip_smoke.plain_adam(start, seq, HYPER, corrected=False)
    else:
        params = dict(runs["got"])
        params[leaf] = chip_smoke.plain_adam(start, seq[:-1], HYPER)[leaf]
    check = chip_smoke.update_check(start, params, runs["ref"], seq,
                                    grads["ref"], HYPER)
    fails = chip_smoke.update_failures(check)
    assert fails
    if fault == "unreduced":
        assert check["grad_at"][0] == leaf
    else:
        assert check["follow_got"] > 0 and check["unexplained"] > 0




def test_journey_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    # the journey phase end to end at journey.py's TINY settings (2 layers
    # of 64, 4 heads, FFN 128, K = 16, 12 crops of T = 96): the phase's
    # smoke schedule with 2 heads and 32 rows an event (the 12 and 512 of
    # full width would empty the tiny model), the plain attention counted
    # as the kernels' launches, the CUDA synchronisation stubbed. Every
    # stage's checks and launch counts, and the quality curve
    import dataclasses

    from speech_ssl_compression_tpu_torch import journey
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    plain_fwd, plain_bwd = fa._reference_fwd, fa.reference_bwd

    def counted_fwd(q, k, v, *args, **kwargs):
        fa._count("flash_attn_fwd", q, k.shape[2])
        return plain_fwd(q, k, v, *args, **kwargs)

    def counted_bwd(q, k, *args):
        for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
            fa._count(name, q, k.shape[2])
        return plain_bwd(q, k, *args)

    monkeypatch.setattr(fa, "_reference_fwd", counted_fwd)
    monkeypatch.setattr(fa, "reference_bwd", counted_bwd)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    settings = journey.settings_for(tiny=True)
    smoke = chip_smoke.journey_schedule()
    assert (smoke.pretrain_steps, smoke.wp_total, smoke.hp_total,
            smoke.rp_total, smoke.distill_steps, smoke.serve_reps) == (
        3, 4, 2, 2, 2, 5)
    assert smoke.wp_prune["sparsity"] == [0.3, 0.5, 0.7]
    tiny = dataclasses.replace(
        smoke, hp_prune=dict(smoke.hp_prune, num_heads_each_step=2),
        rp_prune=dict(smoke.rp_prune, num_rows_each_step=32))
    monkeypatch.setattr(chip_smoke, "JOURNEY_SETTINGS", settings)
    monkeypatch.setattr(chip_smoke, "journey_schedule", lambda: tiny)
    # as the journey's own process runs it: the parent's go given already
    go = tmp_path / "go"
    go.touch()
    # one thread: the tiny model's ops are small, and the suite's workers
    # share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        paths = chip_smoke.phase_journey(torch.device("cpu"), "cpu",
                                         str(tmp_path), go=go)
    finally:
        torch.set_num_threads(threads)
    assert (tmp_path / "go.ready").exists()
    stages = ("pretrain", "weight-prune", "head-prune", "row-prune",
              "distill-6L", "serve", "curve")
    assert set(paths) == {f"journey {s}" for s in stages}
    # every launch f32 (the journey's trainers run f32, as JAX's); 3
    # updates + the held-out forward at 2 layers
    assert paths["journey pretrain"]["flash_attn_fwd"] == {"f32": 8,
                                                           "bf16": 0}
    assert paths["journey pretrain"]["flash_attn_bwd_dq"] == {"f32": 6,
                                                              "bf16": 0}
    # 2 updates and 2 scoring passes (the first layer's context lies past
    # its attention: one backward each) + the held-out forward
    assert paths["journey head-prune"]["flash_attn_bwd_dkv"] == {"f32": 6,
                                                                 "bf16": 0}
    # 2 updates of a 2-layer teacher and a 1-layer student + the student's
    # held-out forward
    assert paths["journey distill-6L"]["flash_attn_fwd"] == {"f32": 7,
                                                             "bf16": 0}
    # 4 models (2, 2, 2, 1 layers), a warm call and 5 repeats each
    assert paths["journey serve"]["flash_attn_fwd"] == {"f32": 42,
                                                        "bf16": 0}
    assert not (tmp_path / "journey").exists()


def test_journey_process_shares_the_card_but_serves_alone():
    import inspect

    src = inspect.getsource(chip_smoke.main)
    # the journey's process starts before the long phase (the last to add
    # to the kernels line's timed cases) and its stages after it, before
    # hubert serve; the parent waits for its stages before the parallel
    # phase times with the card to the ranks, and gives it the card after
    # the ranks end
    assert (src.index("journey_process(tmp)")
            < src.index('"long", phase_long')
            < src.index("journey_start(journey_run)")
            < src.index('"hubert serve", phase_hubert_serve')
            < src.index('"wave prune", phase_wave_prune')
            < src.index('"journey", journey_ready')
            < src.index('"parallel", phase_parallel')
            < src.index("stack.close()")
            < src.index('"journey", phase_journey_join')
            < src.index("paths.update(journey)")
            < src.index("launch_fields("))
    assert src.index("journey_main(args.journey)") < src.index(
        "_kernels.build()")
    argv = inspect.getsource(chip_smoke.journey_process)
    assert '"--journey"' in argv


def test_journey_launches_count_every_stage_at_full_width():
    smoke = chip_smoke.journey_schedule()
    want = {"pretrain": (48, 36), "weight-prune": (60, 48),
            "head-prune": (60, 46), "row-prune": (36, 24),
            "distill-6L": (42, 12), "serve": (252, 0)}
    for stage, (fwd, bwd) in want.items():
        got = chip_smoke.journey_launches(stage, 12, smoke, 2, 6)
        assert got["flash_attn_fwd"] == {"f32": fwd, "bf16": 0}, stage
        assert got["flash_attn_bwd_dq"] == got["flash_attn_bwd_dkv"] == {
            "f32": bwd, "bf16": 0}, stage


# the grouped conv phase at a tiny width: SamePad at an even K, the
# stream's VALID window
GC_TINY = (("pos_conv", (2, 40, 32, 4, 8, (4, 4))),
           ("stream", (2, 23, 32, 4, 8, (0, 0))))


@pytest.fixture()
def tiny_grouped_conv(monkeypatch):
    monkeypatch.setattr(chip_smoke, "GC_CASES", GC_TINY)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, *args, **kwargs: (fn(), 1.0)[1])


def test_grouped_conv_phase_runs_on_the_cpu(tiny_grouped_conv):
    record = chip_smoke.phase_grouped_conv(torch.device("cpu"), "cpu")
    assert set(record) == {(n, t) for n, _ in GC_TINY for t in ("f32",
                                                                "bf16")}
    for (name, tag), rec in record.items():
        assert set(rec["errors"]) == ({"fwd", "dW", "dX"} if tag == "f32"
                                      else {"fwd", "dW"})
        assert max(rec["errors"].values()) < chip_smoke.GC_BAR
        # every planted control fails the bar it would have to pass
        assert set(rec["controls"]) == ({"one tap dropped"} if tag == "f32"
                                        else {"one tap dropped",
                                              "bf16 sums"})
        assert min(rec["controls"].values()) > chip_smoke.GC_BAR
        for what in ("fwd", "fwd+bwd"):
            assert 0 < rec[what]["bound_ms"] < rec[what]["ms"]
    # the bounds: a pass is 2 B T_out C (C/G) K FLOPs, fwd+bwd three; at
    # this width the bytes bound them
    b, t, c, g, k, _ = GC_TINY[0][1]
    flops = 2.0 * b * (t + 1) * c * (c // g) * k
    for what, passes in (("fwd", 1), ("fwd+bwd", 3)):
        rec = record["pos_conv", "bf16"][what]
        assert rec["bound_by"] == "bytes"
        assert rec["bound_ms"] > passes * flops / peak_flops(
            torch.bfloat16) * 1e3


def _drop_last_tap(dw_fn):
    def dw(x, dy, k, groups, pad, *args):
        out = dw_fn(x, dy, k, groups, pad, *args).clone()
        out[-1] = 0
        return out
    return dw


@pytest.mark.parametrize("fault", ["dW tap dropped", "control passes"])
def test_grouped_conv_phase_fails_a_planted_fault(tiny_grouped_conv,
                                                  monkeypatch, fault):
    from speech_ssl_compression_tpu_torch.ops import grouped_conv as gc

    if fault == "dW tap dropped":
        monkeypatch.setattr(gc, "grouped_conv1d_dw",
                            _drop_last_tap(gc.grouped_conv1d_dw))
        match = "disagrees"
    else:  # a bf16 control that sums in f32 would pass: the check says so
        monkeypatch.setattr(chip_smoke, "cudnn_grouped",
                            lambda x, w, g, pad: gc.grouped_conv1d(x, w, g,
                                                                   pad))
        match = "passes a planted control"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.phase_grouped_conv(torch.device("cpu"), "cpu")


def test_cudnn_pos_conv_swaps_the_route_of_every_pos_conv():
    """The stand-ins' old route: pos_conv_embed goes through
    cudnn_samepad inside the context (its calls counted), and through the
    module again after it; f32 agree."""
    from speech_ssl_compression_tpu_torch.models import encoder

    torch.manual_seed(0)
    p = encoder.PosConv(32, 8, 4)
    with torch.no_grad():
        p.weight_v.normal_()
        p.bias.normal_()
    x = torch.randn(2, 40, 32)
    with torch.no_grad():
        got = encoder.pos_conv_embed(x, p)
        with chip_smoke.cudnn_pos_conv() as calls:
            old = encoder.pos_conv_embed(x, p)
        again = encoder.pos_conv_embed(x, p)
    assert len(calls) == 1
    assert encoder._grouped_conv_samepad is not None and torch.equal(got,
                                                                     again)
    assert got.shape == old.shape == (2, 40, 32)
    assert torch.allclose(got, old, rtol=1e-5, atol=1e-5)
