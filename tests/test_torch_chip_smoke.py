"""The pieces of ``chip_smoke.py`` that need no GPU: the attention kernels'
work and bounds per dtype (the kernels line's bound_ms and bound_by), the
layout of an attention kernel's entry in that line, the launches per dtype
and path in it, and the check that the attention kernels (forward, dQ,
dK/dV; bf16, and f32 in split TF32), the f32 conv forward (split TF32) and
the bf16 conv forward, dW and dX run on the tensor cores (HGMMA in their
SASS)."""

import pathlib
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")


@pytest.mark.parametrize("dtype,size,peak", [(torch.float32, 4, 495e12 / 3),
                                             (torch.bfloat16, 2, 989e12)])
def test_attention_bounds_per_dtype(dtype, size, peak):
    assert chip_smoke.PEAK_FLOPS[dtype] == peak
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
        want = max(flops / peak, n_bytes / chip_smoke.PEAK_BYTES) * 1e3
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
