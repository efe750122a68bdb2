#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the quickest proof that
the port still builds, starts and is right on the card.

    python3 chip_smoke.py            # from the repo root; needs one CUDA device
    python3 chip_smoke.py --profile  # also: torch.profiler device time per
                                     # forward_packed call and grad step

Phases (any failure raises, and the script exits non-zero without a
result line):
  build     compile csrc/ with nvcc (speech_ssl_compression_tpu_torch/ops/
            _kernels.py, one nvcc per source in parallel), print the build
            time, ptxas's registers and spills per kernel, and the HGMMA
            (tensor-core) instructions per kernel in cuobjdump -sass; fails
            if the attention forward, dQ or dK/dV kernel or the conv
            forward, dW or dX kernel (each in bf16, and in f32 in split
            TF32) has none;
  kernels   the flash-attention forward kernels (both on the tensor cores,
            f32 in split TF32) against their plain PyTorch version on the
            card, TF32 off, f32 (against the plain version run in float64,
            its distance from the f32 one printed) and bf16, at the shapes
            the serving path and the long/rectangular/causal paths give
            them, with dropout at the training shape, and at the ragged
            edges of the tiles and of the kernels' two-stage rings: T =
            777 (key padding, dropout), T = 65 and T = 1; CUDA-event times
            of the kernel's launches (launch_fwd, without the wrapper's
            host work) and of the plain version at the serving, training,
            long and rectangular shapes;
  backward  the dQ and dK/dV kernels (both dtypes on the tensor cores; f32
            in split TF32), as the autograd path runs them (the
            dQ kernel computes D from its own P and hands it to the dK/dV
            kernel), against the plain backward at the training shape
            (4, 12, 768, 64) with key padding, dropout 0 and 0.1, and at the
            serving, causal, one-head, long and rectangular shapes, and at
            the ragged T = 777 (key padding, dropout) and T = 65, f32 and
            bf16 (bf16: fewer than BF16_BEYOND_BAR of each gradient's valid
            entries past one ulp; f32: dq, dk, dv against the plain
            backward run in float64, which the f32 plain version itself
            misses by up to ~2e-4 at the causal case, and its distance
            from the f32 one printed); D also against JAX's
            rowsum(dO o O);
            times of both kernels
            and their plain versions at the long and rectangular shapes; the
            forward kernels' keep bits and keep rate against the plain mask
            and the binomial, f32 and bf16; the same seed giving the same
            bits twice, f32 and bf16;
  slice     MelHuBERT-20ms at full width (12 layers, 768 wide, seeded random
            weights written as an npz checkpoint and read back through
            load_any_checkpoint) serves 16 synthetic utterances through
            MelHuBERTExtractor.forward_packed: launch counts, the dense
            path, the unpacked path, bf16 against f32;
  timing    CUDA-event medians of 3 after a warm-up: serve-batch frames/s
            with the kernel and with impl="dense", f32 and bf16; then
            F.scaled_dot_product_attention's forward and backward at the
            attention kernels' timed shapes, f32 and bf16;
  train     MelHuBERT-20ms pre-training at full width on a synthetic
            dataset, through the trainer's entry point (python -m
            speech_ssl_compression_tpu_torch.train): 3 updates of 8
            micro-batches (B = 4, T = 768), bf16, dropout 0.1; launch
            counts per micro-batch; the checkpoint read back; loss and every
            gradient of the kernel path against impl="dense" in f32 with
            dropout off; 10 updates on one fixed batch, whose loss falls;
  train timing  the grad step with the kernels and with impl="dense", f32
            and bf16, one full update in bf16, and the backward kernels
            against the plain backward at the training shape;
  conv      the strided-conv forward, dW and dX kernels against their plain
            version at the shapes of HuBERT's frontend layers 1-6 in the
            training batch, at T = 777 / 515 and at the ragged edges of the
            bf16 kernels' tiles (CONV_EDGE_CASES): f32 (TF32 off) against
            the plain version in float64, bf16 against it in bf16, the
            forward, dW and dX of both dtypes bitwise repeatable; dX zero
            past the last input row an output reaches; CUDA-event times of
            each kernel, its plain version and cuDNN's call for the same
            function (F.conv1d, conv1d_weight, conv1d_input);
  hubert serve  HuBERT-base at full width (configs/hubert/config_model.yaml,
            seeded random weights) through hubert_forward(features_only=True)
            on 8 x 491,520 samples: launch counts, the conv kernels
            (conv_frontend_impl="tc_pallas") against cuDNN ("auto"), bf16
            against f32, frames/s of both routes in f32 and bf16;
  hubert train  HuBERT-base pre-training through the trainer's entry point
            (-u hubert) on a synthetic manifest: 3 updates of 2 micro-batches
            (B = 4, 245,760 samples), bf16; launch counts per grad step; the
            checkpoint read back; loss and every gradient of the kernel
            route (f32, TF32 off, dropout off, a fixed span mask) against
            cuDNN + impl="dense" run in float64 and in f32; the grad step
            and one update at the bench recipe with and without the conv
            kernels, f32 and bf16;
  profile   (--profile only) device busy time, idle share and the largest
            device kernels of forward_packed from features, per path, and
            of the MelHuBERT and HuBERT bf16 grad steps.

The conv kernels' bf16 check: kernel and plain version round only their
outputs, so every entry must lie within one ulp and fewer than
BF16_SHARE_BAR may differ; a control that rounds the two halves of the
reduction to bf16 before adding them must fail that share.

The bf16 kernel check. Kernel and plain version both round their output to
bf16, so the two may differ by one bf16 ulp wherever the f32 results
straddle a rounding point. The plain version runs with the kernel's key
tiles (block_k), so a bf16 P is rounded at the same points. The check asks
that every valid entry lie within one ulp (of max(|ref|, mean |ref|)) and
that fewer than BF16_SHARE_BAR of them differ at all. A control, the same
plain version with P left in f32, must fail that share, or the check could
not see the rounding of P and the script fails (with one key, T = 1, P = 1
is exact and there is no rounding to see: there the kernel must give the
plain version's bits).

The bf16 forward kernel computes the scores on the tensor cores, in
another order than the plain version's f32 product, so a p that lies
within the scores' error bound of a bf16 rounding point may round the
other way. Where short segments give single keys large weights
(STRADDLE_CASES: the packed serving batch), one such p moves an entry by
about an ulp. There, and only there, an entry may lie past one ulp if
  * it lies within one ulp plus its straddle bound
    (flash_attention.bf16_forward_straddle_bounds: the most that rounding
    those p the other way can move it), and
  * rounding some of its row's straddling p the other way brings the
    whole row of the plain version within one ulp of the kernel's
    (flash_attention.bf16_forward_straddle_flips).

The backward kernels are held to the same share bar against the plain
backward, which rounds dS and Pd to bf16 where the kernels do (its control
leaves them in f32), and each entry to one ulp plus its straddle bound
(flash_attention.bf16_straddle_bounds, for the dS and Pd terms). Each
bound is built from the inputs before the kernels run.

The line before the last holds the kernels' JSON record: per kernel its
f32 numbers at its main case (the serving batch for the forward, the
training shape with dropout for the backward kernels, HuBERT's frontend
layers 1-6 summed for the conv kernels) and, under keys ending in _bf16,
its bf16 ones: ms (CUDA events), plain_ms, library_ms
(F.scaled_dot_product_attention or cuDNN, timed only: one Python call
each, its dispatch included), bound_ms (the larger of the FLOPs at the
dtype's peak, 165 TFLOP/s f32 (495 / 3: f32-accurate products in split
TF32 on the tensor cores) or 989 TFLOP/s bf16, and the bytes at 3.35
TB/s) and bound_by; launches (the main paths' runs), launches_by_dtype and
launches_by_path (per dtype). The attention
kernels' ms times their launches alone (launch_fwd, launch_bwd_dq,
launch_bwd_dkv on prebuilt masks); the forward's wrapper_ms times
flash_attention (or flash_attention_kv_full), the call the model makes,
host work included, as library_ms times SDPA's. The attention kernels'
other timed shapes are under "cases". The f32 forward's max_abs_err is
against the plain version in float64. Every entry names the file of its
f32 kernel (source) and of its bf16 kernel (source_bf16) and the HGMMA
counts of both (hgmma, hgmma_bf16).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
CONFIG_YAML = ROOT / "configs" / "melhubert" / "config_model_20ms.yaml"
MEAN_STD = ROOT / "example" / "libri-960-mean-std.npy"
FWD_F32_SOURCE = (
    "speech_ssl_compression_tpu_torch/csrc/flash_attn_fwd_f32_sm90.cu")
BWD_F32_SOURCE = (
    "speech_ssl_compression_tpu_torch/csrc/flash_attn_bwd_f32_sm90.cu")
FWD_SM90_SOURCE = "speech_ssl_compression_tpu_torch/csrc/flash_attn_fwd_sm90.cu"
BWD_SM90_SOURCE = "speech_ssl_compression_tpu_torch/csrc/flash_attn_bwd_sm90.cu"
ATTN_SOURCES = {"flash_attn_fwd": FWD_F32_SOURCE,
                "flash_attn_bwd_dq": BWD_F32_SOURCE,
                "flash_attn_bwd_dkv": BWD_F32_SOURCE}
ATTN_REPLACES = {
    "flash_attn_fwd": "speech_ssl_compression_tpu/ops/flash_attention.py:66",
    "flash_attn_bwd_dq": "speech_ssl_compression_tpu/ops/flash_attention.py:473",
    "flash_attn_bwd_dkv":
        "speech_ssl_compression_tpu/ops/flash_attention.py:537",
}
# the kernels' names in the built library's symbols
KERNEL_SYMBOLS = ("flash_attn_fwd_f32_kernel", "flash_attn_fwd_bf16_kernel",
                  "flash_attn_bwd_dq_bf16_kernel",
                  "flash_attn_bwd_dkv_bf16_kernel",
                  "flash_attn_bwd_dq_f32_kernel",
                  "flash_attn_bwd_dkv_f32_kernel", "conv1d_fwd_f32_kernel",
                  "conv1d_split_w_kernel", "conv1d_split_w_dx_kernel",
                  "conv1d_dw_reduce_kernel", "conv1d_dw_f32_kernel",
                  "conv1d_dx_f32_kernel", "conv1d_fwd_bf16_kernel",
                  "conv1d_dw_bf16_kernel", "conv1d_dx_bf16_kernel")
# the kernels that must run on the tensor cores: {(name, dtype tag): symbol}
TENSOR_CORE_KERNELS = {
    ("flash_attn_fwd", "f32"): "flash_attn_fwd_f32_kernel",
    ("flash_attn_fwd", "bf16"): "flash_attn_fwd_bf16_kernel",
    ("flash_attn_bwd_dq", "bf16"): "flash_attn_bwd_dq_bf16_kernel",
    ("flash_attn_bwd_dkv", "bf16"): "flash_attn_bwd_dkv_bf16_kernel",
    ("flash_attn_bwd_dq", "f32"): "flash_attn_bwd_dq_f32_kernel",
    ("flash_attn_bwd_dkv", "f32"): "flash_attn_bwd_dkv_f32_kernel",
    ("conv1d_fwd", "f32"): "conv1d_fwd_f32_kernel",
    ("conv1d_dw", "f32"): "conv1d_dw_f32_kernel",
    ("conv1d_dx", "f32"): "conv1d_dx_f32_kernel",
    ("conv1d_fwd", "bf16"): "conv1d_fwd_bf16_kernel",
    ("conv1d_dw", "bf16"): "conv1d_dw_bf16_kernel",
    ("conv1d_dx", "bf16"): "conv1d_dx_bf16_kernel"}
# the melhubert_pretrain batch: B = 4 utterances cropped to 750 stacked
# frames (sequence_length), padded to 768
TRAIN_SHAPE = (4, 12, 768, 64)
TRAIN_LENGTHS = (750, 750, 700, 512)  # kernel checks: a mix of lengths
DROPOUT_P, DROPOUT_SEED = 0.1, 1234
KEEP_SIGMAS = 5.0  # kernel keep rate within 5 sigma of the binomial
GRAD_BAR = 1e-4  # rel. L2, loss and every gradient: kernels vs impl="dense"
# stacked 20 ms frame counts of the two bundled LibriSpeech utterances that
# bench.py tiles into its 16-utterance serve batch
SERVE_LENGTHS = (101,) * 8 + (792,) * 8
CAPACITY = 896  # pack row width those lengths give (792 rounded up to 128)
RECT_VALID_KEYS = 4800  # of the 5000 keys of the rectangular case
TIMED_CASES = ("serving", "training_dropout", "long", "rectangular")
F32_BAR, LSE_BAR = 1e-4, 1e-4  # max |d| / mean |ref|; lse max |d|
BF16_ULP_BAR = 1.0     # max |d| in bf16 ulps of max(|ref|, mean |ref|)
BF16_SHARE_BAR = 0.03  # share of valid bf16 outputs that differ at all
# bf16 backward: share of a gradient's valid entries that may lie past one
# ulp (each also within its straddle bound), fixed before any run
BF16_BEYOND_BAR = 0.001
# bf16 forward cases whose short segments give single keys weights large
# enough that one p rounded the other way moves an entry past one ulp
STRADDLE_CASES = ("serving",)
MAX_STRADDLE_ROWS = 64  # rows past one ulp the flip search takes
SLICE_BAR, PACKED_BAR, BF16_SLICE_BAR = 1e-4, 2e-4, 5e-2
CONV_SM90_SOURCE = "speech_ssl_compression_tpu_torch/csrc/conv1d_sm90.cu"
# the f32 conv kernels, all three in split TF32 in one file (csrc/conv1d.cu
# keeps the C entry points and dW's reduce kernel)
CONV_SOURCES = dict.fromkeys(
    ("conv1d_fwd", "conv1d_dw", "conv1d_dx"),
    "speech_ssl_compression_tpu_torch/csrc/conv1d_f32_sm90.cu")
# (B, T, C, K, O, stride) at the ragged edges of the bf16 kernels' 128-row
# tiles and 64-row steps: one output row, one row past a tile, three
# batches, C != O, the last input row read (T - K divisible by s) or not,
# taps over three phases
CONV_EDGE_CASES = (("t_out1", (2, 3, 512, 3, 512, 2)),
                   ("t_out65", (2, 131, 512, 3, 512, 2)),
                   ("b3", (3, 777, 512, 3, 512, 2)),
                   ("c256_o384", (2, 515, 256, 3, 384, 2)),
                   ("k2s2_last_row", (2, 300, 512, 2, 512, 2)),
                   ("k3s2_short", (2, 302, 512, 3, 512, 2)),
                   ("k7s3", (2, 400, 128, 7, 128, 3)))
CONV_REPLACES = {
    "conv1d_fwd": "speech_ssl_compression_tpu/ops/conv1d.py:63",
    "conv1d_dw": "speech_ssl_compression_tpu/ops/conv1d.py:106",
    "conv1d_dx": "speech_ssl_compression_tpu/ops/conv1d.py:153",
}
# f32 conv kernels against the plain version run in float64: forward and dX
# max |d| / mean |ref|, dW rel. L2 (its sums run over up to ~10^5 rows)
CONV_F32_BAR = 1e-5
HUBERT_YAML = ROOT / "configs" / "hubert" / "config_model.yaml"
HUBERT_SERVE = (8, 491520)  # B x samples: bench.py's hubert extraction row
HUBERT_TRAIN = (4, 245760)  # B x samples: train/wave_bench.py's recipe
HUBERT_CLASSES = 504        # 500 clusters + 4 specials, the bench recipe's
HUBERT_ACCUM = 2            # micro-batches per update in the trainer run
# peaks of one H100 SXM (NVIDIA data sheet): f32-accurate products on the
# tensor cores in split TF32, three TF32 products each (495 / 3 TFLOP/s;
# the CUDA cores' 67 would read below the f32 backward kernels' times),
# bf16 on the tensor cores, HBM bandwidth
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12


def bound(flops: float, n_bytes: float, dtype) -> tuple:
    """(least ms the card could take, "operations" or "bytes"): the larger
    of the FLOPs over the dtype's peak and the bytes over HBM bandwidth."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], n_bytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3, inner: int = 1) -> float:
    """Median over ``reps`` of CUDA-event time per call, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rel_err(got, ref, valid) -> float:
    """max |got - ref| / mean |ref| over the valid entries."""
    got, ref = got.float()[valid], ref.float()[valid]
    return float((got - ref).abs().max() / ref.abs().mean())


def rel_l2(got, ref, valid) -> float:
    got, ref = got.float()[valid], ref.float()[valid]
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


def bf16_ulp(ref, floor=None):
    """One bf16 ulp of max(|ref|, floor), the floor mean |ref| unless
    given; a bf16 x in [2^e, 2^(e+1)) has ulp 2^(e-7). The floor keeps
    near-zero entries, whose f32 sums carry errors of the row's scale, from
    counting as many ulps."""
    mag = ref.abs().clamp_min(float(ref.abs().mean()) if floor is None
                              else floor)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_diff(got, ref, valid):
    """(share of valid entries where two bf16 tensors differ, max |d| in
    bf16 ulps)."""
    got, ref = got.float()[valid], ref.float()[valid]
    d = (got - ref).abs()
    return float((d > 0).float().mean()), float((d / bf16_ulp(ref)).max())


def bf16_bound_diff(got, ref, bound, valid):
    """bf16_diff's (share, max ulps), then the count of valid entries beyond
    one ulp, the largest excess over one ulp as a share of that entry's
    straddle bound (the check passes at <= 1; inf where the bound is 0),
    and the median bound in ulps."""
    got, ref, bound = got.float()[valid], ref.float()[valid], bound[valid]
    ulp = bf16_ulp(ref)
    d = (got - ref).abs()
    beyond = d > ulp
    need = 0.0
    if beyond.any():
        need = float(((d - ulp)[beyond] / bound[beyond]).max())
    return (float((d > 0).float().mean()), float((d / ulp).max()),
            int(beyond.sum()), need, float((bound / ulp).median()))


def packed_segments(lengths, capacity, device):
    """Segment ids of the serve batch as forward_packed lays it out."""
    from speech_ssl_compression_tpu_torch.ops.packing import (
        build_pack_arrays, plan_packing,
    )

    rows = plan_packing(lengths, capacity)
    _, seg, _ = build_pack_arrays(lengths, rows, capacity, capacity)
    return torch.from_numpy(seg).to(device)


def train_padding(dev):
    """Key padding (B, 768) of the kernel checks at the training shape."""
    lens = torch.tensor(TRAIN_LENGTHS, device=dev)
    return torch.arange(TRAIN_SHAPE[2], device=dev)[None, :] >= lens[:, None]


def rect_padding(dev):
    """Key padding (1, 5000) of the rectangular case: the last 200 keys."""
    pad = torch.zeros((1, 5000), dtype=torch.bool, device=dev)
    pad[0, RECT_VALID_KEYS:] = True
    return pad


def kernel_cases(dev):
    """(name, q shape, k shape, mask kwargs, valid rows (B, Tq) bool)."""
    seg = packed_segments(SERVE_LENGTHS, CAPACITY, dev)
    pad_tail = torch.zeros((2, 1024), dtype=torch.bool, device=dev)
    pad_tail[1, 900:] = True
    lens = torch.tensor([896, 700, 500, 101], device=dev)
    pad_1h = torch.arange(896, device=dev)[None, :] >= lens[:, None]
    pad_rect = rect_padding(dev)
    ones = lambda b, t: torch.ones((b, t), dtype=torch.bool, device=dev)
    return [
        ("serving", (seg.shape[0], 12, CAPACITY, 64), None,
         dict(segment_ids=seg, key_padding_mask=seg == 0), seg != 0),
        ("causal", (2, 12, 1024, 64), None,
         dict(causal=True, key_padding_mask=pad_tail), ones(2, 1024)),
        ("one_head", (4, 1, 896, 64), None,
         dict(key_padding_mask=pad_1h), ones(4, 896)),
        ("long", (1, 12, 5000, 64), None, {}, ones(1, 5000)),
        ("rectangular", (1, 12, 1024, 64), (1, 12, 5000, 64),
         dict(key_padding_mask=pad_rect), ones(1, 1024)),
    ]


def training_cases(dev):
    """The training shape, dropout 0 and 0.1, in kernel_cases' layout."""
    pad = dict(key_padding_mask=train_padding(dev))
    valid = torch.ones(TRAIN_SHAPE[0], TRAIN_SHAPE[2], dtype=torch.bool,
                       device=dev)
    return [("training", TRAIN_SHAPE, None, pad, valid),
            ("training_dropout", TRAIN_SHAPE, None,
             dict(pad, dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED), valid)]


def phase_kernels(dev, gpu: str):
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {}
    for name, qs, ks, masks, valid in (kernel_cases(dev) + training_cases(dev)
                                       + edge_cases(dev)):
        ks = ks or qs
        for dtype in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            q = torch.randn(qs, generator=gen, device=dev).to(dtype)
            k = torch.randn(ks, generator=gen, device=dev).to(dtype)
            v = torch.randn(ks, generator=gen, device=dev).to(dtype)
            # the bound is built from the inputs, before the kernel runs
            bound = (fa.bf16_forward_straddle_bounds(q, k, v, **masks)
                     if dtype == torch.bfloat16 else None)
            if ks != qs:
                got, lse = fa.flash_attention_kv_full(q, k, v, return_lse=True,
                                                      **masks)
            else:
                got, lse = fa.flash_attention(q, k, v, return_lse=True, **masks)
            ref, ref_lse = fa.flash_attention_reference(q, k, v, **masks)
            torch.cuda.synchronize()
            rows = valid[:, None, :].expand(lse.shape)
            err = rel_err(got, ref, rows)
            max_abs = float((got.float() - ref.float())[rows].abs().max())
            lse_err = float((lse - ref_lse)[rows].abs().max())
            tag = "f32" if dtype == torch.float32 else "bf16"
            if dtype == torch.float32:
                # the kernel's products are f32-accurate (split TF32) but
                # not rounded where the f32 plain version's are: out and lse
                # are held to the plain version run in float64, and their
                # distance from the f32 one is printed
                exact, exact_lse = fa.flash_attention_reference(
                    q.double(), k.double(), v.double(), **masks)
                plain_err, plain_lse = err, lse_err
                err = rel_err(got, exact, rows)
                max_abs = float((got.double() - exact)[rows].abs().max())
                lse_err = float((lse.double() - exact_lse)[rows].abs().max())
                own = rel_err(ref, exact, rows)
                del exact, exact_lse
                ok = err < F32_BAR and lse_err < LSE_BAR
                detail = (f"against the plain version in float64: "
                          f"max|d|/mean|ref| {err:.3e} (bar {F32_BAR:g}), "
                          f"lse max|d| {lse_err:.3e} (bar {LSE_BAR:g}); "
                          f"against it in f32: {plain_err:.3e}, lse "
                          f"{plain_lse:.3e} (that f32 version's own "
                          f"distance from float64 {own:.3e})")
            else:
                tiled, _ = fa.flash_attention_reference(
                    q, k, v, block_k=fa.KERNEL_BLOCK_K, **masks)
                share, ulps, n_beyond, need, bound_med = bf16_bound_diff(
                    got, tiled, bound, rows)
                del bound
                control, _ = fa.flash_attention_reference(
                    q.float(), k.float(), v.float(), block_k=fa.KERNEL_BLOCK_K,
                    **masks)
                ctl_share, ctl_ulps = bf16_diff(control.to(dtype), tiled, rows)
                ok = share < BF16_SHARE_BAR and lse_err < LSE_BAR
                detail = (f"differ {share:.3%} (bar {BF16_SHARE_BAR:.0%}), "
                          f"max {ulps:g} ulp (bar {BF16_ULP_BAR:g}"
                          f"{' + straddles' if name in STRADDLE_CASES else ''}"
                          f"), {n_beyond} beyond 1 ulp "
                          f"(excess/straddle bound <= {need:.3g}, bar 1; "
                          f"median bound {bound_med:.3g} ulp), lse "
                          f"max|d| {lse_err:.3e} (bar {LSE_BAR:g}); control "
                          f"with P in f32: differ {ctl_share:.3%}, max "
                          f"{ctl_ulps:g} ulp; max|d|/mean|ref| {err:.3e}")
                if ulps > BF16_ULP_BAR:
                    explained, flips = explain_straddles(fa, q, k, v, got,
                                                         tiled, rows, masks)
                    ok = (ok and name in STRADDLE_CASES and need <= 1.0
                          and explained)
                    detail += f"; flip search: {flips}"
                if ks[2] == 1:
                    # one key: P = exp(0) = 1 is exact in bf16, so there is
                    # no rounding of P for the control to show; the output
                    # is that key's V row, and must be its bits
                    ok = ok and share == 0.0
                    detail += " (one key: bar 0% differing)"
                elif not ctl_share >= BF16_SHARE_BAR:
                    raise AssertionError(
                        f"bf16 check at {name} cannot tell a kernel that "
                        f"leaves P in f32 apart ({ctl_share:.3%} differ)")
            log("kernels", f"{name} {tag} q{tuple(qs)} k{tuple(ks)}: kernel vs "
                f"plain, {detail}, {time.perf_counter() - t0:.2f} s")
            if not (ok and torch.isfinite(got.float()[rows]).all()):
                raise AssertionError(f"kernel disagrees at {name} {tag}")
            if name in TIMED_CASES:
                # the kernel's launches alone, as backward_timing times the
                # backward's: the wrapper's host work per call (the bias,
                # the autograd Function) can pace a ~0.1 ms kernel; the
                # wrapper is timed on its own
                args = fa.forward_args(q, k, v, **masks)
                attend = (fa.flash_attention_kv_full if ks != qs
                          else fa.flash_attention)

                def run_kernel(args=args):
                    fa.launch_fwd(*args)

                def run_plain(q=q, k=k, v=v, masks=masks):
                    fa.flash_attention_reference(q, k, v, **masks)

                def run_wrapper(q=q, k=k, v=v, masks=masks, attend=attend):
                    attend(q, k, v, **masks)

                kernel_ms, plain_ms = alternate(run_kernel, run_plain,
                                                inner=5)
                wrapper_ms = cuda_ms(run_wrapper, inner=5)
                record["flash_attn_fwd", name, tag] = dict(
                    max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
                    wrapper_ms=wrapper_ms)
                log("timing", f"flash_attn_fwd {name} {tag} {tuple(qs)}: "
                    f"kernel {kernel_ms:.3f} ms, wrapper {wrapper_ms:.3f} "
                    f"ms, plain {plain_ms:.3f} ms [{gpu}]")
    return record


def explain_straddles(fa, q, k, v, got, ref, rows, masks):
    """(whether p rounded the other way account for every row of the bf16
    forward's output ``got`` with a valid entry past one ulp of ``ref``,
    a report): flash_attention.bf16_forward_straddle_flips must bring each
    such row within one ulp at every entry. More than MAX_STRADDLE_ROWS
    such rows fail without a search."""
    got, ref = got.float(), ref.float()
    ulp = bf16_ulp(ref, floor=float(ref[rows].abs().mean()))
    beyond = (((got - ref).abs() > ulp).any(dim=-1) & rows).nonzero()
    if beyond.shape[0] > MAX_STRADDLE_ROWS:
        return False, f"{beyond.shape[0]} rows past one ulp"
    found = fa.bf16_forward_straddle_flips(q, k, v, got, beyond, ulp, **masks)
    report = "; ".join(
        f"row {tuple(r)}: {n} straddling p, {f} rounded the other way: "
        f"max {a:g} -> {b:g} ulp"
        for r, (n, f, a, b) in zip(beyond.tolist(), found))
    return all(b <= BF16_ULP_BAR for *_, b in found), report


def alternate(run_kernel, run_plain, inner: int = 1):
    """(kernel ms, plain ms), each the mean of two CUDA-event medians taken
    in the order plain, kernel, kernel, plain, to share drift."""
    p1 = cuda_ms(run_plain, inner=inner)
    k1 = cuda_ms(run_kernel, inner=inner)
    k2 = cuda_ms(run_kernel, inner=inner)
    p2 = cuda_ms(run_plain, inner=inner)
    return (k1 + k2) / 2, (p1 + p2) / 2


def edge_cases(dev):
    """The ragged edges of the tiles and of the bf16 kernels' two-stage
    rings, in kernel_cases' layout: T = 777 with key padding and dropout,
    T = 65 (one row and one key past a tile) and T = 1 (one row, one
    key)."""
    lens = torch.tensor([777, 600], device=dev)
    pad = torch.arange(777, device=dev)[None, :] >= lens[:, None]
    ones = lambda b, t: torch.ones((b, t), dtype=torch.bool, device=dev)
    return [("ragged_777", (2, 12, 777, 64), None,
             dict(key_padding_mask=pad, dropout_p=DROPOUT_P,
                  dropout_seed=DROPOUT_SEED), ones(2, 777)),
            ("t65", (2, 12, 65, 64), None, {}, ones(2, 65)),
            ("t1", (2, 12, 1, 64), None, {}, ones(2, 1))]


def backward_cases(dev):
    """(name, q shape, k shape, forward kwargs, valid query rows (B, Tq),
    valid keys (B, Tk)): the training shape with dropout 0 and 0.1, the
    forward's other shapes (dropout-free; the rectangular one is the
    backward of flash_attention_kv_full), and the ragged edges T = 777 and
    T = 65. (With one key, T = 1, dQ and dK are zero up to rounding, which
    the relative bars cannot read; tests/test_torch_cuda.py checks them
    against zero.)"""
    ones = lambda b, t: torch.ones((b, t), dtype=torch.bool, device=dev)
    edges = [e for e in edge_cases(dev) if e[1][2] > 1]
    cases = []
    for name, qs, ks, masks, valid in (training_cases(dev) + kernel_cases(dev)
                                       + edges):
        kpm = masks.get("key_padding_mask")
        tk = (ks or qs)[2]
        valid_k = ones(qs[0], tk) if kpm is None else ~kpm
        cases.append((name, qs, ks, masks, valid, valid_k))
    return cases


def rows_of(valid, shape):
    """(B, T) valid mask -> (B, H, T) row selector for (B, H, T, d)."""
    return valid[:, None, :].expand(shape[:3])


def phase_backward(dev, gpu: str):
    """The dQ and dK/dV kernels against the plain backward (TF32 off), on
    the forward kernel's (out, lse) and a random dO."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1)
    record = {}
    for name, qs, ks, masks, valid_q, valid_k in backward_cases(dev):
        ks = ks or qs
        for dtype in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            q, dout = (torch.randn(qs, generator=gen, device=dev).to(dtype)
                       for _ in range(2))
            # padded query rows carry dO = 0, as they do in the model
            dout = dout.masked_fill(~valid_q[:, None, :, None], 0.0)
            k, v = (torch.randn(ks, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            if ks != qs:
                out, lse = fa.flash_attention_kv_full(q, k, v, return_lse=True,
                                                      **masks)
            else:
                out, lse = fa.flash_attention(q, k, v, return_lse=True, **masks)
            args = fa.backward_args(q, k, v, lse, dout, **masks)
            # the bound is built from the inputs, before the kernels run
            bounds = (fa.bf16_straddle_bounds(*args) if dtype == torch.bfloat16
                      else None)
            *got, dd = fa.launch_bwd(*args)
            *ref, ref_dd = fa.reference_bwd(*args)
            torch.cuda.synchronize()
            sel = (rows_of(valid_q, qs), rows_of(valid_k, ks),
                   rows_of(valid_k, ks))
            tag = "f32" if dtype == torch.float32 else "bf16"
            names = ("dq", "dk", "dv")
            abs_errs = [float((g.float() - r.float())[s].abs().max())
                        for g, r, s in zip(got, ref, sel)]
            record.setdefault(("flash_attn_bwd_dq", name, tag), {})[
                "max_abs_err"] = abs_errs[0]
            record.setdefault(("flash_attn_bwd_dkv", name, tag), {})[
                "max_abs_err"] = max(abs_errs[1:])
            # D, f32 whatever the inputs, against its plain version; in f32
            # also against JAX's D = rowsum(dO o O) from the forward's
            # output (a bf16 O is rounded, and that D with it)
            d_errs = [rel_err(dd, ref_dd, sel[0])]
            detail = f"D max|d|/mean|ref| {d_errs[0]:.3e}"
            if dtype == torch.float32:
                d_errs.append(rel_err(dd, fa.output_dd(out, dout), sel[0]))
                detail += f", against rowsum(dO o O) {d_errs[1]:.3e}"
            ok = max(d_errs) < F32_BAR
            detail += f" (bar {F32_BAR:g}); "
            if dtype == torch.float32:
                # the kernels' products are f32-accurate (split TF32) but
                # not rounded where the f32 plain version's are, which lies
                # up to ~2e-4 from the exact function itself (the causal
                # case): dq, dk and dv are held to the plain version run in
                # float64
                exact = fa.reference_bwd(*fa.float64_args(args))[:3]
                errs = [rel_err(g, r, s) for g, r, s in zip(got, exact, sel)]
                plain = [rel_err(g, r, s) for g, r, s in zip(got, ref, sel)]
                own = [rel_err(r, e, s) for r, e, s in zip(ref, exact, sel)]
                del exact
                ok = ok and max(errs) < F32_BAR
                detail += "max|d|/mean|ref| against the plain version in " + \
                    "float64 " + ", ".join(
                        f"{n} {e:.3e}" for n, e in zip(names, errs))
                detail += f" (bar {F32_BAR:g}); against it in f32 " + ", ".join(
                    f"{n} {e:.3e}" for n, e in zip(names, plain))
                detail += " (that f32 version's own distance from float64 " + \
                    ", ".join(f"{n} {e:.3e}" for n, e in zip(names, own)) + ")"
            else:
                f32_args = tuple(a.float() if torch.is_tensor(a)
                                 and a.dtype == dtype else a for a in args)
                control = fa.reference_bwd(*f32_args)[:3]
                diffs = [bf16_bound_diff(g, r, b, s)
                         for g, r, b, s in zip(got, ref, bounds, sel)]
                del bounds
                ctl = [bf16_diff(c.to(dtype), r, s)
                       for c, r, s in zip(control, ref, sel)]
                n_valid = [int(sl.sum()) * g.shape[-1]
                           for g, sl in zip(got, sel)]
                ok = ok and all(sh < BF16_SHARE_BAR and need <= 1.0
                                and nb < BF16_BEYOND_BAR * n
                                for (sh, _, nb, need, _), n
                                in zip(diffs, n_valid))
                detail += ", ".join(
                    f"{n} differ {sh:.3%} max {u:g} ulp, {nb} beyond 1 ulp "
                    f"({nb / nv:.4%}; excess/straddle bound <= {need:.3g}; "
                    f"median bound {bm:.3g} ulp) (control {csh:.2%}, {cu:g} "
                    f"ulp)" for n, (sh, u, nb, need, bm), (csh, cu), nv
                    in zip(names, diffs, ctl, n_valid))
                detail += (f"; bars {BF16_SHARE_BAR:.0%}, 1 ulp + straddle "
                           f"bound, {BF16_BEYOND_BAR:.1%} beyond 1 ulp")
                if not all(csh >= BF16_SHARE_BAR for csh, _ in ctl):
                    raise AssertionError(
                        f"bf16 backward check at {name} cannot tell kernels "
                        "that leave dS and Pd in f32 apart")
            finite = all(torch.isfinite(g.float()[s]).all()
                         for g, s in zip(got, sel))
            log("backward", f"{name} {tag} q{tuple(qs)} k{tuple(ks)}: kernels "
                f"vs plain, {detail}, {time.perf_counter() - t0:.2f} s")
            if not (ok and finite):
                raise AssertionError(f"backward kernels disagree at {name} {tag}")
            if name in ("long", "rectangular"):
                backward_timing(args, name, tag, record, gpu)
            del args, got, ref
    check_keep_bits(dev)
    check_determinism(dev)
    return record


def backward_timing(args, case: str, tag: str, record: dict, gpu: str):
    """CUDA-event times, in turns, of the dQ kernel against its plain
    version (reference_dd, then reference_bwd_dq: the kernel computes D
    itself) and of the dK/dV kernel against reference_bwd_dkv, on one
    backward_args tuple; into record[kernel, case, tag]."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    _, dd = fa.launch_bwd_dq(*args)
    ref_dd = fa.reference_dd(*args)

    def dq_plain():
        fa.reference_bwd_dq(*args, fa.reference_dd(*args))

    for name, kernel, plain in (
            ("flash_attn_bwd_dq", lambda: fa.launch_bwd_dq(*args), dq_plain),
            ("flash_attn_bwd_dkv", lambda: fa.launch_bwd_dkv(*args, dd),
             lambda: fa.reference_bwd_dkv(*args, ref_dd))):
        kernel_ms, plain_ms = alternate(kernel, plain, inner=5)
        record.setdefault((name, case, tag), {}).update(ms=kernel_ms,
                                                        plain_ms=plain_ms)
        log("timing", f"{name} {case} q{tuple(args[0].shape)} "
            f"k{tuple(args[1].shape)} {tag}: kernel {kernel_ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms [{gpu}]")


def check_keep_bits(dev):
    """The forward kernels' keep bits, read back from their output, f32
    and bf16: with q = 0 every probability is 1/T, and v one-hot on the
    key's residue mod 64 makes out[..., c] * T * (1 - p) the count of kept
    keys j = c mod 64 in that row (at most T / 64 = 12, so a bf16 output,
    within 2^-9 of it, still rounds to the count). Those counts must equal
    the plain keep mask's, and the keep rate must lie within KEEP_SIGMAS of
    the binomial."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.ops.dropout import attention_keep_mask

    b, h, t, d = TRAIN_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(TRAIN_SHAPE, device=dev, dtype=dtype)
        k = torch.randn(TRAIN_SHAPE, device=dev).to(dtype)
        v = torch.nn.functional.one_hot(torch.arange(t, device=dev) % d, d)
        v = v.to(dtype).expand(b, h, t, d).contiguous()
        for p in (0.1, 0.5):
            out = fa.flash_attention(q, k, v, dropout_p=p,
                                     dropout_seed=DROPOUT_SEED)
            counts = torch.round(out.double() * t * (1 - p)).long()
            keep = attention_keep_mask(DROPOUT_SEED, b, h, t, t, p, dev)
            plain = keep.view(b, h, t, t // d, d).sum(dim=3)
            n = keep.numel()
            rate = float(counts.sum()) / n
            sigma = (p * (1 - p) / n) ** 0.5
            z = abs(rate - (1 - p)) / sigma
            same = torch.equal(counts, plain)
            log("backward", f"{dtype} forward kernel keep bits at p={p}: "
                f"keep rate {rate:.6f} over {n} draws, {z:.2f} sigma from "
                f"{1 - p:g} (bar {KEEP_SIGMAS:g}); per-row counts equal to "
                f"the plain mask's: {same}")
            if not (same and z < KEEP_SIGMAS):
                raise AssertionError(f"kernel keep bits wrong at p={p} "
                                     f"({dtype})")


def check_determinism(dev):
    """The same seed gives the same forward and backward bits twice, in f32
    and in bf16; another seed gives another output."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(2)
    masks = dict(key_padding_mask=train_padding(dev), dropout_p=DROPOUT_P)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (torch.randn(TRAIN_SHAPE, generator=gen, device=dev)
                         .to(dtype) for _ in range(4))

        def run(seed):
            out, lse = fa.flash_attention(q, k, v, return_lse=True,
                                          dropout_seed=seed, **masks)
            args = fa.backward_args(q, k, v, lse, dout, dropout_seed=seed,
                                    **masks)
            return (out, lse) + fa.launch_bwd(*args)

        first, second, other = run(7), run(7), run(8)
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        differ = not torch.equal(first[0], other[0])
        log("backward", f"{dtype}, seed 7 twice: forward out and lse, dq, "
            f"dk, dv, D bitwise equal: {same}; seed 8 gives another output: "
            f"{differ}")
        if not (same and differ):
            raise AssertionError(
                f"the kernels' dropout is not a function of the seed ({dtype})")


def write_dataset(root: pathlib.Path, n_utts: int = 32, seed: int = 0) -> str:
    """A synthetic pre-training set: 40-d 10 ms features and k-means-like
    labels < 512 that hold for runs of 4-19 frames, each feature a label
    embedding plus noise (so a fixed batch can be learned). Every utterance
    has 1,500-1,699 frames: 750+ stacked 20 ms frames, cropped to
    sequence_length 750. Returns the CSV path."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((512, 40)).astype(np.float32)
    root.mkdir(parents=True, exist_ok=True)
    rows = ["file_path,label_path,length"]
    for i in range(n_utts):
        n = int(rng.integers(1500, 1700))
        runs = rng.integers(4, 20, n)
        labels = np.repeat(rng.integers(0, 512, n), runs)[:n]
        feat = emb[labels] + 0.5 * rng.standard_normal((n, 40))
        fp, lp = root / f"feat_{i}.npy", root / f"label_{i}.npy"
        np.save(fp, feat.astype(np.float32))
        np.save(lp, labels.astype(np.int64))
        rows.append(f"{fp},{lp},{n}")
    csv = root / "train.csv"
    csv.write_text("\n".join(rows) + "\n")
    return str(csv)


RUNNER_YAML = """runner:
  n_epochs: 0
  total_steps: 3
  gradient_clipping: 10.0
  gradient_accumulate_steps: 8
  log_step: 1
  save_every_x_epochs: 10
  bf16: true
optimizer:
  lr: 0.0001
  betas:
  - 0.9
  - 0.999
  eps: 1.0e-08
  weight_decay: 0
datarc:
  num_workers: 1
  train_batch_size: 4
  max_timestep: 0
  sets:
  - {csv}
"""


def grad_errors(names, got, ref):
    """|got - ref|_2 / |ref|_2 per gradient. The k_proj biases' gradients
    are zero up to rounding (softmax is invariant to a shift of a row's
    scores), so theirs is taken against the norm of all gradients."""
    norm = lambda t: float(torch.linalg.vector_norm(t.float().ravel()))
    total = float(np.sqrt(sum(norm(r) ** 2 for r in ref)))
    return [norm(g.float() - r.float())
            / (total if n.endswith("k_proj.bias") else norm(r))
            for n, g, r in zip(names, got, ref)]


def phase_train(dev, gpu: str, tmp: str):
    """Pre-training through the trainer's entry point, then the checks on
    its model. Returns (runner, fixed batch, launch counts of the training
    run per dtype)."""
    from speech_ssl_compression_tpu_torch.extract import (
        load_any_checkpoint, matmul_precision,
    )
    from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.train.__main__ import main as train
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )

    t0 = time.perf_counter()
    root = pathlib.Path(tmp) / "train"
    csv = write_dataset(root / "data")
    runner_yaml = root / "config_runner.yaml"
    runner_yaml.write_text(RUNNER_YAML.format(csv=csv))
    expdir = root / "exp"
    log("train", f"synthetic set written (32 utterances, 40-d, labels < "
        f"512), {time.perf_counter() - t0:.2f} s")

    # the main path: counts from exactly one run of the trainer
    t0 = time.perf_counter()
    reset_launch_counts()
    runner = train(["-m", "melhubert", "-g", str(CONFIG_YAML), "-c",
                    str(runner_yaml), "-n", str(expdir), "--device", "cuda",
                    "--seed", "0"])
    torch.cuda.synchronize()
    counts = dict(fa.launch_counts)
    by_dtype = dtype_launch_counts()
    cfg = runner.cfg
    micro = 3 * runner.accum_steps
    per_micro = {k: v / micro for k, v in counts.items()}
    log("train", f"MelHuBERT-20ms {cfg.encoder_layers}L/"
        f"{cfg.encoder_embed_dim}, {runner.compute_dtype}, 3 updates x "
        f"{runner.accum_steps} micro-batches: launches per micro-batch "
        f"{per_micro} (expected {cfg.encoder_layers} each), "
        f"{time.perf_counter() - t0:.2f} s")
    if any(v != cfg.encoder_layers * micro for v in counts.values()):
        raise AssertionError(f"launch counts {counts}, want "
                             f"{cfg.encoder_layers * micro} each")
    hist = runner.log_history
    for entry in hist:
        log("train", f"update {entry['step']}: loss {entry['loss']:.6f}, "
            f"grad norm {entry['grad_norm']:.6f}")
    if [e["step"] for e in hist] != [1, 2, 3] or not all(
            np.isfinite([e["loss"], e["grad_norm"]]).all() for e in hist):
        raise AssertionError(f"trainer log {hist}")

    params, ckpt_cfg, meta = load_any_checkpoint(str(expdir / "last-step.npz"))
    last = cfg.encoder_layers - 1
    w = params["encoder"]["layers"][last]["fc2"]["kernel"]
    same = np.array_equal(
        w, runner.params[f"encoder.layers.{last}.fc2.weight"].detach().cpu()
        .numpy().T)
    log("train", f"last-step.npz read back through load_any_checkpoint: Step "
        f"{meta['Step']}, {ckpt_cfg.encoder_layers} layers, weights equal to "
        f"the trainer's: {same}")
    if not (same and meta["Step"] == 3
            and ckpt_cfg.encoder_layers == cfg.encoder_layers):
        raise AssertionError("checkpoint does not read back")

    # one fixed micro-batch and span mask for the parity and fixed-batch runs
    batch = runner._device_batch(runner._get_dataloader().get_batch(0))
    t = batch["feat"].shape[1]
    mask = torch.from_numpy(span_mask(cfg, batch["length"], t,
                                      np.random.default_rng(0))).to(dev)
    if tuple(batch["feat"].shape) != (4, 768, 80):
        raise AssertionError(f"batch {tuple(batch['feat'].shape)}")

    t0 = time.perf_counter()
    results = {}
    for impl in ("auto", "dense"):
        step = make_melhubert_grad_step(runner.model, attn_impl=impl,
                                        deterministic=True)
        fa.reset_launch_counts()
        with matmul_precision("highest"):
            loss, grads, _ = step(runner.params, batch, torch.Generator(),
                                  mask_indices=mask)
        torch.cuda.synchronize()
        results[impl] = (loss, grads, dict(fa.launch_counts))
    (loss_k, grads_k, counts_k), (loss_d, grads_d, counts_d) = (
        results["auto"], results["dense"])
    loss_rel = abs(float(loss_k) - float(loss_d)) / abs(float(loss_d))
    names = list(runner.params)
    errs = grad_errors(names, grads_k, grads_d)
    worst = int(np.argmax(errs))
    log("train", f"grad step, kernels vs impl='dense' (f32, TF32 off, dropout "
        f"off, fixed span mask): loss {float(loss_k):.6f} vs "
        f"{float(loss_d):.6f}, rel {loss_rel:.3e}; worst of {len(errs)} "
        f"gradients rel L2 {errs[worst]:.3e} ({names[worst]}), bar "
        f"{GRAD_BAR:g}; launches {counts_k} and {counts_d}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not (loss_rel < GRAD_BAR and max(errs) < GRAD_BAR):
        raise AssertionError("kernel gradients disagree with the dense path")
    if set(counts_k.values()) != {cfg.encoder_layers} or any(counts_d.values()):
        raise AssertionError("the parity run took the wrong path")

    t0 = time.perf_counter()
    step = make_melhubert_grad_step(runner.model,
                                    compute_dtype=runner.compute_dtype)
    losses = []
    for _ in range(10):
        loss, grads, _ = step(runner.params, batch, runner.rng,
                              mask_indices=mask)
        runner.apply(grads, 1.0)
        losses.append(float(loss))
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    log("train", f"10 updates on one fixed batch ({runner.compute_dtype}, "
        f"dropout on): loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; mean of the first 3 "
        f"{first:.4f}, of the last 3 {last:.4f}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError("the loss does not fall on a fixed batch")
    return runner, batch, by_dtype


def phase_train_timing(runner, batch, gpu: str):
    """CUDA-event medians: the grad step with the kernels and with
    impl="dense" (f32 and bf16, TF32 at PyTorch's defaults), one full bf16
    update, and the backward kernels against the plain backward at the
    training shape. Returns the backward kernels' timing record."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.train.steps import (
        accumulate_grads, make_melhubert_grad_step,
    )

    accum = runner.accum_steps
    frames = int(batch["length"].sum())
    for dtype in (torch.float32, torch.bfloat16):
        steps = {impl: make_melhubert_grad_step(
            runner.model, accum_steps=accum, compute_dtype=dtype,
            attn_impl=impl) for impl in ("auto", "dense")}

        def run(impl):
            return lambda: steps[impl](runner.params, batch, runner.rng)

        kernel_ms, dense_ms = alternate(run("auto"), run("dense"))
        log("timing", f"grad step B=4 T=768 {dtype}: kernels {kernel_ms:.2f} "
            f"ms, impl='dense' {dense_ms:.2f} ms ({frames} frames; "
            f"{frames / kernel_ms * 1e3:.0f} and {frames / dense_ms * 1e3:.0f} "
            f"frames/s) [{gpu}]")

    step = make_melhubert_grad_step(runner.model, accum_steps=accum,
                                    compute_dtype=runner.compute_dtype)

    def update():
        acc = None
        for _ in range(accum):
            _, grads, _ = step(runner.params, batch, runner.rng)
            acc = accumulate_grads(acc, grads)
        runner.apply(acc, float(accum))

    ms = cuda_ms(update)
    log("timing", f"one update ({accum} micro-batches + apply, bf16): "
        f"{ms:.2f} ms, {1e3 / ms:.3f} updates/s, "
        f"{accum * frames / ms * 1e3:.0f} frames/s [{gpu}]")

    gen = torch.Generator(device=batch["feat"].device).manual_seed(3)
    masks = dict(key_padding_mask=train_padding(gen.device),
                 dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (torch.randn(TRAIN_SHAPE, generator=gen,
                                     device=gen.device).to(dtype)
                         for _ in range(4))
        _, lse = fa.flash_attention(q, k, v, return_lse=True, **masks)
        args = fa.backward_args(q, k, v, lse, dout, **masks)
        tag = "f32" if dtype == torch.float32 else "bf16"
        backward_timing(args, "training_dropout", tag, record, gpu)
    return record


def synthetic_wavs(seed: int):
    """16 kHz noise + tones whose stacked 20 ms frame counts are
    SERVE_LENGTHS (n frames <- 400 + 160 * (2n - 2) samples)."""
    rng = np.random.default_rng(seed)
    wavs = []
    for n in SERVE_LENGTHS:
        samples = 400 + 160 * (2 * n - 2)
        t = np.arange(samples) / 16000.0
        tone = sum(0.1 * np.sin(2 * np.pi * rng.uniform(80, 4000) * t)
                   for _ in range(3))
        wavs.append((tone + 0.02 * rng.standard_normal(samples))
                    .astype(np.float32))
    return wavs


def phase_slice(dev, gpu: str, tmp: str):
    from speech_ssl_compression_tpu_torch.configs import (
        melhubert_config_from_yaml,
    )
    from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.utils.checkpoint import save_checkpoint
    from speech_ssl_compression_tpu_torch.utils.weights import init_params_np

    t0 = time.perf_counter()
    cfg = melhubert_config_from_yaml(CONFIG_YAML)
    ckpt = str(pathlib.Path(tmp) / "melhubert_20ms_seed0.npz")
    save_checkpoint(ckpt, init_params_np(cfg, seed=0),
                    meta={"Upstream_Config": {"melhubert": cfg.to_dict()},
                          "Step": 0})

    def extractor(dtype, impl):
        return MelHuBERTExtractor(
            ckpt, fp=20, mean_std_npy_path=str(MEAN_STD), dtype=dtype,
            matmul_precision="highest", device=dev, attn_impl=impl,
        )

    ext = extractor(torch.float32, "auto")
    wavs = synthetic_wavs(seed=0)
    log("slice", f"MelHuBERT-20ms {cfg.encoder_layers}L/"
        f"{cfg.encoder_embed_dim}, {ext.num_params()} params, "
        f"checkpoint written and loaded, {len(wavs)} utterances, "
        f"{time.perf_counter() - t0:.2f} s")

    # the main path: counts from exactly one forward_packed call
    t0 = time.perf_counter()
    reset_launch_counts()
    out = ext.forward_packed(wavs)
    torch.cuda.synchronize()
    launches = fa.launch_counts["flash_attn_fwd"]
    by_dtype = dtype_launch_counts()
    n_layers = cfg.encoder_layers
    log("slice", f"forward_packed f32: {out['n_packed_rows']} rows of "
        f"{CAPACITY}, flash_attn_fwd launches {launches} (expected "
        f"{n_layers}), {time.perf_counter() - t0:.2f} s")
    if launches != n_layers:
        raise AssertionError(f"{launches} kernel launches, want {n_layers}")
    if out["n_packed_rows"] != 8:
        raise AssertionError(f"{out['n_packed_rows']} packed rows, want 8")

    lengths = torch.tensor(out["lengths"], device=dev)
    t = out["last_hidden_state"].shape[1]
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    states = out["hidden_states"] + [out["last_hidden_state"]]
    if not all(torch.isfinite(s.float()[valid]).all() for s in states):
        raise AssertionError("non-finite output")

    def worst(other, metric=rel_err):
        others = other["hidden_states"] + [other["last_hidden_state"]]
        return max(metric(a, b, valid) for a, b in zip(others, states))

    t0 = time.perf_counter()
    ext_dense = extractor(torch.float32, "dense")
    fa.reset_launch_counts()
    out_dense = ext_dense.forward_packed(wavs)
    torch.cuda.synchronize()
    if fa.launch_counts["flash_attn_fwd"]:
        raise AssertionError("impl='dense' launched the kernel")
    err_dense = worst(out_dense)
    log("slice", f"kernel vs impl='dense' (f32, TF32 off), all hidden "
        f"states: max|d|/mean|ref| {err_dense:.3e} (bar {SLICE_BAR:g}), "
        f"{time.perf_counter() - t0:.2f} s")
    if not err_dense < SLICE_BAR:
        raise AssertionError("slice disagrees with the dense path")

    t0 = time.perf_counter()
    err_unpacked = worst(ext.forward(wavs))
    log("slice", f"packed vs unpacked forward (f32): max|d|/mean|ref| "
        f"{err_unpacked:.3e} (bar {PACKED_BAR:g}), "
        f"{time.perf_counter() - t0:.2f} s")
    if not err_unpacked < PACKED_BAR:
        raise AssertionError("packed output disagrees with unpacked")

    t0 = time.perf_counter()
    ext_bf16 = extractor(torch.bfloat16, "auto")
    out_bf16 = ext_bf16.forward_packed(wavs)
    bf16_states = out_bf16["hidden_states"] + [out_bf16["last_hidden_state"]]
    if not all(torch.isfinite(s.float()[valid]).all() for s in bf16_states):
        raise AssertionError("non-finite bf16 output")
    err_bf16 = worst(out_bf16, rel_l2)
    log("slice", f"bf16 vs f32, all hidden states: |d|_2/|ref|_2 "
        f"{err_bf16:.3e} (bar {BF16_SLICE_BAR:g}), max|d|/mean|ref| "
        f"{worst(out_bf16):.3e}, {time.perf_counter() - t0:.2f} s")
    if not err_bf16 < BF16_SLICE_BAR:
        raise AssertionError("bf16 output disagrees with f32")

    extractors = {
        ("f32", "kernel"): ext, ("f32", "dense"): ext_dense,
        ("bf16", "kernel"): ext_bf16,
        ("bf16", "dense"): extractor(torch.bfloat16, "dense"),
    }
    return by_dtype, extractors, wavs


def phase_timing(extractors, wavs, gpu: str):
    frames = sum(SERVE_LENGTHS)
    feats = {}
    for (tag, impl), ext in extractors.items():
        if tag not in feats:
            feats[tag] = ext.featurize(wavs)
        feat, pad_mask, lengths = feats[tag]
        end_to_end = cuda_ms(lambda: ext.forward_packed(wavs))
        encoder = cuda_ms(
            lambda: ext._pack_and_dispatch(feat, pad_mask, lengths))
        log("timing", f"forward_packed {tag} attn={impl}: "
            f"{frames / end_to_end * 1e3:.0f} frames/s from waveforms "
            f"({end_to_end:.2f} ms), {frames / encoder * 1e3:.0f} frames/s "
            f"from features ({encoder:.2f} ms), {frames} frames [{gpu}]")


def device_busy_us(events) -> float:
    """Length of the union of the events' device time intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def profile_calls(label: str, fn, gpu: str, calls: int = 3) -> None:
    """torch.profiler over ``calls`` calls of ``fn`` (after 2 warm-ups):
    device busy time per call, idle share against the CUDA-event wall
    time, the largest device kernels, and the port's own kernels with
    their share of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end) / calls
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        raise AssertionError("the profiler saw no device activity")
    busy = device_busy_us(device) / 1e3 / calls
    per_name = collections.Counter()
    for e in device:
        per_name[e.name] += e.time_range.elapsed_us() / 1e3 / calls
    top = "; ".join(f"{name[:72]} {ms:.2f} ms"
                    for name, ms in per_name.most_common(6))
    ours = "; ".join(
        f"{next(k for k in KERNEL_SYMBOLS if k in name)} {ms:.2f} ms "
        f"({ms / busy:.1%})" for name, ms in per_name.most_common()
        if any(k in name for k in KERNEL_SYMBOLS))
    log("profile", f"{label}: wall {wall:.2f} ms/call (profiler on), device "
        f"busy {busy:.2f} ms/call, idle {1 - busy / wall:.1%}; largest "
        f"device kernels per call: {top}; the port's kernels: "
        f"{ours or 'none'} [{gpu}]")


def phase_profile(extractors, wavs, gpu: str):
    """forward_packed from features, per path."""
    for (tag, impl), ext in extractors.items():
        feat, pad_mask, lengths = ext.featurize(wavs)
        profile_calls(f"forward_packed from features {tag} attn={impl}",
                      lambda: ext._pack_and_dispatch(feat, pad_mask, lengths),
                      gpu)


def phase_train_profile(runner, batch, gpu: str):
    """The bf16 grad step, with the kernels and with impl="dense", and the
    f32 grad step with the kernels."""
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )

    for dtype, impl in ((runner.compute_dtype, "auto"),
                        (runner.compute_dtype, "dense"),
                        (torch.float32, "auto")):
        step = make_melhubert_grad_step(
            runner.model, accum_steps=runner.accum_steps,
            compute_dtype=dtype, attn_impl=impl)
        tag = "f32" if dtype == torch.float32 else "bf16"
        profile_calls(f"grad step B=4 T=768 {tag} attn={impl}",
                      lambda: step(runner.params, batch, runner.rng), gpu)


def hubert_cfg(impl: str):
    """HuBERT-base from configs/hubert/config_model.yaml with the given
    conv_frontend_impl."""
    from speech_ssl_compression_tpu_torch.configs import hubert_config_from_yaml

    return dataclasses.replace(hubert_config_from_yaml(HUBERT_YAML),
                               conv_frontend_impl=impl)


def conv_layer_shapes(b: int, t_wave: int, conv_layers):
    """(B, T_in, C, K, O, stride) of the frontend layers the conv kernels
    take (both channel counts multiples of 128)."""
    shapes, t, c = [], t_wave, 1
    for dim, k, s in conv_layers:
        if c % 128 == 0 and dim % 128 == 0:
            shapes.append((b, t, c, k, dim, s))
        t, c = (t - k) // s + 1, dim
    return shapes


def conv_work(shape, dtype):
    """{kernel: (FLOPs, bytes)} at one layer shape: 2 B T_out K C O FLOPs
    each; bytes for every input read once and every output written once
    (dW written in f32)."""
    b, t, c, k, o, s = shape
    t_out = (t - k) // s + 1
    flops = 2.0 * b * t_out * k * c * o
    size = torch.tensor([], dtype=dtype).element_size()
    x, w, y = b * t * c * size, k * c * o * size, b * t_out * o * size
    return {"conv1d_fwd": (flops, x + w + y),
            "conv1d_dw": (flops, x + y + k * c * o * 4),
            "conv1d_dx": (flops, y + w + x)}


def halves_rounded(x, w, dy, stride):
    """The control of the bf16 conv check, (forward, dW, dX): the plain
    sums with the two halves of their reduction each rounded to bf16 before
    the final add (forward: channels; dW: time, or the batch where there is
    one output row; dX: outputs)."""
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    dt = x.dtype
    c, o = x.shape[2], w.shape[2]
    fwd = (tc.conv1d_strided_plain(x[..., :c // 2], w[:, :c // 2], stride)
           .float() + tc.conv1d_strided_plain(x[..., c // 2:],
                                              w[:, c // 2:], stride).float())
    dx = sum(tc.plain_grads(x, w[..., half], stride, dy[..., half])[0].float()
             for half in (slice(0, o // 2), slice(o // 2, o)))
    h = dy.shape[1] // 2
    k = w.shape[0]
    if h:
        x_lo = x[:, : (h - 1) * stride + k]
        dw = (tc.plain_grads(x_lo, w, stride, dy[:, :h])[1].float()
              + tc.plain_grads(x[:, h * stride:], w, stride,
                               dy[:, h:])[1].float())
    else:  # one output row: the halves of the batch
        h = x.shape[0] // 2
        dw = (tc.plain_grads(x[:h], w, stride, dy[:h])[1].float()
              + tc.plain_grads(x[h:], w, stride, dy[h:])[1].float())
    return fwd.to(dt), dw.to(dt), dx.to(dt)


def phase_conv(dev, gpu: str):
    """The three conv kernels against their plain version (and cuDNN's
    time) at the training batch's layer shapes, at T = 777 / 515 and at
    CONV_EDGE_CASES.
    Returns the record for the kernels line: per kernel the worst f32
    max |d| and, summed over the six training layers, kernel, plain,
    library and bound ms in f32 and (keys ending in _bf16) in bf16."""
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train = conv_layer_shapes(*HUBERT_TRAIN, hubert_cfg("tc_pallas")
                              .conv_feature_layers)
    cases = [(f"layer{i + 1}", s) for i, s in enumerate(train)]
    cases += [("t777", (2, 777, 512, 2, 512, 2)),
              ("t515", (2, 515, 512, 3, 512, 2)), *CONV_EDGE_CASES]
    names = ("conv1d_fwd", "conv1d_dw", "conv1d_dx")
    sums = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms")
    record = {n: dict(max_abs_err=0.0, **{k + sfx: 0.0 for k in sums
                                          for sfx in ("", "_bf16")})
              for n in names}
    gen = torch.Generator(device=dev).manual_seed(4)
    for name, shape in cases:
        b, t, c, k, o, s = shape
        for dtype in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            x = torch.randn((b, t, c), generator=gen, device=dev).to(dtype)
            w = (torch.randn((k, c, o), generator=gen, device=dev)
                 / (k * c) ** 0.5).to(dtype)
            got_y = tc.launch_fwd(x, w, s)
            dy = torch.randn(got_y.shape, generator=gen, device=dev).to(dtype)
            got = (got_y, tc.launch_dw(x, dy, k, s), tc.launch_dx(dy, w, t, s))
            torch.cuda.synchronize()
            last = (got_y.shape[1] - 1) * s + k
            tail_zero = bool((got[2][:, last:] == 0).all())
            tag = "f32" if dtype == torch.float32 else "bf16"
            if dtype == torch.float32:
                x64, w64, dy64 = x.double(), w.double(), dy.double()
                ref = ((tc.conv1d_strided_plain(x64, w64, s),)
                       + tuple(reversed(tc.plain_grads(x64, w64, s, dy64))))
                errs = [rel_err(got[0], ref[0], ...), rel_l2(got[1], ref[1], ...),
                        rel_err(got[2], ref[2], ...)]
                # the split-TF32 forward, dW and dX give the same bits again
                repeat = (torch.equal(tc.launch_fwd(x, w, s), got[0])
                          and torch.equal(tc.launch_dw(x, dy, k, s), got[1])
                          and torch.equal(tc.launch_dx(dy, w, t, s), got[2]))
                ok = max(errs) < CONV_F32_BAR and repeat
                detail = (f"fwd max|d|/mean|ref| {errs[0]:.3e}, dW rel L2 "
                          f"{errs[1]:.3e} (max|d|/mean|ref| "
                          f"{rel_err(got[1], ref[1], ...):.3e}), dX max|d|/"
                          f"mean|ref| {errs[2]:.3e} (bar {CONV_F32_BAR:g}); "
                          f"fwd, dW and dX bitwise repeatable: {repeat}")
                for n, g, r in zip(names, got, ref):
                    rec = record[n]
                    rec["max_abs_err"] = max(rec["max_abs_err"], float(
                        (g.double() - r).abs().max()))
            else:
                ref_y = tc.conv1d_strided_plain(x, w, s)
                ref_dx, ref_dw = tc.plain_grads(x, w, s, dy)
                ref = (ref_y, ref_dw, ref_dx)
                # the tensor-core forward, dW and dX give the same bits again
                repeat = (torch.equal(tc.launch_fwd(x, w, s), got[0])
                          and torch.equal(tc.launch_dw(x, dy, k, s), got[1])
                          and torch.equal(tc.launch_dx(dy, w, t, s), got[2]))
                got = (got[0], got[1].to(dtype), got[2])
                diffs = [bf16_diff(g, r, ...) for g, r in zip(got, ref)]
                ctl = [bf16_diff(cc, r, ...)[0]
                       for cc, r in zip(halves_rounded(x, w, dy, s), ref)]
                ok = repeat and all(u <= BF16_ULP_BAR and sh < BF16_SHARE_BAR
                                    for sh, u in diffs)
                detail = ", ".join(
                    f"{n[7:]} differ {sh:.3%} max {u:g} ulp (control "
                    f"{cs:.2%})" for n, (sh, u), cs in zip(names, diffs, ctl))
                detail += (f"; bars {BF16_SHARE_BAR:.0%}, {BF16_ULP_BAR:g} "
                           f"ulp; fwd, dW and dX bitwise repeatable: "
                           f"{repeat}")
                if not all(cs >= BF16_SHARE_BAR for cs in ctl):
                    raise AssertionError(
                        f"bf16 conv check at {name} cannot tell kernels that "
                        "round inside their sums apart")
            finite = all(torch.isfinite(g.float()).all() for g in got)
            log("conv", f"{name} {tag} x{(b, t, c)} K={k} s={s} O={o}: "
                f"kernels vs plain, {detail}; dX zero past row {last}: "
                f"{tail_zero}, {time.perf_counter() - t0:.2f} s")
            if not (ok and finite and tail_zero):
                raise AssertionError(f"conv kernels disagree at {name} {tag}")
            if name.startswith("layer"):
                conv_timing(shape, x, w, dy, tag, record, gpu)
    for n in names:
        rec = record[n]
        for sfx, tag in (("", "f32"), ("_bf16", "bf16")):
            rec["bound_by" + sfx] = (
                "operations" if rec.pop("ops_ms" + sfx) >= rec["bound_ms" + sfx]
                else "bytes")
            log("timing", f"{n}, HuBERT frontend layers 1-6 at B="
                f"{HUBERT_TRAIN[0]} x {HUBERT_TRAIN[1]} samples, {tag} summed: "
                f"kernel {rec['ms' + sfx]:.3f} ms, plain "
                f"{rec['plain_ms' + sfx]:.3f} ms, cuDNN "
                f"{rec['library_ms' + sfx]:.3f} ms, bound "
                f"{rec['bound_ms' + sfx]:.3f} ms ({rec['bound_by' + sfx]}) "
                f"[{gpu}]")
    return record


def conv_timing(shape, x, w, dy, tag, record, gpu: str):
    """CUDA-event times at one layer shape: each kernel against its plain
    version (dW and dX: autograd through the plain forward, which that
    includes) in turns, and cuDNN's call for the same function on the
    (B, C, T) / (O, C, K) layout (the transposes are made beforehand).
    Times and bounds add into ``record``, bf16's under keys ending in
    _bf16."""
    from torch.nn.grad import conv1d_input, conv1d_weight
    import torch.nn.functional as F
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    b, t, c, k, o, s = shape
    x_nct = x.transpose(1, 2).contiguous()
    w_oik = w.permute(2, 1, 0).contiguous()
    dy_nct = dy.transpose(1, 2).contiguous()

    def plain_grad(wrt):
        def run():
            with torch.enable_grad():
                xx = x.detach().requires_grad_(wrt == "x")
                ww = w.detach().requires_grad_(wrt == "w")
                y = tc.conv1d_strided_plain(xx, ww, s)
                return torch.autograd.grad(y, xx if wrt == "x" else ww, dy)
        return run

    runs = {
        "conv1d_fwd": (lambda: tc.launch_fwd(x, w, s),
                       lambda: tc.conv1d_strided_plain(x, w, s),
                       lambda: F.conv1d(x_nct, w_oik, stride=s)),
        "conv1d_dw": (lambda: tc.launch_dw(x, dy, k, s), plain_grad("w"),
                      lambda: conv1d_weight(x_nct, w_oik.shape, dy_nct,
                                            stride=s)),
        "conv1d_dx": (lambda: tc.launch_dx(dy, w, t, s), plain_grad("x"),
                      lambda: conv1d_input(x_nct.shape, w_oik, dy_nct,
                                           stride=s)),
    }
    work = conv_work(shape, x.dtype)
    for name, (kernel, plain, library) in runs.items():
        kernel_ms, plain_ms = alternate(kernel, plain, inner=3)
        library_ms = cuda_ms(library, inner=3)
        bound_ms, by = bound(*work[name], x.dtype)
        log("timing", f"{name} {tag} x{(b, t, c)} K={k} s={s}: kernel "
            f"{kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN "
            f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({by}) [{gpu}]")
        rec, sfx = record[name], "" if tag == "f32" else "_bf16"
        rec["ms" + sfx] += kernel_ms
        rec["plain_ms" + sfx] += plain_ms
        rec["library_ms" + sfx] += library_ms
        rec["bound_ms" + sfx] += bound_ms
        rec["ops_ms" + sfx] += work[name][0] / PEAK_FLOPS[x.dtype] * 1e3


def launch_counts():
    """Every kernel's launch count, attention and conv."""
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    return {**fa.launch_counts, **tc.launch_counts}


def dtype_launch_counts():
    """Every kernel's launch count per input dtype: {name: {"f32": n,
    "bf16": n}}, a copy."""
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    return {name: dict(counts) for name, counts in
            {**fa.dtype_launch_counts, **tc.dtype_launch_counts}.items()}


def reset_launch_counts():
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    fa.reset_launch_counts()
    tc.reset_launch_counts()


def hubert_source(b: int, t_wave: int, seed: int):
    """(source (B, T) f32 normal noise, as train/wave_bench.py makes it,
    host lengths): the rows are cut to a mix of lengths, zero past each."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((b, t_wave)).astype(np.float32)
    lengths = np.full(b, t_wave, np.int64)
    lengths[1::2] = t_wave - rng.integers(t_wave // 32, t_wave // 2, b // 2)
    src[np.arange(t_wave)[None, :] >= lengths[:, None]] = 0.0
    return src, lengths


def phase_hubert_serve(dev, gpu: str):
    """HuBERT-base extraction at the bench's batch: returns the launch
    counts of the one main-path call per dtype."""
    import copy

    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.models.hubert import hubert_forward
    from speech_ssl_compression_tpu_torch.utils.weights import (
        init_hubert_params_np, load_hubert_model,
    )

    t0 = time.perf_counter()
    cfg = hubert_cfg("tc_pallas")
    params = init_hubert_params_np(cfg, (HUBERT_CLASSES,), seed=0)
    models = {"kernels": load_hubert_model(params, cfg),
              "cudnn": load_hubert_model(
                  params, dataclasses.replace(cfg, conv_frontend_impl="auto"))}
    for m in models.values():
        m.to(dev).eval().requires_grad_(False)
    b, t_wave = HUBERT_SERVE
    src_np, lengths = hubert_source(b, t_wave, seed=0)
    src = torch.from_numpy(src_np).to(dev)
    n_params = sum(p.numel() for p in models["kernels"].parameters())
    log("hubert serve", f"HuBERT-base {cfg.encoder_layers}L/"
        f"{cfg.encoder_embed_dim}, {n_params} params, {b} x {t_wave} samples "
        f"(lengths {lengths.tolist()}), {time.perf_counter() - t0:.2f} s")

    def run(model, dtype=torch.float32):
        with matmul_precision("highest"), torch.inference_mode():
            return hubert_forward(model, src.to(dtype), lengths, mask=False,
                                  features_only=True)

    # the main path: counts from exactly one hubert_forward call
    t0 = time.perf_counter()
    reset_launch_counts()
    out = run(models["kernels"])
    torch.cuda.synchronize()
    counts = launch_counts()
    by_dtype = dtype_launch_counts()
    want = dict(conv1d_fwd=len(conv_layer_shapes(b, t_wave,
                                                 cfg.conv_feature_layers)),
                flash_attn_fwd=cfg.encoder_layers)
    log("hubert serve", f"hubert_forward(features_only=True) f32: x "
        f"{tuple(out['x'].shape)}, launches {counts} (expected {want}, the "
        f"rest 0), {time.perf_counter() - t0:.2f} s")
    if counts != {**dict.fromkeys(counts, 0), **want}:
        raise AssertionError(f"hubert serve launches {counts}")
    valid = ~out["padding_mask"]
    frames = int(valid.sum())
    if not all(torch.isfinite(out[k].float()[valid]).all()
               for k in ("x", "features")):
        raise AssertionError("non-finite HuBERT output")

    ref = run(models["cudnn"])
    errs = {k: rel_err(out[k], ref[k], valid) for k in ("x", "features")}
    log("hubert serve", f"conv kernels vs cuDNN (f32, TF32 off), valid "
        f"frames: encoder output max|d|/mean|ref| {errs['x']:.3e}, frontend "
        f"features {errs['features']:.3e} (bar {SLICE_BAR:g})")
    if not max(errs.values()) < SLICE_BAR:
        raise AssertionError("HuBERT with the conv kernels disagrees with cuDNN")

    for name in list(models):
        models[name + " bf16"] = copy.deepcopy(models[name]).to(torch.bfloat16)
    out_bf16 = run(models["kernels bf16"], torch.bfloat16)
    err_bf16 = rel_l2(out_bf16["x"], out["x"], valid)
    log("hubert serve", f"bf16 vs f32, encoder output: |d|_2/|ref|_2 "
        f"{err_bf16:.3e} (bar {BF16_SLICE_BAR:g})")
    if not (err_bf16 < BF16_SLICE_BAR
            and torch.isfinite(out_bf16["x"].float()[valid]).all()):
        raise AssertionError("HuBERT bf16 output disagrees with f32")
    del out, ref, out_bf16

    for dtype in (torch.float32, torch.bfloat16):
        tag = "" if dtype == torch.float32 else " bf16"
        k_ms, c_ms = alternate(lambda: run(models["kernels" + tag], dtype),
                               lambda: run(models["cudnn" + tag], dtype))
        log("timing", f"hubert_forward {dtype} B={b} x {t_wave} samples: "
            f"conv kernels {k_ms:.2f} ms ({frames / k_ms * 1e3:.0f} frames/s)"
            f", cuDNN {c_ms:.2f} ms ({frames / c_ms * 1e3:.0f} frames/s), "
            f"{frames} valid frames [{gpu}]")
    return by_dtype


def write_wav_dataset(root: pathlib.Path, n_utts: int, min_samples: int,
                      seed: int = 0):
    """A HuBERT pre-training set as tests/test_wave_runner.py builds one: a
    TSV manifest of 16 kHz WAVs up to 2 s longer than ``min_samples`` (the
    crop), train.km with 50 Hz labels < 500 and dict.km.txt."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    lines, labels = [], []
    for i in range(n_utts):
        n = min_samples + int(rng.integers(0, 32000))
        pcm = (rng.uniform(-0.3, 0.3, n) * 32767).astype(np.int16)
        wavfile.write(root / f"u{i}.wav", 16000, pcm)
        lines.append(f"u{i}.wav\t{n}")
        labels.append(" ".join(map(str, rng.integers(0, 500, n // 320))))
    (root / "train.tsv").write_text(f"{root}\n" + "\n".join(lines) + "\n")
    (root / "train.km").write_text("\n".join(labels) + "\n")
    (root / "dict.km.txt").write_text("".join(f"{c} 1\n" for c in range(500)))


HUBERT_RUNNER_YAML = """runner:
  total_steps: 3
  gradient_clipping: 10.0
  gradient_accumulate_steps: {accum}
  log_step: 1
  save_every_x_epochs: 10
  bf16: true
optimizer:
  lr: 0.0005
  betas:
  - 0.9
  - 0.98
  eps: 1.0e-06
  weight_decay: 0.01
datarc:
  train_batch_size: {batch}
task:
  data: {data}
  labels:
  - km
  label_rate: 50
  sample_rate: 16000
  max_sample_size: {samples}
  min_sample_size: 32000
  pad_audio: false
  random_crop: true
"""


def hubert_bench_batch(runner, dev, seed: int = 0):
    """The bench recipe's batch (train/wave_bench.py): B x 245,760 samples
    of normal noise, full lengths, uniform random targets."""
    from speech_ssl_compression_tpu_torch.models.conv_frontend import (
        conv_output_length,
    )

    b, t_wave = HUBERT_TRAIN
    rng = np.random.default_rng(seed)
    t_frames = conv_output_length(t_wave, runner.cfg.conv_feature_layers)
    return {
        "source": torch.from_numpy(rng.standard_normal((b, t_wave))
                                   .astype(np.float32)).to(dev),
        "length": np.full(b, t_wave),
        "target_list": [torch.from_numpy(rng.integers(
            0, runner.num_classes[0], (b, t_frames))).to(dev)],
        "target_valid": torch.ones((b, t_frames), dtype=torch.bool,
                                   device=dev),
    }


def phase_hubert_train(dev, gpu: str, tmp: str):
    """HuBERT-base pre-training through the trainer's entry point, then the
    checks on its model. Returns (runner, launch counts of the run per
    dtype, the cuDNN-route model, the bench batch)."""
    from speech_ssl_compression_tpu_torch.configs import HuBERTConfig
    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.models.hubert import (
        HuBERTModel, span_mask,
    )
    from speech_ssl_compression_tpu_torch.train.__main__ import main as train
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_hubert_grad_step,
    )
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import load_hubert_model

    t0 = time.perf_counter()
    b, t_wave = HUBERT_TRAIN
    root = pathlib.Path(tmp) / "hubert"
    write_wav_dataset(root / "data", 3 * HUBERT_ACCUM * b, t_wave)
    # the model config as shipped, with the kernel route and without
    # LayerDrop, so that every grad step runs all 12 layers' kernels
    text = HUBERT_YAML.read_text()
    if "encoder_layerdrop: 0.05" not in text:
        raise AssertionError(f"{HUBERT_YAML} changed: update this phase")
    model_yaml = root / "config_model.yaml"
    model_yaml.write_text(text.replace("encoder_layerdrop: 0.05",
                                       "encoder_layerdrop: 0.0")
                          + "  conv_frontend_impl: tc_pallas\n")
    runner_yaml = root / "config_runner.yaml"
    runner_yaml.write_text(HUBERT_RUNNER_YAML.format(
        accum=HUBERT_ACCUM, batch=b, data=root / "data", samples=t_wave))
    expdir = root / "exp"
    log("hubert train", f"synthetic set written ({3 * HUBERT_ACCUM * b} "
        f"WAVs, labels < 500), {time.perf_counter() - t0:.2f} s")

    # the main path: counts from exactly one run of the trainer
    t0 = time.perf_counter()
    reset_launch_counts()
    runner = train(["-m", "melhubert", "-u", "hubert", "-g", str(model_yaml),
                    "-c", str(runner_yaml), "-n", str(expdir), "--device",
                    str(dev), "--seed", "0"])
    torch.cuda.synchronize()
    counts = launch_counts()
    by_dtype = dtype_launch_counts()
    cfg = runner.cfg
    steps = 3 * runner.accum_steps
    per_step = {k: v / steps for k, v in counts.items()}
    n_conv = len(conv_layer_shapes(b, t_wave, cfg.conv_feature_layers))
    want = {**dict.fromkeys(("conv1d_fwd", "conv1d_dw", "conv1d_dx"), n_conv),
            **dict.fromkeys(("flash_attn_fwd", "flash_attn_bwd_dq",
                             "flash_attn_bwd_dkv"), cfg.encoder_layers)}
    log("hubert train", f"HuBERT-base {cfg.encoder_layers}L/"
        f"{cfg.encoder_embed_dim}, {runner.num_classes[0]} classes, "
        f"{runner.compute_dtype}, 3 updates x {runner.accum_steps} "
        f"micro-batches of {b} x {t_wave} samples: launches per grad step "
        f"{per_step} (expected {want}), {time.perf_counter() - t0:.2f} s")
    if per_step != want:
        raise AssertionError(f"hubert train launches {counts}")
    hist = runner.log_history
    for entry in hist:
        log("hubert train", f"update {entry['step']}: loss {entry['loss']:.6f}"
            f", grad norm {entry['grad_norm']:.6f}")
    if [e["step"] for e in hist] != [1, 2, 3] or not all(
            np.isfinite([e["loss"], e["grad_norm"]]).all() for e in hist):
        raise AssertionError(f"trainer log {hist}")

    state = load_checkpoint(str(expdir / "last-step.npz"))
    back = load_hubert_model(state["params"],
                             HuBERTConfig.from_dict(state["meta"]["Config"]))
    same = all(torch.equal(v, runner.params[k].detach().cpu())
               for k, v in back.named_parameters())
    log("hubert train", f"last-step.npz read back: Step "
        f"{state['meta']['Step']}, weights equal to the trainer's: {same}")
    if not (same and state["meta"]["Step"] == 3):
        raise AssertionError("HuBERT checkpoint does not read back")

    # kernels vs cuDNN + dense attention: f32, TF32 off, no dropout, one
    # fixed span mask, the bench recipe's batch; both against that plain
    # route run in float64
    t0 = time.perf_counter()
    batch = hubert_bench_batch(runner, dev)
    t_frames = batch["target_valid"].shape[1]
    mask = torch.from_numpy(span_mask(cfg, np.full(b, t_frames), t_frames,
                                      np.random.default_rng(0))).to(dev)
    cudnn_model = HuBERTModel(dataclasses.replace(
        cfg, conv_frontend_impl="auto"), runner.num_classes).to(dev)
    results = {}
    for name, model, impl, dtype in (
            ("kernels", runner.model, "auto", torch.float32),
            ("cudnn+dense", cudnn_model, "dense", torch.float32),
            ("cudnn+dense f64", cudnn_model, "dense", torch.float64)):
        step = make_hubert_grad_step(model, attn_impl=impl, deterministic=True,
                                     compute_dtype=dtype)
        reset_launch_counts()
        with matmul_precision("highest"):
            loss, n, grads, _ = step(runner.params, batch, torch.Generator(),
                                     mask_indices=mask)
        torch.cuda.synchronize()
        results[name] = (float(loss), int(n), grads, launch_counts())
    (loss_k, n_k, grads_k, counts_k), (loss_d, n_d, grads_d, counts_d), (
        loss_64, n_64, grads_64, counts_64) = results.values()
    names = list(runner.params)

    def compare(loss, grads, ref_loss, ref_grads):
        errs = grad_errors(names, grads, ref_grads)
        worst = int(np.argmax(errs))
        return (abs(loss - ref_loss) / abs(ref_loss), errs[worst],
                names[worst])

    k64, d64, kd = (compare(loss_k, grads_k, loss_64, grads_64),
                    compare(loss_d, grads_d, loss_64, grads_64),
                    compare(loss_k, grads_k, loss_d, grads_d))
    log("hubert train", f"grad step (TF32 off, dropout off, fixed span mask, "
        f"{n_k} masked frames), loss rel and worst of {len(names)} "
        f"gradients rel L2: kernels vs cuDNN + impl='dense' in float64 "
        f"{k64[0]:.3e}, {k64[1]:.3e} ({k64[2]}), bar {GRAD_BAR:g}; the f32 "
        f"cuDNN + dense route vs float64 {d64[0]:.3e}, {d64[1]:.3e} "
        f"({d64[2]}); kernels vs the f32 cuDNN + dense route {kd[0]:.3e}, "
        f"{kd[1]:.3e} ({kd[2]}), bar {GRAD_BAR:g}; losses {loss_k:.6f}, {loss_d:.6f}, "
        f"{loss_64:.6f}; launches {counts_k}, {counts_d}, {counts_64}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not (max(k64[:2]) < GRAD_BAR and max(kd[:2]) < GRAD_BAR
            and n_k == n_d == n_64):
        raise AssertionError("HuBERT kernel gradients disagree with the "
                             "plain route (float64 or f32)")
    if (counts_k != want or any(counts_d.values())
            or any(counts_64.values())):
        raise AssertionError("the HuBERT parity run took the wrong path")
    del results, grads_k, grads_d, grads_64
    return runner, by_dtype, cudnn_model, batch


def phase_hubert_train_timing(runner, cudnn_model, batch, gpu: str):
    """CUDA-event medians at the bench recipe: the grad step and one update
    (HUBERT_ACCUM grad steps + apply) with the conv kernels and with cuDNN,
    f32 (TF32 off) and bf16, dropout on."""
    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.train.steps import (
        accumulate_grads, make_hubert_grad_step,
    )

    b, t_wave = HUBERT_TRAIN
    frames = int(batch["target_valid"].sum())
    models = {"conv kernels": runner.model, "cuDNN": cudnn_model}
    for dtype in (torch.float32, torch.bfloat16):
        steps = {name: make_hubert_grad_step(
            m, accum_steps=HUBERT_ACCUM, compute_dtype=dtype)
            for name, m in models.items()}

        def grad(name):
            return lambda: steps[name](runner.params, batch, runner.rng)

        def update(name):
            def run():
                acc, total = None, 0
                for _ in range(HUBERT_ACCUM):
                    _, n, grads, _ = steps[name](runner.params, batch,
                                                 runner.rng)
                    acc = accumulate_grads(acc, grads)
                    total = total + n
                runner.apply(acc, torch.clamp_min(total.float(), 1.0))
            return run

        with matmul_precision("highest"):
            k_ms, c_ms = alternate(grad("conv kernels"), grad("cuDNN"))
            ku_ms, cu_ms = alternate(update("conv kernels"), update("cuDNN"))
        log("timing", f"HuBERT grad step B={b} x {t_wave} samples {dtype}: "
            f"conv kernels {k_ms:.2f} ms, cuDNN {c_ms:.2f} ms; one update "
            f"({HUBERT_ACCUM} grad steps + apply): conv kernels {ku_ms:.2f} ms"
            f" ({1e3 / ku_ms:.3f} updates/s, "
            f"{HUBERT_ACCUM * frames / ku_ms * 1e3:.0f} frames/s), cuDNN "
            f"{cu_ms:.2f} ms ({1e3 / cu_ms:.3f} updates/s) [{gpu}]")


def phase_hubert_profile(runner, cudnn_model, batch, gpu: str):
    """The bf16 HuBERT grad step with the conv kernels and with cuDNN."""
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_hubert_grad_step,
    )

    for name, model in (("conv kernels", runner.model),
                        ("cuDNN", cudnn_model)):
        step = make_hubert_grad_step(model, accum_steps=HUBERT_ACCUM,
                                     compute_dtype=torch.bfloat16)
        profile_calls(f"HuBERT grad step bf16 {name}",
                      lambda: step(runner.params, batch, runner.rng), gpu)


def attention_library_ms(dev, gpu: str, dtype):
    """F.scaled_dot_product_attention's times in ``dtype`` (f32 with TF32
    off), the flash kernels' library yardstick (timed here, never called by
    the port): {(kernel, case): ms}. The forward at the serving shape with
    the packed segments as a boolean mask, at the training shape with key
    padding and dropout 0.1 (its own random mask), at T = 5000 and at
    1024 x 5000 with key padding; the backward (dq, dk and dv in one call,
    the yardstick of the dQ and dK/dV pair) at the training shape with key
    padding and dropout 0.1, at T = 5000 and at 1024 x 5000."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(5)
    seg = packed_segments(SERVE_LENGTHS, CAPACITY, dev)

    def randn(shape, grad=False):
        return (torch.randn(shape, generator=gen, device=dev).to(dtype)
                .requires_grad_(grad))

    def keep(pad):  # (B, Tk) padding -> a mask that keeps the valid keys
        return ~pad[:, None, None, :]

    pad_rect = rect_padding(dev)
    cases = {
        "serving": ((seg.shape[0], 12, CAPACITY, 64), None,
                    (seg[:, None, :, None] == seg[:, None, None, :])
                    & (seg != 0)[:, None, None, :], 0.0),
        "training_dropout": (TRAIN_SHAPE, None, keep(train_padding(dev)),
                             DROPOUT_P),
        "long": ((1, 12, 5000, 64), None, None, 0.0),
        "rectangular": ((1, 12, 1024, 64), (1, 12, 5000, 64), keep(pad_rect),
                        0.0),
    }
    out = {}
    for case, (qs, ks, mask, p) in cases.items():
        q = randn(qs, True)
        k, v = randn(ks or qs, True), randn(ks or qs, True)

        def fwd():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  dropout_p=p)

        with torch.no_grad():
            out["flash_attn_fwd", case] = cuda_ms(fwd, inner=5)
        if case == "serving":
            continue
        o = fwd()
        dout = randn(qs)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), dout,
                                                     retain_graph=True),
                         inner=5)
        out["flash_attn_bwd_dq", case] = out["flash_attn_bwd_dkv", case] = (
            bwd_ms)
        del o, q, k, v, dout
    log("timing", f"F.scaled_dot_product_attention {dtype}: " + ", ".join(
        f"{'forward' if n == 'flash_attn_fwd' else 'backward'} at {c} "
        f"{ms:.3f} ms" for (n, c), ms in out.items()
        if n != "flash_attn_bwd_dkv") + f" [{gpu}]")
    return out


def attention_work(q_shape, tk: int, pairs: float, dtype,
                   segments: bool = False) -> dict:
    """{kernel: (FLOPs, bytes)} of the forward, dQ and dK/dV kernels for q
    (B, H, Tq, d) against tk keys, where ``pairs`` (query, key) pairs per
    head, summed over the batch, survive the masks: 4 d (QK^T and PV),
    6 d (QK^T, dO V^T, dS K) and 8 d (and dS^T Q, Pd^T dO) FLOPs per pair
    and head. Bytes: every input read once and every output written once,
    q/k/v/dO/out and their gradients in ``dtype``, the bias, LSE and D in
    f32, segment ids in int32."""
    b, h, tq, d = q_shape
    size = torch.tensor([], dtype=dtype).element_size()
    q_t, k_t = b * h * tq * d * size, b * h * tk * d * size
    row_f32, key_f32 = b * h * tq * 4, b * tk * 4  # LSE or D; the bias
    masks = key_f32 + (4 * b * (tq + tk) if segments else 0)
    return {"flash_attn_fwd": (4 * d * h * pairs,
                               2 * q_t + 2 * k_t + masks + row_f32),
            "flash_attn_bwd_dq": (6 * d * h * pairs,
                                  3 * q_t + 2 * k_t + masks + 2 * row_f32),
            "flash_attn_bwd_dkv": (8 * d * h * pairs,
                                   2 * q_t + 4 * k_t + masks + 2 * row_f32)}


def attention_bounds(dtype) -> dict:
    """{(kernel, case): (ms, bound_by)} of the flash kernels in ``dtype`` at
    the line's shapes: the forward at the serving batch, counting only the
    (query, key) pairs of one segment; every kernel at the training shape
    (every query row against the valid keys), at T = 5000 (every pair) and
    at 1024 x 5000 (every query against the 4,800 valid keys)."""
    seg = packed_segments(SERVE_LENGTHS, CAPACITY, "cpu")
    serving = (seg.shape[0], 12, CAPACITY, 64)
    work = {
        "serving": attention_work(serving, CAPACITY,
                                  float(sum(n * n for n in SERVE_LENGTHS)),
                                  dtype, segments=True),
        "training_dropout": attention_work(
            TRAIN_SHAPE, TRAIN_SHAPE[2],
            float(TRAIN_SHAPE[2] * sum(TRAIN_LENGTHS)), dtype),
        "long": attention_work((1, 12, 5000, 64), 5000, 5000.0 * 5000, dtype),
        "rectangular": attention_work((1, 12, 1024, 64), 5000,
                                      1024.0 * RECT_VALID_KEYS, dtype),
    }
    out = {}
    for case, per_kernel in work.items():
        for name, (flops, n_bytes) in per_kernel.items():
            if case == "serving" and name != "flash_attn_fwd":
                continue
            out[name, case] = bound(flops, n_bytes, dtype)
    return out


def launch_fields(name: str, paths: dict) -> dict:
    """A kernel's launches on the main paths, from {path: {kernel: {"f32":
    n, "bf16": n}}}: in all (launches), per dtype (launches_by_dtype) and
    per path and dtype (launches_by_path)."""
    by_path = {p: dict(counts.get(name, {"f32": 0, "bf16": 0}))
               for p, counts in paths.items()}
    by_dtype = {tag: sum(c[tag] for c in by_path.values())
                for tag in ("f32", "bf16")}
    return dict(launches=sum(by_dtype.values()), launches_by_dtype=by_dtype,
                launches_by_path=by_path)


def merge(into: dict, more: dict) -> None:
    """Adds the fields of ``more``'s records to ``into``'s, key by key."""
    for key, fields in more.items():
        into.setdefault(key, {}).update(fields)


def check_tensor_cores(kernels) -> dict:
    """HGMMA instructions (Hopper's warpgroup tensor-core products) per
    kernel of the built library, from cuobjdump -sass; fails unless every
    instance of each TENSOR_CORE_KERNELS kernel (the attention forward, dQ
    and dK/dV and the conv forward, dW and dX, bf16 and f32) has some.
    Returns {(kernel, "bf16" or "f32"): count, summed over its instances
    (the attention forwards have four: with and without dropout, with and
    without segment ids)}."""
    counts = kernels.sass_instruction_counts("HGMMA")
    for symbol, n in counts.items():
        short = next((k for k in KERNEL_SYMBOLS if k in symbol), symbol[:80])
        flags = re.search(r"ILb([01])ELb([01])E", symbol)
        if "I13__nv_bfloat16" in symbol:
            short += "<bf16>"
        elif "IfE" in symbol:
            short += "<f32>"
        elif flags:  # the bf16 forward's <dropout, segments>
            short += "<{}, {}>".format(
                *(("no " if f == "0" else "") + what for f, what in
                  zip(flags.groups(), ("dropout", "segments"))))
        log("build", f"SASS: {n} HGMMA in {short}")
    out = {}
    for (name, tag), symbol in TENSOR_CORE_KERNELS.items():
        found = [n for sym, n in counts.items() if symbol in sym]
        if not found or not all(found):
            raise AssertionError(f"{symbol} has no HGMMA instruction: the "
                                 f"{tag} {name} does not run on the tensor "
                                 "cores")
        out[name, tag] = sum(found)
    return out


def attention_entry(name: str, record: dict, bounds: dict,
                    library: dict) -> dict:
    """The kernels-line entry of one flash kernel: at its main case (the
    serving batch for the forward, the training shape with dropout for the
    backward) its f32 numbers and, under keys ending in _bf16, its bf16
    ones; every other timed case under "cases", per dtype."""
    def numbers(case, dtype, tag):
        ms, by = bounds[dtype][name, case]
        return dict(record[name, case, tag], bound_ms=ms, bound_by=by,
                    library_ms=library[dtype].get((name, case)))

    main = "serving" if name == "flash_attn_fwd" else "training_dropout"
    entry = dict(name=name, source=ATTN_SOURCES[name],
                 replaces=ATTN_REPLACES[name],
                 **numbers(main, torch.float32, "f32"))
    entry.update({k + "_bf16": v for k, v in
                  numbers(main, torch.bfloat16, "bf16").items()})
    entry["cases"] = {
        case: {tag: numbers(case, dtype, tag) for dtype, tag in
               ((torch.float32, "f32"), (torch.bfloat16, "bf16"))}
        for case in TIMED_CASES
        if case != main and (name, case, "f32") in record
        and "ms" in record[name, case, "f32"]}
    return entry


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile forward_packed per path and the "
                        "grad step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from speech_ssl_compression_tpu_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    gpu = gpu_name_and_power()
    print(f"gpu: {gpu}", flush=True)

    t0 = time.perf_counter()
    lib = _kernels.build()
    _kernels.load()
    log("build", f"nvcc {' '.join(_kernels.NVCC_FLAGS)} -> {lib.name}, "
        f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in "
        f"parallel)")
    for line in _kernels.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("build", line.strip())
    hgmma = check_tensor_cores(_kernels)

    record = phase_kernels(dev, gpu)
    merge(record, phase_backward(dev, gpu))
    conv = phase_conv(dev, gpu)
    library = {dtype: attention_library_ms(dev, gpu, dtype)
               for dtype in (torch.float32, torch.bfloat16)}
    with tempfile.TemporaryDirectory() as tmp:
        serve, extractors, wavs = phase_slice(dev, gpu, tmp)
        phase_timing(extractors, wavs, gpu)
        if args.profile:
            phase_profile(extractors, wavs, gpu)
        del extractors
        runner, batch, train = phase_train(dev, gpu, tmp)
        merge(record, phase_train_timing(runner, batch, gpu))
        if args.profile:
            phase_train_profile(runner, batch, gpu)
        del runner, batch
        hubert_serve = phase_hubert_serve(dev, gpu)
        runner, hubert_train, cudnn_model, batch = phase_hubert_train(
            dev, gpu, tmp)
        phase_hubert_train_timing(runner, cudnn_model, batch, gpu)
        if args.profile:
            phase_hubert_profile(runner, cudnn_model, batch, gpu)

    # launches of each kernel on each main path per dtype, counted from 0
    # just before the path ran and read just after
    paths = {"melhubert serve": serve, "melhubert train": train,
             "hubert serve": hubert_serve, "hubert train": hubert_train}
    bounds = {dtype: attention_bounds(dtype)
              for dtype in (torch.float32, torch.bfloat16)}
    entries = [attention_entry(name, record, bounds, library)
               for name in ("flash_attn_fwd", "flash_attn_bwd_dq",
                            "flash_attn_bwd_dkv")]
    for e in entries:
        e["source_bf16"] = (FWD_SM90_SOURCE if e["name"] == "flash_attn_fwd"
                            else BWD_SM90_SOURCE)
    entries += [dict(name=name, source=CONV_SOURCES[name],
                     replaces=CONV_REPLACES[name], **conv[name],
                     source_bf16=CONV_SM90_SOURCE)
                for name in ("conv1d_fwd", "conv1d_dw", "conv1d_dx")]
    for e in entries:
        e["hgmma"] = hgmma.get((e["name"], "f32"), 0)
        e["hgmma_bf16"] = hgmma.get((e["name"], "bf16"), 0)
        e.update(route="cuda", **launch_fields(e["name"], paths))
    assert set(launch_counts()) == {e["name"] for e in entries}
    missing = [e["name"] for e in entries if not e["launches"]]
    if missing:
        raise AssertionError(f"kernels no main path launched: {missing}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
