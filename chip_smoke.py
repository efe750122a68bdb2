#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the quickest proof that
the port still builds, starts and is right on the card.

    python3 chip_smoke.py            # from the repo root; needs one CUDA device
    python3 chip_smoke.py --profile  # also: torch.profiler device time per
                                     # forward_packed call, per kernel

Phases (any failure raises, and the script exits non-zero without a
result line):
  build     compile csrc/ with nvcc (speech_ssl_compression_tpu_torch/ops/
            _kernels.py) and print the build time;
  kernels   the flash-attention CUDA kernel against its plain PyTorch
            version on the card, TF32 off, f32 and bf16, at the shapes the
            serving path and the long/rectangular/causal paths give it;
  slice     MelHuBERT-20ms at full width (12 layers, 768 wide, seeded random
            weights written as an npz checkpoint and read back through
            load_any_checkpoint) serves 16 synthetic utterances through
            MelHuBERTExtractor.forward_packed: launch counts, the dense
            path, the unpacked path, bf16 against f32;
  timing    CUDA-event medians of 3 after a warm-up: the kernel against its
            plain version at the serving shape, and serve-batch frames/s
            with the kernel and with impl="dense", f32 and bf16;
  profile   (--profile only) device busy time, idle share and the largest
            device kernels of forward_packed from features, per path.

The bf16 kernel check. Kernel and plain version both round their output to
bf16, so the two may differ by one bf16 ulp wherever the f32 results
straddle a rounding point. The plain version runs with the kernel's key
tiles (block_k), so a bf16 P is rounded at the same points, and the check
asks that every valid entry be within one ulp (of max(|ref|, mean |ref|))
and that fewer than BF16_SHARE_BAR of them differ at all. A control, the
same plain version with P left in f32, must fail that share, or the check
could not see the rounding of P and the script fails.

The line before the last holds the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
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
FA_SOURCE = "speech_ssl_compression_tpu_torch/csrc/flash_attn_fwd.cu"
FA_REPLACES = "speech_ssl_compression_tpu/ops/flash_attention.py:66"
# stacked 20 ms frame counts of the two bundled LibriSpeech utterances that
# bench.py tiles into its 16-utterance serve batch
SERVE_LENGTHS = (101,) * 8 + (792,) * 8
CAPACITY = 896  # pack row width those lengths give (792 rounded up to 128)
F32_BAR, LSE_BAR = 1e-4, 1e-4  # max |d| / mean |ref|; lse max |d|
BF16_ULP_BAR = 1.0     # max |d| in bf16 ulps of max(|ref|, mean |ref|)
BF16_SHARE_BAR = 0.03  # share of valid bf16 outputs that differ at all
SLICE_BAR, PACKED_BAR, BF16_SLICE_BAR = 1e-4, 2e-4, 5e-2


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


def bf16_diff(got, ref, valid):
    """(share of valid entries where two bf16 tensors differ, max |d| in
    bf16 ulps of max(|ref|, mean |ref|)); a bf16 x in [2^e, 2^(e+1)) has
    ulp 2^(e-7). The floor at the mean keeps near-zero entries, whose f32
    sums carry errors of the row's scale, from counting as many ulps."""
    got, ref = got.float()[valid], ref.float()[valid]
    mag = ref.abs().clamp_min(float(ref.abs().mean()))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    d = (got - ref).abs()
    return float((d > 0).float().mean()), float((d / ulp).max())


def packed_segments(lengths, capacity, device):
    """Segment ids of the serve batch as forward_packed lays it out."""
    from speech_ssl_compression_tpu_torch.ops.packing import (
        build_pack_arrays, plan_packing,
    )

    rows = plan_packing(lengths, capacity)
    _, seg, _ = build_pack_arrays(lengths, rows, capacity, capacity)
    return torch.from_numpy(seg).to(device)


def kernel_cases(dev):
    """(name, q shape, k shape, mask kwargs, valid rows (B, Tq) bool)."""
    seg = packed_segments(SERVE_LENGTHS, CAPACITY, dev)
    pad_tail = torch.zeros((2, 1024), dtype=torch.bool, device=dev)
    pad_tail[1, 900:] = True
    lens = torch.tensor([896, 700, 500, 101], device=dev)
    pad_1h = torch.arange(896, device=dev)[None, :] >= lens[:, None]
    pad_rect = torch.zeros((1, 5000), dtype=torch.bool, device=dev)
    pad_rect[0, 4800:] = True
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


def phase_kernels(dev, gpu: str):
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {}
    for name, qs, ks, masks, valid in kernel_cases(dev):
        ks = ks or qs
        for dtype in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            q = torch.randn(qs, generator=gen, device=dev).to(dtype)
            k = torch.randn(ks, generator=gen, device=dev).to(dtype)
            v = torch.randn(ks, generator=gen, device=dev).to(dtype)
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
                ok = err < F32_BAR and lse_err < LSE_BAR
                detail = (f"max|d|/mean|ref| {err:.3e} (bar {F32_BAR:g}), "
                          f"lse max|d| {lse_err:.3e} (bar {LSE_BAR:g})")
            else:
                tiled, _ = fa.flash_attention_reference(
                    q, k, v, block_k=fa.KERNEL_BLOCK_K, **masks)
                share, ulps = bf16_diff(got, tiled, rows)
                control, _ = fa.flash_attention_reference(
                    q.float(), k.float(), v.float(), block_k=fa.KERNEL_BLOCK_K,
                    **masks)
                ctl_share, ctl_ulps = bf16_diff(control.to(dtype), tiled, rows)
                ok = (ulps <= BF16_ULP_BAR and share < BF16_SHARE_BAR
                      and lse_err < LSE_BAR)
                detail = (f"differ {share:.3%} (bar {BF16_SHARE_BAR:.0%}), "
                          f"max {ulps:g} ulp (bar {BF16_ULP_BAR:g}), lse "
                          f"max|d| {lse_err:.3e} (bar {LSE_BAR:g}); control "
                          f"with P in f32: differ {ctl_share:.3%}, max "
                          f"{ctl_ulps:g} ulp; max|d|/mean|ref| {err:.3e}")
                if not ctl_share >= BF16_SHARE_BAR:
                    raise AssertionError(
                        f"bf16 check at {name} cannot tell a kernel that "
                        f"leaves P in f32 apart ({ctl_share:.3%} differ)")
            log("kernels", f"{name} {tag} q{tuple(qs)} k{tuple(ks)}: kernel vs "
                f"plain, {detail}, {time.perf_counter() - t0:.2f} s")
            if not (ok and torch.isfinite(got.float()[rows]).all()):
                raise AssertionError(f"kernel disagrees at {name} {tag}")
            if name == "serving":
                def run_kernel(q=q, k=k, v=v):
                    fa.flash_attention(q, k, v, **masks)

                def run_plain(q=q, k=k, v=v):
                    fa.flash_attention_reference(q, k, v, **masks)

                # plain, kernel, kernel, plain: alternate to share drift
                p1 = cuda_ms(run_plain, inner=5)
                k1 = cuda_ms(run_kernel, inner=5)
                k2 = cuda_ms(run_kernel, inner=5)
                p2 = cuda_ms(run_plain, inner=5)
                record[tag] = dict(max_abs_err=max_abs, ms=(k1 + k2) / 2,
                                   plain_ms=(p1 + p2) / 2)
                log("timing", f"flash_attn_fwd serving {tag} "
                    f"{tuple(qs)}: kernel {k1:.3f}/{k2:.3f} ms, plain "
                    f"{p1:.3f}/{p2:.3f} ms [{gpu}]")
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
    fa.reset_launch_counts()
    out = ext.forward_packed(wavs)
    torch.cuda.synchronize()
    launches = fa.launch_counts["flash_attn_fwd"]
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
    return launches, extractors, wavs


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


def phase_profile(extractors, wavs, gpu: str, calls: int = 3):
    """torch.profiler over ``calls`` forward_packed calls from features
    (after 2 warm-ups) per path: device busy time per call, idle share
    against the CUDA-event wall time, and the largest device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for (tag, impl), ext in extractors.items():
        feat, pad_mask, lengths = ext.featurize(wavs)
        for _ in range(2):
            ext._pack_and_dispatch(feat, pad_mask, lengths)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(calls):
                ext._pack_and_dispatch(feat, pad_mask, lengths)
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
        log("profile", f"forward_packed from features {tag} attn={impl}: "
            f"wall {wall:.2f} ms/call (profiler on), device busy {busy:.2f} "
            f"ms/call, idle {1 - busy / wall:.1%}; largest device kernels "
            f"per call: {top} [{gpu}]")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile forward_packed per path")
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
        f"{time.perf_counter() - t0:.1f} s")

    timing = phase_kernels(dev, gpu)
    with tempfile.TemporaryDirectory() as tmp:
        launches, extractors, wavs = phase_slice(dev, gpu, tmp)
        phase_timing(extractors, wavs, gpu)
        if args.profile:
            phase_profile(extractors, wavs, gpu)

    f32 = timing["f32"]
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda", "source": FA_SOURCE,
        "replaces": FA_REPLACES, "launches": launches,
        "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
    }]}), flush=True)
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
