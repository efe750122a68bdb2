#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention kernels, and the grad steps that
run them, on one CUDA device, for the port found under ``--root``
(this checkout by default). Pointing ``--root`` at an unpacked older tree
times that tree's kernels, so two trees can be compared in one session on
one card, in turns (old, new, new, old).

    python3 tools/torch_attention_timing.py [--root DIR] [--label NAME]
                                            [--grad-steps] [--serve]
                                            [--profile] [--json OUT]

Prints one JSON line (appended to OUT with ``--json``): the label, the
card's name and power limit (nvidia-smi), and CUDA-event medians in ms of
  * ``fwd``: the forward kernel at the serving batch (8 packed rows of 896
    frames, 12 heads, segments), at the training shape with dropout 0.1,
    at T = 5000 (1 x 12 heads) and at 1024 queries against 5000 keys
    (``flash_attention_kv_full``, the last 200 keys padded), through the
    wrapper (``fwd``) and its launches alone (``fwd kernel``:
    ``launch_fwd`` on prebuilt masks);
  * ``dq`` and ``dkv``: ``launch_bwd_dq`` and ``launch_bwd_dkv`` at the
    training shape (4, 12, 768, 64) with key padding (lengths 750, 750,
    700, 512), dropout 0 and 0.1, at T = 5000 and at 1024 x 5000 (the
    forward's long and rectangular cases);
  each f32 (TF32 off) and bf16, 20 launches per timing, median of 5, after
  a warm-up;
  * with ``--grad-steps``: the bf16 and f32 grad steps of MelHuBERT-20ms
    (B = 4, T = 768, 8-step accumulation, dropout on; f32 at PyTorch's
    TF32 defaults: matmuls in f32, cuDNN's convolutions in TF32)
    and the bf16 grad step of HuBERT-base with the cuDNN frontend (B = 4 x
    245,760 samples, LayerDrop 0), full width, seeded random weights,
    median of 5 single steps;
  * with ``--serve``: MelHuBERT-20ms's serve batch through
    ``forward_packed``, f32 (TF32 off) and bf16, from waveforms and from
    features (:func:`serve_times`);
  * with ``--profile``: torch.profiler over 3 f32 MelHuBERT grad steps:
    device busy ms per step and the largest device kernels, under
    ``profile`` in the line.
Needs a CUDA device; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

TRAIN_SHAPE = (4, 12, 768, 64)
# stacked 20 ms frame counts of bench.py's 16-utterance serve batch, packed
# into rows of 896 frames
SERVE_LENGTHS = (101,) * 8 + (792,) * 8
CAPACITY = 896
TRAIN_LENGTHS = (750, 750, 700, 512)
HUBERT_TRAIN = (4, 245760)
HUBERT_CLASSES = 504


def cuda_ms(fn, reps: int = 5, inner: int = 1) -> float:
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


def kernel_times(dev) -> dict:
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.ops.packing import (
        build_pack_arrays, plan_packing,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    lengths = torch.tensor(TRAIN_LENGTHS, device=dev)
    pad = torch.arange(TRAIN_SHAPE[2], device=dev)[None, :] >= lengths[:, None]
    rows = plan_packing(SERVE_LENGTHS, CAPACITY)
    _, seg, _ = build_pack_arrays(SERVE_LENGTHS, rows, CAPACITY, CAPACITY)
    seg = torch.from_numpy(seg).to(dev)
    serving = (seg.shape[0], 12, CAPACITY, 64)
    times = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for case, shape, masks in (
                ("serving", serving,
                 dict(segment_ids=seg, key_padding_mask=seg == 0)),
                ("training p=0.1", TRAIN_SHAPE,
                 dict(key_padding_mask=pad, dropout_p=0.1,
                      dropout_seed=1234))):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            times[f"fwd {tag} {case}"] = cuda_ms(
                lambda: fa.flash_attention(q, k, v, **masks), inner=20)
            args = fa.forward_args(q, k, v, **masks)
            times[f"fwd kernel {tag} {case}"] = cuda_ms(
                lambda: fa.launch_fwd(*args), inner=20)
        q, k, v = (torch.randn((1, 12, 5000, 64), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        times[f"fwd {tag} T=5000"] = cuda_ms(
            lambda: fa.flash_attention(q, k, v), inner=20)
        args = fa.forward_args(q, k, v)
        times[f"fwd kernel {tag} T=5000"] = cuda_ms(
            lambda: fa.launch_fwd(*args), inner=20)
        q_rect = q[:, :, :1024].contiguous()
        rect_pad = torch.arange(5000, device=dev)[None, :] >= 4800
        times[f"fwd {tag} 1024x5000"] = cuda_ms(
            lambda: fa.flash_attention_kv_full(q_rect, k, v,
                                               key_padding_mask=rect_pad),
            inner=20)
        args = fa.forward_args(q_rect, k, v, key_padding_mask=rect_pad)
        times[f"fwd kernel {tag} 1024x5000"] = cuda_ms(
            lambda: fa.launch_fwd(*args), inner=20)
        dout = torch.randn((1, 12, 5000, 64), generator=gen,
                           device=dev).to(dtype)
        long_cases = (("T=5000", q, k, v, dout, {}),
                      ("1024x5000", q_rect, k, v,
                       dout[:, :, :1024].contiguous(),
                       dict(key_padding_mask=rect_pad)))
        q, k, v, dout = (torch.randn(TRAIN_SHAPE, generator=gen, device=dev)
                         .to(dtype) for _ in range(4))
        cases = [(f"p={p}", q, k, v, dout, dict(key_padding_mask=pad) | (
            dict(dropout_p=p, dropout_seed=1234) if p else {}))
                 for p in (0.0, 0.1)] + list(long_cases)
        for case, q, k, v, dout, masks in cases:
            fwd = (fa.flash_attention if q.shape == k.shape
                   else fa.flash_attention_kv_full)
            _, lse = fwd(q, k, v, return_lse=True, **masks)
            args = fa.backward_args(q, k, v, lse, dout, **masks)
            _, dd = fa.launch_bwd_dq(*args)
            times[f"dq {tag} {case}"] = cuda_ms(
                lambda: fa.launch_bwd_dq(*args), inner=20)
            times[f"dkv {tag} {case}"] = cuda_ms(
                lambda: fa.launch_bwd_dkv(*args, dd), inner=20)
    return times


def melhubert_step(root: pathlib.Path, dev, dtype):
    """A callable that runs one MelHuBERT-20ms grad step in ``dtype``."""
    from speech_ssl_compression_tpu_torch.configs import (
        melhubert_config_from_yaml,
    )
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import (
        init_params_np, load_model,
    )

    cfg = melhubert_config_from_yaml(
        root / "configs" / "melhubert" / "config_model_20ms.yaml")
    model = load_model(init_params_np(cfg, seed=0), cfg).to(dev)
    params = dict(model.named_parameters())
    rng = np.random.default_rng(0)
    b, t = TRAIN_SHAPE[0], TRAIN_SHAPE[2]
    lengths = np.asarray(TRAIN_LENGTHS, np.int32)
    valid = np.arange(t)[None, :] < lengths[:, None]
    label = np.where(valid, rng.integers(0, 512, (b, t)), -100)
    batch = {
        "feat": torch.from_numpy(rng.standard_normal((b, t, 80))
                                 .astype(np.float32)).to(dev),
        "label": torch.from_numpy(label).to(dev),
        "pad_mask": torch.from_numpy(valid.astype(np.float32)).to(dev),
        "length": lengths,
    }
    step = make_melhubert_grad_step(model, accum_steps=8,
                                    compute_dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    return lambda: step(params, batch, gen)


def profile_ms(fn, calls: int = 3) -> dict:
    """torch.profiler over ``calls`` calls of ``fn`` after 2 warm-ups:
    {"busy": device busy ms per call, kernel name: device ms per call} for
    the 8 largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise SystemExit("torch_attention_timing: the profiler saw no "
                         "device activity")
    busy, end = 0.0, float("-inf")  # the union of the kernels' intervals
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    per_name = {}
    for e in events:
        per_name[e.name] = (per_name.get(e.name, 0.0)
                            + e.time_range.elapsed_us() / 1e3 / calls)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    return {"busy": busy / 1e3 / calls, **{n[:80]: ms for n, ms in top}}


def serve_times(root: pathlib.Path, dev) -> dict:
    """MelHuBERT-20ms's serve batch (bench.py's 16 utterances, seeded noise
    and tones of SERVE_LENGTHS stacked frames, full width, seeded random
    weights) through ``MelHuBERTExtractor.forward_packed`` with the kernel,
    f32 (TF32 off) and bf16: ms from waveforms and from features (the
    encoder alone)."""
    import tempfile

    from speech_ssl_compression_tpu_torch.configs import (
        melhubert_config_from_yaml,
    )
    from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import init_params_np

    cfg = melhubert_config_from_yaml(
        root / "configs" / "melhubert" / "config_model_20ms.yaml")
    rng = np.random.default_rng(0)
    wavs = []
    for n in SERVE_LENGTHS:  # n stacked frames <- 400 + 160 (2n - 2) samples
        t = np.arange(400 + 160 * (2 * n - 2)) / 16000.0
        wavs.append((sum(0.1 * np.sin(2 * np.pi * rng.uniform(80, 4000) * t)
                         for _ in range(3))
                     + 0.02 * rng.standard_normal(t.size)).astype(np.float32))
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(pathlib.Path(tmp) / "melhubert.npz")
        save_checkpoint(ckpt, init_params_np(cfg, seed=0),
                        meta={"Upstream_Config": {"melhubert": cfg.to_dict()},
                              "Step": 0})
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            ext = MelHuBERTExtractor(
                ckpt, fp=20, mean_std_npy_path=str(
                    root / "example" / "libri-960-mean-std.npy"),
                dtype=dtype, matmul_precision="highest", device=dev)
            feat, pad_mask, lengths = ext.featurize(wavs)
            times[f"melhubert serve batch {tag} from waveforms"] = cuda_ms(
                lambda: ext.forward_packed(wavs))
            times[f"melhubert serve batch {tag} from features"] = cuda_ms(
                lambda: ext._pack_and_dispatch(feat, pad_mask, lengths))
    return times


def hubert_step_ms(root: pathlib.Path, dev) -> float:
    from speech_ssl_compression_tpu_torch.configs import hubert_config_from_yaml
    from speech_ssl_compression_tpu_torch.models.conv_frontend import (
        conv_output_length,
    )
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_hubert_grad_step,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import (
        init_hubert_params_np, load_wave_model,
    )

    cfg = dataclasses.replace(
        hubert_config_from_yaml(root / "configs" / "hubert" / "config_model.yaml"),
        encoder_layerdrop=0.0, conv_frontend_impl="auto")
    model = load_wave_model(
        init_hubert_params_np(cfg, (HUBERT_CLASSES,), seed=0), cfg,
        "hubert").to(dev)
    params = dict(model.named_parameters())
    b, t_wave = HUBERT_TRAIN
    rng = np.random.default_rng(0)
    t_frames = conv_output_length(t_wave, cfg.conv_feature_layers)
    batch = {
        "source": torch.from_numpy(rng.standard_normal((b, t_wave))
                                   .astype(np.float32)).to(dev),
        "length": np.full(b, t_wave),
        "target_list": [torch.from_numpy(rng.integers(
            0, HUBERT_CLASSES, (b, t_frames))).to(dev)],
        "target_valid": torch.ones((b, t_frames), dtype=torch.bool,
                                   device=dev),
    }
    step = make_hubert_grad_step(model, accum_steps=2,
                                 compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    return cuda_ms(lambda: step(params, batch, gen))


def main() -> None:
    here = pathlib.Path(__file__).resolve().parent.parent
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(here),
                        help="the tree whose port is timed")
    parser.add_argument("--label", default="")
    parser.add_argument("--grad-steps", action="store_true")
    parser.add_argument("--serve", action="store_true",
                        help="also time MelHuBERT's serve batch")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--json", help="append the JSON line to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_timing: no CUDA device")
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    times = kernel_times(dev)
    if args.serve:
        times.update(serve_times(root, dev))
    profiled = None
    if args.grad_steps:
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            times[f"melhubert grad step {tag}"] = cuda_ms(
                melhubert_step(root, dev, dtype))
        times["hubert grad step bf16 (cuDNN frontend)"] = hubert_step_ms(
            root, dev)
    if args.profile:
        profiled = profile_ms(melhubert_step(root, dev, torch.float32))
    line = json.dumps({"label": args.label, "root": str(root), "gpu": gpu,
                       "ms": times, "profile": profiled})
    print(line, flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
