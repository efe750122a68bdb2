#!/usr/bin/env python3
"""Time the PyTorch port's strided-conv kernels, and the HuBERT-base bf16
grad step and extraction that run them, on one CUDA device, for the port
found under ``--root`` (this checkout by default). Pointing ``--root`` at
an unpacked older tree times that tree's kernels, so two trees can be
compared on one card, in turns (old, new, new, old).

    python3 tools/torch_conv_timing.py [--root DIR] [--label NAME]
                                       [--hubert] [--host] [--json OUT]

Prints one JSON line (appended to OUT with ``--json``): the label, the
card's name and power limit (nvidia-smi), and CUDA-event medians in ms of
  * ``launch_fwd``, ``launch_dw`` and ``launch_dx`` at each of HuBERT-base's
    frontend layers 1-6 in the training batch (B = 4 x 245,760 samples),
    f32 (TF32 off) and bf16, 5 launches per timing, median of 5 after a
    warm-up, and their sums over the six layers;
  * with ``--hubert``: the f32 (TF32 off) and bf16 grad step (B = 4 x
    245,760 samples, two micro-batches, LayerDrop 0, dropout on) and f32
    and bf16 ``hubert_forward(features_only=True)`` on 8 x 491,520
    samples, with the conv kernels (``conv_frontend_impl="tc_pallas"``) and
    with cuDNN ("auto"), full width, seeded random weights, median of 5
    single calls;
  * with ``--host``: the host work per launch of the three wrappers at
    layers 5 and 6, bf16 and f32 (:func:`host_times`).
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
import time

import numpy as np
import torch

HUBERT_TRAIN = (4, 245760)
HUBERT_SERVE = (8, 491520)
HUBERT_CLASSES = 504
HOST_CALLS = 50  # launches per host-work timing
# GPU clock cycles the device sleeps while the host enqueues HOST_CALLS
# launches (~50 ms at the H100's 1.98 GHz boost clock)
SLEEP_CYCLES = 100_000_000


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


def hubert_cfg(root: pathlib.Path, impl: str):
    from speech_ssl_compression_tpu_torch.configs import hubert_config_from_yaml

    return dataclasses.replace(
        hubert_config_from_yaml(root / "configs" / "hubert" / "config_model.yaml"),
        encoder_layerdrop=0.0, conv_frontend_impl=impl)


def layer_shapes(root: pathlib.Path) -> list:
    """(T_in, C, K, O, stride) of HuBERT-base's frontend layers 1-6 in the
    training batch (B = HUBERT_TRAIN[0])."""
    t = HUBERT_TRAIN[1]
    shapes, c = [], 1
    for dim, k, s in hubert_cfg(root, "tc_pallas").conv_feature_layers:
        if c % 128 == 0 and dim % 128 == 0:
            shapes.append((t, c, k, dim, s))
        t, c = (t - k) // s + 1, dim
    return shapes


def conv_inputs(shape, dtype, gen, dev):
    """Seeded x (B, T_in, C), w (K, C, O) and dy (B, T_out, O)."""
    t_in, c, k, o, s = shape
    b = HUBERT_TRAIN[0]
    x = torch.randn((b, t_in, c), generator=gen, device=dev).to(dtype)
    w = (torch.randn((k, c, o), generator=gen, device=dev)
         / (k * c) ** 0.5).to(dtype)
    dy = torch.randn((b, (t_in - k) // s + 1, o), generator=gen,
                     device=dev).to(dtype)
    return x, w, dy


def conv_times(root: pathlib.Path, dev) -> dict:
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for i, shape in enumerate(layer_shapes(root)):
            t_in, c, k, o, s = shape
            x, w, dy = conv_inputs(shape, dtype, gen, dev)
            for name, fn in (
                    ("conv1d_fwd", lambda: tc.launch_fwd(x, w, s)),
                    ("conv1d_dw", lambda: tc.launch_dw(x, dy, k, s)),
                    ("conv1d_dx", lambda: tc.launch_dx(dy, w, t_in, s))):
                ms = cuda_ms(fn, inner=5)
                times[f"{name} {tag} layer{i + 1}"] = ms
                key = f"{name} {tag} layers 1-6"
                times[key] = times.get(key, 0.0) + ms
    return times


def queued(fn, n: int = HOST_CALLS) -> tuple:
    """(host us per call, device us per call) of ``n`` calls of ``fn``
    enqueued behind a device sleep of SLEEP_CYCLES, median of 5: the host
    never waits on the device, so the host time is the work per launch
    (enqueue included) and the device time the launches back to back.
    Raises if the host took longer than the sleep."""
    fn()
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(5):
        before, start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(3))
        before.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        took = time.perf_counter() - t0
        end.record()
        end.synchronize()
        if took * 1e3 >= before.elapsed_time(start):
            raise RuntimeError("the device sleep ended before the host had "
                               "enqueued every launch; raise SLEEP_CYCLES")
        host.append(took / n * 1e6)
        device.append(start.elapsed_time(end) / n * 1e3)
    return statistics.median(host), statistics.median(device)


def host_times(root: pathlib.Path, dev) -> dict:
    """Host work per launch of ``launch_fwd``, ``launch_dw`` and
    ``launch_dx`` at HuBERT's layers 5 and 6 (the shortest kernels), bf16
    and f32, in us: ``wrapper host`` (the Python wrapper, enqueued behind a
    device sleep: :func:`queued`), ``entry host`` (its C entry point alone
    on the same arguments: for bf16 the tensor maps, the shared-memory
    attribute and the launch; f32 encodes no map), ``device`` (the launches
    back to back behind the sleep) and ``wall`` (CUDA events around
    HOST_CALLS wrapper calls, the larger of host and device), and one
    ``get_device_properties`` lookup (the SM count ``launch_dw`` plans
    its split-K with)."""
    from speech_ssl_compression_tpu_torch.ops import _kernels
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    lib = _kernels.load()
    gen = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    b = HUBERT_TRAIN[0]
    times = {}
    for layer in (5, 6):
        shape = layer_shapes(root)[layer - 1]
        t_in, c, k, o, s = shape
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x, w, dy = conv_inputs(shape, dtype, gen, dev)
            t_out = dy.shape[1]
            bf16 = int(dtype == torch.bfloat16)
            y = torch.empty((b, t_out, o), dtype=dtype, device=dev)
            dx = torch.empty_like(x)
            chunk, n_split, scratch = tc.dw_plan(dtype, b, t_out, k, c, o,
                                                 n_sm)
            dw = torch.empty((k, c, o), dtype=torch.float32, device=dev)
            partial = (torch.empty(scratch, dtype=torch.float32, device=dev)
                       if scratch else None)
            tail = (bf16, dev.index, stream)
            # the f32 forward's w^T scratch and the f32 dX's w scratch, in
            # a tree whose entry points take them (13 arguments there, 12
            # before)
            wt = ((None if bf16 else torch.empty((2, o, k * c), device=dev)
                   .data_ptr(),)
                  if len(lib.sslc_conv1d_fwd.argtypes) == 13 else ())
            ws = ((None if bf16 else torch.empty((2, k * c, o), device=dev)
                   .data_ptr(),)
                  if len(lib.sslc_conv1d_dx.argtypes) == 13 else ())
            entries = {
                "conv1d_fwd": (lambda: tc.launch_fwd(x, w, s),
                               lib.sslc_conv1d_fwd,
                               (x.data_ptr(), w.data_ptr(), *wt,
                                y.data_ptr(), b, t_in, c, k, o, s) + tail),
                "conv1d_dw": (lambda: tc.launch_dw(x, dy, k, s),
                              lib.sslc_conv1d_dw,
                              (x.data_ptr(), dy.data_ptr(),
                               None if partial is None else partial.data_ptr(),
                               dw.data_ptr(), b, t_in, c, k, o, s, chunk,
                               n_split) + tail),
                "conv1d_dx": (lambda: tc.launch_dx(dy, w, t_in, s),
                              lib.sslc_conv1d_dx,
                              (dy.data_ptr(), w.data_ptr(), *ws,
                               dx.data_ptr(), b, t_in, c, k, o, s) + tail),
            }
            for name, (wrapper, entry, args) in entries.items():
                _kernels.check(lib, entry(*args), name)
                key = f"{name} {tag} layer{layer}"
                host, device = queued(wrapper)
                times[f"{key} wrapper host us"] = host
                times[f"{key} device us"] = device
                times[f"{key} entry host us"] = queued(lambda: entry(*args))[0]
                times[f"{key} wall us"] = cuda_ms(wrapper,
                                                  inner=HOST_CALLS) * 1e3
    t0 = time.perf_counter()
    for _ in range(1000):
        torch.cuda.get_device_properties(dev).multi_processor_count
    times["get_device_properties us"] = (time.perf_counter() - t0) * 1e3
    return times


def hubert_times(root: pathlib.Path, dev) -> dict:
    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.models.conv_frontend import (
        conv_output_length,
    )
    from speech_ssl_compression_tpu_torch.models.hubert import hubert_forward
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_hubert_grad_step,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import (
        init_hubert_params_np, load_wave_model,
    )

    times = {}
    for impl, label in (("tc_pallas", "conv kernels"), ("auto", "cuDNN")):
        cfg = hubert_cfg(root, impl)
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
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            step = make_hubert_grad_step(model, accum_steps=2,
                                         compute_dtype=dtype)
            gen = torch.Generator().manual_seed(0)
            with matmul_precision("highest"):
                times[f"hubert grad step {tag} ({label})"] = cuda_ms(
                    lambda: step(params, batch, gen))
            del step
        del batch, params

        model = model.eval().requires_grad_(False)
        b, t_wave = HUBERT_SERVE
        src = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (b, t_wave)).astype(np.float32)).to(dev)
        lengths = np.full(b, t_wave)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            model, src = model.to(dtype), src.to(dtype)

            def serve():
                with matmul_precision("highest"), torch.inference_mode():
                    return hubert_forward(model, src, lengths, mask=False,
                                          features_only=True)

            frames = int((~serve()["padding_mask"]).sum())
            ms = cuda_ms(serve)
            times[f"hubert_forward {tag} ({label})"] = ms
            times[f"hubert_forward {tag} ({label}) frames/s"] = (
                frames / ms * 1e3)
        del model, src
        torch.cuda.empty_cache()
    return times


def main() -> None:
    here = pathlib.Path(__file__).resolve().parent.parent
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(here),
                        help="the tree whose port is timed")
    parser.add_argument("--label", default="")
    parser.add_argument("--hubert", action="store_true")
    parser.add_argument("--host", action="store_true",
                        help="also time the wrappers' host work per launch")
    parser.add_argument("--json", help="append the JSON line to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_conv_timing: no CUDA device")
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    times = conv_times(root, dev)
    if args.host:
        times.update(host_times(root, dev))
    if args.hubert:
        times.update(hubert_times(root, dev))
    line = json.dumps({"label": args.label, "root": str(root), "gpu": gpu,
                       "ms": times})
    print(line, flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
