#!/usr/bin/env python3
"""Time the port's f32 split-TF32 forward kernels (the flash-attention
forward, csrc/flash_attn_fwd_f32_sm90.cu, and the strided-conv forward,
csrc/conv1d_f32_sm90.cu) in variants of this checkout's sources, each with
one design choice changed or one part of the work cut out, to show what
paces them.

    python3 tools/torch_split_timing.py [--variants NAME ...] [--json OUT]

Each variant is a set of text edits applied to a copy of csrc/ in a
temporary directory (an edit whose text is not found, once, fails the run,
so the variants follow the sources or stop). The sources an edit touches
are compiled again with ops/_kernels.py's nvcc flags (every .cu where a
header changes), linked with the others, and the library is loaded in
place of the port's own (``_kernels.load``). A variant that cuts work out
computes wrong numbers: only its time means anything. Variants:
  * ``base``: the sources as they are;
  * ``no_kv_split``: the attention forward without its split pass over
    each K and V tile (K hi in place, K lo, V^T hi and lo): the least time
    a kernel that read K and V split by a pre-pass could take, before that
    pre-pass and the extra bytes it makes every block read;
  * ``hi_hi_only``: every split-TF32 product as one TF32 product (hi hi)
    in both kernels: what the other two products cost;
  * ``fwd_two_blocks``: the attention forward with 40 KB more shared
    memory a block, so that two blocks share an SM instead of three;
  * ``conv_no_a_split``: the conv forward without the split of x in shared
    memory.
Prints one JSON line (appended to OUT with ``--json``): the card's name and
power limit (nvidia-smi) and, per variant, CUDA-event medians in ms of the
attention forward's launches (``launch_fwd``) at the serving batch (8 packed
rows of 896 frames, 12 heads, segments), the training shape (4, 12, 768,
64) with dropout 0.1, T = 5000 and 1024 x 5000 (the last 200 keys padded),
and of the conv forward's launches summed over HuBERT-base's frontend
layers 1-6 in the training batch (B = 4 x 245,760 samples), 20 (attention)
or 5 (conv) launches per timing, median of 5 after a warm-up; the variants
run in turns (base first and last). Needs nvcc and a CUDA device; imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FWD = "flash_attn_fwd_f32_sm90.cu"
CONV = "conv1d_f32_sm90.cu"
# name: [(source file, text, replacement)]
VARIANTS = {
    "base": [],
    "no_kv_split": [(FWD, """    split_tile<kN, kWgThreads, false>(s_k, s_k_lo, nullptr, nullptr, tid);
    split_tile<kN, kWgThreads, true, false>(s_v, nullptr, s_vt, s_vt_lo, tid);
""", "")],
    "hi_hi_only": [
        ("split_tf32.cuh", """  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk)""", """  for (int p = 2; p < 3; ++p) {
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk)"""),
        ("split_tf32.cuh", """    wgmma_tf32_rs(c, a_hi[kk], kstep(bt_lo, kk, kTBox), kk > 0);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_tf32_rs(c, a_lo[kk], kstep(bt_hi, kk, kTBox), 1);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_tf32_rs(c, a_hi[kk], kstep(bt_hi, kk, kTBox), 1);""",
         """    wgmma_tf32_rs(c, a_hi[kk], kstep(bt_hi, kk, kTBox), kk > 0);"""),
        (CONV, "    for (int p = 0; p < 3; ++p) {",
         "    for (int p = 2; p < 3; ++p) {"),
    ],
    "fwd_two_blocks": [
        (FWD, "    2 * kN * 4 + kTile * 2 * 2 + 2 * 8 + 1024;",
         "    2 * kN * 4 + kTile * 2 * 2 + 2 * 8 + 1024 + 40 * 1024;"),
    ],
    "conv_no_a_split": [
        (CONV, "    split_box(a_hi(st), a_hi(st) + 2 * kABox, wtid);\n", ""),
    ],
}


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


def build_variants(names, tmp: pathlib.Path) -> dict:
    """{name: loaded library} of each variant, built under ``tmp``."""
    from speech_ssl_compression_tpu_torch.ops import _kernels

    nvcc = _kernels._cuda_tool("nvcc")
    cuda = pathlib.Path(nvcc).resolve().parent.parent
    stubs = [f"-L{d}" for d in (cuda / "lib64" / "stubs",
                                cuda / "targets" / "x86_64-linux" / "lib"
                                / "stubs") if d.is_dir()]
    jobs, plans = [], {}
    for name in names:
        src = tmp / name / "csrc"
        shutil.copytree(_kernels.CSRC, src)
        edited = set()
        for fname, text, new in VARIANTS[name]:
            path = src / fname
            body = path.read_text()
            if body.count(text) != 1:
                raise SystemExit(f"variant {name}: the text to edit in {fname} "
                                 f"is found {body.count(text)} times")
            path.write_text(body.replace(text, new))
            edited.add(fname)
        cus = sorted(src.glob("*.cu"))
        if name != "base":  # only what the edits reach; base for the rest
            cus = [c for c in cus if c.name in edited or any(
                e.endswith(".cuh") for e in edited)]
        objs = {c.stem: tmp / name / f"{c.stem}.o" for c in cus}
        plans[name] = objs
        jobs += [subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, "-c", "-o", str(objs[c.stem]),
             str(c)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for c in cus]
    for job in jobs:
        _, err = job.communicate()
        if job.returncode:
            raise SystemExit(f"nvcc failed: {' '.join(job.args)}\n{err}")
    libs = {}
    for name in names:
        objs = {**plans["base"], **plans[name]}
        lib = tmp / name / "libvariant.so"
        subprocess.run([nvcc, "-shared", "-o", str(lib),
                        *map(str, objs.values()), *stubs,
                        *_kernels.LINK_FLAGS], check=True,
                       capture_output=True)
        libs[name] = lib
    return libs


def attention_cases(dev):
    """(name, forward_args) of the timed attention shapes, f32."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.ops.packing import (
        build_pack_arrays, plan_packing,
    )

    lengths = (101,) * 8 + (792,) * 8  # bench.py's serve batch, rows of 896
    _, seg, _ = build_pack_arrays(lengths, plan_packing(lengths, 896), 896,
                                  896)
    seg = torch.from_numpy(seg).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    pad = (torch.arange(768, device=dev)[None, :]
           >= torch.tensor([750, 750, 700, 512], device=dev)[:, None])
    q, k, v = (randn(1, 12, 5000, 64) for _ in range(3))
    return [
        ("serving", fa.forward_args(
            *(randn(seg.shape[0], 12, 896, 64) for _ in range(3)),
            segment_ids=seg, key_padding_mask=seg == 0)),
        ("training p=0.1", fa.forward_args(
            *(randn(4, 12, 768, 64) for _ in range(3)), key_padding_mask=pad,
            dropout_p=0.1, dropout_seed=1234)),
        ("T=5000", fa.forward_args(q, k, v)),
        ("1024x5000", fa.forward_args(
            q[:, :, :1024].contiguous(), k, v,
            key_padding_mask=torch.arange(5000, device=dev)[None, :] >= 4800)),
    ]


def conv_cases(dev):
    """(x, w, stride) of HuBERT-base's frontend layers 1-6 in the training
    batch, f32."""
    from speech_ssl_compression_tpu_torch.configs import (
        hubert_config_from_yaml,
    )

    cfg = hubert_config_from_yaml(ROOT / "configs" / "hubert"
                                  / "config_model.yaml")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases, t, c = [], 245760, 1
    for dim, k, s in cfg.conv_feature_layers:
        if c % 128 == 0 and dim % 128 == 0:
            cases.append((torch.randn((4, t, c), generator=gen, device=dev),
                          torch.randn((k, c, dim), generator=gen, device=dev)
                          / (k * c) ** 0.5, s))
        t, c = (t - k) // s + 1, dim
    return cases


def time_variant(lib_path: pathlib.Path, attention, convs) -> dict:
    from speech_ssl_compression_tpu_torch.ops import _kernels
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    load = _kernels.load
    lib = ctypes.CDLL(str(lib_path))
    # declare the entry points as the port's own load() does
    _kernels.load = lambda: lib
    try:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sslc_flash_attn_fwd.argtypes = [vp] * 8 + [ci] * 7 + [
            ctypes.c_uint, ctypes.c_float, ctypes.c_ulonglong, ci, vp]
        lib.sslc_conv1d_fwd.argtypes = [vp] * 4 + [ci] * 8 + [vp]
        for fn in (lib.sslc_flash_attn_fwd, lib.sslc_conv1d_fwd):
            fn.restype = ci
        lib.sslc_cuda_error_string.argtypes = [ci]
        lib.sslc_cuda_error_string.restype = ctypes.c_char_p
        times = {f"fwd f32 {name}": cuda_ms(lambda: fa.launch_fwd(*args),
                                            inner=20)
                 for name, args in attention}
        times["conv1d_fwd f32 layers 1-6"] = sum(
            cuda_ms(lambda: tc.launch_fwd(x, w, s), inner=5)
            for x, w, s in convs)
    finally:
        _kernels.load = load
    return times


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS),
                        choices=list(VARIANTS))
    parser.add_argument("--json", help="append the JSON line to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_split_timing: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    names = ["base"] + [n for n in args.variants if n != "base"]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(names, pathlib.Path(tmp))
        attention, convs = attention_cases(dev), conv_cases(dev)
        times = {}
        for name in names + ["base"]:  # base first and last
            key = name if name not in times else "base again"
            times[key] = time_variant(libs[name], attention, convs)
    line = json.dumps({"gpu": gpu, "ms": times})
    print(line, flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
