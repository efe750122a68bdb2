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
            time and ptxas's registers and spills per kernel;
  kernels   the flash-attention forward kernel against its plain PyTorch
            version on the card, TF32 off, f32 and bf16, at the shapes the
            serving path and the long/rectangular/causal paths give it, and
            with dropout at the training shape;
  backward  the dQ and dK/dV kernels against the plain backward at the
            training shape (4, 12, 768, 64) with key padding, dropout 0 and
            0.1, and at the serving, causal, one-head, long and rectangular
            shapes; the kernels' keep rate against the binomial; the same
            seed giving the same bits twice;
  slice     MelHuBERT-20ms at full width (12 layers, 768 wide, seeded random
            weights written as an npz checkpoint and read back through
            load_any_checkpoint) serves 16 synthetic utterances through
            MelHuBERTExtractor.forward_packed: launch counts, the dense
            path, the unpacked path, bf16 against f32;
  timing    CUDA-event medians of 3 after a warm-up: the kernel against its
            plain version at the serving shape, and serve-batch frames/s
            with the kernel and with impl="dense", f32 and bf16;
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
  profile   (--profile only) device busy time, idle share and the largest
            device kernels of forward_packed from features, per path, and
            of the bf16 grad step.

The bf16 kernel check. Kernel and plain version both round their output to
bf16, so the two may differ by one bf16 ulp wherever the f32 results
straddle a rounding point. The plain version runs with the kernel's key
tiles (block_k), so a bf16 P is rounded at the same points, and the check
asks that every valid entry be within one ulp (of max(|ref|, mean |ref|))
and that fewer than BF16_SHARE_BAR of them differ at all. A control, the
same plain version with P left in f32, must fail that share, or the check
could not see the rounding of P and the script fails. The backward kernels
are held to the same share bar against the plain backward, which rounds dS
and Pd to bf16 where the kernels do (its control leaves them in f32). They
also round dS and Pd inside, before their sums, so an entry may lie beyond
one ulp where a dS or Pd term straddles a rounding point: every valid
entry must lie within one ulp plus its straddle bound
(flash_attention.bf16_straddle_bounds: the most that rounding the terms
within the f32 error bound of a rounding point the other way can move
it), built from the inputs before the kernels run.

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
BWD_SOURCE = "speech_ssl_compression_tpu_torch/csrc/flash_attn_bwd.cu"
DQ_REPLACES = "speech_ssl_compression_tpu/ops/flash_attention.py:473"
DKV_REPLACES = "speech_ssl_compression_tpu/ops/flash_attention.py:537"
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


def bf16_ulp(ref):
    """One bf16 ulp of max(|ref|, mean |ref|); a bf16 x in [2^e, 2^(e+1))
    has ulp 2^(e-7). The floor at the mean keeps near-zero entries, whose
    f32 sums carry errors of the row's scale, from counting as many ulps."""
    mag = ref.abs().clamp_min(float(ref.abs().mean()))
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_diff(got, ref, valid):
    """(share of valid entries where two bf16 tensors differ, max |d| in
    bf16 ulps)."""
    got, ref = got.float()[valid], ref.float()[valid]
    d = (got - ref).abs()
    return float((d > 0).float().mean()), float((d / bf16_ulp(ref)).max())


def bf16_bwd_diff(got, ref, bound, valid):
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
    for name, qs, ks, masks, valid in kernel_cases(dev) + training_cases(dev):
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
            if name in ("serving", "training_dropout"):
                def run_kernel(q=q, k=k, v=v, masks=masks):
                    fa.flash_attention(q, k, v, **masks)

                def run_plain(q=q, k=k, v=v, masks=masks):
                    fa.flash_attention_reference(q, k, v, **masks)

                kernel_ms, plain_ms = alternate(run_kernel, run_plain,
                                                inner=5)
                record[name, tag] = dict(max_abs_err=max_abs, ms=kernel_ms,
                                         plain_ms=plain_ms)
                log("timing", f"flash_attn_fwd {name} {tag} {tuple(qs)}: "
                    f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms "
                    f"[{gpu}]")
    return record


def alternate(run_kernel, run_plain, inner: int = 1):
    """(kernel ms, plain ms), each the mean of two CUDA-event medians taken
    in the order plain, kernel, kernel, plain, to share drift."""
    p1 = cuda_ms(run_plain, inner=inner)
    k1 = cuda_ms(run_kernel, inner=inner)
    k2 = cuda_ms(run_kernel, inner=inner)
    p2 = cuda_ms(run_plain, inner=inner)
    return (k1 + k2) / 2, (p1 + p2) / 2


def backward_cases(dev):
    """(name, q shape, k shape, forward kwargs, valid query rows (B, Tq),
    valid keys (B, Tk)): the training shape with dropout 0 and 0.1, and
    the forward's other shapes (dropout-free; the rectangular one is the
    backward of flash_attention_kv_full)."""
    cases = []
    for name, qs, ks, masks, valid in training_cases(dev) + kernel_cases(dev):
        kpm = masks.get("key_padding_mask")
        tk = (ks or qs)[2]
        valid_k = (torch.ones(qs[0], tk, dtype=torch.bool, device=dev)
                   if kpm is None else ~kpm)
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
            args = fa.backward_args(q, k, v, out, lse, dout, **masks)
            got = (fa.launch_bwd_dq(*args),) + fa.launch_bwd_dkv(*args)
            ref = (fa.reference_bwd_dq(*args),) + fa.reference_bwd_dkv(*args)
            torch.cuda.synchronize()
            sel = (rows_of(valid_q, qs), rows_of(valid_k, ks),
                   rows_of(valid_k, ks))
            tag = "f32" if dtype == torch.float32 else "bf16"
            names = ("dq", "dk", "dv")
            if dtype == torch.float32:
                errs = [rel_err(g, r, s) for g, r, s in zip(got, ref, sel)]
                ok = max(errs) < F32_BAR
                detail = ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
                detail = f"max|d|/mean|ref| {detail} (bar {F32_BAR:g})"
                abs_errs = [float((g - r)[s].abs().max())
                            for g, r, s in zip(got, ref, sel)]
                record[name] = dict(max_abs_err_dq=abs_errs[0],
                                    max_abs_err_dkv=max(abs_errs[1:]))
            else:
                f32_args = tuple(a.float() if torch.is_tensor(a)
                                 and a.dtype == dtype else a for a in args)
                control = ((fa.reference_bwd_dq(*f32_args),)
                           + fa.reference_bwd_dkv(*f32_args))
                bounds = fa.bf16_straddle_bounds(*args)
                diffs = [bf16_bwd_diff(g, r, b, s)
                         for g, r, b, s in zip(got, ref, bounds, sel)]
                del bounds
                ctl = [bf16_diff(c.to(dtype), r, s)
                       for c, r, s in zip(control, ref, sel)]
                ok = all(sh < BF16_SHARE_BAR and need <= 1.0
                         for sh, _, _, need, _ in diffs)
                detail = ", ".join(
                    f"{n} differ {sh:.3%} max {u:g} ulp, {nb} beyond 1 ulp "
                    f"(excess/straddle bound <= {need:.3g}; median bound "
                    f"{bm:.3g} ulp) (control {csh:.2%}, {cu:g} ulp)"
                    for n, (sh, u, nb, need, bm), (csh, cu)
                    in zip(names, diffs, ctl))
                detail += (f"; bars {BF16_SHARE_BAR:.0%}, 1 ulp + straddle "
                           "bound")
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
    check_keep_bits(dev)
    check_determinism(dev)
    return record


def check_keep_bits(dev):
    """The forward kernel's keep bits, read back from its output: with
    q = 0 every probability is 1/T, and v one-hot on the key's residue mod
    64 makes out[..., c] * T * (1 - p) the count of kept keys j = c mod 64
    in that row. Those counts must equal the plain keep mask's, and the
    keep rate must lie within KEEP_SIGMAS of the binomial."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.ops.dropout import attention_keep_mask

    b, h, t, d = TRAIN_SHAPE
    q = torch.zeros(TRAIN_SHAPE, device=dev)
    k = torch.randn(TRAIN_SHAPE, device=dev)
    v = torch.nn.functional.one_hot(torch.arange(t, device=dev) % d, d).float()
    v = v.expand(b, h, t, d).contiguous()
    for p in (0.1, 0.5):
        out = fa.flash_attention(q, k, v, dropout_p=p, dropout_seed=DROPOUT_SEED)
        counts = torch.round(out.double() * t * (1 - p)).long()
        keep = attention_keep_mask(DROPOUT_SEED, b, h, t, t, p, dev)
        plain = keep.view(b, h, t, t // d, d).sum(dim=3)
        n = keep.numel()
        rate = float(counts.sum()) / n
        sigma = (p * (1 - p) / n) ** 0.5
        z = abs(rate - (1 - p)) / sigma
        same = torch.equal(counts, plain)
        log("backward", f"kernel keep bits at p={p}: keep rate {rate:.6f} "
            f"over {n} draws, {z:.2f} sigma from {1 - p:g} (bar "
            f"{KEEP_SIGMAS:g}); per-row counts equal to the plain mask's: "
            f"{same}")
        if not (same and z < KEEP_SIGMAS):
            raise AssertionError(f"kernel keep bits wrong at p={p}")


def check_determinism(dev):
    """The same seed gives the same forward and backward bits twice; another
    seed gives another output."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v, dout = (torch.randn(TRAIN_SHAPE, generator=gen, device=dev)
                     .bfloat16() for _ in range(4))
    masks = dict(key_padding_mask=train_padding(dev), dropout_p=DROPOUT_P)

    def run(seed):
        out, lse = fa.flash_attention(q, k, v, return_lse=True,
                                      dropout_seed=seed, **masks)
        args = fa.backward_args(q, k, v, out, lse, dout, dropout_seed=seed,
                                **masks)
        return (out, fa.launch_bwd_dq(*args)) + fa.launch_bwd_dkv(*args)

    first, second, other = run(7), run(7), run(8)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    differ = not torch.equal(first[0], other[0])
    log("backward", f"seed 7 twice: forward, dq, dk, dv bitwise equal: "
        f"{same}; seed 8 gives another output: {differ}")
    if not (same and differ):
        raise AssertionError("the kernels' dropout is not a function of the seed")


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
    run)."""
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
    fa.reset_launch_counts()
    runner = train(["-m", "melhubert", "-g", str(CONFIG_YAML), "-c",
                    str(runner_yaml), "-n", str(expdir), "--device", "cuda",
                    "--seed", "0"])
    torch.cuda.synchronize()
    counts = dict(fa.launch_counts)
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
    return runner, batch, counts


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
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **masks)
        args = fa.backward_args(q, k, v, out, lse, dout, **masks)
        tag = "f32" if dtype == torch.float32 else "bf16"
        for name, kernel, plain in (
                ("flash_attn_bwd_dq", fa.launch_bwd_dq, fa.reference_bwd_dq),
                ("flash_attn_bwd_dkv", fa.launch_bwd_dkv,
                 fa.reference_bwd_dkv)):
            kernel_ms, plain_ms = alternate(lambda: kernel(*args),
                                            lambda: plain(*args), inner=5)
            record[name, tag] = dict(ms=kernel_ms, plain_ms=plain_ms)
            log("timing", f"{name} training shape {TRAIN_SHAPE} {tag}, "
                f"dropout {DROPOUT_P}: kernel {kernel_ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms [{gpu}]")
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


def profile_calls(label: str, fn, gpu: str, calls: int = 3) -> None:
    """torch.profiler over ``calls`` calls of ``fn`` (after 2 warm-ups):
    device busy time per call, idle share against the CUDA-event wall
    time, and the largest device kernels."""
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
    log("profile", f"{label}: wall {wall:.2f} ms/call (profiler on), device "
        f"busy {busy:.2f} ms/call, idle {1 - busy / wall:.1%}; largest "
        f"device kernels per call: {top} [{gpu}]")


def phase_profile(extractors, wavs, gpu: str):
    """forward_packed from features, per path."""
    for (tag, impl), ext in extractors.items():
        feat, pad_mask, lengths = ext.featurize(wavs)
        profile_calls(f"forward_packed from features {tag} attn={impl}",
                      lambda: ext._pack_and_dispatch(feat, pad_mask, lengths),
                      gpu)


def phase_train_profile(runner, batch, gpu: str):
    """The bf16 grad step, with the kernels and with impl="dense"."""
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )

    for impl in ("auto", "dense"):
        step = make_melhubert_grad_step(
            runner.model, accum_steps=runner.accum_steps,
            compute_dtype=runner.compute_dtype, attn_impl=impl)
        profile_calls(f"grad step B=4 T=768 bf16 attn={impl}",
                      lambda: step(runner.params, batch, runner.rng), gpu)


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
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

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

    record = phase_kernels(dev, gpu)
    backward = phase_backward(dev, gpu)
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches, extractors, wavs = phase_slice(dev, gpu, tmp)
        phase_timing(extractors, wavs, gpu)
        if args.profile:
            phase_profile(extractors, wavs, gpu)
        del extractors
        runner, batch, train = phase_train(dev, gpu, tmp)
        record.update(phase_train_timing(runner, batch, gpu))
        if args.profile:
            phase_train_profile(runner, batch, gpu)

    serve = {"flash_attn_fwd": serve_launches,
             "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0}
    bwd = backward["training_dropout"]
    fwd = record["serving", "f32"]
    fwd_drop = record["training_dropout", "f32"]
    entries = [
        dict(name="flash_attn_fwd", source=FA_SOURCE, replaces=FA_REPLACES,
             max_abs_err=fwd["max_abs_err"], ms=fwd["ms"],
             plain_ms=fwd["plain_ms"], dropout_max_abs_err=fwd_drop[
                 "max_abs_err"], dropout_ms=fwd_drop["ms"],
             dropout_plain_ms=fwd_drop["plain_ms"]),
        dict(name="flash_attn_bwd_dq", source=BWD_SOURCE,
             replaces=DQ_REPLACES, max_abs_err=bwd["max_abs_err_dq"],
             **record["flash_attn_bwd_dq", "f32"]),
        dict(name="flash_attn_bwd_dkv", source=BWD_SOURCE,
             replaces=DKV_REPLACES, max_abs_err=bwd["max_abs_err_dkv"],
             **record["flash_attn_bwd_dkv", "f32"]),
    ]
    for e in entries:
        e.update(route="cuda", launches=serve[e["name"]] + train[e["name"]],
                 launches_by_path={"serve": serve[e["name"]],
                                   "train": train[e["name"]]})
    assert set(fa.launch_counts) == {e["name"] for e in entries}
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
