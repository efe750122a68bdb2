"""Strided 1-D convolution for the waveform conv frontend: the CUDA kernels'
wrappers, their plain version, and the autograd Function that joins them.

Port of ``speech_ssl_compression_tpu/ops/conv1d.py`` (``conv1d_strided``
with its custom VJP). It computes

    out[b, t, o] = sum_j x[b, s*t + j, :] @ w[j, :, o]      (VALID, stride s)

for x (B, T, C) and w (K, C, O), in x's dtype with f32 accumulation. The
backward is the dW kernel (f32, cast to w's dtype, as JAX casts it) and the
dX kernel (in x's dtype; input rows that no output reaches get 0).

Routing is by device, and only by device: for CUDA tensors the wrappers
launch the hand-written kernels or raise, all on the tensor cores: f32 in
split TF32 (``csrc/conv1d_f32_sm90.cu``; the forward and dX read w split
into hi and lo in scratch by a kernel of their own, w^T for the forward,
w as it is for dX), bf16 in bf16 (``csrc/conv1d_sm90.cu``). The forwards
and dWs read x through one TMA map per stride phase, so they take stride
<= SM90_MAX_STRIDE; the dXs read dy and w and store their rows directly,
so they take any stride. CPU tensors go to
:func:`conv1d_strided_plain`, a per-tap version in plain PyTorch, and its
dX and dW come from autograd through it. ``chip_smoke.py`` holds each
kernel against that plain version on the card. Scope and error text are
JAX's ``_validate``: C and O multiples of 128, stride <= K <= 8 * stride
(every frontend layer after the first).
"""

from __future__ import annotations

import functools

import torch

from . import _kernels

_SLACK = 8  # JAX's bound on K / stride, kept for the same scope
DW_MIN_CHUNK = 256  # fewest rows of B * T_out per partial sum of dW
DW_WAVES = 4  # blocks of the dW kernel: about this many per SM
# the forwards and dWs (csrc/conv1d_f32_sm90.cu, conv1d_sm90.cu): the
# per-phase TMA maps a launch carries; the rows t of one batch in a dW
# reduction step, bf16 and f32
SM90_MAX_STRIDE = 8
DW_STEP = 64
DW_F32_STEP = 32

# launches of the CUDA kernels, counted where each is launched (read and
# reset by chip_smoke.py to show which path a run took): in all, and per
# input dtype
launch_counts = {"conv1d_fwd": 0, "conv1d_dw": 0, "conv1d_dx": 0}
dtype_launch_counts = {name: {"f32": 0, "bf16": 0} for name in launch_counts}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
        dtype_launch_counts[name] = {"f32": 0, "bf16": 0}


def _count(name: str, t: torch.Tensor) -> None:
    launch_counts[name] += 1
    dtype_launch_counts[name]["bf16" if t.dtype == torch.bfloat16
                              else "f32"] += 1


def _validate(k, c, o, stride):
    """JAX ``_validate``, its scope and its messages."""
    if stride < 1 or k < stride or k > _SLACK * stride:
        raise ValueError(
            f"conv1d_strided supports stride >= 1 and stride <= K <= "
            f"{_SLACK}*stride; got K={k}, stride={stride}"
        )
    if c % 128 or o % 128:
        raise ValueError(
            f"conv1d_strided needs C and O to be multiples of 128 "
            f"(TPU lane width); got C={c}, O={o}"
        )


def output_length(t_in: int, k: int, stride: int) -> int:
    return (t_in - k) // stride + 1


def conv1d_strided_plain(x: torch.Tensor, w: torch.Tensor,
                         stride: int) -> torch.Tensor:
    """The plain version: x and w in f32 (f64 stays f64), one matmul per tap
    over the strided slice x[:, j::s], summed, and the sum rounded to x's
    dtype once, as the kernels round only their outputs. Differentiable:
    autograd through it gives the plain dX and dW."""
    k = w.shape[0]
    t_out = output_length(x.shape[1], k, stride)
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xf, wf = x.to(acc_dtype), w.to(acc_dtype)
    out = None
    for j in range(k):
        tap = xf[:, j: j + (t_out - 1) * stride + 1: stride]
        term = torch.matmul(tap, wf[j])
        out = term if out is None else out + term
    return out.to(x.dtype)


def plain_grads(x, w, stride, dy):
    """(dX, dW) of :func:`conv1d_strided_plain` for the output gradient
    ``dy``, by autograd through it."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        ww = w.detach().requires_grad_()
        out = conv1d_strided_plain(xx, ww, stride)
        return torch.autograd.grad(out, (xx, ww), dy)


def _check_kernel_inputs(name, a, b, what):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{name}: {what} must be CUDA tensors on one device, "
                         f"got {a.device} and {b.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {a.dtype}")
    if b.dtype != a.dtype:
        raise TypeError(f"{name}: {what} must share one dtype, got {a.dtype} "
                        f"and {b.dtype}")
    for t in (a, b):
        if t.dim() != 3:
            raise ValueError(f"{name}: {what} must be 3-D, got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous {what}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs {what} 16-byte aligned")


def _is_bf16(t):
    return int(t.dtype == torch.bfloat16)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    """The SMs of a CUDA device, looked up once per process: the lookup
    costs a few microseconds, a measurable share of the host work of a dW
    launch at the frontend's smallest layers (PERF.md §6)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def phase_rows(t_in: int, stride: int) -> list:
    """Rows of x per batch in each stride phase r, as the TMA maps of the
    forward and dW kernels take them: phase r holds rows
    r, r + s, ..., so n_r = (T_in - 1 - r) // s + 1 (tap j = s q + r of
    output t reads its row t + q; the dX kernels write the same rows of
    dX, phase by phase). Raises past the SM90_MAX_STRIDE maps a launch
    carries."""
    if stride > SM90_MAX_STRIDE:
        raise ValueError(
            f"the conv forward and dW kernels take stride <= "
            f"{SM90_MAX_STRIDE} (one TMA map per phase); got stride={stride}")
    return [(t_in - 1 - r) // stride + 1 for r in range(stride)]


def launch_fwd(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """The forward kernel on CUDA tensors x (B, T, C), w (K, C, O)."""
    _check_kernel_inputs("conv1d_fwd", x, w, "x and w")
    b, t_in, c = x.shape
    k, c_w, o = w.shape
    if c_w != c:
        raise ValueError(f"conv1d_fwd: w {tuple(w.shape)} does not take C={c}")
    _validate(k, c, o, stride)
    phase_rows(t_in, stride)
    if t_in < k:
        raise ValueError(f"conv1d_fwd: T={t_in} is shorter than K={k}")
    out = torch.empty((b, output_length(t_in, k, stride), o), dtype=x.dtype,
                      device=x.device)
    # the f32 kernel's w^T (O, K C), split into hi and lo
    wt = (None if x.dtype == torch.bfloat16 else
          torch.empty((2, o, k * c), dtype=torch.float32, device=x.device))
    lib = _kernels.load()
    err = lib.sslc_conv1d_fwd(x.data_ptr(), w.data_ptr(),
                              None if wt is None else wt.data_ptr(),
                              out.data_ptr(), b, t_in, c, k, o, stride,
                              _is_bf16(x), x.device.index, _stream(x))
    _kernels.check(lib, err, "conv1d_fwd launch")
    _count("conv1d_fwd", x)
    return out


def _n_splits(units: int, min_units: int, blocks_per_split: int,
              n_sm: int) -> int:
    """Enough splits that the grid, ``blocks_per_split`` blocks each, gives
    every one of the ``n_sm`` SMs about DW_WAVES blocks, and no more (the
    f32 scratch holds one dW per split and the reduction reads them all),
    with at least ``min_units`` units a split where there are that many."""
    want = max(1, (DW_WAVES * n_sm) // blocks_per_split)
    return max(1, min(want, units // min_units))


def dw_tile_splits(b: int, t_out: int, blocks_per_split: int, n_sm: int,
                   step: int = DW_STEP):
    """(chunk, n_split) of a dW kernel, in reduction steps of ``step``
    rows (DW_STEP for bf16, DW_F32_STEP for f32): step i is batch i // s_b,
    rows t = step * (i % s_b) .. + step - 1 (those past T_out read dy as
    zeros), with s_b = ceil(T_out / step) steps a batch. Split k sums steps
    k * chunk .. min(B s_b, (k + 1) chunk) - 1 in that order. The number of
    splits is :func:`_n_splits`'s (about DW_WAVES blocks per SM, at least
    DW_MIN_CHUNK rows a chunk), so the sum order is a function of the
    shape and the card alone."""
    total = b * -(-t_out // step)
    n_split = _n_splits(total, DW_MIN_CHUNK // step, blocks_per_split, n_sm)
    chunk = -(-total // n_split)
    return chunk, -(-total // chunk)


def dw_plan(dtype, b: int, t_out: int, k: int, c: int, o: int, n_sm: int):
    """(chunk, n_split, scratch shape or None) of the dW kernels, chunks
    in steps of DW_STEP rows (bf16) or DW_F32_STEP rows (f32) of one batch
    (:func:`dw_tile_splits`); both use one block per (128 x 128 tile of dW,
    tap, chunk). With more than one chunk, each writes its own f32 (K, C, O)
    slot of the scratch, and a second kernel adds the slots in chunk
    order."""
    blocks = k * (c // 128) * (o // 128)
    step = DW_STEP if dtype == torch.bfloat16 else DW_F32_STEP
    chunk, n_split = dw_tile_splits(b, t_out, blocks, n_sm, step)
    return chunk, n_split, (n_split, k, c, o) if n_split > 1 else None


def launch_dw(x: torch.Tensor, dy: torch.Tensor, k: int,
              stride: int) -> torch.Tensor:
    """The dW kernel on CUDA tensors x (B, T, C), dy (B, T_out, O): dW
    (K, C, O) in f32."""
    _check_kernel_inputs("conv1d_dw", x, dy, "x and dy")
    b, t_in, c = x.shape
    o = dy.shape[2]
    _validate(k, c, o, stride)
    if dy.shape[:2] != (b, output_length(t_in, k, stride)):
        raise ValueError(f"conv1d_dw: dy {tuple(dy.shape)} is not the output "
                         f"of x {tuple(x.shape)} at K={k}, stride={stride}")
    phase_rows(t_in, stride)
    chunk, n_split, scratch = dw_plan(x.dtype, b, dy.shape[1], k, c, o,
                                      _sm_count(x.device.index))
    dw = torch.empty((k, c, o), dtype=torch.float32, device=x.device)
    partial = (torch.empty(scratch, dtype=torch.float32, device=x.device)
               if scratch else None)
    lib = _kernels.load()
    err = lib.sslc_conv1d_dw(
        x.data_ptr(), dy.data_ptr(),
        None if partial is None else partial.data_ptr(), dw.data_ptr(),
        b, t_in, c, k, o, stride, chunk, n_split, _is_bf16(x),
        x.device.index, _stream(x))
    _kernels.check(lib, err, "conv1d_dw launch")
    _count("conv1d_dw", x)
    return dw


def launch_dx(dy: torch.Tensor, w: torch.Tensor, t_in: int,
              stride: int) -> torch.Tensor:
    """The dX kernel on CUDA tensors dy (B, T_out, O), w (K, C, O): dX
    (B, t_in, C) in dy's dtype, any stride the scope allows (the kernels
    have no per-phase maps to cap it)."""
    _check_kernel_inputs("conv1d_dx", dy, w, "dy and w")
    b, t_out, o = dy.shape
    k, c, o_w = w.shape
    if o_w != o:
        raise ValueError(f"conv1d_dx: w {tuple(w.shape)} does not give O={o}")
    _validate(k, c, o, stride)
    if t_out != output_length(t_in, k, stride):
        raise ValueError(f"conv1d_dx: T_out={t_out} is not the output length "
                         f"of T={t_in} at K={k}, stride={stride}")
    dx = torch.empty((b, t_in, c), dtype=dy.dtype, device=dy.device)
    # the f32 kernel's w (K C, O), split into hi and lo
    ws = (None if dy.dtype == torch.bfloat16 else
          torch.empty((2, k * c, o), dtype=torch.float32, device=dy.device))
    lib = _kernels.load()
    err = lib.sslc_conv1d_dx(dy.data_ptr(), w.data_ptr(),
                             None if ws is None else ws.data_ptr(),
                             dx.data_ptr(), b, t_in, c, k, o, stride,
                             _is_bf16(dy), dy.device.index, _stream(dy))
    _kernels.check(lib, err, "conv1d_dx launch")
    _count("conv1d_dx", dy)
    return dx


def _route(x):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"conv1d_strided: no route for device {x.device}")
    return x.device.type == "cuda"


class _Conv1dStrided(torch.autograd.Function):
    """Port of JAX's custom VJP: the forward kernel, and for the gradient
    the dW kernel (f32, cast to w's dtype) and the dX kernel (cast to x's
    dtype); on the CPU the plain version and autograd through it."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        if _route(x):
            return launch_fwd(x, w, stride)
        return conv1d_strided_plain(x, w, stride)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        s = ctx.stride
        if not _route(x):
            dx, dw = plain_grads(x, w, s, dy)
            return dx, dw, None
        dy = dy.to(x.dtype).contiguous()
        need_x, need_w, _ = ctx.needs_input_grad
        dw = launch_dw(x, dy, w.shape[0], s).to(w.dtype) if need_w else None
        dx = launch_dx(dy, w, x.shape[1], s).to(x.dtype) if need_x else None
        return dx, dw, None


def conv1d_strided(x: torch.Tensor, w: torch.Tensor,
                   stride: int) -> torch.Tensor:
    """VALID strided conv, x (B, T, C) @ w (K, C, O) -> (B, T_out, O), port
    of JAX ``conv1d_strided`` (its ``block_t`` is a VMEM tile size and has
    no counterpart). Needs C and O multiples of 128 and stride <= K <=
    8 * stride. Differentiable in x and w."""
    _validate(w.shape[0], x.shape[2], w.shape[2], stride)
    return _Conv1dStrided.apply(x, w, int(stride))
