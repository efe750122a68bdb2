"""The flash-attention CUDA kernels (forward, with and without dropout, and
the dQ and dK/dV backward) and the strided-conv kernels against their plain
PyTorch versions on the GPU, at the shapes the serving, training, long,
rectangular and causal paths give them and at the ragged edges of the
tiles; the f32 kernels against the plain versions run in float64. Needs an
NVIDIA GPU and nvcc; skipped elsewhere. On a GPU machine:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which a GPU machine
running only the port need not have.)
"""

import pytest
import torch

from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
from speech_ssl_compression_tpu_torch.ops.attention import (
    multi_head_self_attention,
    SelfAttention,
)

pytestmark = [
    pytest.mark.cuda,
    # a string condition is evaluated at setup, not while the module imports
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU"),
]

F32_BAR, LSE_BAR = 1e-4, 1e-4  # max |d| / mean |ref|; lse max |d|
GRAD_BAR = 1e-4  # rel. L2: loss, each gradient, each layer's head scores
# bf16: both sides round their output, so they may differ by one ulp where
# the f32 results straddle a rounding point; against the plain version run
# with the kernel's key tiles, few entries may differ at all
BF16_ULP_BAR, BF16_SHARE_BAR = 1.0, 0.03
# the backward also rounds dS and Pd inside, before its sums: an entry may
# lie past one ulp by at most its straddle bound
# (flash_attention.bf16_straddle_bounds; chip_smoke.py says more), and
# fewer than BF16_BEYOND_BAR of a gradient's entries may lie past one ulp
BF16_BEYOND_BAR = 0.001


@pytest.fixture(autouse=True)
def _true_f32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _bf16_diff(got, ref, valid):
    """(share of valid entries that differ, max |d| in bf16 ulps of
    max(|ref|, mean |ref|))"""
    got, ref = got.float()[valid], ref.float()[valid]
    d = (got - ref).abs()
    return float((d > 0).float().mean()), float((d / _bf16_ulp(ref)).max())


def _bf16_ulp(ref, floor=None):
    mag = ref.abs().clamp_min(float(ref.abs().mean()) if floor is None
                              else floor)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _bf16_forward_within_ulp(name, out, ref, rows, q, k, v, masks):
    """The bf16 forward's bar (chip_smoke.py says more): every valid entry
    within one ulp of the plain version walked in the kernel's key tiles.
    The kernel's scores come from the tensor cores, so a p near a bf16
    rounding point may round the other way; in the serving case, where a
    segment's few keys weigh much, an entry may lie past one ulp if it
    lies within one ulp plus its straddle bound and rounding some of its
    row's straddling p the other way brings the row within one ulp."""
    got, want = out.float(), ref.float()
    ulp = _bf16_ulp(want, float(want[rows].abs().mean()))
    d = (got - want).abs()
    beyond = (d > ulp) & rows[..., None]
    if not beyond.any():
        return True
    if name != "serving":
        return False
    bound = fa.bf16_forward_straddle_bounds(q, k, v, **masks)
    if (d > ulp + bound)[beyond].any():
        return False
    found = fa.bf16_forward_straddle_flips(
        q, k, v, out, beyond.any(dim=-1).nonzero(), ulp, **masks)
    return all(after <= BF16_ULP_BAR for *_, after in found)


def _segments(b, t, dev):
    seg = torch.zeros((b, t), dtype=torch.int32, device=dev)
    for i in range(b):
        seg[i, : 3 * t // 4] = 2 * i + 1
        seg[i, 3 * t // 4: t - 3] = 2 * i + 2
    return seg


SHAPES = {
    # name: (q shape, key length of a rectangular case)
    "serving": ((8, 12, 896, 64), None),
    "causal": ((2, 12, 1024, 64), None),
    "one_head": ((4, 1, 896, 64), None),
    "long": ((1, 12, 5000, 64), None),
    "rectangular": ((1, 12, 1024, 64), 5000),
    # the ragged edges of the tiles and of the bf16 kernels' two-stage ring:
    # T = 777 with key padding and dropout, one row and one key, one row
    # and one key past a tile
    "ragged_777": ((2, 12, 777, 64), None),
    "t1": ((2, 12, 1, 64), None),
    "t65": ((2, 12, 65, 64), None),
}


def _case(name, dev):
    qs, tk = SHAPES[name]
    b, _, tq, _ = qs
    valid = torch.ones((b, tq), dtype=torch.bool, device=dev)
    if name == "serving":
        seg = _segments(b, tq, dev)
        return qs, tk, dict(segment_ids=seg, key_padding_mask=seg == 0), seg != 0
    if name == "causal":
        pad = torch.zeros((b, tq), dtype=torch.bool, device=dev)
        pad[1, 900:] = True
        return qs, tk, dict(causal=True, key_padding_mask=pad), valid
    if name == "one_head":
        lens = torch.tensor([896, 700, 500, 101], device=dev)
        pad = torch.arange(tq, device=dev)[None, :] >= lens[:, None]
        return qs, tk, dict(key_padding_mask=pad), valid
    if name == "rectangular":
        pad = torch.zeros((b, tk), dtype=torch.bool, device=dev)
        pad[0, 4800:] = True
        return qs, tk, dict(key_padding_mask=pad), valid
    if name == "ragged_777":
        lens = torch.tensor([777, 600], device=dev)
        pad = torch.arange(tq, device=dev)[None, :] >= lens[:, None]
        return qs, tk, dict(key_padding_mask=pad, dropout_p=0.1,
                            dropout_seed=1234), valid
    return qs, tk, {}, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_matches_plain_version(name, dtype):
    dev = torch.device("cuda")
    qs, tk, masks, valid = _case(name, dev)
    ks = qs if tk is None else (qs[0], qs[1], tk, qs[3])
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype)
               for s in (qs, ks, ks))
    fa.reset_launch_counts()
    if tk is None:
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **masks)
    else:
        out, lse = fa.flash_attention_kv_full(q, k, v, return_lse=True, **masks)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attn_fwd"] == 1
    rows = valid[:, None, :].expand(lse.shape)
    if dtype == torch.float32:
        # the split-TF32 kernel's products are f32-accurate but not rounded
        # where the f32 plain version's are: it is held to the plain
        # version run in float64, out and lse
        ref, ref_lse = fa.flash_attention_reference(
            q.double(), k.double(), v.double(), **masks)
        d = (out.double() - ref)[rows].abs().max()
        assert d / ref[rows].abs().mean() < F32_BAR
    else:
        ref, ref_lse = fa.flash_attention_reference(
            q, k, v, block_k=fa.KERNEL_BLOCK_K, **masks)
        if ks[2] == 1:
            # one key: P = 1 is exact, and the output is that key's V row
            assert torch.equal(out, ref)
        else:
            share, _ = _bf16_diff(out, ref, rows)
            assert share < BF16_SHARE_BAR
            assert _bf16_forward_within_ulp(name, out, ref, rows, q, k, v,
                                            masks)
            # the check sees the rounding of P: leaving P in f32 fails it
            control, _ = fa.flash_attention_reference(
                q.float(), k.float(), v.float(), block_k=fa.KERNEL_BLOCK_K,
                **masks)
            assert _bf16_diff(control.to(dtype), ref, rows)[0] >= (
                BF16_SHARE_BAR)
    assert (lse - ref_lse)[rows].abs().max() < LSE_BAR
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


def test_cuda_tensors_never_reach_the_plain_version_unless_dense():
    dev = torch.device("cuda")
    attn = SelfAttention(128, 2, 64).to(dev).requires_grad_(False)
    x = torch.randn(2, 100, 128, device=dev)
    fa.reset_launch_counts()
    out, _ = multi_head_self_attention(x, attn, num_heads=2, head_dim=64)
    assert fa.launch_counts["flash_attn_fwd"] == 1
    ref, _ = multi_head_self_attention(x, attn, num_heads=2, head_dim=64,
                                       impl="dense")
    assert fa.launch_counts["flash_attn_fwd"] == 1
    assert (out - ref).abs().max() / ref.abs().mean() < F32_BAR


def test_kernel_refuses_what_it_does_not_take():
    q = torch.randn(1, 2, 64, 32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 2, 64, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 64, 2, 64, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)


TRAIN_SHAPE = (4, 12, 768, 64)


def _train_masks(dev, dropout_p):
    lens = torch.tensor([750, 750, 700, 512], device=dev)
    pad = torch.arange(768, device=dev)[None, :] >= lens[:, None]
    kw = dict(key_padding_mask=pad)
    if dropout_p:
        kw.update(dropout_p=dropout_p, dropout_seed=1234)
    return kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_forward_kernel_matches_plain_version(dtype):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(TRAIN_SHAPE, generator=g, device=dev).to(dtype)
               for _ in range(3))
    masks = _train_masks(dev, 0.1)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **masks)
    if dtype == torch.float32:  # against float64, as above
        ref, ref_lse = fa.flash_attention_reference(
            q.double(), k.double(), v.double(), **masks)
        assert (out.double() - ref).abs().max() / ref.abs().mean() < F32_BAR
    else:
        ref, ref_lse = fa.flash_attention_reference(
            q, k, v, block_k=fa.KERNEL_BLOCK_K, **masks)
        share, ulps = _bf16_diff(out, ref, slice(None))
        assert ulps <= BF16_ULP_BAR and share < BF16_SHARE_BAR
    assert (lse - ref_lse).abs().max() < LSE_BAR


def test_f32_forward_runs_on_the_tensor_cores_bitwise_repeatably():
    # f32 CUDA tensors launch the split-TF32 wgmma forward
    # (csrc/flash_attn_fwd_f32_sm90.cu): every instance of it (with and
    # without dropout and segment ids) has HGMMA, the library holds no
    # CUDA-core forward, and the same inputs (dropout and segments
    # included) give the same bits twice
    from speech_ssl_compression_tpu_torch.ops import _kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(TRAIN_SHAPE, generator=g, device=dev)
               for _ in range(3))
    seg = _segments(TRAIN_SHAPE[0], TRAIN_SHAPE[2], dev)
    fa.reset_launch_counts()
    for masks in (_train_masks(dev, 0.1),
                  dict(segment_ids=seg, key_padding_mask=seg == 0)):
        first = fa.flash_attention(q, k, v, return_lse=True, **masks)
        second = fa.flash_attention(q, k, v, return_lse=True, **masks)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert fa.dtype_launch_counts["flash_attn_fwd"] == {"f32": 4, "bf16": 0}
    hgmma = _kernels.sass_instruction_counts("HGMMA")
    found = [n for sym, n in hgmma.items() if "flash_attn_fwd_f32_kernel" in sym]
    assert len(found) == 4 and all(found)
    assert not [sym for sym in hgmma if "flash_attn_fwd_kernel" in sym]


BWD_CASES = {
    # name: (q shape, key length of a rectangular case, dropout)
    "training": (TRAIN_SHAPE, None, 0.0),
    "training_dropout": (TRAIN_SHAPE, None, 0.1),
    "causal": ((2, 12, 1024, 64), None, 0.0),
    "one_head": ((4, 1, 896, 64), None, 0.0),
    "rectangular": ((1, 12, 1024, 64), 5000, 0.0),
    # the packed serving shape with segments, and ragged edges of the tiles
    # and of the two-stage ring: T = 777 with key padding and dropout, one
    # row, one row past a tile
    "serving": ((8, 12, 896, 64), None, 0.0),
    "ragged_777": ((2, 12, 777, 64), None, 0.1),
    "t1": ((2, 12, 1, 64), None, 0.0),
    "t65": ((2, 12, 65, 64), None, 0.0),
}


def _bwd_masks(name, dev):
    """(forward kwargs, valid query rows (B, Tq)) of a BWD_CASES entry."""
    qs, _, p = BWD_CASES[name]
    valid = torch.ones(qs[0], qs[2], dtype=torch.bool, device=dev)
    if name.startswith("training"):
        return _train_masks(dev, p), valid
    _, _, masks, valid = _case(name, dev)
    return masks, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_backward_kernels_match_plain_version(name, dtype):
    dev = torch.device("cuda")
    qs, tk, p = BWD_CASES[name]
    masks, valid = _bwd_masks(name, dev)
    ks = qs if tk is None else (qs[0], qs[1], tk, qs[3])
    g = torch.Generator(device=dev).manual_seed(1)
    q, dout = (torch.randn(qs, generator=g, device=dev).to(dtype)
               for _ in range(2))
    # padded query rows carry dO = 0, as they do in the model
    dout = dout.masked_fill(~valid[:, None, :, None], 0.0)
    k, v = (torch.randn(ks, generator=g, device=dev).to(dtype)
            for _ in range(2))
    if tk is None:
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **masks)
    else:
        out, lse = fa.flash_attention_kv_full(q, k, v, return_lse=True,
                                              **masks)
    args = fa.backward_args(q, k, v, lse, dout, **masks)
    fa.reset_launch_counts()
    got = fa.launch_bwd(*args)
    assert fa.launch_counts["flash_attn_bwd_dq"] == 1
    assert fa.launch_counts["flash_attn_bwd_dkv"] == 1
    ref = fa.reference_bwd(*args)
    dd, ref_dd = got[3], ref[3]
    assert (dd - ref_dd).abs().max() / ref_dd.abs().mean() < F32_BAR
    if dtype == torch.float32:  # and JAX's D, rowsum(dO o O)
        jax_dd = fa.output_dd(out, dout)
        assert (dd - jax_dd).abs().max() / jax_dd.abs().mean() < F32_BAR
        # the kernels' products are f32-accurate (split TF32) but not
        # rounded where the f32 plain version's are, and that version lies
        # up to ~2e-4 from the exact function at the causal case: dq, dk
        # and dv are held to the plain version run in float64
        ref = fa.reference_bwd(*fa.float64_args(args))
    bounds = (fa.bf16_straddle_bounds(*args) if dtype == torch.bfloat16
              else (None,) * 3)
    if k.shape[2] == 1:
        # one key: dS = P o dPd - P o D cancels, so dQ and dK are zero up to
        # rounding on both sides, at the size dS K would otherwise have
        size = float((dout.float() @ v.float().mT).abs().mean()
                     * k.float().abs().mean() / 8.0)
        for a, b in zip(got[:2], ref[:2]):
            assert float(a.float().abs().max()) < F32_BAR * size
            assert float(b.float().abs().max()) < F32_BAR * size
        got, ref, bounds = got[2:3], ref[2:3], bounds[2:3]
    for a, b, bound in zip(got[:3], ref[:3], bounds):
        if dtype == torch.float32:
            assert (a - b).abs().max() / b.abs().mean() < F32_BAR
        else:
            share, _ = _bf16_diff(a, b, slice(None))
            assert share < BF16_SHARE_BAR
            d = (a.float() - b.float()).abs()
            ulp = _bf16_ulp(b.float())
            assert (d <= ulp + bound).all()
            assert float((d > ulp).float().mean()) < BF16_BEYOND_BAR
        assert torch.isfinite(a).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_goes_through_the_kernels(dtype):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, dout = (torch.randn(TRAIN_SHAPE, generator=g, device=dev)
                     .to(dtype) for _ in range(4))
    masks = _train_masks(dev, 0.1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launch_counts()
    out, lse = fa.flash_attention(*leaves, return_lse=True, **masks)
    out.backward(dout)
    assert set(fa.launch_counts.values()) == {1}
    # the forward, dropout included, gives the same bits for the same seed
    again, lse_again = fa.flash_attention(q, k, v, return_lse=True, **masks)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    # the autograd path is the dQ kernel, then the dK/dV kernel on its D
    args = fa.backward_args(q, k, v, lse, dout, **masks)
    want = fa.launch_bwd(*args)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)  # deterministic: no atomics


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_keep_bits_equal_the_plain_mask(dtype):
    # out[..., c] * T * (1 - p) counts the kept keys j = c mod 64 of a row
    # (at most 12: a bf16 output, within 2^-9, still rounds to the count)
    from speech_ssl_compression_tpu_torch.ops.dropout import attention_keep_mask

    dev = torch.device("cuda")
    b, h, t, d = TRAIN_SHAPE
    q = torch.zeros(TRAIN_SHAPE, device=dev, dtype=dtype)
    k = torch.randn(TRAIN_SHAPE, device=dev).to(dtype)
    v = torch.nn.functional.one_hot(torch.arange(t, device=dev) % d, d)
    v = v.to(dtype).expand(b, h, t, d).contiguous()
    out = fa.flash_attention(q, k, v, dropout_p=0.1, dropout_seed=5)
    counts = torch.round(out.double() * t * 0.9).long()
    keep = attention_keep_mask(5, b, h, t, t, 0.1, dev)
    assert torch.equal(counts, keep.view(b, h, t, t // d, d).sum(dim=3))


# ------------------------------------------------- strided conv kernels

CONV_F32_BAR = 1e-5  # against the plain version in float64
CONV_SHAPES = {
    # name: (B, T, C, K, O, stride)
    "t777": (2, 777, 512, 2, 512, 2),
    "t515": (2, 515, 512, 3, 512, 2),
    "layer5": (4, 3071, 512, 2, 512, 2),
    # the ragged edges of the bf16 kernels' 128-row tiles and 64-row steps:
    # one output row, one row past a tile, three batches, C != O, the last
    # input row read (T - K divisible by s) or not, taps over three phases
    "t_out1": (2, 3, 512, 3, 512, 2),
    "t_out65": (2, 131, 512, 3, 512, 2),
    "b3": (3, 777, 512, 3, 512, 2),
    "c256_o384": (2, 515, 256, 3, 384, 2),
    "k2s2_last_row": (2, 300, 512, 2, 512, 2),
    "k3s2_short": (2, 302, 512, 3, 512, 2),
    "k7s3": (2, 400, 128, 7, 128, 3),
    # the largest stride the forwards' per-phase maps take
    "k8s8": (2, 400, 128, 8, 128, 8),
}


def _conv_inputs(shape, dtype, seed=0):
    b, t, c, k, o, s = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, t, c), generator=g, device="cuda").to(dtype)
    w = (torch.randn((k, c, o), generator=g, device="cuda")
         / (k * c) ** 0.5).to(dtype)
    t_out = (t - k) // s + 1
    dy = torch.randn((b, t_out, o), generator=g, device="cuda").to(dtype)
    return x, w, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CONV_SHAPES))
def test_conv_kernels_match_plain_version(name, dtype):
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    shape = CONV_SHAPES[name]
    b, t, c, k, o, s = shape
    x, w, dy = _conv_inputs(shape, dtype)
    tc.reset_launch_counts()
    got = (tc.launch_fwd(x, w, s), tc.launch_dw(x, dy, k, s),
           tc.launch_dx(dy, w, t, s))
    torch.cuda.synchronize()
    assert set(tc.launch_counts.values()) == {1}
    last = (got[0].shape[1] - 1) * s + k
    assert not got[2][:, last:].any()  # no output reaches these rows
    if dtype == torch.float32:
        x64, w64, dy64 = x.double(), w.double(), dy.double()
        dx64, dw64 = tc.plain_grads(x64, w64, s, dy64)
        ref = (tc.conv1d_strided_plain(x64, w64, s), dw64, dx64)
        for a, r in zip(got, ref):
            assert (a.double() - r).abs().max() / r.abs().mean() < CONV_F32_BAR
    else:
        dx, dw = tc.plain_grads(x, w, s, dy)
        ref = (tc.conv1d_strided_plain(x, w, s), dw, dx)
        for a, r in zip((got[0], got[1].to(dtype), got[2]), ref):
            share, ulps = _bf16_diff(a, r, slice(None))
            assert ulps <= BF16_ULP_BAR and share < BF16_SHARE_BAR


def test_conv_autograd_goes_through_the_kernels_deterministically():
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    x, w, dy = _conv_inputs(CONV_SHAPES["t515"], torch.float32, seed=1)

    def grads():
        leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
        tc.conv1d_strided(*leaves, 2).backward(dy)
        return [leaf.grad for leaf in leaves]

    tc.reset_launch_counts()
    first, second = grads(), grads()
    assert set(tc.launch_counts.values()) == {2}
    assert all(torch.equal(a, b) for a, b in zip(first, second))  # no atomics


def test_conv_bf16_kernels_run_on_the_tensor_cores_bitwise_repeatably():
    # a bf16 CUDA tensor launches the wgmma forward, dW and dX kernels
    # (csrc/conv1d_sm90.cu): the library holds no CUDA-core bf16 instance
    # of any of them, and the same inputs give the same bits twice (the
    # split-K dW adds its slots in a fixed order; one block sums each dX
    # element)
    from speech_ssl_compression_tpu_torch.ops import _kernels
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    x, w, dy = _conv_inputs(CONV_SHAPES["b3"], torch.bfloat16, seed=2)

    def run():
        leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
        y = tc.conv1d_strided(*leaves, 2)
        y.backward(dy)
        return [y] + [leaf.grad for leaf in leaves]

    tc.reset_launch_counts()
    first, second = run(), run()
    assert tc.launch_counts == {"conv1d_fwd": 2, "conv1d_dw": 2,
                                "conv1d_dx": 2}
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    hgmma = _kernels.sass_instruction_counts("HGMMA")
    for name in ("conv1d_fwd", "conv1d_dw", "conv1d_dx"):
        assert [n for sym, n in hgmma.items() if f"{name}_bf16_kernel" in sym
                ] and all(n for sym, n in hgmma.items()
                          if f"{name}_bf16_kernel" in sym)
        assert not [sym for sym in hgmma if f"{name}_kernel" in sym
                    and "bfloat16" in sym]


def test_conv_bf16_kernels_refuse_strides_past_their_maps():
    # the forward and dW launchers (bf16 and f32) read x through per-phase
    # maps and refuse stride 9; conv1d_strided folds the stride into the
    # channels and takes it on the stride-1 kernels: k = s = 9 and k = 20,
    # s = 9, forward, dW and dX against the plain version at the bars of
    # test_conv_kernels_match_plain_version, bitwise repeatable
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    s = tc.SM90_MAX_STRIDE + 1
    x = torch.randn(1, 64, 128, device="cuda").bfloat16()
    w = torch.randn(s, 128, 128, device="cuda").bfloat16()
    dy = torch.zeros(1, 7, 128, device="cuda")
    with pytest.raises(ValueError, match="stride <= 8"):
        tc.launch_fwd(x, w, s)
    with pytest.raises(ValueError, match="stride <= 8"):
        tc.launch_dw(x, dy.bfloat16(), s, s)
    with pytest.raises(ValueError, match="stride <= 8"):
        tc.launch_fwd(x.float(), w.float(), s)
    with pytest.raises(ValueError, match="stride <= 8"):
        tc.launch_dw(x.float(), dy, s, s)

    for shape in ((2, 777, 512, 9, 512, 9), (2, 400, 128, 20, 128, 9)):
        b, t, c, k, o, s = shape
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy = _conv_inputs(shape, dtype, seed=7)

            def run():
                leaves = [x.clone().requires_grad_(),
                          w.clone().requires_grad_()]
                y = tc.conv1d_strided(*leaves, s)
                y.backward(dy)
                return [y.detach()] + [leaf.grad for leaf in leaves]

            tc.reset_launch_counts()
            got = run()
            assert tc.launch_counts == {"conv1d_fwd": 1, "conv1d_dw": 1,
                                        "conv1d_dx": 1}
            assert all(torch.equal(a, b) for a, b in zip(got, run()))
            y, dx, dw = got
            assert not dx[:, (y.shape[1] - 1) * s + k:].any()
            if dtype == torch.float32:
                x64, w64, dy64 = x.double(), w.double(), dy.double()
                dx64, dw64 = tc.plain_grads(x64, w64, s, dy64)
                ref = (tc.conv1d_strided_plain(x64, w64, s), dx64, dw64)
                for a, r in zip(got, ref):
                    assert ((a.double() - r).abs().max() / r.abs().mean()
                            < CONV_F32_BAR)
            else:
                rdx, rdw = tc.plain_grads(x, w, s, dy)
                ref = (tc.conv1d_strided_plain(x, w, s), rdx, rdw)
                for a, r in zip(got, ref):
                    share, ulps = _bf16_diff(a, r, slice(None))
                    assert ulps <= BF16_ULP_BAR and share < BF16_SHARE_BAR


def test_masked_bf16_grad_step_gives_masked_entries_zero_gradients():
    # weight pruning's grad step on the card, bf16 through the attention
    # kernels: every masked entry's gradient is exactly zero, the kept
    # ones are not all zero, and the masters are untouched (the zero-init
    # biases, smallest in magnitude, are masked whole)
    import numpy as np
    from speech_ssl_compression_tpu_torch.compress import weight_pruning as wp
    from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
    from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import (
        init_params_np, load_model, named_masks, prunable_tree,
    )

    cfg = MelHuBERTConfig.from_dict(dict(
        feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=256,
        encoder_ffn_embed_dim=512, encoder_attention_heads=4, head_dim=64,
        conv_pos=16, conv_pos_groups=4, num_cluster=32, mask_prob=0.5,
        mask_length=4))
    model = load_model(init_params_np(cfg, seed=0), cfg).cuda()
    params = dict(model.named_parameters())
    masks = named_masks(wp.global_magnitude_prune(prunable_tree(params), 0.6),
                        torch.device("cuda"))
    rng = np.random.default_rng(0)
    b, t = 4, 256
    lengths = np.array([256, 200, 130, 256])
    pad = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    batch = {"feat": torch.from_numpy(rng.standard_normal(
        (b, t, 80)).astype(np.float32)).cuda(),
        "label": torch.from_numpy(rng.integers(0, 32, (b, t))).cuda(),
        "pad_mask": torch.from_numpy(pad).cuda(), "length": lengths}
    mask = torch.from_numpy(span_mask(cfg, lengths, t, rng)).cuda()
    before = {k: v.detach().clone() for k, v in params.items()}
    step = make_melhubert_grad_step(model, compute_dtype=torch.bfloat16)
    fa.reset_launch_counts()
    loss, grads, _ = step(params, batch, torch.Generator(),
                          mask_indices=mask, masks=masks)
    torch.cuda.synchronize()
    assert set(fa.launch_counts.values()) == {cfg.encoder_layers}
    assert torch.isfinite(loss)
    named = dict(zip(params, grads))
    for name, m in masks.items():
        assert bool((named[name][m == 0] == 0).all()), name
        if name.endswith("weight"):
            assert bool(named[name][m != 0].abs().sum() > 0), name
    assert all(torch.equal(before[k], params[k]) for k in params)


def test_conv_f32_forward_runs_on_the_tensor_cores_bitwise_repeatably():
    # an f32 CUDA tensor launches the split-TF32 wgmma forward
    # (csrc/conv1d_f32_sm90.cu), which has HGMMA, and no CUDA-core forward
    # is left in the library; the same inputs give the same bits twice (one
    # block sums each output in one fixed order), through autograd too
    from speech_ssl_compression_tpu_torch.ops import _kernels
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    x, w, _ = _conv_inputs(CONV_SHAPES["b3"], torch.float32, seed=5)
    tc.reset_launch_counts()
    first, second = tc.launch_fwd(x, w, 2), tc.conv1d_strided(x, w, 2)
    assert torch.equal(first, second)
    assert tc.dtype_launch_counts["conv1d_fwd"] == {"f32": 2, "bf16": 0}
    hgmma = _kernels.sass_instruction_counts("HGMMA")
    found = [n for sym, n in hgmma.items() if "conv1d_fwd_f32_kernel" in sym]
    assert found and all(found)
    assert not [sym for sym in hgmma if "conv1d_fwd_kernel" in sym]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_bf16_dx_takes_strides_past_the_forwards_maps(dtype):
    # the dX kernels (bf16 and f32) read dy and w and store their rows
    # directly, so they have no per-phase maps and no stride cap: K = s = 9
    # against the plain version, with the bars of
    # test_conv_kernels_match_plain_version (bf16; f32 against float64)
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    s = tc.SM90_MAX_STRIDE + 1
    b, t, c, k, o = 2, 400, 128, s, 128
    _, w, dy = _conv_inputs((b, t, c, k, o, s), dtype, seed=3)
    tc.reset_launch_counts()
    got = tc.launch_dx(dy, w, t, s)
    torch.cuda.synchronize()
    assert tc.launch_counts["conv1d_dx"] == 1
    x = torch.zeros((b, t, c), device="cuda", dtype=dtype)
    if dtype == torch.float32:
        ref = tc.plain_grads(x.double(), w.double(), s, dy.double())[0]
        assert ((got.double() - ref).abs().max() / ref.abs().mean()
                < CONV_F32_BAR)
    else:
        ref = tc.plain_grads(x, w, s, dy)[0]
        share, ulps = _bf16_diff(got, ref, slice(None))
        assert ulps <= BF16_ULP_BAR and share < BF16_SHARE_BAR
    assert not got[:, (dy.shape[1] - 1) * s + k:].any()


def test_conv_f32_dw_dx_run_on_the_tensor_cores_bitwise_repeatably():
    # an f32 CUDA tensor launches the split-TF32 wgmma dW and dX
    # (csrc/conv1d_f32_sm90.cu), which have HGMMA, and no CUDA-core dW or dX
    # is left in the library; the same inputs give the same bits twice (the
    # split-K dW adds its slots in a fixed order; one block sums each dX
    # element), launched directly and through autograd
    from speech_ssl_compression_tpu_torch.ops import _kernels
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    x, w, dy = _conv_inputs(CONV_SHAPES["b3"], torch.float32, seed=6)
    t = x.shape[1]

    def run():
        leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
        tc.conv1d_strided(*leaves, 2).backward(dy)
        return [leaf.grad for leaf in leaves]

    tc.reset_launch_counts()
    direct = [tc.launch_dx(dy, w, t, 2), tc.launch_dw(x, dy, 3, 2)]
    first, second = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(direct, first))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for name in ("conv1d_dw", "conv1d_dx"):
        assert tc.dtype_launch_counts[name] == {"f32": 3, "bf16": 0}
    hgmma = _kernels.sass_instruction_counts("HGMMA")
    for name in ("conv1d_dw", "conv1d_dx"):
        found = [n for sym, n in hgmma.items() if f"{name}_f32_kernel" in sym]
        assert found and all(found)
        assert not [sym for sym in hgmma if f"{name}_kernel" in sym]


def test_conv_kernels_refuse_what_they_do_not_take():
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    x = torch.randn(1, 64, 128, device="cuda")
    w = torch.randn(3, 128, 128, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tc.launch_fwd(x.half(), w.half(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        tc.launch_fwd(torch.randn(1, 128, 64, device="cuda").transpose(1, 2),
                      w, 2)
    with pytest.raises(ValueError, match="multiples of 128"):
        tc.launch_fwd(x[..., :96].contiguous(), w[:, :96].contiguous(), 2)
    with pytest.raises(TypeError, match="one dtype"):
        tc.launch_fwd(x, w.bfloat16(), 2)


@pytest.mark.parametrize("name", ["training_dropout", "causal", "rectangular"])
def test_dq_kernel_computes_d_from_its_own_p(name):
    dev = torch.device("cuda")
    qs, tk, p = BWD_CASES[name]
    masks = (_train_masks(dev, p) if name.startswith("training")
             else _case(name, dev)[2])
    ks = qs if tk is None else (qs[0], qs[1], tk, qs[3])
    g = torch.Generator(device=dev).manual_seed(3)
    q, dout = (torch.randn(qs, generator=g, device=dev) for _ in range(2))
    k, v = (torch.randn(ks, generator=g, device=dev) for _ in range(2))
    if tk is None:
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **masks)
    else:
        out, lse = fa.flash_attention_kv_full(q, k, v, return_lse=True,
                                              **masks)
    args = fa.backward_args(q, k, v, lse, dout, **masks)
    dq, dd = fa.launch_bwd_dq(*args)
    dk, dv = fa.launch_bwd_dkv(*args, dd)
    ref_dd = fa.reference_dd(*args)
    assert (dd - ref_dd).abs().max() / ref_dd.abs().mean() < F32_BAR
    # the same D as JAX's, rowsum(dO o O), to f32 rounding
    jax_dd = fa.output_dd(out, dout)
    assert (dd - jax_dd).abs().max() / jax_dd.abs().mean() < F32_BAR
    ref = fa.reference_bwd(*fa.float64_args(args))  # as in the test above
    for a, b in zip((dq, dk, dv), ref):
        assert (a - b).abs().max() / b.abs().mean() < F32_BAR


def test_f32_backward_runs_on_the_tensor_cores_bitwise_repeatably():
    # f32 CUDA tensors launch the split-TF32 wgmma dQ and dK/dV kernels
    # (csrc/flash_attn_bwd_f32_sm90.cu): the library holds no CUDA-core
    # backward kernel, and the same inputs (dropout included) give the same
    # bits twice
    from speech_ssl_compression_tpu_torch.ops import _kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v, dout = (torch.randn(TRAIN_SHAPE, generator=g, device=dev)
                     for _ in range(4))
    masks = _train_masks(dev, 0.1)
    _, lse = fa.flash_attention(q, k, v, return_lse=True, **masks)
    args = fa.backward_args(q, k, v, lse, dout, **masks)
    fa.reset_launch_counts()
    first, second = fa.launch_bwd(*args), fa.launch_bwd(*args)
    assert fa.launch_counts["flash_attn_bwd_dq"] == 2
    assert fa.launch_counts["flash_attn_bwd_dkv"] == 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    hgmma = _kernels.sass_instruction_counts("HGMMA")
    for name in ("dq", "dkv"):
        found = [n for sym, n in hgmma.items()
                 if f"flash_attn_bwd_{name}_f32_kernel" in sym]
        assert found and all(found)
        assert not [sym for sym in hgmma
                    if f"flash_attn_bwd_{name}_kernel" in sym]


RAGGED_HEADS = (1, 3, 12, 7)  # per layer, as by_whole head pruning leaves


def _ragged_model_and_batch(seed=0):
    """A 4-layer model with RAGGED_HEADS on the card (q/k/v of 64, 192,
    768 and 448 outputs), a batch of B = 4, T = 256 with key padding and a
    fixed span mask."""
    import numpy as np
    from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
    from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
    from speech_ssl_compression_tpu_torch.utils.weights import (
        init_params_np, load_model,
    )

    cfg = MelHuBERTConfig.from_dict(dict(
        feat_emb_dim=80, encoder_layers=4, encoder_embed_dim=256,
        encoder_ffn_embed_dim=512, encoder_attention_heads=list(RAGGED_HEADS),
        head_dim=64, conv_pos=16, conv_pos_groups=4, num_cluster=32,
        mask_prob=0.5, mask_length=4))
    model = load_model(init_params_np(cfg, seed=seed), cfg).cuda()
    rng = np.random.default_rng(seed)
    b, t = 4, 256
    lengths = np.array([256, 200, 130, 256])
    pad = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    label = rng.integers(0, 32, (b, t))
    label[pad == 0] = -100
    batch = {"feat": torch.from_numpy(rng.standard_normal(
        (b, t, 80)).astype(np.float32)).cuda(),
        "label": torch.from_numpy(label).cuda(),
        "pad_mask": torch.from_numpy(pad).cuda(), "length": lengths}
    mask = torch.from_numpy(span_mask(cfg, lengths, t, rng)).cuda()
    return cfg, model, batch, mask


def _rel_l2(got, ref):
    return float(torch.linalg.vector_norm((got.double() - ref.double()))
                 / torch.linalg.vector_norm(ref.double()))


def test_data_driven_scores_f32_kernels_match_dense():
    # head scoring's f32 pass: the forward with dropout off and a fixed
    # span mask, autograd to the contexts through the f32 dQ and dK/dV
    # kernels of every layer but the first (the first layer's context lies
    # past its attention), against impl="dense"; TF32 off
    from speech_ssl_compression_tpu_torch.compress import head_pruning as hp

    cfg, model, batch, mask = _ragged_model_and_batch()
    params = dict(model.named_parameters())
    scores = {}
    for impl in ("auto", "dense"):
        fa.reset_launch_counts()
        _, scores[impl] = hp.context_scores(
            model, params, batch, mask, torch.Generator(),
            deterministic=True, attn_impl=impl)
        torch.cuda.synchronize()
        counts = dict(fa.dtype_launch_counts)
        if impl == "auto":
            assert counts["flash_attn_fwd"]["f32"] == cfg.encoder_layers
            for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
                assert counts[name]["f32"] == cfg.encoder_layers - 1
        else:
            assert not any(sum(c.values()) for c in counts.values())
    for layer, (got, ref) in enumerate(zip(scores["auto"], scores["dense"])):
        assert got.shape == (RAGGED_HEADS[layer],)
        assert _rel_l2(got, ref) < GRAD_BAR, layer


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_heads_grad_step_kernels_match_dense(dtype):
    # one grad step of a model whose layers keep 1, 3, 12 and 7 heads (the
    # q/k/v head views of 1 head are (B, 1, T, 64)), dropout off, a fixed
    # span mask. f32 (TF32 off): loss and each gradient within GRAD_BAR of
    # impl="dense". bf16: kernel and dense path round in other places, so
    # each is held to the f32 dense gradients, and the kernels' distance
    # from them may not pass the dense bf16 path's by more than 10%, over
    # all gradients and for each gradient on its own (k_proj.bias, zero in
    # exact arithmetic, against the norm of all gradients)
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )

    cfg, model, batch, mask = _ragged_model_and_batch(seed=1)
    params = dict(model.named_parameters())

    def run(impl, compute_dtype):
        step = make_melhubert_grad_step(model, compute_dtype=compute_dtype,
                                        attn_impl=impl, deterministic=True)
        fa.reset_launch_counts()
        loss, grads, _ = step(params, batch, torch.Generator(),
                              mask_indices=mask)
        torch.cuda.synchronize()
        launches = dict(fa.launch_counts)
        return loss, torch.cat([g.flatten() for g in grads]), grads, launches

    loss_k, flat_k, grads_k, launches = run("auto", dtype)
    assert set(launches.values()) == {cfg.encoder_layers}
    loss_d, flat_d, grads_d, _ = run("dense", torch.float32)
    if dtype == torch.float32:
        assert abs(float(loss_k) - float(loss_d)) / float(loss_d) < GRAD_BAR
        total = float(torch.linalg.vector_norm(flat_d.double()))
        for name, g, r in zip(params, grads_k, grads_d):
            den = (total if name.endswith("k_proj.bias")
                   else float(torch.linalg.vector_norm(r.double())))
            err = float(torch.linalg.vector_norm(g.double() - r.double()))
            assert err / den < GRAD_BAR, name
    else:
        _, flat_b, grads_b, _ = run("dense", torch.bfloat16)
        assert torch.isfinite(flat_k).all()
        bar = 1.1 * _rel_l2(flat_b, flat_d)
        assert _rel_l2(flat_k, flat_d) <= bar
        total = float(torch.linalg.vector_norm(flat_d.double()))
        for name, g, b, r in zip(params, grads_k, grads_b, grads_d):
            err = float(torch.linalg.vector_norm(g.double() - r.double()))
            if name.endswith("k_proj.bias"):
                assert err / total <= bar, name
            else:
                own = float(torch.linalg.vector_norm(b.double() - r.double()))
                assert err <= 1.1 * own, name


@pytest.mark.parametrize("loss_type", ["nomasked", "masked"])
@pytest.mark.parametrize("teacher_heads", [12, 1])
def test_distill_grad_step_kernels_match_dense(teacher_heads, loss_type):
    # one distill grad step, f32 (TF32 off), dropout off: a 3-layer
    # teacher of 12 heads a layer or of one (its q/k/v head views
    # (B, 1, T, 64)), a 2-layer student of 12, 768 wide, B = 4, T = 256 with
    # key padding (masked: one fixed span mask); the loss, its three logs
    # and every student gradient with the kernels within GRAD_BAR of
    # impl="dense", the kernels launched 3 + 2 times forward and 2 times
    # backward
    import numpy as np
    from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
    from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_distill_grad_step,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import (
        init_params_np, load_model,
    )

    wide = dict(feat_emb_dim=80, encoder_embed_dim=768,
                encoder_ffn_embed_dim=3072, head_dim=64, conv_pos=128,
                conv_pos_groups=16, num_cluster=512, mask_prob=0.7,
                mask_length=5)
    tcfg = MelHuBERTConfig.from_dict(dict(
        wide, encoder_layers=3, encoder_attention_heads=teacher_heads))
    scfg = MelHuBERTConfig.from_dict(dict(wide, encoder_layers=2,
                                          encoder_attention_heads=12))
    teacher = load_model(init_params_np(tcfg, seed=0), tcfg).cuda()
    student = load_model(init_params_np(scfg, seed=1), scfg).cuda()
    rng = np.random.default_rng(2)
    b, t = 4, 256
    lengths = np.array([256, 200, 130, 256])
    pad = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    label = rng.integers(0, 512, (b, t))
    label[pad == 0] = -100
    batch = {"feat": torch.from_numpy(rng.standard_normal(
        (b, t, 80)).astype(np.float32)).cuda(),
        "label": torch.from_numpy(label).cuda(),
        "pad_mask": torch.from_numpy(pad).cuda(), "length": lengths}
    mask = (torch.from_numpy(span_mask(tcfg, lengths, t, rng)).cuda()
            if loss_type == "masked" else None)
    params = dict(student.named_parameters())
    out = {}
    for impl in ("auto", "dense"):
        step = make_distill_grad_step(
            teacher, student, temperature=2.0, alpha=0.5, loss_type=loss_type,
            attn_impl=impl, deterministic=True)
        fa.reset_launch_counts()
        out[impl] = step(params, batch, torch.Generator(), mask_indices=mask)
        torch.cuda.synchronize()
        counts = dict(fa.launch_counts)
        if impl == "auto":
            assert counts == {"flash_attn_fwd": 5, "flash_attn_bwd_dq": 2,
                              "flash_attn_bwd_dkv": 2}
        else:
            assert not any(counts.values())
    (loss_k, grads_k, logs_k), (loss_d, grads_d, logs_d) = (out["auto"],
                                                            out["dense"])
    for a, r in [(loss_k, loss_d)] + [(logs_k[k], logs_d[k]) for k in (
            "hard_loss", "soft_loss", "teacher_loss")]:
        assert abs(float(a) - float(r)) / abs(float(r)) < GRAD_BAR
    total = float(torch.linalg.vector_norm(torch.cat(
        [g.flatten() for g in grads_d]).double()))
    for name, g, r in zip(params, grads_k, grads_d):
        den = (total if name.endswith("k_proj.bias")
               else float(torch.linalg.vector_norm(r.double())))
        err = float(torch.linalg.vector_norm(g.double() - r.double()))
        assert err / den < GRAD_BAR, name
    assert not any(p.grad is not None for p in teacher.parameters())


def _w2v2_model_and_batch(impl: str):
    """A 2-layer wav2vec 2.0 of 768 wide (12 heads) on the base frontend
    (layers 1-6 take the conv kernels with ``tc_pallas``), dropouts and
    LayerDrop off; B = 2 x 32,000 samples, row 1 cut to 25,000 (99 frames
    with 77 valid, the encoder's pad frame a padded key)."""
    import dataclasses

    import numpy as np
    from speech_ssl_compression_tpu_torch.configs import Wav2Vec2Config
    from speech_ssl_compression_tpu_torch.utils.weights import (
        init_wav2vec2_params_np, load_wave_model,
    )

    cfg = Wav2Vec2Config.from_dict(dict(
        encoder_layers=2, final_dim=256, quantize_targets=True,
        latent_vars=320, latent_groups=2, num_negatives=100, mask_prob=0.65,
        mask_length=10, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, dropout_input=0.0, dropout_features=0.0,
        feature_grad_mult=0.1))
    params = init_wav2vec2_params_np(cfg, seed=0)
    cfg = dataclasses.replace(cfg, conv_frontend_impl=impl)
    model = load_wave_model(params, cfg, "wav2vec2").cuda()
    rng = np.random.default_rng(1)
    lengths = np.array([32000, 25000])
    source = rng.uniform(-0.3, 0.3, (2, 32000)).astype(np.float32)
    source[1, 25000:] = 0.0
    return cfg, model, {"source": torch.from_numpy(source).cuda(),
                        "length": lengths}


def test_wav2vec2_grad_step_kernels_match_cudnn_dense():
    # one wav2vec 2.0 grad step, f32 (TF32 off), dropouts off, a fixed span
    # mask, negative counts and Gumbel uniforms: the loss, its logs and
    # every gradient with the attention and conv kernels within GRAD_BAR
    # of cuDNN + impl="dense", the kernels launched once per layer
    import numpy as np
    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.models import wav2vec2 as w2v
    from speech_ssl_compression_tpu_torch.models.conv_frontend import (
        frame_lengths,
    )
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_wav2vec2_grad_step,
    )

    cfg, kernel_model, batch = _w2v2_model_and_batch("tc_pallas")
    _, cudnn_model, _ = _w2v2_model_and_batch("auto")
    t = 99
    n = frame_lengths(batch["length"], cfg.conv_feature_layers, t)
    valid = torch.from_numpy(np.arange(t)[None, :] < n[:, None]).cuda()
    mask = torch.from_numpy(w2v.span_mask(
        cfg, n, t, np.random.default_rng(2))).cuda()
    counts = w2v.sample_negative_counts(
        torch.Generator(device="cuda").manual_seed(3), mask & valid, 100)
    uniform = torch.rand((2 * t * 2, 320), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(4))
    params = dict(kernel_model.named_parameters())
    out = {}
    for impl, model in (("auto", kernel_model), ("dense", cudnn_model)):
        step = make_wav2vec2_grad_step(model, attn_impl=impl)
        fa.reset_launch_counts()
        tc.reset_launch_counts()
        with matmul_precision("highest"):
            out[impl] = step(params, batch, torch.Generator(), 1.5,
                             mask_indices=mask, gumbel_uniform=uniform,
                             negative_counts=counts)
        torch.cuda.synchronize()
        launches = {**fa.launch_counts, **tc.launch_counts}
        if impl == "auto":
            assert launches == {"flash_attn_fwd": 2, "flash_attn_bwd_dq": 2,
                                "flash_attn_bwd_dkv": 2, "conv1d_fwd": 6,
                                "conv1d_dw": 6, "conv1d_dx": 6}
        else:
            assert not any(launches.values())
    (loss_k, n_k, grads_k, logs_k), (loss_d, n_d, grads_d, logs_d) = (
        out["auto"], out["dense"])
    assert int(n_k) == int(n_d) == int((mask & valid).sum()) > 0
    assert logs_k["temp"] == logs_d["temp"] == 1.5
    for a, r in [(loss_k, loss_d)] + [(logs_k[k], logs_d[k]) for k in (
            "loss_infonce", "loss_prob_perplexity", "loss_features_pen")]:
        assert abs(float(a) - float(r)) / abs(float(r)) < GRAD_BAR
    total = float(torch.linalg.vector_norm(torch.cat(
        [g.flatten() for g in grads_d]).double()))
    for name, g, r in zip(params, grads_k, grads_d):
        den = (total if name.endswith("k_proj.bias")
               else float(torch.linalg.vector_norm(r.double())))
        err = float(torch.linalg.vector_norm(g.double() - r.double()))
        assert err / den < GRAD_BAR, name


def test_wav2vec2_negative_counts_on_the_card_match_the_eq_formula():
    # the scatter-add of ones over the (B, T, N) draws against JAX's
    # formula, the (B, T, N, S) comparison of each draw with every frame's
    # rank summed over N, on the same draws on the card
    from speech_ssl_compression_tpu_torch.models import wav2vec2 as w2v

    gen = torch.Generator(device="cuda").manual_seed(0)
    mask = torch.rand((3, 300), device="cuda", generator=gen) < 0.5
    mask[2] = False
    draws, ordinal = w2v._negative_draws(gen, mask, 100)
    got = w2v.negative_counts(draws, mask)
    eq = draws[:, :, :, None] == ordinal[:, None, None, :]
    want = eq.sum(2, dtype=torch.float32) * mask[:, None, :].float()
    assert got.device.type == "cuda" and torch.equal(got, want)
    assert not got[2].any()
    assert torch.equal(got[:2].sum(-1), torch.full((2, 300), 100.0,
                                                   device="cuda"))


def _tiny_wave_extractor(tmp_path, device):
    import numpy as np
    from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
    from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import init_params_np

    cfg = MelHuBERTConfig.from_dict(dict(
        feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=128,
        encoder_ffn_embed_dim=256, encoder_attention_heads=2, head_dim=64,
        conv_pos=16, conv_pos_groups=4, num_cluster=32))
    path = tmp_path / "tiny.npz"
    if not path.exists():
        save_checkpoint(str(path), init_params_np(cfg, seed=0), meta={
            "Upstream_Config": {"melhubert": cfg.to_dict()}})
    rng = np.random.default_rng(0)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32)
            for n in (16000, 9000, 41300, 4000)]
    return MelHuBERTExtractor(str(path), device=device), wavs


def test_device_featurizer_and_forward_stream_on_the_card(tmp_path):
    # the card's fbank within 1e-4 of max |ref| of the plain CPU version on
    # the same batch; forward_stream bitwise sequential forward_packed, one
    # forward kernel launch per layer and batch
    import numpy as np
    from speech_ssl_compression_tpu_torch.ops.fbank import featurize_batch

    ext, wavs = _tiny_wave_extractor(tmp_path, "cuda")
    cpu, _ = _tiny_wave_extractor(tmp_path, "cpu")
    batch, n_samp, max_frames, stack, lengths, _ = (
        ext._assemble_wave_batch(wavs))
    got = ext.featurize_device(wavs)[0].cpu()
    ref, n_valid = featurize_batch(torch.from_numpy(batch),
                                   torch.tensor(n_samp), cpu._mean, cpu._std,
                                   max_frames, stack=stack)
    assert n_valid.tolist() == lengths
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    batches = [wavs, wavs[::-1], wavs[1:]]
    want = [ext.forward_packed(b, featurizer="device") for b in batches]
    fa.reset_launch_counts()
    out = list(ext.forward_stream(iter(batches), featurizer="device"))
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attn_fwd"] == 2 * len(batches)
    for g, w in zip(out, want):
        assert g["lengths"] == w["lengths"]
        for a, b in zip(g["hidden_states"] + [g["last_hidden_state"]],
                        w["hidden_states"] + [w["last_hidden_state"]]):
            assert torch.equal(a, b)
    assert np.isfinite(out[0]["last_hidden_state"].cpu().numpy()).all()


def test_kmeans_on_the_card_matches_the_cpu():
    import numpy as np
    from speech_ssl_compression_tpu_torch.ops.kmeans import (
        kmeans_assign,
        kmeans_fit,
    )

    rng = np.random.default_rng(0)
    true = rng.standard_normal((8, 16)).astype(np.float32) * 5
    x = (true[rng.integers(0, 8, 2048)]
         + 0.1 * rng.standard_normal((2048, 16))).astype(np.float32)
    chunks = [x[i:i + 256] for i in range(0, len(x), 256)]
    card, _ = kmeans_fit(0, chunks, 8, epochs=2, reseed_every=3,
                         device="cuda")
    host, _ = kmeans_fit(0, chunks, 8, epochs=2, reseed_every=3,
                         device="cpu")
    np.testing.assert_allclose(card, host, atol=1e-5)
    ids = kmeans_assign(torch.from_numpy(x).cuda(), torch.from_numpy(card)
                        .cuda()).cpu()
    assert torch.equal(ids, kmeans_assign(torch.from_numpy(x),
                                          torch.from_numpy(card)))
