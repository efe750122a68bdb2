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
    # and so do the f32 forward and dW, which read x through per-phase maps
    # too (the f32 forward refuses stride 9, so autograd never reaches an
    # f32 dW there)
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
