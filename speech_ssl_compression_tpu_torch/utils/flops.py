"""Analytic dense-equivalent matmul FLOPs and the card's peak rates.

Port of ``speech_ssl_compression_tpu/utils/flops.py``: the same four FLOP
counts, integer for integer. JAX's ``PEAK_TFLOPS = 98.0`` is a TPU v5e
figure and does not come across; in its place :func:`peak_flops` gives
the peaks of the card ``torch.cuda.get_device_name()`` names (NVIDIA's
data sheets): an H100 SXM does 989 TFLOP/s dense in bf16 on the tensor
cores, and f32-accurate products in split TF32 (three TF32 products each)
at 495 / 3 = 165 TFLOP/s (f32 on the CUDA cores: 67). An unknown card
raises rather than guessing.
"""

from __future__ import annotations

from typing import Optional

import torch

# {name fragment: the card's peaks}: dense FLOP/s of products in each dtype
# on the tensor cores (torch.float32: split TF32), FLOP/s of f32 products
# on the CUDA cores ("cuda_cores"), HBM bytes/s ("bytes"). H100 SXM (80 GB
# HBM3, 700 W)
CARDS = {
    "H100 80GB HBM3": {torch.float32: 495e12 / 3, torch.bfloat16: 989e12,
                       "cuda_cores": 67e12, "bytes": 3.35e12},
}


def _card(name: Optional[str]) -> dict:
    if name is None:
        name = torch.cuda.get_device_name()
    for fragment, peaks in CARDS.items():
        if fragment in name:
            return peaks
    raise ValueError(f"no peak rates known for the card {name!r}; add its "
                     "data sheet's figures to utils/flops.py")


def peak_flops(dtype, name: Optional[str] = None,
               cuda_cores: bool = False) -> float:
    """Dense FLOP/s of the card ``name`` (default: the current CUDA
    device) for products in ``dtype`` on the tensor cores (torch.float32:
    split TF32), or with ``cuda_cores`` for f32 products on the CUDA
    cores."""
    peaks = _card(name)
    if cuda_cores:
        if dtype != torch.float32:
            raise ValueError("the CUDA cores' peak is given for float32 only")
        return peaks["cuda_cores"]
    return peaks[dtype]


def peak_bytes(name: Optional[str] = None) -> float:
    """Memory bytes/s of the card ``name`` (default: the current one)."""
    return _card(name)["bytes"]


def encoder_fwd_flops(cfg, length: int) -> int:
    """Transformer-encoder forward FLOPs over ``length`` frames: q/k/v/out
    projections, attention score and context matmuls, FFN."""
    d = cfg.encoder_embed_dim
    total = 0
    for i in range(cfg.encoder_layers):
        f = cfg.encoder_ffn_embed_dim[i]
        p = cfg.encoder_attention_heads[i] * cfg.head_dim
        total += 2 * length * (3 * d * p + p * d)  # qkv + out projections
        total += 4 * length * length * p           # scores + context
        total += 4 * length * d * f                # fc1 + fc2
    return total


def melhubert_fwd_flops(cfg, length: int, d_in: int) -> int:
    """One MelHuBERT forward over ``length`` valid frames (pre-projection,
    encoder, final cluster projection)."""
    d = cfg.encoder_embed_dim
    return (
        2 * length * d_in * d
        + encoder_fwd_flops(cfg, length)
        + 2 * length * d * cfg.num_cluster
    )


def conv_frontend_fwd_flops(conv_layers, n_samples: int) -> int:
    """Waveform conv-frontend forward FLOPs for one utterance."""
    total, n, in_d = 0, n_samples, 1
    for dim, k, s in conv_layers:
        n = (n - k) // s + 1
        total += 2 * n * dim * in_d * k
        in_d = dim
    return total


def wave_fwd_flops(cfg, t_wave: int, t_frames: int) -> int:
    """HuBERT / wav2vec 2.0 forward FLOPs per utterance (conv frontend,
    post_extract_proj, encoder; the loss and VQ matmuls are small)."""
    embed = cfg.conv_feature_layers[-1][0]
    return (
        conv_frontend_fwd_flops(cfg.conv_feature_layers, t_wave)
        + 2 * t_frames * embed * cfg.encoder_embed_dim
        + encoder_fwd_flops(cfg, t_frames)
    )
