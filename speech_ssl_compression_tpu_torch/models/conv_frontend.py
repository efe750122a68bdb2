"""The waveform conv frontend of HuBERT and wav2vec 2.0.

Port of ``speech_ssl_compression_tpu/models/conv_frontend.py`` (reference
module.py:270-394, ConvFeatureExtractionModel with Fp32GroupNorm /
Fp32LayerNorm). :class:`ConvFeatureExtractor` holds the parameters under
the reference names (``conv_layers.{i}.0.weight`` (O, I, K), ``.0.bias``
with conv_bias, ``.2.weight``/``.2.bias`` for the GroupNorm of the default
mode's first layer, ``.2.1.weight``/``.2.1.bias`` in layer_norm mode);
the forward is the plain functions below, in JAX's feature-last layout
(B, T, C) throughout.

``conv_frontend_impl`` keeps JAX's values. "tc_pallas" runs every layer
whose channel counts are multiples of 128 (layers 1-6 of the base spec)
through the port's CUDA strided-conv kernels (``ops/conv1d.py``), the
counterpart of the Pallas kernel. Every other value runs those layers
through cuDNN (``F.conv1d``): "auto", "tc_conv" and "nch" are the JAX
formulations of the same function, and the TPU-only variants "tc_fold",
"tc_matmul" and "tc_taps" (and ``conv_frontend_barrier``) rearrange it
for XLA's TPU layouts and are not carried over. Layer 0 (one input
channel) is an im2col matmul in every mode, as in JAX. Norms run in f32
whatever the compute dtype, and GELU is the exact erf form.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import at_least_f32, gelu
from ..ops.conv1d import conv1d_strided
from ..ops.dropout import dropout

NORM_EPS = 1e-5
FRONTEND_IMPLS = ("auto", "tc_conv", "tc_pallas", "tc_fold", "tc_matmul",
                  "tc_taps", "nch")


class ConvFeatureExtractor(nn.Module):
    """``conv_layers.{i}``: a Sequential whose index 0 is the Conv1d and
    index 2 the norm (a GroupNorm(C, C) on layer 0 in the default mode, a
    Sequential(Identity, LayerNorm, Identity) in layer_norm mode)."""

    def __init__(self, conv_layers, mode: str = "default",
                 conv_bias: bool = False):
        super().__init__()
        if mode not in ("default", "layer_norm"):
            raise ValueError(f"unknown extractor_mode {mode!r}")
        blocks = []
        in_d = 1
        for i, (dim, k, stride) in enumerate(conv_layers):
            if mode == "layer_norm":
                norm = nn.Sequential(nn.Identity(),
                                     nn.LayerNorm(dim, eps=NORM_EPS),
                                     nn.Identity())
            elif i == 0:
                norm = nn.GroupNorm(dim, dim, eps=NORM_EPS)
            else:
                norm = nn.Identity()
            blocks.append(nn.Sequential(
                nn.Conv1d(in_d, dim, k, stride=stride, bias=conv_bias),
                nn.Identity(), norm, nn.Identity()))
            in_d = dim
        self.conv_layers = nn.ModuleList(blocks)


def _instance_norm_f32(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm(C, C) over time per channel, in f32. x: (B, T, C)."""
    x32 = at_least_f32(x)
    var, mean = torch.var_mean(x32, dim=1, keepdim=True, correction=0)
    out = (x32 - mean) * torch.rsqrt(var + NORM_EPS)
    return (out * norm.weight.to(x32.dtype)
            + norm.bias.to(x32.dtype)).to(x.dtype)


def _channel_layer_norm_f32(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm over channels, in f32. x: (B, T, C)."""
    x32 = at_least_f32(x)
    return F.layer_norm(x32, ln.normalized_shape, ln.weight.to(x32.dtype),
                        ln.bias.to(x32.dtype), NORM_EPS).to(x.dtype)


def _im2col_matmul(x: torch.Tensor, w_oik: torch.Tensor, k: int,
                   stride: int) -> torch.Tensor:
    """Strided conv as patches @ weights (JAX ``_im2col_matmul``): the k
    strided slices side by side on the feature axis, one matmul. x (B, T, C)
    -> (B, T_out, O); w_oik the torch-layout (O, I, K) weight."""
    b, t, c = x.shape
    t_out = (t - k) // stride + 1
    patches = torch.cat(
        [x[:, j: j + (t_out - 1) * stride + 1: stride] for j in range(k)],
        dim=-1)  # (B, T_out, k * C), feature index j * C + c
    w2 = w_oik.permute(2, 1, 0).reshape(k * c, -1)
    return torch.matmul(patches, w2.to(x.dtype))


def _cudnn_conv(x: torch.Tensor, w_oik: torch.Tensor,
                stride: int) -> torch.Tensor:
    return F.conv1d(x.transpose(1, 2), w_oik.to(x.dtype),
                    stride=stride).transpose(1, 2)


def conv_frontend_forward_tc(fe: ConvFeatureExtractor, conv_layers,
                             source: torch.Tensor,
                             impl: str = "auto") -> torch.Tensor:
    """source (B, T_wave) -> features (B, T_frames, C), port of JAX
    ``conv_frontend_forward_tc``: conv (+ bias), the f32 norm, GELU per
    layer. ``impl`` is a ``conv_frontend_impl`` value (module docstring)."""
    if impl not in FRONTEND_IMPLS:
        raise ValueError(f"unknown conv_frontend_impl {impl!r}")
    x = source[:, :, None]
    for i, (block, (dim, k, stride)) in enumerate(zip(fe.conv_layers,
                                                      conv_layers)):
        conv, norm = block[0], block[2]
        w = conv.weight  # (O, I, K)
        if i == 0:
            x = _im2col_matmul(x, w, k, stride)
        elif impl == "tc_pallas" and x.shape[-1] % 128 == 0 and dim % 128 == 0:
            x = conv1d_strided(x, w.permute(2, 1, 0).contiguous().to(x.dtype),
                               stride)
        else:
            x = _cudnn_conv(x, w, stride)
        if conv.bias is not None:
            x = x + conv.bias.to(x.dtype)
        if isinstance(norm, nn.GroupNorm):
            x = _instance_norm_f32(x, norm)
        elif isinstance(norm, nn.Sequential):
            x = _channel_layer_norm_f32(x, norm[1])
        x = gelu(x)
    return x


def conv_output_length(n_samples: int, conv_layers) -> int:
    for _, k, stride in conv_layers:
        n_samples = (n_samples - k) // stride + 1
    return n_samples


def conv_downsample_rate(conv_layers) -> int:
    return int(np.prod([s for _, _, s in conv_layers]))


class _GradMultiply(torch.autograd.Function):
    """Identity forward, gradient times ``scale`` (reference module.py:259,
    JAX's stop_gradient form)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def frame_lengths(wave_lengths, conv_layers, t_frames: int) -> np.ndarray:
    """(B,) valid conv frames of rows of ``wave_lengths`` valid samples,
    clipped to [0, t_frames] (JAX ``wave_frontend_forward``'s length
    arithmetic)."""
    n = np.asarray(wave_lengths, np.int64)
    for _, k, s in conv_layers:
        n = (n - k) // s + 1
    return np.clip(n, 0, t_frames)


def wave_frontend_forward(
    model: nn.Module,
    cfg,
    source: torch.Tensor,  # (B, T_wave)
    wave_lengths,          # (B,) host ints: valid samples per row
    *,
    generator: Optional[torch.Generator] = None,  # on source's device
    deterministic: bool = True,
):
    """Port of JAX ``wave_frontend_forward`` (reference model.py:276-346):
    the conv features, GradMultiply (whose scale also reaches the feature
    penalty, computed after it), the feature penalty mean(f^2) in f32, the
    LayerNorm, the frame-valid mask from the conv length arithmetic,
    ``post_extract_proj`` and the input dropout. ``model`` holds
    ``feature_extractor``, ``layer_norm`` and an optional
    ``post_extract_proj``. Returns (x, unmasked_features, frame_valid (B, T')
    bool, out_len (B,) numpy, features_pen)."""
    features = conv_frontend_forward_tc(
        model.feature_extractor, cfg.conv_feature_layers, source,
        getattr(cfg, "conv_frontend_impl", "auto"))
    if cfg.feature_grad_mult == 0:
        features = features.detach()
    elif cfg.feature_grad_mult != 1.0:
        features = _GradMultiply.apply(features, float(cfg.feature_grad_mult))
    features_pen = torch.mean(at_least_f32(features) ** 2)

    x = F.layer_norm(features, model.layer_norm.normalized_shape,
                     model.layer_norm.weight.to(features.dtype),
                     model.layer_norm.bias.to(features.dtype), NORM_EPS)
    unmasked_features = x
    b, t_frames, _ = x.shape
    out_len = frame_lengths(wave_lengths, cfg.conv_feature_layers, t_frames)
    frame_valid = (torch.arange(t_frames, device=x.device)[None, :]
                   < torch.from_numpy(out_len).to(x.device)[:, None])
    proj = getattr(model, "post_extract_proj", None)
    if proj is not None:
        x = proj(x)
    x = dropout(x, cfg.dropout_input, generator, deterministic)
    return x, unmasked_features, frame_valid, out_len, features_pen
