"""The shared HuBERT / wav2vec 2.0 pre-training benchmark recipe.

Port of ``speech_ssl_compression_tpu/train/wave_bench.py``: one definition
of the benchmarked step, so that a bench and the smoke run cannot drift
apart. Base architectures (reference model.py defaults: conv frontend
[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2, a 12-layer, 768-wide
encoder), B rows of 15.36 s of 16 kHz audio, and one grad step built from
the runners' own (``train/steps.py::make_hubert_grad_step``,
``make_wav2vec2_grad_step``), so it is their exact loss path. The numpy
draws (``source``, ``targets``, ``lengths``, ``t_frames``) are JAX's bit
for bit; the parameters come from the port's seeded init
(``utils/weights.py``), not JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs import HuBERTConfig, Wav2Vec2Config
from ..models.conv_frontend import conv_output_length
from ..utils.device import resolve_device
from ..utils.weights import (
    init_hubert_params_np,
    init_wav2vec2_params_np,
    load_wave_model,
)
from .steps import make_hubert_grad_step, make_wav2vec2_grad_step

BASE_CONV_SPEC = "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2"
BASE_COMMON = {
    "encoder_layers": 12, "encoder_embed_dim": 768,
    "encoder_attention_heads": 12, "encoder_ffn_embed_dim": 3072,
    "conv_feature_layers": BASE_CONV_SPEC, "final_dim": 256,
    "conv_pos": 128, "conv_pos_groups": 16, "mask_length": 10,
}
GUMBEL_TEMP = 2.0  # wav2vec 2.0's quantizer temperature in the bench step


def wave_bench_setup(model: str, b: int = 4, t_wave: int = 245760,
                     seed: int = 0, device="cuda") -> dict:
    """The benchmarked pre-training step's inputs. Returns a dict with
    ``cfg``, ``model`` (the port's module on ``device``, seeded weights;
    the card unless the caller asks for the CPU, and without CUDA a
    request for the card raises),
    ``source`` (B, T_wave) f32 numpy, ``lengths`` (B,) int32 numpy,
    ``t_frames`` and, for "hubert", ``targets`` (a list of one (B,
    t_frames) int32 numpy array) and ``num_classes``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    if model == "hubert":
        cfg = HuBERTConfig.from_dict({**BASE_COMMON, "mask_prob": 0.8})
        num_classes = (504,)
        params = init_hubert_params_np(cfg, num_classes, seed)
        t_frames = conv_output_length(t_wave, cfg.conv_feature_layers)
        out["targets"] = [rng.integers(0, 504, (b, t_frames)).astype(
            np.int32)]
        out["num_classes"] = num_classes
    elif model == "wav2vec2":
        cfg = Wav2Vec2Config.from_dict({
            **BASE_COMMON, "mask_prob": 0.65, "quantize_targets": True,
            "latent_vars": 320, "latent_groups": 2, "num_negatives": 100,
        })
        params = init_wav2vec2_params_np(cfg, seed)
        t_frames = conv_output_length(t_wave, cfg.conv_feature_layers)
    else:
        raise ValueError(f"unknown wave bench model: {model}")
    out["cfg"] = cfg
    out["model"] = load_wave_model(params, cfg, model).to(device)
    out["t_frames"] = t_frames
    out["source"] = rng.standard_normal((b, t_wave)).astype(np.float32)
    out["lengths"] = np.full((b,), t_wave, np.int32)
    return out


def make_wave_bench_grad_step(model: str, setup: dict, compute_dtype):
    """``grad_step(params, rng) -> grads`` over ``setup``'s batch: the
    runner's grad step (cast -> forward, masked, dropouts on -> the
    pre-training loss -> the gradients in ``params``' order), ``params``
    the model's named f32 masters and ``rng`` a host
    ``torch.Generator``."""
    net = setup["model"]
    dev = next(net.parameters()).device
    batch = {"source": torch.from_numpy(setup["source"]).to(dev),
             "length": setup["lengths"]}
    if model == "hubert":
        batch["target_list"] = [torch.from_numpy(t).long().to(dev)
                                for t in setup["targets"]]
        batch["target_valid"] = None
        step = make_hubert_grad_step(net, compute_dtype=compute_dtype)

        def grad_step(params, rng):
            return step(params, batch, rng)[2]
    else:
        step = make_wav2vec2_grad_step(net, compute_dtype=compute_dtype)

        def grad_step(params, rng):
            return step(params, batch, rng, GUMBEL_TEMP)[2]
    return grad_step
