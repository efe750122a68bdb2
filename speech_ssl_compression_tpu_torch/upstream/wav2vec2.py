"""wav2vec 2.0 pretrain expert (reference
upstream/wav2vec2/pretrain_expert.py:16-115).

Port of ``speech_ssl_compression_tpu/upstream/wav2vec2.py`` on the port's
wav2vec 2.0 model. ``data`` follows the reference criterion's sample
layout: ``{"net_input": {"source", "padding_mask"}}`` with a raw-waveform
source. The Gumbel temperature anneals with ``global_step`` as the
reference's set_num_updates does (gumbel_vector_quantizer.py:95-99).
``forward`` returns (the loss, the masked-frame count).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..configs import Wav2Vec2Config
from ..extract import resolve_device
from ..models.gumbel_vq import anneal_temp
from ..train.steps import mask_params
from ..utils.torch_convert import (
    load_wave_initial_weight,
    wave_params_to_state_dict,
    wave_state_dict_to_params,
)
from ..utils.weights import (
    infer_pruned_dims,
    init_wav2vec2_params_np,
    load_wave_model,
    masks_tree,
    named_masks,
    wave_tree_from_named,
)


class Wav2Vec2PretrainExpert:
    def __init__(self, upstream_config: dict,
                 initial_weight: Optional[str] = None, device: str = "cuda",
                 multi_gpu: bool = False, **kwargs):
        self.upstream_config = upstream_config
        self.device = resolve_device(device)
        model_cfg = upstream_config.get("wav2vec2") or upstream_config["model"]
        self.cfg = Wav2Vec2Config.from_dict(dict(model_cfg))
        self.rng = torch.Generator().manual_seed(0)
        masks = None
        if initial_weight:
            # npz or reference .ckpt: pruned widths from the shapes, the
            # weight-pruning masks kept
            params, masks, self.cfg, _, _, _ = load_wave_initial_weight(
                initial_weight, "wav2vec2", self.cfg)
            print(f"[Pretrainer] Loaded initialization weight from "
                  f"{initial_weight}")
        else:
            params = init_wav2vec2_params_np(self.cfg, 0)
        self._set_state(params, masks)
        n = sum(p.numel() for p in self.model.parameters())
        print(f"[Pretrainer] - Number of parameters: {n}")

    def _set_state(self, params: dict, masks: Optional[dict]):
        heads, ffns = infer_pruned_dims(params, self.cfg.head_dim)
        self.cfg = self.cfg.with_heads(heads).with_ffn_dims(ffns)
        self.model = load_wave_model(params, self.cfg,
                                     "wav2vec2").to(self.device)
        self.masks = named_masks(masks, self.device) if masks else None

    def forward(self, data, global_step: int = 0, log_step: int = 1000,
                **kwargs):
        net = data["net_input"]
        source = np.asarray(net["source"], np.float32)
        if net.get("padding_mask") is not None:
            lengths = (~np.asarray(net["padding_mask"], bool)).sum(-1)
        else:
            lengths = np.full(source.shape[0], source.shape[1])
        out = functional_call(
            self.model,
            mask_params(dict(self.model.named_parameters()), self.masks),
            (torch.from_numpy(source).to(self.device),
             lengths.astype(np.int64)),
            dict(compute_loss=True, mask=True, rng=self.rng,
                 deterministic=False,
                 gumbel_temp=anneal_temp(self.cfg.latent_temp, global_step)))
        return out["loss"], int(out["sample_size"])

    __call__ = forward

    def load_model(self, init_ckpt: dict):
        """A JAX-layout tree (``params``, with its ``masks`` or none), or
        under ``model`` a state dict in the reference naming or a tree."""
        assert "model" in init_ckpt or "params" in init_ckpt
        if "params" in init_ckpt:
            params, masks = init_ckpt["params"], init_ckpt.get("masks")
        elif any("." in k for k in init_ckpt["model"]):
            params, masks, _ = wave_state_dict_to_params(init_ckpt["model"],
                                                         "wav2vec2")
        else:
            params, masks = init_ckpt["model"], None
        self._set_state(params, masks)

    def add_state_to_save(self, all_states: dict) -> dict:
        all_states["model"] = wave_params_to_state_dict(
            wave_tree_from_named(dict(self.model.named_parameters()),
                                 "wav2vec2"),
            "wav2vec2", None if self.masks is None else masks_tree(self.masks))
        all_states["Upstream_Config"] = self.upstream_config
        return all_states

    def train(self):
        return self


UpstreamPretrainExpert = Wav2Vec2PretrainExpert
