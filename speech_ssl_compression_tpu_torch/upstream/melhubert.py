"""MelHuBERT pretrain expert (reference upstream/melhubert/pretrain_expert.py).

Port of ``speech_ssl_compression_tpu/upstream/melhubert.py``: ``forward(data,
global_step, log_step) -> (loss, 1)`` with data = [audio_feat, label,
pad_mask, audio_len]; on ``initial_weight`` the checkpoint's architecture
(head- and row-pruned widths from the shapes) and its weight-pruning masks,
applied in every forward so training stays at the checkpoint's sparsity;
``add_state_to_save`` exports the state dict in the reference naming with
``Upstream_Config`` and ``Pruned_heads`` (reference :88-93).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..configs import MelHuBERTConfig
from ..extract import resolve_device
from ..models.melhubert import melhubert_pretrain_loss
from ..train.steps import host_span_mask, mask_params
from ..utils.checkpoint import load_checkpoint
from ..utils.torch_convert import (
    load_reference_checkpoint,
    melhubert_state_dict_to_params,
    params_to_state_dict,
)
from ..utils.weights import (
    infer_pruned_dims,
    init_params_np,
    jax_tree_from_named,
    load_model,
    masks_tree,
    named_masks,
)


def device_batch(data, device) -> dict:
    """[feat (B, T, F), label (B, T), pad_mask (B, T), ...] as the grad
    steps' batch: device tensors, and the host ``length`` (B,) the span
    mask is drawn from."""
    pad = np.asarray(data[2], np.float32)
    return {
        "feat": torch.as_tensor(np.asarray(data[0], np.float32)).to(device),
        "label": torch.as_tensor(np.asarray(data[1], np.int64)).to(device),
        "pad_mask": torch.as_tensor(pad).to(device),
        "length": (pad > 0).sum(axis=1),
    }


class MelHuBERTPretrainExpert:
    def __init__(self, upstream_config: dict,
                 initial_weight: Optional[str] = None, device: str = "cuda",
                 multi_gpu: bool = False, **kwargs):
        self.upstream_config = upstream_config
        self.device = resolve_device(device)
        self.cfg = MelHuBERTConfig.from_dict(
            dict(upstream_config["melhubert"]))
        self.pruned_heads = None
        self.rng = torch.Generator().manual_seed(0)
        masks = None
        if initial_weight and initial_weight.endswith(".npz"):
            state = load_checkpoint(initial_weight, load_opt=False)
            params, masks = state["params"], state["masks"]
            meta_cfg = state["meta"].get("Upstream_Config", {}).get(
                "melhubert")
            if meta_cfg:
                self.cfg = MelHuBERTConfig.from_dict(meta_cfg)
            self.pruned_heads = state["meta"].get("Pruned_heads")
        elif initial_weight:
            params, masks, self.cfg, extras = load_reference_checkpoint(
                initial_weight)
            self.pruned_heads = extras.get("Pruned_heads")
        else:
            params = init_params_np(self.cfg, 0)
        if initial_weight:
            print(f"[Pretrainer] Loaded initialization weight from "
                  f"{initial_weight}")
        self._set_state(params, masks)
        n = sum(p.numel() for p in self.model.parameters())
        print(f"[Pretrainer] - Number of parameters: {n}")

    def _set_state(self, params: dict, masks: Optional[dict]):
        """The model for a JAX-layout tree, at the widths its shapes give;
        ``masks`` (a JAX-layout tree) belong to this state, None for a
        dense one."""
        heads, ffns = infer_pruned_dims(params, self.cfg.head_dim)
        self.cfg = self.cfg.with_heads(heads).with_ffn_dims(ffns)
        self.model = load_model(params, self.cfg).to(self.device)
        self.masks = named_masks(masks, self.device) if masks else None

    def forward(self, data, global_step: int = 0, log_step: int = 1000,
                **kwargs):
        batch = device_batch(data, self.device)
        out = functional_call(
            self.model,
            mask_params(dict(self.model.named_parameters()), self.masks),
            (batch["feat"], batch["pad_mask"]),
            dict(mask=True, rng=self.rng, deterministic=False,
                 teacher_mask_indices=host_span_mask(self.cfg, batch,
                                                     self.rng)))
        loss, _ = melhubert_pretrain_loss(out, batch["label"],
                                          batch["pad_mask"], self.cfg)
        return loss, 1  # (loss, sample_size), reference :121

    __call__ = forward

    def load_model(self, init_ckpt: dict):
        """A JAX-layout tree (``params``, with its ``masks`` or none) or a
        state dict in the reference naming (``model``)."""
        assert "model" in init_ckpt or "params" in init_ckpt
        if "params" in init_ckpt:
            params, masks = init_ckpt["params"], init_ckpt.get("masks")
        else:
            params, masks, _ = melhubert_state_dict_to_params(
                init_ckpt["model"])
        self._set_state(params, masks)

    def add_state_to_save(self, all_states: dict) -> dict:
        all_states["model"] = params_to_state_dict(
            jax_tree_from_named(dict(self.model.named_parameters())),
            None if self.masks is None else masks_tree(self.masks))
        all_states["Upstream_Config"] = self.upstream_config
        if self.pruned_heads:
            all_states["Pruned_heads"] = self.pruned_heads
        return all_states

    def train(self):
        return self


UpstreamPretrainExpert = MelHuBERTPretrainExpert
