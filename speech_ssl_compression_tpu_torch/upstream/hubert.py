"""HuBERT pretrain expert (reference
upstream/hubert/pretrain_expert.py:17-126).

Port of ``speech_ssl_compression_tpu/upstream/hubert.py`` on the port's
HuBERT model. ``data`` follows the reference criterion's sample layout
(pretrain_expert.py:98-126): ``{"net_input": {"source", "padding_mask"},
"target_list": [...]}`` with a raw-waveform source and label-rate
targets, aligned to the conv frames and encoded through the
dictionaries' symbol order on the host (reference forward_targets,
model.py:292-305). The dictionaries come as the ``dicts`` keyword, as in
the reference (runner.py:136-141). ``forward`` returns (the NCE loss
summed over the masked frames, their count).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..configs import HuBERTConfig
from ..data.dictionary import build_label_lookup
from ..extract import resolve_device
from ..models.conv_frontend import conv_output_length
from ..models.hubert import encode_aligned_targets_np, feat2tar_ratio
from ..train.steps import mask_params
from ..utils.torch_convert import (
    load_wave_initial_weight,
    wave_params_to_state_dict,
    wave_state_dict_to_params,
)
from ..utils.weights import (
    hubert_tree_from_named,
    infer_pruned_dims,
    init_hubert_params_np,
    load_hubert_model,
    masks_tree,
    named_masks,
)


class HuBERTPretrainExpert:
    def __init__(self, upstream_config: dict,
                 initial_weight: Optional[str] = None, device: str = "cuda",
                 multi_gpu: bool = False, **kwargs):
        self.upstream_config = upstream_config
        self.device = resolve_device(device)
        model_cfg = upstream_config.get("hubert") or upstream_config["model"]
        self.cfg = HuBERTConfig.from_dict(dict(model_cfg))
        self.dicts = kwargs["dicts"]
        self.num_classes = tuple(len(d) for d in self.dicts)
        self._label_lookups = [build_label_lookup(d) for d in self.dicts]
        self.sample_rate = int(upstream_config.get("sample_rate", 16000))
        self.rng = torch.Generator().manual_seed(0)
        masks = None
        if initial_weight:
            # npz or reference .ckpt: pruned widths from the shapes, the
            # weight-pruning masks kept
            params, masks, self.cfg, _, _, _ = load_wave_initial_weight(
                initial_weight, "hubert", self.cfg)
            n_embs = int(params["label_embs_concat"].shape[0])
            assert n_embs == int(sum(self.num_classes)), (
                f"checkpoint has {n_embs} label embeddings but the "
                f"dictionaries define {sum(self.num_classes)}")
            print(f"[Pretrainer] Loaded initialization weight from "
                  f"{initial_weight}")
        else:
            params = init_hubert_params_np(self.cfg, self.num_classes, 0)
        self._set_state(params, masks)
        n = sum(p.numel() for p in self.model.parameters())
        print(f"[Pretrainer] - Number of parameters: {n}")

    def _set_state(self, params: dict, masks: Optional[dict]):
        heads, ffns = infer_pruned_dims(params, self.cfg.head_dim)
        self.cfg = self.cfg.with_heads(heads).with_ffn_dims(ffns)
        self.model = load_hubert_model(params, self.cfg).to(self.device)
        self.masks = named_masks(masks, self.device) if masks else None

    def forward(self, data, global_step: int = 0, log_step: int = 1000,
                **kwargs):
        net = data["net_input"]
        source = np.asarray(net["source"], np.float32)
        if net.get("padding_mask") is not None:
            lengths = (~np.asarray(net["padding_mask"], bool)).sum(-1)
        else:
            lengths = np.full(source.shape[0], source.shape[1])
        t_frames = conv_output_length(source.shape[1],
                                      self.cfg.conv_feature_layers)
        ratio = feat2tar_ratio(self.cfg, self.sample_rate)
        target_list = []
        valid = np.zeros((source.shape[0], t_frames), bool)
        for di, labels in enumerate(data["target_list"]):
            arr, v = encode_aligned_targets_np(
                labels, t_frames, ratio, self._label_lookups[di],
                self.dicts[di].unk())
            valid |= v
            target_list.append(torch.from_numpy(arr).long().to(self.device))
        out = functional_call(
            self.model,
            mask_params(dict(self.model.named_parameters()), self.masks),
            (torch.from_numpy(source).to(self.device),
             lengths.astype(np.int64)),
            dict(mask=True, rng=self.rng, deterministic=False,
                 target_list=target_list,
                 target_valid=torch.from_numpy(valid).to(self.device)))
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
                                                         "hubert")
        else:
            params, masks = init_ckpt["model"], None
        self._set_state(params, masks)

    def add_state_to_save(self, all_states: dict) -> dict:
        all_states["model"] = wave_params_to_state_dict(
            hubert_tree_from_named(dict(self.model.named_parameters())),
            "hubert", None if self.masks is None else masks_tree(self.masks))
        all_states["Upstream_Config"] = self.upstream_config
        return all_states

    def train(self):
        return self


UpstreamPretrainExpert = HuBERTPretrainExpert
