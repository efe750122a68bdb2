"""MelHuBERT distiller expert
(reference upstream/melhubert_distiller/pretrain_expert.py).

Port of ``speech_ssl_compression_tpu/upstream/melhubert_distiller.py``:
the teacher from ``initial_weight`` (``load_any_checkpoint``: masks
folded, pruned widths inferred; its config is the checkpoint's), frozen;
the student from the ``student:`` (or legacy ``melhubert:``) section,
seeded, with ``initial_from_teacher``'s copies; ``forward`` runs
``compress/distillation.py::distill_forward``. As in JAX, ``forward``
returns (loss, sample_size): the reference returns a bare loss (:141)
while its runner unpacks two values (runner.py:364).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..compress.distillation import distill_forward, init_student_from_teacher
from ..configs import MelHuBERTConfig
from ..extract import load_any_checkpoint, resolve_device
from ..train.steps import host_span_mask
from ..utils.torch_convert import (
    melhubert_state_dict_to_params,
    params_to_state_dict,
)
from ..utils.weights import (
    infer_pruned_dims,
    init_params_np,
    jax_tree_from_named,
    load_model,
)
from .melhubert import device_batch


class MelHuBERTDistillerExpert:
    def __init__(self, upstream_config: dict, initial_weight: Optional[str],
                 device: str = "cuda", multi_gpu: bool = False, **kwargs):
        if not initial_weight:
            raise ValueError("specify the teacher's weight via -i")
        self.upstream_config = upstream_config
        self.device = resolve_device(device)
        student = dict(upstream_config.get("student")
                       or upstream_config["melhubert"])
        self.student_cfg = MelHuBERTConfig.from_dict(student)
        tparams, self.teacher_cfg, _ = load_any_checkpoint(initial_weight)
        self.teacher = load_model(tparams, self.teacher_cfg).to(
            self.device).eval().requires_grad_(False)
        print(f"[Distiller] - Loaded teacher weight from {initial_weight}")

        self.rng = torch.Generator().manual_seed(0)
        params = init_params_np(self.student_cfg, 0)
        if student.get("initial_from_teacher", False):
            print("[Distiller] - Initializing from teacher")
            params = init_student_from_teacher(
                params, tparams, self.student_cfg.encoder_layers)
        self.model = load_model(params, self.student_cfg).to(self.device)

        lp = upstream_config["loss_param"]
        self.loss_temp = float(lp["T"])
        self.loss_alpha = float(lp["alpha"])
        self.loss_type = str(lp["type"])
        if self.loss_type not in ("masked", "nomasked"):
            raise NotImplementedError(
                f"[Distiller] - No such loss type {self.loss_type}")
        n = sum(p.numel() for p in self.model.parameters())
        print(f"[Distiller] - Number of parameters: {n}")

    def forward(self, data, global_step: int = 0, log_step: int = 1000,
                **kwargs):
        batch = device_batch(data, self.device)
        mask = (host_span_mask(self.teacher_cfg, batch, self.rng)
                if self.loss_type == "masked" else None)
        loss, _ = distill_forward(
            self.teacher, self.model, batch["feat"], batch["pad_mask"],
            batch["label"], temperature=self.loss_temp, alpha=self.loss_alpha,
            loss_type=self.loss_type, mask_indices=mask, rng=self.rng)
        return loss, 1

    __call__ = forward

    def load_model(self, init_ckpt: dict):
        """The student from a JAX-layout tree (``params``) or a state dict
        in the reference naming (``model``)."""
        if "params" in init_ckpt:
            params = init_ckpt["params"]
        else:
            params, _, _ = melhubert_state_dict_to_params(init_ckpt["model"])
        heads, ffns = infer_pruned_dims(params, self.student_cfg.head_dim)
        self.student_cfg = self.student_cfg.with_heads(heads).with_ffn_dims(
            ffns)
        self.model = load_model(params, self.student_cfg).to(self.device)

    def add_state_to_save(self, all_states: dict) -> dict:
        all_states["model"] = params_to_state_dict(
            jax_tree_from_named(dict(self.model.named_parameters())))
        all_states["Upstream_Config"] = self.upstream_config
        return all_states

    def train(self):
        return self


UpstreamPretrainExpert = MelHuBERTDistillerExpert
