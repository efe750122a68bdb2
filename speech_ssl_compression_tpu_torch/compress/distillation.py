"""Knowledge distillation: a 12-layer MelHuBERT teacher into a smaller
student (the reference's upstream/melhubert_distiller/pretrain_expert.py).

Port of ``speech_ssl_compression_tpu/compress/distillation.py``. The
teacher runs without grad and without dropout; its span mask, drawn on the
host from the TEACHER's config (``train/steps.py::host_span_mask``), masks
its own input and is replayed into the student, which masks with it only
where its own ``mask_prob > 0`` (JAX ``models/melhubert.py:93``). With
``loss_type="nomasked"``, what both shipped YAMLs say, neither model masks
and the loss runs over every valid frame (JAX :116-120).

Loss (reference loss_fn_kd, :83-92):
  total = (1 - alpha) * CE(student, labels)
          + alpha * KL(softmax(teacher / T) || softmax(student / T))
over the selected frames, the KL divided by their count (batchmean) and,
as in the reference, not scaled by T^2. Labels of -100 are excluded inside
``masked_cross_entropy``; the teacher's CE is logged as ``teacher_loss``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..models.melhubert import masked_cross_entropy


def kd_soft_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 select: torch.Tensor, temperature: float,
                 total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KLDiv (batchmean) over the selected frames: the mean over them of
    sum_c p_t * (log p_t - log p_s), on temperature-softened logits in f32
    (JAX ``kd_soft_loss``); divided by ``total`` where given (a
    data-parallel rank's share of the global batch's mean)."""
    t = temperature
    logp_s = torch.log_softmax(student_logits.float() / t, dim=-1)
    logp_t = torch.log_softmax(teacher_logits.float() / t, dim=-1)
    p_t = torch.exp(logp_t)
    per_frame = torch.sum(p_t * (logp_t - logp_s), dim=-1)  # (B, T)
    count = select.sum() if total is None else total
    return (torch.where(select, per_frame, torch.zeros_like(per_frame)).sum()
            / count.clamp_min(1))


def distillation_loss(student_out: dict, teacher_out: dict,
                      labels: torch.Tensor, pad_mask: torch.Tensor, *,
                      temperature: float, alpha: float,
                      loss_type: str = "masked",
                      totals: Optional[dict] = None):
    """Returns (total_loss, logs) with logs ``hard_loss``, ``soft_loss``
    and ``teacher_loss`` (JAX ``distillation_loss``). ``loss_type`` selects
    the student's masked or unmasked valid frames (reference
    'masked'/'nomasked', :127-139). ``totals`` ({"hard", "soft"}: the
    global batch's counts of :func:`distill_selections`) are a
    data-parallel rank's divisors."""
    totals = totals or {}
    valid = pad_mask.to(torch.bool)
    mask_indices = student_out["mask_indices"]
    if loss_type == "masked":
        select = valid & mask_indices
    elif loss_type == "nomasked":
        select = valid & ~mask_indices
    else:
        raise NotImplementedError(loss_type)
    t_logits = teacher_out["logits"].detach()
    hard_loss, _ = masked_cross_entropy(student_out["logits"], labels, select,
                                        totals.get("hard"))
    teacher_loss, _ = masked_cross_entropy(t_logits, labels, select,
                                           totals.get("hard"))
    soft_loss = kd_soft_loss(student_out["logits"], t_logits, select,
                             temperature, totals.get("soft"))
    total = hard_loss * (1.0 - alpha) + soft_loss * alpha
    logs = {"hard_loss": hard_loss, "soft_loss": soft_loss,
            "teacher_loss": teacher_loss}
    return total, logs


def distill_selections(mask_indices: Optional[torch.Tensor],
                       labels: torch.Tensor, pad_mask: torch.Tensor,
                       loss_type: str = "masked") -> dict:
    """The frames the KD loss's terms average over: {"hard": the selected
    frames with a label, "soft": the selected frames}."""
    valid = pad_mask.to(torch.bool)
    mask = (torch.zeros_like(valid) if mask_indices is None
            else mask_indices.to(torch.bool))
    select = valid & mask if loss_type == "masked" else valid & ~mask
    return {"hard": select & (labels != -100), "soft": select}


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return np.array(tree, copy=True)


def init_student_from_teacher(student_params: dict, teacher_params: dict,
                              n_student_layers: int) -> dict:
    """The student's JAX-layout numpy tree with ``encoder.pos_conv`` and
    the first ``n_student_layers`` encoder layers replaced by copies of
    the teacher's (reference :60-69, JAX ``init_student_from_teacher``).
    Nothing else is copied: ``pre_extract_proj``, ``final_proj``, the
    encoder LayerNorm and ``mask_emb`` keep the student's own init. Every
    copied leaf is a new array, so no update of the student reaches the
    teacher; the input trees are left as they are."""
    out = dict(student_params)
    out["encoder"] = dict(out["encoder"])
    teacher = teacher_params["encoder"]
    out["encoder"]["pos_conv"] = _copy_tree(teacher["pos_conv"])
    out["encoder"]["layers"] = [_copy_tree(teacher["layers"][i])
                                for i in range(n_student_layers)]
    return out


def _call(model, params: Optional[Dict[str, torch.Tensor]], feat, pad_mask,
          kwargs: dict):
    """``model(feat, pad_mask, **kwargs)``, on ``params`` in place of its
    own where given."""
    if params is None:
        return model(feat, pad_mask, **kwargs)
    return functional_call(model, params, (feat, pad_mask), kwargs)


@torch.no_grad()
def teacher_forward(teacher, feat: torch.Tensor, pad_mask: torch.Tensor, *,
                    mask: bool, mask_indices: Optional[torch.Tensor] = None,
                    attn_impl: str = "auto",
                    params: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """The teacher's forward, without grad and without dropout: only
    {"logits", "mask_indices"} are kept, so nothing else of it outlives
    the call. Under ``torch.no_grad`` and not ``inference_mode``: the
    student's loss saves the teacher's probabilities for its backward,
    which an inference tensor cannot be."""
    out = _call(teacher, params, feat, pad_mask,
                dict(mask=mask, teacher_mask_indices=mask_indices,
                     deterministic=True, attn_impl=attn_impl))
    return {"logits": out["logits"], "mask_indices": out["mask_indices"]}


def distill_forward(teacher, student, feat: torch.Tensor,
                    pad_mask: torch.Tensor, labels: torch.Tensor, *,
                    temperature: float, alpha: float,
                    loss_type: str = "masked",
                    mask_indices: Optional[torch.Tensor] = None,
                    rng: Optional[torch.Generator] = None,
                    deterministic_student: bool = False,
                    attn_impl: str = "auto",
                    teacher_params: Optional[Dict[str, torch.Tensor]] = None,
                    student_params: Optional[Dict[str, torch.Tensor]] = None,
                    totals: Optional[dict] = None):
    """One teacher and student forward and the loss (JAX
    ``distill_forward``); differentiate with respect to the student's
    parameters only. ``mask_indices`` is the teacher's span mask (B, T),
    drawn on the host from the teacher's config; it is used with
    ``loss_type="masked"`` alone (nomasked masks neither model, reference
    distillation/pretrain_expert.py:28-34, :115-117). The student replays
    the teacher's mask. ``rng`` is the host generator of the student's
    dropout. ``teacher_params`` / ``student_params`` stand in for the
    models' own parameters where given (``functional_call``); ``totals``
    as in :func:`distillation_loss`."""
    mask_or_not = loss_type == "masked"
    teacher_out = teacher_forward(teacher, feat, pad_mask, mask=mask_or_not,
                                  mask_indices=mask_indices,
                                  attn_impl=attn_impl, params=teacher_params)
    student_out = _call(student, student_params, feat, pad_mask, dict(
        mask=mask_or_not, teacher_mask_indices=teacher_out["mask_indices"],
        rng=rng, deterministic=deterministic_student, attn_impl=attn_impl))
    return distillation_loss(student_out, teacher_out, labels, pad_mask,
                             temperature=temperature, alpha=alpha,
                             loss_type=loss_type, totals=totals)
