"""Sequence-parallel (context-parallel) MelHuBERT extraction and
distillation: the time axis of one long utterance sharded over the ranks
of the data group.

Port of ``speech_ssl_compression_tpu/parallel/seqpar.py`` (the whole
module: ``_pos_conv_halo`` :53, ``_rect_attention`` :83,
``_make_seqpar_attn`` :98, ``_seqpar_body`` :117,
``melhubert_extract_seqpar`` :172, ``make_melhubert_seqpar_distill_step``
:215). JAX runs one ``shard_map`` program over a mesh axis; here every rank
of the data group (``parallel/mesh.py::Mesh``; ``make_mesh()`` over the
process group) calls the same function on the whole batch and takes its
own time shard, rank i the i-th of n:

- position-wise ops (projections, LayerNorms, FFN, GELU) run on the local
  frames, through ``models/encoder.py::encoder_layer_forward`` and its
  ``attn_fn`` hook, so the layer's semantics have one source;
- the grouped positional conv takes a K//2-frame halo from each neighbour
  (``mesh.halo_exchange``); the sequence's two ends get zeros, which is
  the reference's SamePad zero padding, so the shard boundaries are exact;
- each layer all-gathers K and V over the group (``mesh.all_gather_seq``)
  and runs its local query rows against all keys through the rectangular
  non-causal flash attention (``ops/flash_attention.py::
  flash_attention_kv_full``: the CUDA kernels on the card, their plain
  versions on the CPU).

Extraction is a forward; the distillation step differentiates through the
gathers, whose backward sends each rank the summed gradient of its own K
and V slice (JAX's transpose of the all-gather, ``psum_scatter``).
Deterministic and non-causal, as in JAX; no dropout. On gloo the gathers
go through the host (``mesh.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.encoder import (
    _holding,
    encoder_layer_forward,
    layer_norm,
    pos_conv_embed,
)
from ..models.melhubert import _apply_mask, pre_project
from ..ops.attention import (
    dense_attention,
    output_projection,
    project_to_heads,
)
from ..ops.flash_attention import flash_attention_kv_full
from ..train.steps import _grads, cast_for_compute, host_span_mask
from .mesh import (
    Mesh,
    all_gather_seq,
    all_reduce_tensors,
    gather_parts,
    halo_exchange,
)

__all__ = ["melhubert_extract_seqpar", "make_melhubert_seqpar_distill_step"]

SHARD_UNIT = 128  # T pads to a multiple of n x SHARD_UNIT, as in JAX


def _ranks(mesh: Optional[Mesh]) -> tuple:
    """(this rank's shard index, the number of shards)."""
    if mesh is None:
        return 0, 1
    return mesh.data_index, mesh.dp


def _pos_conv_halo(x: torch.Tensor, pos_conv, mesh: Optional[Mesh]):
    """The grouped SamePad pos-conv on a time shard (B, Tl, D): out[t]
    reads x[t - K//2 .. t + K//2 - 1], so a K//2 halo on each side holds
    every local output's receptive field. Refuses a shard shorter than the
    halo, as JAX does."""
    halo = pos_conv.kernel_size // 2
    if x.shape[1] < halo:
        raise NotImplementedError(
            f"local shard ({x.shape[1]} frames) shorter than the pos-conv "
            f"halo ({halo}); use fewer shards or longer sequences")
    from_left, from_right = halo_exchange(x, halo, mesh)
    out = pos_conv_embed(torch.cat([from_left, x, from_right], dim=1),
                         pos_conv)
    return out[:, halo:halo + x.shape[1]]


def _rect_attention(q, k_full, v_full, pad_full, impl: str):
    """(B, H, Tl, d) local queries against (B, H, T, d) full keys and
    values, ``pad_full`` (B, T) True on padded keys. "dense" is the plain
    O(Tl T) path; "auto" and "flash" the flash route (the kernels on the
    card)."""
    if impl == "dense":
        return dense_attention(q, k_full, v_full, key_padding_mask=pad_full)
    return flash_attention_kv_full(q, k_full, v_full,
                                   key_padding_mask=pad_full)


def _make_seqpar_attn(layer, pad_full, mesh: Optional[Mesh], impl: str):
    """One layer's self-attention: local q/k/v projections, K and V
    gathered over the group, rectangular attention, out_proj (the batch
    forward's ``project_to_heads`` / ``output_projection``)."""
    attn = layer.self_attn
    h, d = attn.num_heads, attn.head_dim

    def run(x):
        q = project_to_heads(x, attn.q_proj, h, d)
        k = all_gather_seq(project_to_heads(x, attn.k_proj, h, d), 2, mesh)
        v = all_gather_seq(project_to_heads(x, attn.v_proj, h, d), 2, mesh)
        context = _rect_attention(q, k, v, pad_full, impl)
        return output_projection(context, attn.out_proj), context

    return run


def _seqpar_body(model, cfg, feat_l, pad_l, mesh: Optional[Mesh],
                 impl: str, mask_l=None):
    """One shard's forward: what ``melhubert_forward`` does for extraction
    (no_pred, deterministic) on local frames; ``mask_l`` (B, Tl) bool, the
    local slice of a span mask drawn over the whole batch, masks as
    ``melhubert_forward(mask=True, teacher_mask_indices=...)`` does."""
    x = feat_l
    if mask_l is not None and cfg.mask_before_proj:
        x = _apply_mask(x, mask_l, model)
    x = pre_project(model, x)
    if mask_l is not None and not cfg.mask_before_proj:
        x = _apply_mask(x, mask_l, model)

    enc = model.encoder
    x = x.masked_fill(pad_l[:, :, None], 0.0)
    x = x + _pos_conv_halo(x, enc.pos_conv[0], mesh)
    if not cfg.layer_norm_first:
        x = layer_norm(x, enc.layer_norm)
    pad_full = torch.cat(gather_parts(pad_l, mesh), dim=1)
    for layer in enc.layers:
        x, _ = encoder_layer_forward(
            x, layer, layer_norm_first=cfg.layer_norm_first,
            activation_fn=cfg.activation_fn, deterministic=True,
            attn_fn=_make_seqpar_attn(layer, pad_full, mesh, impl))
    if cfg.layer_norm_first:
        x = layer_norm(x, enc.layer_norm)
    return x


def _check_seqpar(cfg) -> None:
    if getattr(cfg, "attention_type", "original") == "causal":
        raise NotImplementedError(
            "sequence-parallel extraction is non-causal; use "
            "streaming.StreamingCausalExtractor for causal serving")
    if getattr(cfg, "pos_conv_depth", 1) > 1:
        raise NotImplementedError(
            "seqpar halo exchange supports pos_conv_depth == 1")


def _padded(t: int, n: int) -> int:
    unit = n * SHARD_UNIT
    return -(-t // unit) * unit


def melhubert_extract_seqpar(model, feat: torch.Tensor,
                             pad_mask: torch.Tensor,
                             mesh: Optional[Mesh] = None, *,
                             attn_impl: str = "auto") -> torch.Tensor:
    """Sequence-parallel extraction forward of ``model`` (a
    ``MelHuBERTModel``) on ``feat`` (B, T, F) and ``pad_mask`` (B, T)
    (1/True on valid frames), the whole batch on every rank of ``mesh``'s
    data group. Returns the hidden states (B, T, D) on every rank, as
    ``melhubert_forward(..., no_pred=True)`` gives them. T is padded to a
    multiple of n x 128; the pad is key-masked and stripped."""
    cfg = model.cfg
    _check_seqpar(cfg)
    i, n = _ranks(mesh)
    t = feat.shape[1]
    t_pad = _padded(t, n)
    pad = ~pad_mask.to(torch.bool)
    if t_pad > t:
        feat = torch.nn.functional.pad(feat, (0, 0, 0, t_pad - t))
        pad = torch.nn.functional.pad(pad, (0, t_pad - t), value=True)
    tl = t_pad // n
    hidden = _seqpar_body(model, cfg, feat[:, i * tl:(i + 1) * tl],
                          pad[:, i * tl:(i + 1) * tl], mesh, attn_impl)
    return torch.cat(gather_parts(hidden, mesh), dim=1)[:, :t]


def make_melhubert_seqpar_distill_step(teacher, student,
                                       mesh: Optional[Mesh] = None, *,
                                       temperature: float, alpha: float,
                                       loss_type: str = "masked",
                                       attn_impl: str = "auto",
                                       compute_dtype=torch.float32):
    """The sequence-parallel distillation grad step: the time axis sharded
    over ``mesh``'s data group, the teacher's and the student's forwards
    per shard, K and V gathered per layer.

    Returns ``grad_step(params, batch, rng=None, mask_indices=None) ->
    (loss, grads, logs)``: ``params`` the student's f32 masters by name,
    ``batch`` the WHOLE batch on every rank (``feat``, ``pad_mask``,
    ``label``; ``length`` on the host where the mask is drawn). The
    semantics are ``compress.distillation.distill_forward``'s (masked: the
    teacher's span mask replayed into the student; nomasked: every valid
    frame): the counts are global and taken outside the differentiated
    path, the local loss is differentiated, and loss, logs (``hard_loss``,
    ``soft_loss``) and gradients are summed over the group. The span mask
    is drawn once on the host from the teacher's config (every rank draws
    the same from the same ``rng`` state) unless ``mask_indices`` (B, T)
    is given; each rank takes its time slice. No dropout."""
    if loss_type not in ("masked", "nomasked"):
        raise NotImplementedError(loss_type)
    _check_seqpar(teacher.cfg)
    _check_seqpar(student.cfg)
    teacher.eval().requires_grad_(False)
    teacher_params = {k: v.detach().to(compute_dtype)
                      for k, v in teacher.named_parameters()}
    masked = loss_type == "masked"
    i, n = _ranks(mesh)
    group = None if mesh is None or n == 1 else mesh.data_group

    def summed(tensors):
        return tensors if group is None else all_reduce_tensors(tensors,
                                                                group)

    def grad_step(params, batch, rng=None, mask_indices=None):
        feat, label = batch["feat"], batch["label"]
        valid = batch["pad_mask"].to(torch.bool)
        b, t = valid.shape
        if mask_indices is None:
            if masked:
                lengths = batch.get("length")
                if lengths is None:
                    lengths = valid.sum(-1).cpu().numpy()
                mask_indices = host_span_mask(
                    teacher.cfg, {"feat": feat, "length": lengths}, rng)
            else:
                mask_indices = torch.zeros((b, t), dtype=torch.bool)
        mask_indices = mask_indices.to(device=valid.device, dtype=torch.bool)
        t_pad = _padded(t, n)
        if t_pad > t:
            feat = torch.nn.functional.pad(feat, (0, 0, 0, t_pad - t))
            valid = torch.nn.functional.pad(valid, (0, t_pad - t))
            label = torch.nn.functional.pad(label, (0, t_pad - t),
                                            value=-100)
            mask_indices = torch.nn.functional.pad(mask_indices,
                                                   (0, t_pad - t))
        tl = t_pad // n
        rows = slice(i * tl, (i + 1) * tl)
        feat_l = feat[:, rows].to(compute_dtype)
        valid_l, label_l, mask_l = (valid[:, rows], label[:, rows],
                                    mask_indices[:, rows])
        sel = valid_l & (mask_l if masked else ~mask_l)
        sel_ce = sel & (label_l != -100)
        c_hard, c_soft = summed([torch.stack(
            [sel_ce.sum(), sel.sum()]).float()])[0].clamp_min(1.0).unbind()
        m_l = mask_l if masked else None

        with torch.no_grad(), _holding(teacher, teacher_params):
            t_hidden = _seqpar_body(teacher, teacher.cfg, feat_l, ~valid_l,
                                    mesh, attn_impl, mask_l=m_l)
            t_logits = teacher.final_proj(t_hidden)
        with _holding(student, cast_for_compute(params, compute_dtype)):
            s_hidden = _seqpar_body(student, student.cfg, feat_l, ~valid_l,
                                    mesh, attn_impl, mask_l=m_l)
            s_logits = student.final_proj(s_hidden)

        safe = torch.where(sel_ce, label_l, torch.zeros_like(label_l)).long()
        logp = torch.log_softmax(s_logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        hard = torch.where(sel_ce, nll, torch.zeros_like(nll)).sum() / c_hard
        logp_s = torch.log_softmax(s_logits.float() / temperature, dim=-1)
        logp_t = torch.log_softmax(t_logits.float() / temperature, dim=-1)
        per_frame = (logp_t.exp() * (logp_t - logp_s)).sum(-1)
        soft = (torch.where(sel, per_frame, torch.zeros_like(per_frame))
                .sum() / c_soft)
        local = hard * (1.0 - alpha) + soft * alpha
        grads = _grads(local, params)
        out = summed(grads + [torch.stack([local, hard, soft]).detach()])
        loss, hard, soft = out[-1].unbind()
        return loss, out[:-1], {"hard_loss": hard, "soft_loss": soft}

    return grad_step
