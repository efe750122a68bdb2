"""GPipe pipeline parallelism for the MelHuBERT pre-training step.

Port of ``speech_ssl_compression_tpu/parallel/pipeline.py``
(``split_pipeline_params`` :91, ``merge_pipeline_params`` :115,
``make_melhubert_pipeline_grad_step`` :147). The encoder stack is cut into
S contiguous stages; stage rank s of a data index (``parallel/mesh.py``,
the pipe group) holds layers ``[s L/S, (s+1) L/S)`` and the replicated
leaves (``pre_extract_proj``, the pos-conv, the encoder LayerNorm,
``final_proj``, ``mask_emb``) under the whole model's names
(:func:`stage_model`). M microbatches flow through the stages:

- JAX scans ``M + S - 1`` ticks of one ``shard_map`` program and lets
  autodiff write the backward; here each stage is a process and writes
  both phases itself. Stage 0 runs the span mask, ``pre_extract_proj`` and
  the prologue on its data rank's whole batch; in the forward every stage
  runs its layers on microbatch m and sends the output on
  (``mesh.send``), keeping its autograd graph; in the backward the last
  stage takes each microbatch's loss, and each stage differentiates its
  outputs against the gradient it receives and sends its input's gradient
  back;
- the loss is ``melhubert_pretrain_loss``: the last stage's CE sums over
  the global batch's counts, so the ranks' losses sum to the 1-process
  loss (JAX :184-246);
- the replicated leaves' gradients are summed over the whole world (a rank
  that did not touch a leaf adds zeros), the stage leaves' over the
  stage's data group; loss and logs over the world;
- dropout draws its seeds from the host generator as the 1-process step
  does (the encoder's seed, then one a layer), so the span masks drawn
  after them stay the 1-process run's; it folds them per (data index,
  microbatch, stage) for the residual and activation dropouts and per
  (data index, microbatch) into each layer's attention seed
  (``ops/dropout.py::fold_seed``, as JAX folds its keys :207-212): the
  1-process path's distribution, not its bits (but for the prologue's,
  which are its bits).

Scope as in JAX: the uniform pre-training stack (equal heads and FFN
widths per layer); LayerDrop in training, ``required_seq_len_multiple``
padding, a stack that does not split into S stages and weight-pruning
masks are refused.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, List

import torch
import torch.distributed as dist
from torch import nn

from ..models.encoder import (
    _holding,
    checkpoint_layer,
    encoder_layer_forward,
    encoder_prologue,
    layer_norm,
)
from ..models.melhubert import (
    MelHuBERTModel,
    _apply_mask,
    loss_selections,
    masked_cross_entropy,
    pre_project,
)
from ..ops.dropout import draw_seed, fold_seed, seeded_generator
from ..train.steps import cast_for_compute, global_totals, host_span_mask
from .mesh import Mesh, all_reduce_tensors, recv, send

__all__ = [
    "split_pipeline_params",
    "merge_pipeline_params",
    "gather_stages",
    "stage_layers",
    "stage_model",
    "make_melhubert_pipeline_grad_step",
]

_LAYER = re.compile(r"^encoder\.layers\.(\d+)\.")


def layer_of(name: str):
    """The encoder layer index of a parameter name, None for a replicated
    leaf."""
    m = _LAYER.match(name)
    return None if m is None else int(m.group(1))


def stage_layers(n_layers: int, stage: int, n_stages: int) -> range:
    """The global indices of stage ``stage``'s layers."""
    if n_stages < 1 or n_layers % n_stages != 0:
        raise ValueError(
            f"{n_layers} encoder layers do not split into {n_stages} stages")
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def split_pipeline_params(named: Dict[str, torch.Tensor],
                          n_stages: int) -> dict:
    """Tensors under the whole model's names (parameters, gradients, Adam
    moments) -> ``{"rep": {...}, "stages": [{...} per stage]}``: the
    replicated leaves, and each stage's layers, under their own names."""
    n_layers = len({layer_of(k) for k in named} - {None})
    owner = {i: s for s in range(n_stages)
             for i in stage_layers(n_layers, s, n_stages)}
    rep = {k: v for k, v in named.items() if layer_of(k) is None}
    stages = [{} for _ in range(n_stages)]
    for k, v in named.items():
        if layer_of(k) is not None:
            stages[owner[layer_of(k)]][k] = v
    return {"rep": rep, "stages": stages}


def _order(item) -> tuple:
    """The whole model's parameter order (``named_parameters``: its own
    ``mask_emb`` first, then pre_extract_proj, the pos-conv and LayerNorm,
    the layers in order, final_proj)."""
    name = item[0]
    layer = layer_of(name)
    if layer is not None:
        return (3, layer)
    for rank, prefix in enumerate(("mask_emb", "pre_extract_proj.",
                                   "encoder.")):
        if name.startswith(prefix):
            return (rank, 0)
    return (4, 0)


def merge_pipeline_params(pp: dict) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`split_pipeline_params`: one dict under the whole
    model's names, in its parameter order."""
    items = list(pp["rep"].items())
    for stage in pp["stages"]:
        items += list(stage.items())
    return dict(sorted(items, key=_order))


def _move_layer(name: str, by: int) -> str:
    """``encoder.layers.{i}.<rest>`` -> ``encoder.layers.{i + by}.<rest>``."""
    return f"encoder.layers.{layer_of(name) + by}.{name.split('.', 3)[3]}"


def gather_stages(dicts: List[Dict[str, torch.Tensor]], cfg, mesh: Mesh,
                  to_primary: bool = False):
    """Several dicts of this stage's tensors under the whole model's names
    (parameters, gradients, Adam moments; the replicated leaves equal on
    every stage) -> the whole model's, in its order: one gather of the
    stages' layers over the pipe group, on the host, to every rank or,
    with ``to_primary``, to the group's first rank alone (None
    elsewhere). The stack is uniform, so stage s holds this rank's layers
    moved by (s - this stage) x L/S."""
    own = [k for k in dicts[0] if layer_of(k) is not None]
    flat = torch.cat([d[k].detach().float().reshape(-1).cpu()
                      for d in dicts for k in own])
    pieces = [torch.empty_like(flat) for _ in range(mesh.pp)]
    first = mesh.rank - mesh.pipe_index
    if to_primary:
        dist.gather(flat, pieces if mesh.rank == first else None, dst=first,
                    group=mesh.cpu_pipe_group)
        if mesh.rank != first:
            return None
    else:
        dist.all_gather(pieces, flat, group=mesh.cpu_pipe_group)
    per = cfg.encoder_layers // mesh.pp
    like = [d[k] for d in dicts for k in own]
    whole = []
    for j, d in enumerate(dicts):
        stages = []
        for s, piece in enumerate(pieces):
            chunks = torch.split(piece, [t.numel() for t in like])
            moved = (s - mesh.pipe_index) * per
            stages.append({
                _move_layer(k, moved): c.view(t.shape).to(t.device, t.dtype)
                for k, c, t in zip(own, chunks[j * len(own):],
                                   like[j * len(own):])})
        rep = {k: v for k, v in d.items() if layer_of(k) is None}
        whole.append(merge_pipeline_params({"rep": rep, "stages": stages}))
    return whole


def stage_model(named: Dict[str, torch.Tensor], cfg, stage: int,
                n_stages: int) -> MelHuBERTModel:
    """Stage ``stage``'s model: a ``MelHuBERTModel`` of the whole ``cfg``
    whose ``encoder.layers`` holds this stage's layers alone (an
    ``nn.ModuleDict`` keyed by their global indices, so every parameter
    keeps the whole model's name), its parameters the tensors of ``named``
    (the replicated leaves and this stage's layers; detached, no copy)."""
    with torch.device("meta"):
        model = MelHuBERTModel(cfg)
    own = stage_layers(cfg.encoder_layers, stage, n_stages)
    model.encoder.layers = nn.ModuleDict(
        {str(i): model.encoder.layers[i] for i in own})
    model.load_state_dict({k: v.detach() for k, v in named.items()},
                          assign=True)
    return model


def check_pipeline(cfg, n_stages: int, deterministic: bool = False) -> None:
    """JAX's refusals (:168-196)."""
    stage_layers(cfg.encoder_layers, 0, n_stages)
    if (len(set(cfg.encoder_attention_heads)) != 1
            or len(set(cfg.encoder_ffn_embed_dim)) != 1):
        raise NotImplementedError(
            "pipeline parallelism needs a uniform layer stack (equal "
            f"heads/FFN per layer); got heads={cfg.encoder_attention_heads} "
            f"ffn={cfg.encoder_ffn_embed_dim} - ragged (pruned) models "
            "train on the data/tensor axes instead")
    if not deterministic and cfg.encoder_layerdrop > 0:
        raise NotImplementedError(
            "LayerDrop would desynchronize pipeline stages; set "
            "encoder_layerdrop: 0 for pipeline-parallel training")
    if int(getattr(cfg, "required_seq_len_multiple", 1) or 1) != 1:
        raise NotImplementedError(
            "required_seq_len_multiple padding is not threaded through the "
            "pipeline schedule (MelHuBERT configs keep the default 1)")


def make_melhubert_pipeline_grad_step(model, mesh: Mesh, *,
                                      n_microbatches: int,
                                      accum_steps: int = 1,
                                      compute_dtype=torch.float32,
                                      attn_impl: str = "auto",
                                      deterministic: bool = False,
                                      remat: bool = False):
    """The pipelined counterpart of ``train.steps.make_melhubert_grad_step``
    on this rank's stage: ``model`` is its :func:`stage_model` (``cfg`` the
    whole model's), ``mesh`` the ``(data, pipe)`` grid.

    Returns ``grad_step(params, batch, rng, mask_indices=None, masks=None)
    -> (loss, grads, logs)`` with the call shape of the 1-process step:
    ``params`` the stage's f32 masters by name, ``batch`` this data rank's
    batch (every stage rank of a data index reads the same), the span mask
    drawn on the host over the data group's global batch (every rank draws
    it) unless ``mask_indices`` is given. Returns the global loss /
    accum_steps, the gradients in ``params``' order already summed (the
    replicated leaves over the world, the stage's layers over the data
    group), and the logs (``loss_masked``, ``n_masked`` and their nomask
    twins; the counts global). ``remat`` recomputes each layer in the
    backward (``models/encoder.py::checkpoint_layer``)."""
    cfg = model.cfg
    n_stages, stage, d = mesh.pp, mesh.pipe_index, mesh.data_index
    check_pipeline(cfg, n_stages, deterministic)
    n_mb = int(n_microbatches)
    if n_mb < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {n_mb}")
    own = list(stage_layers(cfg.encoder_layers, stage, n_stages))
    stack = model.encoder.layers  # a ModuleDict on a stage model
    layers = [stack[str(i)] if isinstance(stack, nn.ModuleDict) else stack[i]
              for i in own]
    first, last = stage == 0, stage == n_stages - 1
    width = cfg.encoder_embed_dim
    run_layer = functools.partial(
        encoder_layer_forward, layer_norm_first=cfg.layer_norm_first,
        causal=cfg.attention_type == "causal", attn_impl=attn_impl,
        activation_fn=cfg.activation_fn, dropout_p=cfg.dropout,
        attention_dropout=cfg.attention_dropout,
        activation_dropout=cfg.activation_dropout,
        deterministic=deterministic)

    def run_stage(h, kpm, m, seeds):
        gen = (None if seeds is None else seeded_generator(
            fold_seed(seeds[0], d, m, stage + 1), h.device))
        for i, layer in zip(own, layers):
            run = functools.partial(
                run_layer, layer=layer, key_padding_mask=kpm, generator=gen,
                attention_seed=(None if seeds is None
                                else fold_seed(seeds[1][i], d, m)))
            h, _ = (checkpoint_layer(run, h, layer, gen) if remat
                    else run(h))
        return h

    terms = [k for k in ("masked", "nomask")
             if not getattr(cfg, f"skip_{k}")
             and getattr(cfg, f"pred_{k}_weight") > 0]

    def head(h, rows, label, valid, mask, totals):
        """This microbatch's share of the loss and of each term."""
        if cfg.layer_norm_first:
            h = layer_norm(h, model.encoder.layer_norm)
        logits = model.final_proj(h)
        loss, parts = 0.0, []
        for key in terms:
            select = valid[rows] & (mask[rows] if key == "masked"
                                    else ~mask[rows])
            term, _ = masked_cross_entropy(logits, label[rows], select,
                                           totals[key])
            loss = loss + getattr(cfg, f"pred_{key}_weight") * term
            parts.append(term.detach())
        return loss / accum_steps, parts

    def grad_step(params: Dict[str, torch.Tensor], batch: dict,
                  rng: torch.Generator, mask_indices=None, masks=None):
        if masks:
            raise NotImplementedError(
                "pipeline-parallel training from a weight-pruned checkpoint "
                "is unsupported (fold the masks into the weights first)")
        feat, label = batch["feat"], batch["label"]
        valid = batch["pad_mask"].to(torch.bool)
        b, t = valid.shape
        if b % n_mb:
            raise ValueError(
                f"batch {b * mesh.dp} must be a multiple of data_parallel="
                f"{mesh.dp} x n_microbatches={n_mb}")
        mb = b // n_mb
        if mask_indices is None:
            mask_indices = host_span_mask(cfg, batch, rng, mesh)
        mask = (torch.zeros_like(valid) if mask_indices is None
                else mask_indices.to(device=valid.device, dtype=torch.bool))
        # the 1-process step's draws: the encoder's seed, one a layer
        seeds = None if deterministic else (draw_seed(rng), [
            draw_seed(rng) for _ in range(cfg.encoder_layers)])
        sel = loss_selections(mask, label, valid)
        totals = global_totals(mesh, sel) or {
            k: v.sum().float() for k, v in sel.items()}
        names = list(params)
        leaves = list(params.values())
        acc = [None] * len(leaves)

        def grad(outputs, inputs, grad_outputs=None):
            """d outputs / d (the masters, inputs), the masters' part added
            to ``acc``; returns the inputs' part."""
            got = torch.autograd.grad(outputs, leaves + inputs, grad_outputs,
                                      allow_unused=True)
            for k, g in enumerate(got[:len(leaves)]):
                if g is not None:
                    acc[k] = g if acc[k] is None else acc[k] + g
            return got[len(leaves):]

        with _holding(model, cast_for_compute(params, compute_dtype)):
            if first:
                x = feat.to(compute_dtype)
                if cfg.mask_before_proj:
                    x = _apply_mask(x, mask, model)
                x = pre_project(model, x)
                if not cfg.mask_before_proj:
                    x = _apply_mask(x, mask, model)
                x = encoder_prologue(
                    x, model.encoder, cfg, padding_mask=~valid,
                    generator=(None if seeds is None else seeded_generator(
                        fold_seed(seeds[0], d), x.device)),
                    deterministic=deterministic)
            ins, outs = [], []
            for m in range(n_mb):
                rows = slice(m * mb, (m + 1) * mb)
                h = (x[rows].detach() if first else
                     recv((mb, t, width), compute_dtype, feat.device,
                          mesh.rank - 1)).requires_grad_()
                out = run_stage(h, ~valid[rows], m, seeds)
                if not last:
                    send(out, mesh.rank + 1)
                ins.append(h)
                outs.append(out)

            # the loss and each term, summed over the microbatches
            scalars = torch.zeros(1 + len(terms), device=feat.device)
            dx: List[torch.Tensor] = [None] * n_mb
            for m in reversed(range(n_mb)):
                rows = slice(m * mb, (m + 1) * mb)
                if last:
                    loss_m, parts = head(outs[m], rows, label, valid, mask,
                                         totals)
                    (dx[m],) = grad([loss_m], [ins[m]])
                    scalars = scalars + torch.stack(
                        [loss_m.detach()] + parts).float()
                else:
                    g = recv(outs[m].shape, compute_dtype, feat.device,
                             mesh.rank + 1)
                    (dx[m],) = grad([outs[m]], [ins[m]], [g])
                if not first:
                    send(dx[m], mesh.rank - 1)
            if first:
                grad([x], [], [torch.cat(dx)])
        del ins, outs

        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, acc)]
        rep = [k for k, n in enumerate(names) if layer_of(n) is None]
        own_leaves = [k for k, n in enumerate(names)
                      if layer_of(n) is not None]
        if mesh.world > 1:
            out = all_reduce_tensors([grads[k] for k in rep] + [scalars],
                                     None)
            for k, g in zip(rep, out):
                grads[k] = g
            scalars = out[-1]
        if mesh.dp > 1 and own_leaves:
            for k, g in zip(own_leaves, all_reduce_tensors(
                    [grads[k] for k in own_leaves], mesh.data_group)):
                grads[k] = g
        logs = {}
        for key, value in zip(terms, scalars[1:].unbind()):
            logs[f"loss_{key}"] = value
            logs[f"n_{key}"] = totals[key]
        return scalars[0], grads, logs

    return grad_step
