"""Attention-head pruning: l1 and data-driven scoring, physical slicing.

Port of ``speech_ssl_compression_tpu/compress/head_pruning.py`` (the
reference's head_pruning/hp_utils.py).

  * l1 (:func:`l1_head_scores`, hp_utils.py:188-240): sum |W| + |b| over
    a head's q/k/v slices, out_proj not counted. A copy of JAX's numpy
    code on a JAX-layout tree (kernels (in, out)): float32 sums round by
    the order they add in, so the trainer scores the JAX-layout host view
    of its weights (``utils/weights.py::prunable_tree``), where the scores
    are JAX's bit for bit and near-ties rank as in JAX.
  * data-driven (:func:`context_scores`, hp_utils.py:242-353): per head
    sum_b sum_l |<c[b,h,l,:], dL/dc[b,h,l,:]>| of each layer's attention
    context c. JAX adds a zero "probe" to every context and differentiates
    the loss with respect to the probes; here the forward returns the
    contexts (``return_contexts=True``) and autograd differentiates the
    loss with respect to those non-leaf tensors, the same d(loss)/d(c).
    The parameters are detached and the features are the graph's one
    input that requires grad, so the first layer's context is in the
    graph too, and autograd runs only the backward that reaches the
    contexts: no parameter gradient, no prologue, no backward of the
    first layer's attention.
  * selection (:func:`select_heads_to_prune`, hp_utils.py:62-99) and the
    event's slicing (:func:`prune_heads`, hp_utils.py:108-186): q/k/v lose
    the pruned heads' output rows (torch layout (out, in)), out_proj its
    input columns; the trainer rebuilds its model for the new per-layer
    head counts.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..models.melhubert import melhubert_pretrain_loss
from ..utils.weights import prunable_name

_QKV = ("q_proj", "k_proj", "v_proj")


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def l1_head_scores(params: dict, cfg) -> List[Tuple[Tuple[int, int], float]]:
    """[((layer, head), score), ...] of a JAX-layout tree (numpy kernels
    (in, out)), JAX ``l1_head_scores``."""
    out = []
    hd = cfg.head_dim
    for i, layer in enumerate(params["encoder"]["layers"]):
        mods = {mod: (np.asarray(layer[mod]["kernel"]),
                      np.asarray(layer[mod]["bias"]))
                for mod in ("k_proj", "q_proj", "v_proj")}
        for h in range(cfg.encoder_attention_heads[i]):
            sl = slice(h * hd, (h + 1) * hd)
            s = 0.0
            for kernel, bias in mods.values():
                s += float(np.abs(kernel[:, sl]).sum())
                s += float(np.abs(bias[sl]).sum())
            out.append(((i, h), s))
    return out


def data_driven_scores_from_grads(contexts, context_grads):
    """score[layer][head] = sum_b sum_l |<c[b,h,l,:], dc[b,h,l,:]>|
    (reference einsum "bhli,bhli->bhl", then abs().sum(-1).sum(0),
    hp_utils.py:330-331). Returns a list of (H_i,) f32 tensors."""
    return [torch.einsum("bhli,bhli->bhl", cg.float(), c.float())
            .abs().sum(dim=(0, 2))
            for c, cg in zip(contexts, context_grads)]


def context_scores(model, params: Dict[str, torch.Tensor], batch: dict,
                   mask_indices, rng: torch.Generator, *,
                   deterministic: bool = False, attn_impl: str = "auto",
                   totals=None):
    """One scoring batch: the masked forward of ``model`` on ``params``
    (detached here; their dtype is the compute dtype) with its contexts,
    the pre-training loss, its gradient with respect to the contexts, and
    the per-head products. ``batch`` holds device tensors
    ``feat``, ``label`` and ``pad_mask``; ``mask_indices`` is the (B, T)
    span mask drawn on the host; ``rng`` (a host generator) feeds the
    dropouts unless ``deterministic``. A layer LayerDrop skips scores 0.
    ``totals`` are the loss's divisors on a data-parallel rank
    (``melhubert_pretrain_loss``). Returns (loss, [(H_i,) f32 tensor per
    layer])."""
    cfg = model.cfg
    feat = batch["feat"].detach().requires_grad_()
    out = functional_call(
        model, {k: v.detach() for k, v in params.items()},
        (feat, batch["pad_mask"]),
        dict(mask=True, teacher_mask_indices=mask_indices, rng=rng,
             deterministic=deterministic, attn_impl=attn_impl,
             return_contexts=True))
    loss, _ = melhubert_pretrain_loss(out, batch["label"], batch["pad_mask"],
                                      cfg, totals)
    ran = [c for c in out["contexts"] if c is not None]
    # every layer skipped: nothing to differentiate, every head scores 0
    grads = iter(torch.autograd.grad(loss, ran) if ran else ())
    scores = []
    for h, c in zip(cfg.encoder_attention_heads, out["contexts"]):
        if c is None:  # skipped by LayerDrop
            scores.append(torch.zeros(h, device=feat.device))
        else:
            scores += data_driven_scores_from_grads([c.detach()],
                                                    [next(grads)])
    return loss.detach(), scores


def normalize_scores_by_layer(scores: List[np.ndarray], exponent: float):
    """Lp-normalize per layer (hp_utils.py:344-348)."""
    out = []
    for s in scores:
        norm = np.power(np.power(s, exponent).sum(), 1.0 / exponent)
        out.append(s / (norm + 1e-20))
    return out


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def select_heads_to_prune(
    heads_and_score: Sequence[Tuple[Tuple[int, int], float]],
    n_to_prune: int,
    target: str,
    n_layers: int,
) -> Dict[int, List[int]]:
    """JAX ``select_heads_to_prune`` (reference hp_utils.py:62-99): by_whole
    takes the n lowest heads over all layers, each layer's top head
    protected; by_layer the lowest head of each of the first n layers.
    Returns {layer: [head, ...]}."""
    ranked = sorted(heads_and_score, key=lambda x: x[1])
    sorted_heads = [hs[0] for hs in ranked]

    if target == "by_whole":
        to_protect = {l: 1 for l in range(n_layers)}
        filtered: List[Tuple[int, int]] = []
        for layer, head in reversed(sorted_heads):
            if layer in to_protect:
                if to_protect[layer] > 0:
                    to_protect[layer] -= 1
                    continue
                else:
                    to_protect.pop(layer)
            filtered.insert(0, (layer, head))
        assert len(filtered) >= n_to_prune
        to_prune = filtered[:n_to_prune]
    elif target == "by_layer":
        assert n_to_prune <= n_layers, (
            f"by_layer prunes 1 head per layer; {n_to_prune} requested "
            f"but only {n_layers} layers exist"
        )
        remaining = set(range(n_to_prune))
        to_prune = []
        for layer, head in sorted_heads:
            if not remaining:
                break
            if layer in remaining:
                to_prune.append((layer, head))
                remaining.remove(layer)
        assert not remaining, (
            f"layers {sorted(remaining)} had no prunable head left"
        )
    else:
        raise NotImplementedError(target)

    grouped: Dict[int, List[int]] = {}
    for layer, head in to_prune:
        grouped.setdefault(layer, []).append(head)
    return grouped


# ---------------------------------------------------------------------------
# physical pruning
# ---------------------------------------------------------------------------

def prune_layer_heads(named: Dict[str, torch.Tensor], layer: int,
                      heads: Sequence[int], n_heads: int,
                      head_dim: int) -> None:
    """Slice the heads ``heads`` out of one layer's attention in ``named``
    (state-dict names, torch layout): q/k/v lose weight rows and bias
    entries, out_proj loses weight columns. Replaces the tensors in the
    dict; each slice is a new contiguous tensor."""
    keep = [h for h in range(n_heads) if h not in set(heads)]
    cols = np.concatenate(
        [np.arange(h * head_dim, (h + 1) * head_dim) for h in keep])
    some = named[prunable_name(layer, "q_proj", "kernel")]
    idx = torch.from_numpy(cols).to(some.device)
    for mod in _QKV:
        for leaf in ("kernel", "bias"):
            name = prunable_name(layer, mod, leaf)
            named[name] = named[name].detach().index_select(0, idx)
    name = prunable_name(layer, "out_proj", "kernel")
    named[name] = named[name].detach().index_select(1, idx)


def prune_heads(named: Dict[str, torch.Tensor], cfg,
                group_to_prune: Dict[int, List[int]]):
    """Apply a prune event, JAX ``prune_heads`` on the port's tensors.
    Returns (new named tensors, new cfg); ``named`` itself is not
    changed."""
    new = dict(named)
    heads = list(cfg.encoder_attention_heads)
    for i in range(cfg.encoder_layers):
        if i in group_to_prune:
            prune_layer_heads(new, i, group_to_prune[i], heads[i],
                              cfg.head_dim)
            heads[i] -= len(group_to_prune[i])
            assert heads[i] >= 1
    return new, cfg.with_heads(heads)


def summarize_pruned_heads(pruned_heads_history) -> Dict[int, int]:
    """Fold the per-event history (list of {layer: [heads]}) into
    {layer: total_count} (reference extract_feature.py:118-122)."""
    summarized: Dict[int, int] = {}
    for event in pruned_heads_history:
        for layer, heads in event.items():
            summarized[int(layer)] = summarized.get(int(layer), 0) + len(heads)
    return summarized
