"""Iterative global magnitude (unstructured) weight pruning.

Port of ``speech_ssl_compression_tpu/compress/weight_pruning.py``. The
reference's mask reparametrization (``weight_orig`` + ``weight_mask`` and a
forward pre-hook, weight_pruning/wp_utils.py:13-48) is, functionally:

  * masks on the prunable encoder leaves (q/k/v/out_proj, fc1, fc2: kernel
    and bias);
  * ``p * m`` inside the differentiated function of every grad step
    (``train/steps.py``), so the forward sees masked weights and the
    gradient reaching the f32 master is ``m * g``; the masters themselves
    are not zeroed between events (Adam's old moments keep moving masked
    entries, as in JAX);
  * a prune event: fold the masks into the masters (``prune.remove``), then
    keep the global top (1 - amount) fraction of |w| over every prunable
    entry (``global_unstructured(L1Unstructured)``).

Two representations meet here. The tree functions (``iter_prunable_leaves``,
``init_masks``, ``apply_masks``, ``fold_masks``, ``global_magnitude_prune``)
take JAX-layout numpy trees, ``masks["layer_{i}"][module]["kernel" |
"bias"]`` with kernels (in, out), as the checkpoints store them; they are
copies of JAX's. The trainer holds its masters and masks as device tensors
under the port's state-dict names (kernels (out, in)); :func:`prune_event`
folds those in place and computes the new masks on the JAX-layout view
(``utils/weights.py::prunable_tree``), because the exact-count tie rule
ranks ties by global index in JAX's leaf order and layout: a ravel in the
torch layout would mask other entries wherever magnitudes tie.

The EMA-smoothed-loss convergence gate (wp_utils.py:113-132) is host-side
controller state, kept in :class:`WeightPruningState`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.weights import PRUNABLE, apply_masks, named_masks, prunable_tree

__all__ = [
    "PRUNABLE",
    "WeightPruningState",
    "apply_masks",
    "fold_masks",
    "global_magnitude_prune",
    "init_masks",
    "iter_prunable_leaves",
    "prune_event",
    "sparsity_of",
]


def iter_prunable_leaves(params: dict, bias: bool = True):
    """Yield (path, leaf) for every prunable encoder leaf of a JAX-layout
    tree, in JAX's leaf order: layer, then PRUNABLE order, kernel before
    bias. path = (layer_idx, module_name, "kernel"|"bias")."""
    for i, layer in enumerate(params["encoder"]["layers"]):
        for mod in PRUNABLE:
            yield (i, mod, "kernel"), layer[mod]["kernel"]
            if bias:
                yield (i, mod, "bias"), layer[mod]["bias"]


def init_masks(params: dict, bias: bool = True) -> dict:
    """All-ones masks (the reference's prune.Identity attach,
    wp_utils.py:91-94)."""
    masks: dict = {}
    for (i, mod, leaf), p in iter_prunable_leaves(params, bias):
        masks.setdefault(f"layer_{i}", {}).setdefault(mod, {})[leaf] = (
            np.ones(np.shape(p), np.float32))
    return masks


def fold_masks(params: dict, masks: Optional[dict]) -> dict:
    """prune.remove: bake masks into a tree's params (a new tree)."""
    return apply_masks(params, masks)


def global_magnitude_prune(params: dict, amount: float,
                           bias: bool = True) -> dict:
    """Fresh masks keeping the global top (1-amount) fraction by |w|, a
    copy of JAX's host pass (numpy, on the JAX-layout tree): exactly
    round(amount * n) entries are zeroed, those strictly below the
    magnitude of the n_prune-th smallest, then ties at it in global index
    order (torch L1Unstructured's global semantics,
    pytorch_code/prune.py:1049-1174)."""
    leaves = list(iter_prunable_leaves(params, bias))
    flat = np.concatenate([np.abs(np.asarray(p)).ravel() for _, p in leaves])
    n_prune = int(round(amount * flat.size))
    masks: dict = {}
    if n_prune == 0:
        thresh = -1.0
    else:
        part = np.partition(flat, n_prune - 1)
        thresh = part[n_prune - 1]

    # count ties to zero exactly n_prune entries
    below = flat < thresh
    n_below = int(below.sum())
    n_ties_needed = n_prune - n_below

    ties_used = 0
    for (i, mod, leaf), p in leaves:
        a = np.abs(np.asarray(p))
        keep = a > thresh
        if n_ties_needed > 0:
            tie = (a == thresh).ravel()
            tie_idx = np.nonzero(tie)[0]
            n_take = min(len(tie_idx), n_ties_needed - ties_used)
            tie_keep = np.ones_like(tie)
            if n_take > 0:
                tie_keep[tie_idx[:n_take]] = False
                ties_used += n_take
            keep = keep | ((a == thresh) & tie_keep.reshape(a.shape))
        else:
            keep = keep | (a == thresh)
        masks.setdefault(f"layer_{i}", {}).setdefault(mod, {})[leaf] = (
            keep.astype(np.float32))
    return masks


def _mask_leaves(masks: dict):
    for v in masks.values():
        if isinstance(v, dict):
            yield from _mask_leaves(v)
        else:
            yield v


def _nonzero(m) -> int:
    if isinstance(m, torch.Tensor):
        return int(torch.count_nonzero(m))
    return int(np.count_nonzero(m))


def sparsity_of(masks: dict) -> float:
    """The masked share of the masked entries, for a mask tree or the
    trainer's named masks."""
    total = kept = 0
    for m in _mask_leaves(masks):
        total += int(np.prod(tuple(m.shape)))
        kept += _nonzero(m)
    return 1.0 - kept / max(total, 1)


@dataclasses.dataclass
class WeightPruningState:
    """Host-side controller state (reference wp_utils.py:84-152), a copy
    of JAX's."""

    sparsity: List[float]
    prune_condition: str = "converge"
    smooth_factor: float = 0.999
    avg_len: int = 15000
    con_tol: float = 0.001
    warnup: int = 25000
    period: int = 25000

    smooth_loss: Optional[float] = None
    tgt_smooth_loss: float = -float("inf")
    buffer_loss: List[float] = dataclasses.field(default_factory=list)
    pruning_times: int = 0

    def update_smooth_loss(self, batch_loss: float):
        # seeded by a 3-batch average (wp_utils.py:113-121)
        if self.smooth_loss is not None:
            self.smooth_loss = (self.smooth_loss * self.smooth_factor
                                + batch_loss * (1 - self.smooth_factor))
        elif len(self.buffer_loss) == 3:
            self.smooth_loss = sum(self.buffer_loss) / 3
            self.buffer_loss = []
        else:
            self.buffer_loss.append(batch_loss)

    def update_target_smooth_loss(self, global_step: int, prune_steps):
        """Record the convergence target avg_len steps before each prune
        step (JAX's fix of the reference's ``warnup``-relative test,
        docs/DESIGN.md §7), and not while the EMA's 3-batch seed refills."""
        if (
            self.prune_condition == "converge"
            and global_step > self.warnup
            and any(global_step + self.avg_len == p for p in prune_steps)
            and self.smooth_loss is not None
        ):
            self.tgt_smooth_loss = self.smooth_loss

    def converged(self) -> bool:
        if self.prune_condition != "converge":
            return True
        if self.smooth_loss is None:
            return True
        return not (self.tgt_smooth_loss - self.con_tol > self.smooth_loss)

    def next_amount(self) -> float:
        return self.sparsity[self.pruning_times]

    def to_meta(self) -> dict:
        return {
            "smooth_loss": self.smooth_loss,
            "tgt_smooth_loss": (None if self.tgt_smooth_loss == -float("inf")
                                else self.tgt_smooth_loss),
            "pruning_times": self.pruning_times,
        }

    def load_meta(self, meta: dict):
        self.smooth_loss = meta.get("smooth_loss")
        tgt = meta.get("tgt_smooth_loss")
        self.tgt_smooth_loss = -float("inf") if tgt is None else float(tgt)
        self.pruning_times = int(meta.get("pruning_times", 0))


@torch.no_grad()
def prune_event(
    params: Dict[str, torch.Tensor],
    masks: Dict[str, torch.Tensor],
    state: WeightPruningState,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], str]:
    """One prune_api call (wp_utils.py:129-152) on the trainer's named
    masters and masks. Returns (params, masks, status), status in
    {"pruned", "not-converge"}: when pruned, the old masks are folded into
    ``params`` IN PLACE and the new masks, from
    :func:`global_magnitude_prune` on the JAX-layout view of the folded
    prunable leaves, are device tensors under the same names."""
    if not state.converged():
        return params, masks, "not-converge"
    for name, m in masks.items():
        params[name].mul_(m)
    new = global_magnitude_prune(prunable_tree(params), state.next_amount())
    masks = named_masks(new, next(iter(params.values())).device)
    state.pruning_times += 1
    state.smooth_loss = None
    state.buffer_loss = []
    return params, masks, "pruned"
