"""FFN row (hidden-unit) pruning, the reference's "row pruning"
(row_pruning/rp_utils.py).

Port of ``speech_ssl_compression_tpu/compress/row_pruning.py``. The score
of hidden unit i of a layer is

    sum |fc1.W[i, :]| + |fc1.b[i]| + sum |fc2.W[:, i]|   (rp_utils.py:84-112)

and each prune event deletes the ``num_rows_each_step`` lowest-scoring
units of EVERY layer (rp_utils.py:40-48), ties to the lower index
(``argsort(kind="stable")``).

:func:`ffn_row_scores` is a copy of JAX's numpy code and takes a
JAX-layout layer (kernels (in, out)): float32 sums round by the order
they add in, so the scores are taken on the JAX-layout host view of the
trainer's weights (``utils/weights.py::prunable_tree``), where they are
JAX's bit for bit and near-ties rank as in JAX (:func:`select_rows`).
:func:`prune_rows` then slices the port's tensors (kernels (out, in), on
their device) by the rows chosen there.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..utils.weights import prunable_name, prunable_tree


def ffn_row_scores(layer_params: dict) -> np.ndarray:
    """(F,) scores of one JAX-layout layer (``fc1``/``fc2`` kernels (D, F)
    and (F, D), numpy), JAX ``ffn_row_scores``."""
    fc1_k = np.asarray(layer_params["fc1"]["kernel"])  # (D, F)
    fc1_b = np.asarray(layer_params["fc1"]["bias"])    # (F,)
    fc2_k = np.asarray(layer_params["fc2"]["kernel"])  # (F, D)
    return (
        np.abs(fc1_k).sum(axis=0) + np.abs(fc1_b) + np.abs(fc2_k).sum(axis=1)
    )


def rows_to_keep(scores: np.ndarray, num_rows: int) -> np.ndarray:
    """The units that survive an event, ascending: all but the
    ``num_rows`` lowest scores, ties to the lower index (JAX
    ``prune_rows``)."""
    order = np.argsort(scores, kind="stable")
    to_prune = set(order[:num_rows].tolist())
    keep = np.array([j for j in range(scores.size) if j not in to_prune],
                    np.int64)
    assert len(keep) >= 1
    return keep


def prune_layer_ffn(named: Dict[str, torch.Tensor], layer: int,
                    keep: np.ndarray) -> None:
    """Slice one layer's FFN to the units ``keep`` in ``named`` (state-dict
    names, torch layout): fc1 loses weight rows and bias entries, fc2
    loses weight columns. Replaces the tensors in the dict."""
    w1, b1 = (prunable_name(layer, "fc1", leaf) for leaf in ("kernel", "bias"))
    w2 = prunable_name(layer, "fc2", "kernel")
    idx = torch.from_numpy(keep).to(named[w1].device)
    named[w1] = named[w1].detach().index_select(0, idx)
    named[b1] = named[b1].detach().index_select(0, idx)
    named[w2] = named[w2].detach().index_select(1, idx)


def select_rows(named: Dict[str, torch.Tensor],
                num_rows_each_step: int) -> List[np.ndarray]:
    """The units each layer keeps in one event, scored on the JAX-layout
    host view of ``named``'s fc1/fc2 (state-dict names, torch layout)."""
    tree = prunable_tree(named, modules=("fc1", "fc2"))
    return [rows_to_keep(ffn_row_scores(layer), num_rows_each_step)
            for layer in tree["encoder"]["layers"]]


def prune_rows(named: Dict[str, torch.Tensor], cfg,
               keeps: List[np.ndarray]):
    """One prune event over all layers, JAX ``prune_rows`` on the port's
    tensors, keeping the units ``keeps`` (:func:`select_rows`). Returns
    (new named tensors, new cfg); ``named`` itself is not changed."""
    new = dict(named)
    for i, keep in enumerate(keeps):
        prune_layer_ffn(new, i, keep)
    return new, cfg.with_ffn_dims([len(k) for k in keeps])
