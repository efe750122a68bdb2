"""Read and write the JAX package's npz+JSON checkpoints without JAX.

The format is plain ``np.savez``: ``params/<path>`` and ``masks/<path>``
arrays, where ``<path>`` joins dict keys with ``/`` and list indices as
``[i]``, the optimizer state's leaves as ``opt/<i>`` in JAX's leaf order,
plus the JSON metadata as a ``meta_json`` uint8 array. Two JAX-only
entries are not written: ``opt_treedef`` (the string of an optax tree
definition, which the JAX reader treats as optional) and ``rng_key``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np


def _flatten(tree, prefix: str, out: dict) -> None:
    """Mirror of ``speech_ssl_compression_tpu/utils/checkpoint.py::_flatten``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/[{i}]", out)
    else:
        out[prefix] = np.asarray(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list tree in JAX's leaf order (dict
    keys sorted, list items in order), as ``jax.tree.leaves`` gives them."""
    flat: dict = {}
    _flatten(tree, "", flat)
    return list(flat.values())


def _unflatten(flat: dict) -> Any:
    """Mirror of ``speech_ssl_compression_tpu/utils/checkpoint.py::_unflatten``:
    rebuild nested dict/list trees from '/'-joined keys."""
    root: dict = {}
    for key, val in flat.items():
        parts = [p for p in key.split("/") if p]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("[") and k.endswith("]") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:-1]))
            return [fix(v) for _, v in items]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def load_checkpoint(path: str) -> dict:
    """Mirror of ``speech_ssl_compression_tpu/utils/checkpoint.py::load_checkpoint``,
    read-only and limited to what inference needs.

    Returns ``{"params", "masks", "meta"}`` with numpy leaves; ``masks`` is
    None for a checkpoint without weight-pruning masks."""
    params_flat, masks_flat = {}, {}
    meta = None
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            if k.startswith("params/"):
                params_flat[k[len("params/"):]] = data[k]
            elif k.startswith("masks/"):
                masks_flat[k[len("masks/"):]] = data[k]
            elif k == "meta_json":
                meta = json.loads(data[k].tobytes().decode())
    if meta is None:
        meta = {}
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
    return {
        "params": _unflatten(params_flat) if params_flat else None,
        "masks": _unflatten(masks_flat) if masks_flat else None,
        "meta": meta,
    }


def save_checkpoint(path: str, params, *, opt_state=None, masks=None,
                    meta: Optional[dict] = None) -> None:
    """Write ``params`` (a JAX-layout numpy tree) in the format of
    ``speech_ssl_compression_tpu/utils/checkpoint.py::save_checkpoint``: a
    single atomic ``.npz`` with the metadata embedded, and a ``.json`` copy
    beside it. ``opt_state`` is the list of optimizer leaves in JAX's
    order (for Adam: [count, *mu, *nu], each tree in the params' leaf
    order and layout), stored as ``opt/<i>``; JAX's ``restore_opt_state``
    zips them into its own optimizer state."""
    flat: dict = {}
    _flatten(params, "params", flat)
    if masks is not None:
        _flatten(masks, "masks", flat)
    for i, leaf in enumerate(opt_state or ()):
        flat[f"opt/{i}"] = np.asarray(leaf)
    meta_bytes = json.dumps(meta or {}, default=str).encode()
    flat["meta_json"] = np.frombuffer(meta_bytes, dtype=np.uint8)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    json_tmp = path + ".json.tmp"
    with open(json_tmp, "w") as f:
        json.dump(meta or {}, f, indent=2, default=str)
    os.replace(json_tmp, path + ".json")
