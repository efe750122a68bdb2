"""Read and write the JAX package's npz+JSON checkpoints without JAX.

The format is plain ``np.savez``: ``params/<path>`` and ``masks/<path>``
arrays, where ``<path>`` joins dict keys with ``/`` and list indices as
``[i]``, the optimizer state's leaves as ``opt/<i>`` in JAX's leaf order,
plus the JSON metadata as a ``meta_json`` uint8 array. ``opt_treedef``, the
string of an optax tree definition (optional for both readers), is written
when the trainer carries one from the checkpoint it resumed; ``rng_key``
(a JAX key) is not.

The port's Adam state is the list [count, *mu, *nu] in its parameter order
and layout; :func:`restore_opt_state` maps JAX's leaf order and layout
back onto it and refuses a state that does not match.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


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


def load_checkpoint(path: str, load_opt: bool = True) -> dict:
    """Mirror of ``speech_ssl_compression_tpu/utils/checkpoint.py::load_checkpoint``
    without the JAX key.

    Returns ``{"params", "masks", "opt_leaves", "opt_treedef", "meta"}``
    with numpy leaves; ``masks`` is None for a checkpoint without
    weight-pruning masks, ``opt_leaves`` the optimizer leaves in JAX's
    order ([] without them, or with ``load_opt=False``: inference reads
    no Adam moments, twice the params' bytes) and ``opt_treedef`` their
    tree's string or None."""
    params_flat, masks_flat, opt = {}, {}, {}
    meta = opt_treedef = None
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            if k.startswith("params/"):
                params_flat[k[len("params/"):]] = data[k]
            elif k.startswith("masks/"):
                masks_flat[k[len("masks/"):]] = data[k]
            elif k.startswith("opt/") and load_opt:
                opt[int(k[len("opt/"):])] = data[k]
            elif k == "opt_treedef":
                opt_treedef = data[k].tobytes().decode()
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
        "opt_leaves": [opt[i] for i in sorted(opt)],
        "opt_treedef": opt_treedef,
        "meta": meta,
    }


def opt_leaves_of(opt_state: list, names: List[str],
                  tree_from_named: Callable[[dict], dict]) -> list:
    """The port's Adam state [count, *mu, *nu] (mu and nu in the order of
    ``names``) -> numpy leaves in JAX's order and layout: count, then the
    leaves of the mu tree and of the nu tree, each made by
    ``tree_from_named`` (``weights.jax_tree_from_named`` or
    ``wave_tree_from_named``)."""
    n = len(names)
    leaves = [opt_state[0].cpu().numpy()]
    for moments in (opt_state[1:1 + n], opt_state[1 + n:]):
        leaves += tree_leaves(tree_from_named(dict(zip(names, moments))))
    return leaves


def restore_opt_state(opt_state: list, names: List[str],
                      template: dict, opt_leaves: list,
                      named_from_tree: Callable[[dict], Dict[str, Any]],
                      saved_treedef: Optional[str] = None) -> list:
    """Saved optimizer leaves (JAX's order and layout, as
    :func:`opt_leaves_of` and JAX's ``save_checkpoint`` write them) -> a
    new Adam state [count, *mu, *nu] like ``opt_state`` (same devices and
    dtypes), mu and nu in the order of ``names``. ``template`` is the
    params' JAX-layout tree, whose leaf order and shapes the saved leaves
    must follow; ``named_from_tree`` maps such a tree to arrays under the
    parameter names (``torch_convert.params_to_state_dict``).

    Refuses (ValueError), as JAX's ``restore_opt_state`` does, rather than
    zip leaves positionally: a leaf count other than 1 + 2 x the params'
    leaves, a leaf whose shape is not the template's, or a saved tree
    definition that is not Adam's over that many leaves (another
    optimizer whose leaves merely line up)."""
    flat: dict = {}
    _flatten(template, "", flat)
    paths = list(flat)
    n_tree = len(paths)
    if len(opt_leaves) != 1 + 2 * n_tree:
        raise ValueError(
            f"optimizer state mismatch: {1 + 2 * n_tree} leaves expected "
            f"(Adam's count, mu and nu), the checkpoint has {len(opt_leaves)}")
    if saved_treedef is not None and (
            "ScaleByAdamState" not in saved_treedef
            or saved_treedef.count("*") != len(opt_leaves)):
        raise ValueError(
            "checkpoint optimizer state structure differs from the "
            "configured optimizer (Adam) - refusing to zip leaves "
            f"positionally (saved: {saved_treedef[:120]}...)")
    count = np.asarray(opt_leaves[0])
    if count.shape != ():
        raise ValueError(f"optimizer state: count has shape {count.shape}")
    moments = []
    for part in (opt_leaves[1:1 + n_tree], opt_leaves[1 + n_tree:]):
        for path, leaf in zip(paths, part):
            if np.shape(leaf) != np.shape(flat[path]):
                raise ValueError(
                    f"optimizer state leaf {path}: shape {np.shape(leaf)}, "
                    f"the params' {np.shape(flat[path])}")
        named = named_from_tree(_unflatten(dict(zip(paths, part))))
        moments.append([named[k] for k in names])
    n = len(names)
    out = [torch.as_tensor(count.astype(np.int32)).to(opt_state[0].device)]
    for group, slots in zip(moments, (opt_state[1:1 + n], opt_state[1 + n:])):
        for arr, slot in zip(group, slots):
            arr = np.ascontiguousarray(np.asarray(arr, np.float32))
            if arr.shape != tuple(slot.shape):
                raise ValueError(f"optimizer state: {arr.shape} for a "
                                 f"parameter of shape {tuple(slot.shape)}")
            out.append(torch.from_numpy(arr).to(slot.device, slot.dtype))
    return out


def save_checkpoint(path: str, params, *, opt_state=None, masks=None,
                    meta: Optional[dict] = None,
                    opt_treedef: Optional[str] = None) -> None:
    """Write ``params`` (a JAX-layout numpy tree) in the format of
    ``speech_ssl_compression_tpu/utils/checkpoint.py::save_checkpoint``: a
    single atomic ``.npz`` with the metadata embedded, and a ``.json`` copy
    beside it. ``opt_state`` is the list of optimizer leaves in JAX's
    order (for Adam: [count, *mu, *nu], each tree in the params' leaf
    order and layout), stored as ``opt/<i>``; JAX's ``restore_opt_state``
    zips them into its own optimizer state. ``opt_treedef`` (the string
    of a resumed checkpoint's optax tree) is stored as ``opt_treedef``."""
    flat: dict = {}
    _flatten(params, "params", flat)
    if masks is not None:
        _flatten(masks, "masks", flat)
    for i, leaf in enumerate(opt_state or ()):
        flat[f"opt/{i}"] = np.asarray(leaf)
    if opt_treedef is not None:
        flat["opt_treedef"] = np.frombuffer(opt_treedef.encode(),
                                            dtype=np.uint8)
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
