"""The ``(data, model)`` grid of ranks, the tensor-parallel layout and its
collectives.

Port of ``speech_ssl_compression_tpu/parallel/mesh.py``. JAX lays its
devices out as a ``(data, model)`` mesh and lets GSPMD place the
collectives; here each process is one rank of a ``world // tp`` x ``tp``
grid (rank ``r``: data index ``r // tp``, model index ``r % tp``, JAX's
``reshape(n // tp, tp)``), with a process group per row and per column:

  * the data group (the ranks of one model index) holds replicas that read
    different batches; their gradients are summed over it;
  * the model group (the ranks of one data index) splits each encoder
    layer by JAX's ``_mha_spec`` table: ``q_proj``, ``k_proj``, ``v_proj``
    and ``fc1`` on their outputs (heads, FFN units), ``out_proj`` and
    ``fc2`` on their inputs (their biases replicated and added once, after
    the all-reduce), everything else replicated. Those are the dimensions
    head and row pruning delete, so a pruned model splits the same way; a
    layer's heads or units that do not divide by ``tp`` split unevenly
    (the first ``n % tp`` ranks take one more).

Each group has a twin on gloo for host tensors where the device backend is
NCCL. :class:`CopyToModel` and :class:`ReduceFromModel` are the pair of
autograd functions Megatron-LM calls f and g (identity forward and
all-reduce backward, and the reverse), which JAX gets from GSPMD.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .multihost import backend, process_info

_LAYER_LEAF = re.compile(
    r"^encoder\.layers\.(\d+)\.(self_attn\.(q_proj|k_proj|v_proj|out_proj)"
    r"|fc1|fc2)\.(weight|bias)$")


@dataclass
class Mesh:
    """This rank's place in the grid and its groups (None where the group
    would hold one rank)."""

    world: int = 1
    tp: int = 1
    rank: int = 0
    data_group: Any = None
    model_group: Any = None
    cpu_data_group: Any = None
    cpu_model_group: Any = None

    @property
    def dp(self) -> int:
        return self.world // self.tp

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.tp}


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The grid over every rank of the process group (one rank without
    one). Raises JAX's ``ValueError`` where ``model_parallel`` does not
    divide the ranks. Every rank must call it, in the same order: each
    group is made on all of them."""
    rank, n = process_info()
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(
            f"make_mesh: {n} device(s) available but model_parallel="
            f"{model_parallel} must evenly divide them. Either lower "
            "model_parallel (tp=1 always works) or start more ranks "
            "(torchrun --nproc_per_node N ... --multi_host).")
    mesh = Mesh(world=n, tp=model_parallel, rank=rank)
    if n == 1:
        return mesh
    same = backend() == "gloo"
    tp, dp = mesh.tp, mesh.dp

    def groups(ranks, mine):
        if len(ranks) == 1:
            return None, None
        dev = dist.new_group(ranks)
        cpu = dev if same else dist.new_group(ranks, backend="gloo")
        return (dev, cpu) if mine else (None, None)

    for m in range(tp):
        got = groups([d * tp + m for d in range(dp)], m == mesh.model_index)
        if m == mesh.model_index:
            mesh.data_group, mesh.cpu_data_group = got
    for d in range(dp):
        got = groups([d * tp + m for m in range(tp)], d == mesh.data_index)
        if d == mesh.data_index:
            mesh.model_group, mesh.cpu_model_group = got
    return mesh


# ---------------------------------------------------------------- layout

def split(n: int, parts: int) -> List[Tuple[int, int]]:
    """(start, size) of each of ``parts`` contiguous pieces of ``n``; the
    first ``n % parts`` take one more."""
    base, extra = divmod(int(n), parts)
    out, start = [], 0
    for i in range(parts):
        size = base + (i < extra)
        out.append((start, size))
        start += size
    return out


def shard_spec(name: str, cfg, tp: int) -> Optional[tuple]:
    """(dim, [(start, size) per model rank]) of a tensor-parallel leaf
    (torch layout: a Linear's weight is (out, in)), None for a replicated
    one."""
    m = _LAYER_LEAF.match(name)
    if m is None or tp == 1:
        return None
    layer, module, leaf = int(m.group(1)), m.group(2), m.group(4)
    if module in ("self_attn.out_proj", "fc2") and leaf == "bias":
        return None
    if module.startswith("self_attn"):
        d = cfg.head_dim
        parts = [(s * d, n * d) for s, n in
                 split(cfg.encoder_attention_heads[layer], tp)]
    else:
        parts = split(cfg.encoder_ffn_embed_dim[layer], tp)
    return (1 if module in ("self_attn.out_proj", "fc2") else 0), parts


def local_config(cfg, mesh: Mesh):
    """``cfg`` with this model rank's heads and FFN units per layer."""
    if mesh.tp == 1:
        return cfg
    m = mesh.model_index
    return cfg.with_heads(
        [split(h, mesh.tp)[m][1] for h in cfg.encoder_attention_heads]
    ).with_ffn_dims(
        [split(f, mesh.tp)[m][1] for f in cfg.encoder_ffn_embed_dim])


def shard_named(named: Dict[str, torch.Tensor], cfg,
                mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This model rank's slices of whole tensors under the model's names
    (parameters, masks, Adam moments), in a new dict; replicated ones as
    they are. Slices are copies: the whole tensor can be freed."""
    out = {}
    for name, t in named.items():
        spec = shard_spec(name, cfg, mesh.tp)
        if spec is None:
            out[name] = t
            continue
        dim, parts = spec
        start, size = parts[mesh.model_index]
        out[name] = t.detach().narrow(dim, start, size).clone(
            memory_format=torch.contiguous_format)
    return out


def gather_named(dicts: List[Dict[str, torch.Tensor]], cfg, mesh: Mesh,
                 dst: Optional[int] = None):
    """The inverse of :func:`shard_named` on every rank of the model group,
    of several dicts (parameters, Adam moments, masks) at once: the whole
    tensors, on the device of the slices, in one all-gather on the host
    group; with ``dst`` (a global rank of the model group) a gather to
    that rank alone, and None elsewhere. ``cfg`` is the whole model's
    config."""
    if mesh.tp == 1:
        return [dict(d) for d in dicts]
    # (dict index, name, (dim, parts)) of every split leaf, and its shape
    # on each model rank
    leaves = [(k, n, shard_spec(n, cfg, mesh.tp))
              for k, d in enumerate(dicts) for n in d]
    leaves = [leaf for leaf in leaves if leaf[2] is not None]
    shapes = [[list(dicts[k][n].shape[:dim]) + [parts[r][1]]
               + list(dicts[k][n].shape[dim + 1:])
               for k, n, (dim, parts) in leaves] for r in range(mesh.tp)]
    sizes = [sum(int(np.prod(s)) for s in per) for per in shapes]
    flat = torch.cat([dicts[k][n].detach().float().reshape(-1).cpu()
                      for k, n, _ in leaves] or [torch.zeros(0)])
    width = max(sizes)
    flat = torch.nn.functional.pad(flat, (0, width - flat.numel()))
    pieces = [torch.empty(width) for _ in range(mesh.tp)]
    if dst is None:
        dist.all_gather(pieces, flat, group=mesh.cpu_model_group)
    else:
        dist.gather(flat, pieces if mesh.rank == dst else None, dst=dst,
                    group=mesh.cpu_model_group)
        if mesh.rank != dst:
            return None
    per_rank = [torch.split(piece[:sizes[r]],
                            [int(np.prod(s)) for s in shapes[r]])
                for r, piece in enumerate(pieces)]
    out = [dict(d) for d in dicts]
    for i, (k, name, (dim, _)) in enumerate(leaves):
        t = dicts[k][name]
        whole = torch.cat([per_rank[r][i].view(shapes[r][i])
                           for r in range(mesh.tp)], dim=dim)
        out[k][name] = whole.to(device=t.device, dtype=t.dtype)
    return out


def attach(model, mesh: Optional[Mesh], shard: bool = False):
    """Marks ``model`` as a rank's replica of the grid: its forwards draw
    span masks over the data group's global batch and fold the rank into
    their dropout seeds; with ``shard`` (a model built on
    :func:`local_config`) its encoder layers all-reduce over the model
    group. Returns ``model``."""
    model.mesh = mesh
    enc = getattr(model, "encoder", None)
    if enc is not None:
        tp = mesh if shard and mesh is not None and mesh.tp > 1 else None
        enc.mesh, enc.tp = mesh, tp
        for layer in enc.layers:
            layer.tp = tp
    return model


# ----------------------------------------------------------- collectives

class CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce (sum over the model group) backward:
    the replicated input of a split region."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums a split
    region hands back to the replicated one."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of ``x`` over ``group``, added in f32 whatever
    ``x``'s dtype (as a matmul accumulates) and returned in it."""
    y = x.float().contiguous()
    if y.data_ptr() == x.data_ptr():
        y = y.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def all_reduce_tensors(tensors: List[torch.Tensor],
                       group) -> List[torch.Tensor]:
    """The sums over ``group`` of tensors of one device, in one all-reduce
    of their flat concatenation (f32, or f64 where one is f64); new
    tensors in the input dtypes."""
    wide = (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
            else torch.float32)
    flat = torch.cat([t.detach().to(wide).reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out = []
    for t, piece in zip(tensors, torch.split(flat, [t.numel()
                                                    for t in tensors])):
        out.append(piece.view(t.shape).to(t.dtype))
    return out


def local_rows(mesh: Optional[Mesh], draw, lengths):
    """``draw(lengths)`` of this rank's batch as the 1-process run draws
    it over the data group's global batch: the lengths gathered over the
    data group (each rank's batch has as many rows), ``draw`` called on
    them on every rank with the same generator state, and this rank's rows
    of the result taken. ``draw`` draws row after row, so the global batch's
    mask is the 1-process replay's."""
    lengths = np.asarray(lengths)
    if mesh is None or mesh.dp == 1:
        return draw(lengths)
    mine = torch.as_tensor(lengths.astype(np.int64))
    parts = [torch.empty_like(mine) for _ in range(mesh.dp)]
    dist.all_gather(parts, mine, group=mesh.cpu_data_group)
    glob = torch.cat(parts).numpy().astype(lengths.dtype)
    b = len(lengths)
    out = draw(glob)
    return out[mesh.data_index * b:(mesh.data_index + 1) * b]
