"""The grid of ranks, the tensor-parallel layout and the collectives of
the data, tensor, sequence and pipeline parallel paths.

Port of ``speech_ssl_compression_tpu/parallel/mesh.py`` and of the mesh of
``parallel/pipeline.py::pipeline_mesh``. JAX lays its devices out as a
``(data, model)`` or ``(data, pipe)`` mesh and lets GSPMD (or shard_map)
place the collectives; here each process is one rank of a ``world //
inner`` x ``inner`` grid, ``inner`` being ``tp`` or ``pp`` (rank ``r``:
data index ``r // inner``, model or pipe index ``r % inner``, JAX's
``reshape(n // inner, inner)``), with a process group per row and per
column:

  * the data group (the ranks of one model index) holds replicas that read
    different batches; their gradients are summed over it;
  * the model group (the ranks of one data index) splits each encoder
    layer by JAX's ``_mha_spec`` table: ``q_proj``, ``k_proj``, ``v_proj``
    and ``fc1`` on their outputs (heads, FFN units), ``out_proj`` and
    ``fc2`` on their inputs (their biases replicated and added once, after
    the all-reduce), everything else replicated. Those are the dimensions
    head and row pruning delete, so a pruned model splits the same way; a
    layer's heads or units that do not divide by ``tp`` split unevenly
    (the first ``n % tp`` ranks take one more);
  * the pipe group (the ranks of one data index under ``--pipeline_parallel``)
    holds the stages of one replica, each rank a contiguous run of encoder
    layers (``parallel/pipeline.py``).

Each group has a twin on gloo for host tensors where the device backend is
NCCL. :class:`CopyToModel` and :class:`ReduceFromModel` are the pair of
autograd functions Megatron-LM calls f and g (identity forward and
all-reduce backward, and the reverse), which JAX gets from GSPMD.

The sequence and pipeline paths add three host collectives, each
differentiable where JAX differentiates its counterpart:
:func:`all_gather_seq` (JAX's ``all_gather(tiled=True)``, whose transpose
is ``psum_scatter``), :func:`halo_exchange` (the pair of ``lax.ppermute``
calls of ``parallel/seqpar.py::_pos_conv_halo`` and their transposes) and
the point-to-point :func:`send` / :func:`recv` between consecutive stages.
Under gloo they go through the host group, on CPU copies of the tensors
(gloo gathers and sends CPU tensors only); under NCCL they take the CUDA
tensors on the device group.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .multihost import backend, cpu_group, process_info

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
    pp: int = 1
    pipe_group: Any = None
    cpu_pipe_group: Any = None

    @property
    def inner(self) -> int:
        return self.tp * self.pp

    @property
    def dp(self) -> int:
        return self.world // self.inner

    @property
    def data_index(self) -> int:
        return self.rank // self.inner

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def pipe_index(self) -> int:
        return self.rank % self.pp

    @property
    def shape(self) -> dict:
        if self.pp > 1:
            return {"data": self.dp, "pipe": self.pp}
        return {"data": self.dp, "model": self.tp}


def make_mesh(model_parallel: int = 1, pipeline_parallel: int = 1) -> Mesh:
    """The grid over every rank of the process group (one rank without
    one). Raises JAX's ``ValueError`` where ``model_parallel`` or
    ``pipeline_parallel`` does not divide the ranks (``make_mesh``,
    ``pipeline_mesh``), and its runner's ``NotImplementedError`` for both
    at once. Every rank must call it, in the same order: each group is
    made on all of them."""
    rank, n = process_info()
    if pipeline_parallel > 1 and model_parallel > 1:
        raise NotImplementedError(
            "--pipeline_parallel cannot combine with --model_parallel")
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(
            f"make_mesh: {n} device(s) available but model_parallel="
            f"{model_parallel} must evenly divide them. Either lower "
            "model_parallel (tp=1 always works) or start more ranks "
            "(torchrun --nproc_per_node N ... --multi_host).")
    if pipeline_parallel < 1 or n % pipeline_parallel != 0:
        raise ValueError(
            f"pipeline_mesh: {n} device(s) but pipeline_parallel="
            f"{pipeline_parallel} must divide them: --pipeline_parallel "
            f"{pipeline_parallel} needs {pipeline_parallel} ranks (or a "
            "multiple; torchrun --nproc_per_node N ... --multi_host)")
    mesh = Mesh(world=n, tp=model_parallel, rank=rank, pp=pipeline_parallel)
    if n == 1:
        return mesh
    same = backend() == "gloo"
    inner, dp = mesh.inner, mesh.dp

    def groups(ranks, mine):
        if len(ranks) == 1:
            return None, None
        dev = dist.new_group(ranks)
        cpu = dev if same else dist.new_group(ranks, backend="gloo")
        return (dev, cpu) if mine else (None, None)

    col = mesh.rank % inner
    for m in range(inner):
        got = groups([d * inner + m for d in range(dp)], m == col)
        if m == col:
            mesh.data_group, mesh.cpu_data_group = got
    for d in range(dp):
        got = groups([d * inner + m for m in range(inner)],
                     d == mesh.data_index)
        if d == mesh.data_index:
            if mesh.pp > 1:
                mesh.pipe_group, mesh.cpu_pipe_group = got
            else:
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
        # a pipeline stage's layers are an nn.ModuleDict
        layers = enc.layers
        for layer in (layers.values() if hasattr(layers, "values")
                      else layers):
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


# ------------------------------------ sequence and pipeline collectives

def _on_device(x: torch.Tensor) -> bool:
    """Whether a collective takes ``x`` where it lies: CUDA tensors under
    NCCL. Everything else goes through the host group."""
    return x.is_cuda and backend() == "nccl"


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a collective sends it: contiguous, on the host unless
    NCCL takes it on the device, booleans as uint8."""
    x = x.detach()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if not _on_device(x):
        x = x.cpu()
    return x.contiguous()


def gather_parts(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``x`` of every rank of the data group, in data-index order, on
    ``x``'s device and in its dtype (each rank's ``x`` has one shape)."""
    if mesh is None or mesh.dp == 1:
        return [x]
    wire = _wire(x)
    parts = [torch.empty_like(wire) for _ in range(mesh.dp)]
    dist.all_gather(parts, wire, group=(mesh.data_group if _on_device(x)
                                        else mesh.cpu_data_group))
    return [p.to(device=x.device, dtype=x.dtype) for p in parts]


def _sum_over_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The f32 sum of ``x`` over the data group, on ``x``'s device."""
    y = x.detach().float()
    y = (y if _on_device(x) else y.cpu()).contiguous().clone()
    dist.all_reduce(y, group=(mesh.data_group if _on_device(x)
                              else mesh.cpu_data_group))
    return y.to(x.device)


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.size = dim, mesh, x.shape[dim]
        return torch.cat(gather_parts(x, mesh), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        # the reduce-scatter of the gradient: summed over the ranks (in
        # f32, as a matmul accumulates), each keeping its own slice
        whole = _sum_over_data(grad, ctx.mesh)
        own = whole.narrow(ctx.dim, ctx.mesh.data_index * ctx.size,
                           ctx.size)
        return own.to(grad.dtype), None, None


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _sum_over_data(x, mesh).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over_data(grad, ctx.mesh).to(grad.dtype), None


def sum_over_data(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the data group (added in f32), for a batch
    statistic that every rank's loss reads whole (JAX takes it over the
    global batch): its gradient is the sum of the ranks' gradients of it.
    ``x`` itself off a data-parallel grid."""
    if mesh is None or mesh.dp == 1:
        return x
    return _SumOverData.apply(x, mesh)


def all_gather_seq(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The data group's ``x`` concatenated along ``dim`` in data-index
    order (JAX's ``all_gather(x, axis, axis=dim, tiled=True)``); its
    gradient is the reduce-scatter that sends each rank the sum of the
    gradients of its own slice (JAX's transpose, ``psum_scatter``). Every
    rank's ``x`` has one shape. ``x`` itself with one data rank."""
    if mesh is None or mesh.dp == 1:
        return x
    return _AllGatherSeq.apply(x, dim, mesh)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, mesh):
        ctx.halo, ctx.mesh, ctx.length = halo, mesh, x.shape[1]
        i, n = mesh.data_index, mesh.dp
        parts = gather_parts(torch.cat([x[:, :halo], x[:, -halo:]], dim=1),
                             mesh)
        zeros = x.new_zeros(x[:, :halo].shape)
        from_left = parts[i - 1][:, halo:] if i > 0 else zeros
        from_right = parts[i + 1][:, :halo] if i < n - 1 else zeros
        return from_left, from_right

    @staticmethod
    def backward(ctx, g_left, g_right):
        # each halo's gradient goes back to the neighbour it came from:
        # this rank's head to the left neighbour's from_right, its tail to
        # the right neighbour's from_left
        halo, mesh = ctx.halo, ctx.mesh
        i, n = mesh.data_index, mesh.dp
        parts = gather_parts(torch.cat([g_left, g_right], dim=1), mesh)
        shape = list(g_left.shape)
        shape[1] = ctx.length
        dx = g_left.new_zeros(shape)
        if i > 0:
            dx[:, :halo] += parts[i - 1][:, halo:]
        if i < n - 1:
            dx[:, -halo:] += parts[i + 1][:, :halo]
        return dx, None, None


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh):
    """(from_left, from_right), each (B, halo, ...): the left neighbour's
    last ``halo`` frames of ``x`` (B, T_local, ...) and the right
    neighbour's first, zeros at the sequence's two ends (the ranks of the
    data group hold consecutive time shards, in data-index order). The
    port of ``_pos_conv_halo``'s two ``lax.ppermute`` calls, gradient
    included: each halo's gradient is added to the frames it came from."""
    if mesh is None or mesh.dp == 1:
        zeros = x.new_zeros(x[:, :halo].shape)
        return zeros, zeros
    return _HaloExchange.apply(x, halo, mesh)


def send(x: torch.Tensor, dst: int) -> None:
    """``x`` to global rank ``dst`` (which posts the matching
    :func:`recv`); blocks until it is sent. bf16 travels as its bits."""
    wire = _wire(x)
    if wire.dtype == torch.bfloat16:
        wire = wire.view(torch.int16)
    dist.send(wire, dst, group=None if _on_device(x) else cpu_group())


def recv(shape, dtype: torch.dtype, device, src: int) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on ``device`` from global rank
    ``src``'s :func:`send`."""
    device = torch.device(device)
    on_device = device.type == "cuda" and backend() == "nccl"
    wire = torch.empty(shape, dtype=dtype,
                       device=device if on_device else "cpu")
    buf = wire.view(torch.int16) if dtype == torch.bfloat16 else wire
    dist.recv(buf, src, group=None if on_device else cpu_group())
    return wire.to(device)
