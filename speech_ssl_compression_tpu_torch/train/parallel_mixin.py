"""Data-, tensor- and pipeline-parallel training, shared by Runner and
WaveRunner (pipeline parallel: MelHuBERT pre-training only).

Port of what JAX's two runners do on their ``(data, model)`` mesh
(``speech_ssl_compression_tpu/train/runner.py:86-100,215-248`` and
``wave_runner.py:86-95,140-141``) with one process per rank
(``parallel/mesh.py``):

  * every rank builds the same whole model (the same seed, or the same
    ``-i`` checkpoint), its masks and Adam state; then a tensor-parallel
    rank keeps its slices (:meth:`_shard_state`) and builds its model on
    its own heads and FFN units;
  * each data rank reads its shard of the data (the datasets'
    ``process_index`` of ``process_count``) and draws its span masks as
    rows of the global batch's; its loss divides by the global batch's
    counts, and the window's gradients and losses are summed over the data
    group (:meth:`_reduce_window`) before the apply, whose clip takes the
    norm of the whole gradient (:meth:`_grad_sumsq`);
  * what needs the whole model (a checkpoint, a prune event's scores and
    slicing) gathers it (:meth:`_whole_state`, :meth:`_whole`), and after
    a prune event every rank slices anew;
  * only the primary (rank 0) writes: the expdir, TensorBoard, the
    checkpoints, the log lines;
  * under ``--pipeline_parallel S`` (JAX ``Runner._init_pipeline_mesh``,
    ``runner.py:159-213``) the grid is ``(data, pipe)``: every rank builds
    the whole model and Adam state, then keeps the replicated leaves and
    its stage's layers (``parallel/pipeline.py::stage_model``); the grad
    step sums its own gradients (:meth:`_reduce_window` passes them on),
    the clip adds the stages' squares over the pipe group, and a
    checkpoint gathers the stages into the standard per-layer tree, its
    Adam state in JAX's stage-split layout (so an optimizer resume needs
    the same S, as in JAX).

Host attributes the mixin relies on: ``args``, ``cfg`` (the whole
model's), ``params``, ``masks``, ``opt_state``, ``model``, ``device``,
``_model_from_named(named, cfg)`` and ``_build_grad_step()``.
"""

from __future__ import annotations

import contextlib

import torch

from ..parallel.mesh import (
    all_reduce_tensors,
    attach,
    gather_named,
    local_config,
    make_mesh,
    shard_named,
    shard_spec,
)
from ..parallel.multihost import process_info, rank_device
from ..parallel.pipeline import (
    check_pipeline,
    gather_stages,
    layer_of,
    split_pipeline_params,
    stage_model,
)
from ..utils.torch_convert import merge_pipeline_tree, split_pipeline_tree
from .steps import grad_sumsq


class ParallelMixin:
    # whether the trainer runs --pipeline_parallel (JAX's WaveRunner has
    # no pipeline)
    _pipeline = False

    def _init_grid(self, args) -> None:
        """The rank grid of ``--model_parallel`` or ``--pipeline_parallel``
        over the process group (one rank without one), this rank's device
        and whether it is the primary. The pipeline takes MelHuBERT
        pre-training alone, never with ``--model_parallel`` (JAX's
        refusals, ``runner.py:171-181``)."""
        pp = int(getattr(args, "pipeline_parallel", 1) or 1)
        tp = int(getattr(args, "model_parallel", 1) or 1)
        if pp > 1:
            if not self._pipeline:
                raise NotImplementedError(
                    "--pipeline_parallel: JAX's WaveRunner has no pipeline; "
                    "the waveform models train on the data/tensor axes")
            if args.mode != "melhubert":
                raise NotImplementedError(
                    "--pipeline_parallel supports the melhubert pre-train "
                    f"mode only (got {args.mode}); compression runs use "
                    "data/tensor parallelism")
        self.mesh = make_mesh(tp, pp)
        self.proc_id, self.proc_count = process_info()
        self.primary = self.proc_id == 0
        self.device = rank_device(self.device)
        self._sharded = False
        if self.mesh.world > 1 and self.primary:
            print(f"{self._log_tag} - Rank grid {self.mesh.shape} across "
                  f"{self.proc_count} process(es)")

    def _data_shard(self) -> dict:
        """The datasets' sharding arguments: this rank's data index of the
        data group's ranks."""
        return dict(process_index=self.mesh.data_index,
                    process_count=self.mesh.dp)

    # ------------------------------------------------------- shard / gather

    def _init_pipeline(self) -> None:
        """After the model is built: the pipeline's limits that need it
        (JAX ``_init_pipeline_mesh``: no weight-pruning masks, a stack
        that splits, a batch of whole microbatches) and the checkpoints'
        Adam layout, JAX's stage-split tree."""
        if self.mesh.pp == 1:
            return
        if self.masks is not None:
            raise NotImplementedError(
                "pipeline-parallel training from a weight-pruned checkpoint "
                "is unsupported (fold the masks into the weights first)")
        check_pipeline(self.cfg, self.mesh.pp)
        m = int(getattr(self.args, "pp_microbatches", 0) or 0)
        self.pp_microbatches = m if m > 0 else 2 * self.mesh.pp
        b = int(self.runner_config["datarc"]["train_batch_size"])
        if b % self.pp_microbatches:
            raise ValueError(
                f"train_batch_size={b} (a data rank's batch) must be a "
                f"multiple of pp_microbatches={self.pp_microbatches}")
        tree_from_named, named_from_tree = (self._tree_from_named,
                                            self._named_from_tree)
        n = self.mesh.pp
        self._tree_from_named = lambda named: split_pipeline_tree(
            tree_from_named(named), n)
        self._named_from_tree = lambda tree: named_from_tree(
            merge_pipeline_tree(tree))
        if self.primary:
            print(f"{self._log_tag} - Pipeline grid {self.mesh.shape}, "
                  f"{self.pp_microbatches} microbatches")

    def _shard_state(self) -> None:
        """The whole model, masks and Adam state -> this rank's: slices of
        the split leaves on a tensor-parallel grid, a model built on the
        local widths, the mesh attached to it; on a pipeline grid the
        replicated leaves and this stage's layers."""
        mesh = self.mesh
        if mesh.world == 1:
            return
        if mesh.pp > 1:
            names = list(self.params)
            n = len(names)
            parts = [split_pipeline_params(dict(zip(names, leaves)), mesh.pp)
                     for leaves in (list(self.params.values()),
                                    self.opt_state[1:1 + n],
                                    self.opt_state[1 + n:])]
            mine = [{**p["rep"], **p["stages"][mesh.pipe_index]}
                    for p in parts]
            self.model = stage_model(mine[0], self.cfg, mesh.pipe_index,
                                     mesh.pp)
            self.params = dict(self.model.named_parameters())
            self.opt_state = ([self.opt_state[0]]
                              + [mine[1][k] for k in self.params]
                              + [mine[2][k] for k in self.params])
            attach(self.model, mesh)
            return
        if mesh.tp > 1:
            names = list(self.params)
            local = shard_named(self.params, self.cfg, mesh)
            self.model = self._model_from_named(
                local, local_config(self.cfg, mesh))
            self.params = dict(self.model.named_parameters())
            if self.masks is not None:
                self.masks = shard_named(self.masks, self.cfg, mesh)
            n = len(names)
            moments = [shard_named(dict(zip(names, part)), self.cfg, mesh)
                       for part in (self.opt_state[1:1 + n],
                                    self.opt_state[1 + n:])]
            self.opt_state = ([self.opt_state[0]]
                              + [moments[0][k] for k in names]
                              + [moments[1][k] for k in names])
            self._sharded = True
        attach(self.model, mesh, shard=mesh.tp > 1)

    def _whole_state(self, for_primary: bool = False):
        """(params, masks, Adam state) of the whole model, gathered over
        the model group where this rank holds slices (a collective: every
        rank of the group calls it), else its own. ``for_primary`` (a
        checkpoint): gathered to the primary alone, by its model group
        only; None elsewhere."""
        if for_primary and not self.primary and (
                not (self._sharded or self.mesh.pp > 1)
                or self.mesh.data_index != 0):
            return None
        if self.mesh.pp > 1:
            return self._gather_stages(for_primary)
        if not self._sharded:
            return self.params, self.masks, self.opt_state
        names = list(self.params)
        n = len(names)
        dicts = [self.params] + [dict(zip(names, part)) for part in (
            self.opt_state[1:1 + n], self.opt_state[1 + n:])]
        if self.masks is not None:
            dicts.append(self.masks)
        whole = gather_named(dicts, self.cfg, self.mesh,
                             dst=0 if for_primary else None)
        if whole is None:
            return None
        opt_state = ([self.opt_state[0]] + [whole[1][k] for k in names]
                     + [whole[2][k] for k in names])
        masks = whole[3] if self.masks is not None else None
        return whole[0], masks, opt_state

    def _gather_stages(self, for_primary: bool):
        """The whole model's parameters and Adam state from the stages of
        this rank's pipe group (``pipeline.gather_stages``), in the whole
        model's order; None on a rank that receives nothing."""
        names = list(self.params)
        n = len(names)
        whole = gather_stages(
            [self.params] + [dict(zip(names, part)) for part in (
                self.opt_state[1:1 + n], self.opt_state[1 + n:])],
            self.cfg, self.mesh, to_primary=for_primary)
        if whole is None:
            return None
        params, mu, nu = whole
        return (params, None,
                [self.opt_state[0]] + list(mu.values()) + list(nu.values()))

    @contextlib.contextmanager
    def _whole(self):
        """The whole model, masks and Adam state on this rank for the
        duration (a prune event, which scores and slices the whole model),
        then this rank's slices of what they have become."""
        if not self._sharded:
            yield
            return
        params, self.masks, self.opt_state = self._whole_state()
        self.model = attach(self._model_from_named(params, self.cfg),
                            self.mesh)
        self.params = dict(self.model.named_parameters())
        self._sharded = False
        yield
        self._shard_state()
        self._build_grad_step()

    def _prune_hook(self, global_step: int, pbar_state: dict):
        if global_step not in self.prune_steps:
            return
        with self._whole():
            super()._prune_hook(global_step, pbar_state)

    # ---------------------------------------------------------- reductions

    def _reduce_window(self, grads, scalars):
        """The window's gradients and scalars (losses, sample counts)
        summed over the data group, in one all-reduce; as they are with
        one data rank. On a tensor-parallel grid the replicated leaves'
        gradients and the scalars are then averaged over the model group:
        every model rank computes the same values, but a kernel that adds
        with atomics (cuDNN's weight gradients) may round them apart, and
        replicas that step apart drift."""
        if self.mesh.world == 1 or self.mesh.pp > 1:
            # the pipeline's grad step returns them summed
            return grads, scalars
        grads = list(grads)
        scalars = [torch.as_tensor(s, dtype=torch.float32,
                                   device=self.device).reshape(())
                   for s in scalars]
        if self.mesh.dp > 1:
            out = all_reduce_tensors(grads + scalars, self.mesh.data_group)
            grads, scalars = out[:len(grads)], out[len(grads):]
        if self._sharded:
            same = [i for i, name in enumerate(self.params)
                    if shard_spec(name, self.cfg, self.mesh.tp) is None]
            out = all_reduce_tensors([grads[i] for i in same] + scalars,
                                     self.mesh.model_group)
            for i, g in zip(same, out):
                grads[i] = g / self.mesh.tp
            scalars = [s / self.mesh.tp for s in out[len(same):]]
        return grads, scalars

    def _grad_sumsq(self, grads):
        """The squared norm of the whole gradient on a tensor-parallel
        grid: the split leaves' squares summed over the model group, the
        replicated ones' once; on a pipeline grid the stages' squares
        summed over the pipe group, the replicated leaves' once. None
        elsewhere (the apply takes its own)."""
        if self.mesh.pp > 1:
            own = [g for name, g in zip(self.params, grads)
                   if layer_of(name) is not None]
            rep = [g for name, g in zip(self.params, grads)
                   if layer_of(name) is None]
            total = all_reduce_tensors([grad_sumsq(own)],
                                       self.mesh.pipe_group)[0]
            return total + grad_sumsq(rep)
        if not self._sharded:
            return None
        split, whole = [], []
        for name, g in zip(self.params, grads):
            sharded = shard_spec(name, self.cfg, self.mesh.tp) is not None
            (split if sharded else whole).append(g)
        own = (grad_sumsq(split) if split
               else torch.zeros((), device=self.device))
        total = all_reduce_tensors([own], self.mesh.model_group)[0]
        return total + (grad_sumsq(whole) if whole else 0.0)

    def _raise_if_grid(self, err: BaseException):
        """A CUDA out-of-memory error on a grid of ranks ends the run: a
        window one rank dropped alone would put the ranks out of step."""
        if self.mesh.world > 1:
            raise err

