"""The MelHuBERT trainer: pre-training (``melhubert``), the weight-,
head- and row-pruning modes and distillation.

Port of the ``melhubert``, ``weight-pruning``, ``head-pruning``,
``row-pruning`` and ``distillation`` modes of
``speech_ssl_compression_tpu/train/runner.py::Runner``: a seeded
full-width model, or one initialised from ``-i`` (the JAX package's npz
with its masks, ``Pruning`` meta, ``Pruned_heads`` and Adam state, head-
and row-pruned widths inferred from the shapes, or a reference
``.ckpt``); the bucketed CSV batches, the gradient-accumulation
window (dropped whole on a CUDA out-of-memory error), the fused apply step
with its non-finite skip, log lines and TensorBoard scalars with loss,
grad norm and lr, and checkpoints in the JAX package's format (its
``load_checkpoint`` and ``restore_opt_state`` read them;
``--init_optimizer_from_initial_weight`` restores theirs).

Weight pruning adds the EMA convergence gate, the prune events at
``warnup + i * period`` with their ``before-pruning-states-*`` artifacts,
and masks applied inside every grad step. Head and row pruning (the
weight-pruning masks of an ``-i`` folded into the weights first) prune at
``warm_up + interval`` steps: each event writes ``states_prune_{n}.npz``
(n: the heads left, or the narrowest FFN), scores (heads: l1 on the host,
or data-driven, a pass in f32 with dropout on over ``data_ratio`` of an
epoch, buckets stacked into batches of >= 32; rows: l1 on the host),
slices the weights, and rebuilds the model, a fresh Adam state and the
grad step for the new widths; head events also write
``heads_and_score_{n}.npy`` and add to ``Pruned_heads``.

Distillation takes its teacher from ``-i`` (an npz through
``load_any_checkpoint``, weight-pruning masks folded and pruned widths
inferred, or a reference ``.ckpt``; the teacher's config is the
checkpoint's, not the YAML's ``teacher:`` section), frozen on the device.
The student is the YAML's ``student:`` (or legacy ``melhubert:``) section,
seeded, its pos-conv and first layers copied from the teacher with
``initial_from_teacher``; each micro-step runs the teacher without grad
and the student forward and backward (``steps.make_distill_grad_step``).
``--init_optimizer_from_initial_weight`` is ignored there, as in JAX; the
checkpoints hold the student, ``Config`` the student's and
``Upstream_Config`` the whole YAML.

Data, tensor and pipeline parallel (``--multi_host``,
``--model_parallel``, ``--pipeline_parallel`` with ``--pp_microbatches``;
``train/parallel_mixin.py``): one process per rank of a ``(data, model)``
or ``(data, pipe)`` grid, each data rank on its shard of the buckets, the
gradients summed over the data group, the encoder layers split over the
model group, or the stack cut into stages over the pipe group (MelHuBERT
pre-training only, ``parallel/pipeline.py``); only the primary writes.
Remat is a grad-step option
(``steps.make_melhubert_grad_step(remat=True)``), which JAX's Runner does
not expose either.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..compress import head_pruning as hp
from ..compress import weight_pruning as wp
from ..compress.distillation import init_student_from_teacher
from ..configs import MelHuBERTConfig
from ..data.bucket_dataset import MelFeatBuckets, PrefetchIterator
from ..extract import load_any_checkpoint, resolve_device
from ..models.melhubert import loss_selections
from ..parallel.mesh import all_reduce_tensors
from ..parallel.pipeline import make_melhubert_pipeline_grad_step
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.profiling import span
from ..utils.tb import TBLogger
from ..utils.torch_convert import (
    load_reference_checkpoint,
    params_to_state_dict,
)
from ..utils.weights import (
    infer_pruned_dims,
    init_params_np,
    jax_tree_from_named,
    load_model,
    masks_tree,
    model_from_named,
    named_masks,
)
from .optim_mixin import OptimizerScheduleMixin
from .parallel_mixin import ParallelMixin
from .prune_mixin import PruneMixin
from .steps import (
    accumulate_grads,
    global_totals,
    host_span_mask,
    make_distill_grad_step,
    make_melhubert_grad_step,
)

_PORTED_MODES = ("melhubert", "weight-pruning", "head-pruning",
                 "row-pruning", "distillation")


def _stack_buckets(batches: list) -> dict:
    """Copy of JAX ``_stack_buckets``: host bucket batches stacked into one
    head-scoring batch, each padded to the group's longest T rounded up to
    a multiple of 128 (labels with -100, pad_mask with 0, features with
    0) and concatenated on the batch axis."""
    t = -(-max(b["feat"].shape[1] for b in batches) // 128) * 128
    feat, label, pad, lens = [], [], [], []
    for b in batches:
        bt = b["feat"].shape[1]
        w = ((0, 0), (0, t - bt), (0, 0))
        feat.append(np.pad(b["feat"], w))
        label.append(np.pad(b["label"], w[:2], constant_values=-100))
        pad.append(np.pad(b["pad_mask"], w[:2]))
        lens.append(b["length"])
    return {
        "feat": np.concatenate(feat),
        "label": np.concatenate(label),
        "pad_mask": np.concatenate(pad),
        "length": np.concatenate(lens),
    }


class Runner(ParallelMixin, OptimizerScheduleMixin, PruneMixin):
    """``Runner(args, runner_config, upstream_config).train()``, as the JAX
    runner, for ``args.mode`` ``melhubert``, ``weight-pruning``,
    ``head-pruning``, ``row-pruning`` or ``distillation``.
    ``args.device`` names the torch device (``cuda`` when absent: the CPU
    only when asked for; ``cuda:LOCAL_RANK`` on a grid of ranks)."""

    _log_tag = "[Runner]"
    _strict_prune_schedule = True
    _pipeline = True

    def __init__(self, args, runner_config: dict, upstream_config: dict):
        if args.mode not in _PORTED_MODES:
            raise NotImplementedError(
                f"mode {args.mode!r} is not ported yet "
                f"({' and '.join(_PORTED_MODES)} only)")
        self.args = args
        self.runner_config = runner_config
        self.upstream_config = upstream_config
        self.mode = args.mode
        self.device = resolve_device(getattr(args, "device", "cuda"))
        self._init_grid(args)
        self.expdir = args.expdir
        if self.primary:  # the other ranks never touch the expdir
            os.makedirs(self.expdir, exist_ok=True)
        self.logger = TBLogger(self.expdir if self.primary else None)

        self.seed = int(getattr(args, "seed", 1337))
        self.rng = torch.Generator().manual_seed(self.seed)
        runner = runner_config.get("runner", {})
        self.compute_dtype = (
            torch.bfloat16
            if runner.get("bf16", True) and self.device.type == "cuda"
            else torch.float32
        )

        # the weight bridge the checkpoints and the Adam state go through
        self._tree_from_named = jax_tree_from_named
        self._named_from_tree = params_to_state_dict
        self.masks = None  # weight-pruning masks, named device tensors
        self.pruned_heads: list = []
        self.wp_state: Optional[wp.WeightPruningState] = None
        if self.mode == "distillation":
            self._init_distillation()
        else:
            self._init_melhubert()

        # frame-period sanity (reference runner.py:48-52)
        fp = getattr(args, "frame_period", 20)
        expect = {20: 80, 10: 40}[fp]
        assert self.cfg.feat_emb_dim == expect, (
            f"feat_emb_dim should be {expect} at frame period {fp}")
        self._init_pipeline()

        self._init_mode_schedules()
        self._init_optimizer_state()
        if (getattr(args, "init_optimizer_from_initial_weight", False)
                and self._resumed_opt_leaves):
            self._restore_opt_state(self._resumed_opt_leaves)
            print("[Runner] Loaded optimizer state from "
                  f"{args.initial_weight}")
            self._resync_schedule_offset()
        self._shard_state()

        self.accum_steps = int(runner.get("gradient_accumulate_steps", 1))
        self._build_grad_step()
        # {"step", "loss", "grad_norm"} of every log line; each prune
        # event's step and host seconds, and for a head or row event what
        # it chose and the device memory around it
        self.log_history: list = []
        self.prune_event_log: list = []

    def _init_melhubert(self):
        """The model: fresh from the seed, or from ``-i`` (JAX
        ``_init_melhubert``). The masters hold the checkpoint's params as
        they are; its masks, if any, go to ``self.masks``."""
        self.cfg = MelHuBERTConfig.from_dict(
            dict(self.upstream_config["melhubert"]))
        self._resumed_meta = None
        self._resumed_opt_leaves = None
        self._resumed_opt_treedef = None
        masks = None
        init_w = getattr(self.args, "initial_weight", None)
        if init_w and init_w.endswith(".npz"):
            state = load_checkpoint(init_w)
            params, masks = state["params"], state["masks"]
            self._resumed_meta = state["meta"]
            self._resumed_opt_leaves = state["opt_leaves"] or None
            self._resumed_opt_treedef = state["opt_treedef"]
            meta_cfg = (state["meta"].get("Upstream_Config", {})
                        .get("melhubert"))
            if meta_cfg:
                self.cfg = MelHuBERTConfig.from_dict(meta_cfg)
            self.pruned_heads = state["meta"].get("Pruned_heads", [])
            heads, ffns = infer_pruned_dims(params, self.cfg.head_dim)
            self.cfg = self.cfg.with_heads(heads).with_ffn_dims(ffns)
        elif init_w:
            params, masks, self.cfg, extras = load_reference_checkpoint(init_w)
            self._resumed_meta = extras
            self.pruned_heads = extras.get("Pruned_heads", [])
        else:
            params = init_params_np(self.cfg, self.seed)
        if init_w:
            print(f"[Runner] Initialized model from {init_w}")
        self.model = load_model(params, self.cfg).to(self.device)
        self.params = dict(self.model.named_parameters())
        if masks:
            self.masks = named_masks(masks, self.device)
        n = sum(p.numel() for p in self.params.values())
        print(f"[Runner] - Number of parameters: {n}")

    def _init_distillation(self):
        """The teacher from ``-i`` and a seeded student (JAX
        ``_init_distillation``). The teacher's config is the checkpoint's;
        it is frozen (``eval()``, no grad) on the device. The student's
        pos-conv and first layers are copies of the teacher's with
        ``initial_from_teacher``. Nothing is resumed: there is no Adam
        state to restore."""
        init_w = getattr(self.args, "initial_weight", None)
        if not init_w:
            raise ValueError("distillation needs the teacher's weights: "
                             "-i <ckpt.npz or reference .ckpt>")
        self._resumed_meta = None
        self._resumed_opt_leaves = None
        self._resumed_opt_treedef = None
        # the student under "student" (the current expert) or "melhubert"
        # (the legacy distillation/pretrain_expert.py:46)
        student = dict(self.upstream_config.get("student")
                       or self.upstream_config["melhubert"])
        self.cfg = MelHuBERTConfig.from_dict(student)
        tparams, self.teacher_cfg, _ = load_any_checkpoint(init_w)
        self.teacher = load_model(tparams, self.teacher_cfg).to(
            self.device).eval().requires_grad_(False)
        print(f"[Runner/Distill] - Loaded teacher weight from {init_w}")
        params = init_params_np(self.cfg, self.seed)
        if student.get("initial_from_teacher", False):
            print("[Runner/Distill] - Initializing student from teacher")
            params = init_student_from_teacher(params, tparams,
                                               self.cfg.encoder_layers)
        self.model = load_model(params, self.cfg).to(self.device)
        self.params = dict(self.model.named_parameters())
        lp = self.upstream_config["loss_param"]
        self.loss_temp = float(lp["T"])
        self.loss_alpha = float(lp["alpha"])
        self.loss_type = str(lp["type"])
        if self.loss_type not in ("masked", "nomasked"):
            raise NotImplementedError(
                f"[Runner/Distill] - no such loss type {self.loss_type}")
        n = sum(p.numel() for p in self.params.values())
        print(f"[Runner] - Number of parameters: {n} (student)")

    def _build_grad_step(self):
        if self.mesh.pp > 1:
            self.grad_step = make_melhubert_pipeline_grad_step(
                self.model, self.mesh, n_microbatches=self.pp_microbatches,
                accum_steps=self.accum_steps,
                compute_dtype=self.compute_dtype)
        elif self.mode == "distillation":
            self.grad_step = make_distill_grad_step(
                self.teacher, self.model, temperature=self.loss_temp,
                alpha=self.loss_alpha, loss_type=self.loss_type,
                accum_steps=self.accum_steps,
                compute_dtype=self.compute_dtype)
        else:
            self.grad_step = make_melhubert_grad_step(
                self.model, accum_steps=self.accum_steps,
                compute_dtype=self.compute_dtype)

    def _heads_each_step(self, pc: dict) -> int:
        # l1 prunes one head per layer per event, whatever the target
        return (self.cfg.encoder_layers if pc["metric"] == "l1"
                else pc["num_heads_each_step"])

    def _weight_prune_artifact(self, global_step: int, total: int):
        """``[mask-]before-pruning-states-{step}-sparsity-{s}.npz`` (s the
        sparsity so far), with ``TotalStep``."""
        state = self.wp_state
        prefix = "mask-" if state.pruning_times > 0 else ""
        cur = (0 if state.pruning_times == 0
               else state.sparsity[state.pruning_times - 1])
        return (f"{prefix}before-pruning-states-{global_step}-sparsity-"
                f"{cur}.npz", {"total_step": total})

    @staticmethod
    def _model_from_named(named, cfg):
        return model_from_named(named, cfg)

    def _get_dataloader(self) -> MelFeatBuckets:
        datarc = self.runner_config["datarc"]
        task = self.upstream_config.get("task") or {"sequence_length": 0}
        return MelFeatBuckets(
            frame_period=getattr(self.args, "frame_period", 20),
            sequence_length=task.get("sequence_length", 0),
            bucket_size=int(datarc["train_batch_size"]),
            sets=datarc["sets"],
            max_timestep=int(datarc.get("max_timestep", 0)),
            seed=self.seed,
            **self._data_shard(),
        )

    def _device_batch(self, batch: dict) -> dict:
        """Device tensors for feat, label and pad_mask; ``length`` stays a
        host array (the span mask is drawn on the host). Traced as
        ``sslc.train.upload``."""
        with span("sslc.train.upload"):
            out = {k: torch.from_numpy(batch[k]).to(self.device)
                   for k in ("feat", "label", "pad_mask")}
            out["label"] = out["label"].long()
            out["length"] = batch["length"]
            return out

    def save(self, global_step: int, name: str,
             total_step: Optional[int] = None):
        """A checkpoint in the JAX package's format: params, masks, the
        Adam state's leaves [count, *mu, *nu] in JAX's leaf order and
        layout, and the meta (``TotalStep``, ``Pruned_heads`` and
        ``Pruning`` where they apply). On a grid every rank calls it (a
        tensor-parallel rank's slices are gathered) and the primary
        writes."""
        whole = self._whole_state(for_primary=True)
        if whole is None:
            return
        params, masks, opt_state = whole
        meta = {
            "Step": global_step,
            "Args": dict(vars(self.args)),
            "Runner": self.runner_config,
            "Upstream_Config": self.upstream_config,
            "Config": self.cfg.to_dict(),
        }
        if total_step is not None:
            meta["TotalStep"] = total_step
        if self.pruned_heads:
            meta["Pruned_heads"] = self.pruned_heads
        if self.wp_state is not None:
            meta["Pruning"] = self.wp_state.to_meta()
        path = os.path.join(self.expdir, name)
        save_checkpoint(
            path, jax_tree_from_named(params),
            opt_state=self._opt_leaves(opt_state, list(params)),
            masks=None if masks is None else masks_tree(masks),
            meta=meta, opt_treedef=self._opt_treedef)
        print(f"[Runner] - Saved checkpoint to {path}")

    def _select_heads(self) -> dict:
        """The heads of this event (JAX ``_head_prune_event``): l1 scores
        on the JAX-layout host view, or the data-driven pass, written to
        ``heads_and_score_{n}.npy``; the selection is appended to
        ``Pruned_heads`` in JAX's form. Returns {layer: [head, ...]}."""
        pc = self.runner_config["prune"]
        metric = pc["metric"]
        if metric == "l1":
            scores = self._l1_scores()
        elif metric == "data-driven":
            scores = self._data_driven_head_scores()
        else:
            raise NotImplementedError(metric)
        if self.primary:
            np.save(os.path.join(
                self.expdir,
                f"heads_and_score_{sum(self.cfg.encoder_attention_heads)}"
                ".npy"),
                np.array([(l, h, s) for (l, h), s in scores], np.float64))
        group = hp.select_heads_to_prune(scores, self.num_heads_each_step,
                                         pc["target"], self.cfg.encoder_layers)
        print(f"[Head Pruning] - These heads are pruned: {group}")
        self.pruned_heads.append({int(k): list(v) for k, v in group.items()})
        return group

    def _data_driven_head_scores(self):
        """The data-driven scores (JAX ``_data_driven_head_scores``,
        reference hp_utils.py:242-353) over ``data_ratio`` of an epoch:
        consecutive buckets stacked into batches of >= 32 rows
        (``prune.scoring_batch_buckets`` overrides the group; 1 is the
        reference's per-bucket loop), each a forward in f32 with dropout
        on and a span mask drawn on the host, then the per-head products
        (``compress/head_pruning.py::context_scores``), summed in float64
        over the groups / their count, then ``normalize_by_layer``. On a
        data-parallel grid each rank scores its rows of the global scoring
        batches (the loss divided by the global counts) and the scores are
        summed over the data group before ranking, so every rank makes the
        same choice. Returns [((layer, head), score), ...]."""
        cfg = self.cfg
        pc = self.runner_config["prune"]
        data_ratio = pc["data_ratio"]
        assert 0 < data_ratio <= 1
        dataset = self._get_dataloader()
        total_steps = max(1, int(len(dataset) * data_ratio))
        bucket_b = int(self.runner_config["datarc"]["train_batch_size"])
        group = int(pc.get("scoring_batch_buckets", 0) or 0)
        if group <= 0:
            group = max(1, -(-32 // max(1, bucket_b)))
        group = min(group, total_steps)
        print(f"[Head Pruning] - data-driven scoring over {data_ratio} of an "
              f"epoch = {total_steps} buckets (stacked {group}/scoring batch "
              f"= B{bucket_b * group})")
        scores = [np.zeros((h,), np.float64)
                  for h in cfg.encoder_attention_heads]
        n_groups = -(-total_steps // group)
        pending = []
        consumed = 0
        for step, batch in enumerate(dataset.epoch(shuffle=True)):
            if step >= total_steps:
                break
            pending.append(batch)
            if len(pending) < group and step != total_steps - 1:
                continue
            batch = _stack_buckets(pending) if len(pending) > 1 else pending[0]
            pending = []
            dev_batch = self._device_batch(batch)
            mask = host_span_mask(cfg, dev_batch, self.rng, self.mesh)
            _, per_layer = hp.context_scores(
                self.model, self.params, dev_batch, mask, self.rng,
                totals=global_totals(self.mesh, loss_selections(
                    mask, dev_batch["label"], dev_batch["pad_mask"])))
            consumed += 1
            for i, s in enumerate(per_layer):
                scores[i] += s.cpu().numpy().astype(np.float64) / n_groups
        assert consumed == n_groups, (consumed, n_groups)
        if self.mesh.dp > 1:
            scores = [s.numpy() for s in all_reduce_tensors(
                [torch.from_numpy(s) for s in scores],
                self.mesh.cpu_data_group)]
        norm_exp = pc.get("normalize_by_layer")
        if norm_exp is not None:
            scores = hp.normalize_scores_by_layer(scores, float(norm_exp))
        return [((layer, head), float(s[head]))
                for layer, s in enumerate(scores) for head in range(len(s))]

    def train(self):
        runner = self.runner_config["runner"]
        dataset = self._get_dataloader()
        if not len(dataset):
            # an epoch of no batches would loop forever (JAX's does)
            raise ValueError("the training set gives no batch (datarc.sets "
                             "and max_timestep leave no utterance pair)")
        accum = self.accum_steps
        print("[Runner] - Accumulated batch size:",
              int(self.runner_config["datarc"]["train_batch_size"]) * accum
              * self.mesh.dp)

        n_epochs = runner.get("n_epochs", 0)
        if n_epochs > 0:
            total_steps = int(n_epochs * len(dataset) / accum)
            print(f"[Runner] - Training for {n_epochs} epochs "
                  f"= {total_steps} steps")
        else:
            total_steps = runner["total_steps"]
            n_epochs = max(1, int(total_steps * accum / max(len(dataset), 1)))
            print(f"[Runner] - Training for {total_steps} steps "
                  f"~= {n_epochs} epochs")
        step_per_epoch = max(1, len(dataset) // accum)
        save_every_x_epochs = runner.get("save_every_x_epochs", 10)
        self._finalize_schedule_total(total_steps)
        if self.prune_steps:
            assert max(self.prune_steps) <= total_steps, (
                f"prune steps {max(self.prune_steps)} > total {total_steps}")
        log_step = runner.get("log_step", 1000)

        pbar = {"n": 0, "total": total_steps}
        # window_* between log events; batch_loss and all_sample_size
        # within one accumulation window (grads are divided by the
        # window's sample count, as in JAX)
        window_loss = 0.0
        window_count = 0
        all_sample_size = 0
        batch_loss = 0.0
        global_step = 0
        backward_steps = 0
        # an OOM rewinds the window: the prune hook must not fire twice for
        # one global_step on the retry
        last_prune_fired = -1
        grads_acc = None
        prefix = f"{self.mode}/train-"
        t_start = time.time()

        while pbar["n"] < pbar["total"]:
            batches = PrefetchIterator(dataset.epoch(shuffle=True))
            for batch in batches:
                if pbar["n"] >= pbar["total"]:
                    break
                first_accu = backward_steps % accum == 0
                if self.mode in ("melhubert", "distillation") and first_accu:
                    cadence = max(1, int(save_every_x_epochs * step_per_epoch))
                    if global_step % cadence == 0:
                        self.save(global_step, f"states-epoch-"
                                  f"{global_step // step_per_epoch}.npz")
                elif first_accu and global_step != last_prune_fired:
                    self._prune_hook(global_step, pbar)
                    last_prune_fired = global_step

                global_step = pbar["n"] + 1
                try:
                    loss, grads, _ = self.grad_step(
                        self.params, self._device_batch(batch), self.rng,
                        masks=self.masks)
                except torch.cuda.OutOfMemoryError as err:
                    self._raise_if_grid(err)
                    # reference runner.py:379-386: drop the WHOLE window and
                    # rewind its counters, so the surviving windows divide
                    # by the right sample count
                    print(f"[Runner] - OOM at step {global_step}; "
                          "dropping accumulation window")
                    dropped = backward_steps % accum
                    grads_acc = None
                    backward_steps -= dropped
                    all_sample_size -= dropped  # sample_size == 1 each
                    batch_loss = 0.0
                    continue
                grads_acc = accumulate_grads(grads_acc, grads)
                del grads  # no handle on a pruned-away shape past an event
                all_sample_size += 1  # the melhubert expert returns (loss, 1)
                # the loss stays on the device until a log line reads it (and,
                # in weight pruning, once per window for the EMA)
                batch_loss = batch_loss + loss
                backward_steps += 1
                if backward_steps % accum > 0:
                    continue

                # the window's gradients and loss over the data group
                grads_acc, (batch_loss,) = self._reduce_window(grads_acc,
                                                               [batch_loss])
                window_loss = window_loss + batch_loss
                window_count += all_sample_size
                if self.mode == "weight-pruning":
                    self.wp_state.update_smooth_loss(
                        float(batch_loss) / all_sample_size)
                    self.wp_state.update_target_smooth_loss(
                        global_step, self.prune_steps)
                batch_loss = 0.0
                grad_norm = self.apply(grads_acc, float(all_sample_size))
                grads_acc = None

                last = pbar["n"] == pbar["total"] - 1
                if global_step % log_step == 0 or last:
                    norm_loss = float(window_loss) / max(window_count, 1)
                    self.logger.scalar(f"{prefix}loss", norm_loss,
                                       global_step)
                    self.logger.scalar(f"{prefix}gradient norm",
                                       float(grad_norm), global_step)
                    lr_now = self._applied_lr()
                    if lr_now is not None:
                        self.logger.scalar(f"{prefix}lr", lr_now, global_step)
                    steps_per_sec = global_step / (time.time() - t_start)
                    lr_text = "" if lr_now is None else f" lr={lr_now:.3e}"
                    if self.primary:
                        print(f"[Runner] step {global_step}/{pbar['total']} "
                              f"loss={norm_loss:.4f} "
                              f"gnorm={float(grad_norm):.3f}{lr_text} "
                              f"({steps_per_sec:.2f} steps/s)", flush=True)
                    self.log_history.append({"step": global_step,
                                             "loss": norm_loss,
                                             "grad_norm": float(grad_norm)})
                    window_loss = 0.0
                    window_count = 0
                all_sample_size = 0

                if last and self.mode in ("head-pruning", "row-pruning"):
                    self.save(global_step, self._states_prune_name())
                elif last:
                    self.save(global_step, "last-step.npz",
                              total_step=(pbar["total"]
                                          if self.mode == "weight-pruning"
                                          else None))
                pbar["n"] += 1
            batches.close()
        self.logger.close()  # flush buffered scalars before returning
        print(f"[Runner] - Done: {pbar['total']} steps")
