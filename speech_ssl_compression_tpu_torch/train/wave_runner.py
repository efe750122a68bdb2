"""The runner of the waveform models, HuBERT and wav2vec 2.0: pre-training
and the weight-, head- and row-pruning modes.

Port of ``speech_ssl_compression_tpu/train/wave_runner.py::WaveRunner``
for ``-u hubert`` and ``-u wav2vec2`` in one process. HuBERT: the task
config and its label-rate checks, the label dictionaries and lookups, the
collate step that aligns labels to conv frames on the host. wav2vec 2.0:
its task config, the percentile-bucketed raw-audio dataset (block masks
per batch with ``task.precompute_mask_config``), one span-count draw per
batch for crop-collated batches (``mask_shared_rounding = not pad``, the
dataset's pad flag), and the Gumbel temperature annealed on the host at
every micro-step (``anneal_temp(latent_temp, step)``, on across prune
events). Both: a seeded fresh init, the grad step (on bf16 copies of the
f32 masters on a GPU when the runner YAML says ``bf16``, as the port's
MelHuBERT runner decides; JAX's WaveRunner takes bf16 only on a TPU), the
accumulation window divided by the masked frame count, the fused clip +
Adam apply with its non-finite skip, log lines and TensorBoard scalars, a
window dropped whole on a CUDA out-of-memory error (its prune event does
not fire twice), and checkpoints in the JAX package's format
(``states-epoch-*.npz`` in pre-training only, ``last-step.npz`` at the
end). ``-i`` starts from the JAX package's npz or a reference ``.ckpt``
(pruned widths from the shapes; weight-pruning masks kept and applied in
every grad step), and ``--init_optimizer_from_initial_weight`` restores
its Adam state.

The pruning modes (``train/prune_mixin.py``, shared with the MelHuBERT
runner, with JAX WaveRunner's choices where its two runners differ):
``-m weight-pruning`` writes ``before-pruning-{step}.npz`` before each
event (no ``TotalStep``), feeds the controller each window's loss per
masked frame, and a deferred event adds one period to the schedule and
the run; ``-m head-pruning`` (l1 only, by_layer or by_whole with
``num_heads_each_step``) and ``-m row-pruning`` write
``states_prune_{n}.npz`` before each event, slice, and rebuild the model,
a fresh Adam state and the grad step for the new widths; a weight-pruned
``-i`` has its masks folded first. ``Pruning`` and ``Pruned_heads`` go
into every checkpoint's meta.

Data and tensor parallel (``--multi_host``, ``--model_parallel``) as in
the MelHuBERT runner (``train/parallel_mixin.py``): each data rank on its
shard of the batches, its span and channel masks the rows of the global
batch's, the window's gradients, losses and masked-frame counts summed
over the data group; the encoder layers split over the model group; only
the primary writes; wav2vec 2.0's ``cross_sample_negatives`` are drawn
from the global batch on every data rank and the targets gathered over
the data group (``models/wav2vec2.py``). Pipeline parallelism raises
``NotImplementedError``: JAX's WaveRunner has none. ``-m distillation`` is
refused: JAX's WaveRunner has no teacher and trains plain pre-training
under that mode's name.
"""

from __future__ import annotations

import collections
import functools
import os
import time

import torch

from ..compress import head_pruning as hp
from ..configs import HuBERTConfig, Wav2Vec2Config
from ..data.bucket_dataset import PrefetchIterator
from ..data.dictionary import Dictionary, build_label_lookup
from ..data.hubert_dataset import HubertWaveDataset
from ..data.task_config import HubertTaskConfig, Wav2vec2TaskConfig
from ..data.wav2vec2_dataset import Wav2Vec2AudioDataset
from ..extract import resolve_device
from ..models.conv_frontend import conv_output_length
from ..models.gumbel_vq import anneal_temp
from ..models.hubert import encode_aligned_targets_np, feat2tar_ratio
from ..utils.checkpoint import save_checkpoint
from ..utils.profiling import span
from ..utils.tb import TBLogger
from ..utils.torch_convert import (
    load_wave_initial_weight,
    wave_params_to_state_dict,
)
from ..utils.weights import (
    init_hubert_params_np,
    init_wav2vec2_params_np,
    load_wave_model,
    masks_tree,
    named_masks,
    wave_model_from_named,
    wave_tree_from_named,
)
from .optim_mixin import OptimizerScheduleMixin
from .parallel_mixin import ParallelMixin
from .prune_mixin import PruneMixin
from .steps import (
    accumulate_grads,
    make_hubert_grad_step,
    make_wav2vec2_grad_step,
)

_PRUNING_MODES = ("weight-pruning", "head-pruning", "row-pruning")


class WaveRunner(ParallelMixin, OptimizerScheduleMixin, PruneMixin):
    """``WaveRunner(args, runner_config, upstream_config).train()``, as the
    JAX runner, for ``args.upstream`` "hubert" or "wav2vec2": pre-training
    (``args.mode == "melhubert"``, the mode ``train.py`` passes for it) or
    one of the pruning modes. ``args.device`` names the torch device
    (``cuda`` when absent: the CPU only when asked for)."""

    _log_tag = "[WaveRunner]"

    def __init__(self, args, runner_config: dict, upstream_config: dict):
        if args.upstream not in ("hubert", "wav2vec2"):
            raise NotImplementedError(f"upstream {args.upstream!r}")
        if args.mode == "distillation":
            raise NotImplementedError(
                f"mode 'distillation' on {args.upstream}: JAX's WaveRunner "
                "has no teacher and trains plain pre-training under this "
                "mode's name; the port refuses it (use -m melhubert for "
                "pre-training)")
        if args.mode not in ("melhubert",) + _PRUNING_MODES:
            raise NotImplementedError(
                f"mode {args.mode!r} on {args.upstream}")
        self.args = args
        self.runner_config = runner_config
        self.upstream_config = upstream_config
        self.upstream = args.upstream
        self.mode = args.mode
        self.device = resolve_device(getattr(args, "device", "cuda"))
        self._init_grid(args)
        self.expdir = args.expdir
        if self.primary:  # the other ranks never touch the expdir
            os.makedirs(self.expdir, exist_ok=True)
        self.logger = TBLogger(self.expdir if self.primary else None)

        seed = int(getattr(args, "seed", 1337))
        self.rng = torch.Generator().manual_seed(seed)
        runner = runner_config.get("runner", {})
        self.compute_dtype = (
            torch.bfloat16
            if runner.get("bf16", True) and self.device.type == "cuda"
            else torch.float32
        )

        self._bind_upstream(runner_config.get("task", {}))
        self._tree_from_named = lambda named: wave_tree_from_named(
            named, self.upstream)
        self._named_from_tree = lambda tree: wave_params_to_state_dict(
            tree, self.upstream)
        self._init_params(seed)
        n = sum(p.numel() for p in self.params.values())
        print(f"[WaveRunner] - {self.upstream}: {n} parameters")

        self._init_mode_schedules()
        self._init_optimizer_state()
        if getattr(args, "init_optimizer_from_initial_weight", False):
            if self._resumed_opt_leaves:
                self._restore_opt_state(self._resumed_opt_leaves)
                print("[WaveRunner] Loaded optimizer state from "
                      f"{args.initial_weight}")
                self._resync_schedule_offset()
            else:
                # a reference .ckpt or an npz without optimizer state: be
                # loud, not silent
                print("[WaveRunner] WARNING: --init_optimizer_from_initial_"
                      "weight requested but the checkpoint carries no "
                      "compatible optimizer state - starting with fresh "
                      "Adam moments")
        self._shard_state()
        self.accum_steps = int(runner.get("gradient_accumulate_steps", 1))
        self._build_grad_step()
        # {"step", "loss", "grad_norm"} of every log line; each prune
        # event's step and host seconds, and for a head or row event what
        # it chose and the device memory around it
        self.log_history: list = []
        self.prune_event_log: list = []
        # wav2vec 2.0: (step, the temperature the quantizer ran at) of the
        # last micro-steps
        self.temp_history = collections.deque(maxlen=1024)

    def _bind_upstream(self, task: dict):
        """Everything that differs between the two upstreams, decided in
        one place: the task config and the model config (HuBERT: the label
        rate checks and the dictionaries; wav2vec 2.0: the dataset's pad
        flag), the fresh init, the check of an ``-i`` tree, the grad step,
        the dataset, the collate and the per-micro-step arguments of the
        grad step."""
        if self.upstream == "hubert":
            self.task_cfg = HubertTaskConfig.from_dict(task)
            self.cfg = HuBERTConfig.from_dict(self.upstream_config["hubert"])
            if self.task_cfg.label_rate < 0:
                # sequence labels cannot be frame-aligned to cropped audio
                raise NotImplementedError(
                    "task.label_rate = -1 (sequence labels) is not valid for "
                    "HuBERT pre-training; set the frame label rate (e.g. 50)")
            if (self.task_cfg.label_rate > 0
                    and float(self.task_cfg.label_rate)
                    != float(self.cfg.label_rate)):
                raise ValueError(
                    f"task.label_rate ({self.task_cfg.label_rate}) != model "
                    f"label_rate ({self.cfg.label_rate})")
            self.dictionaries = self._load_dictionaries()
            self.num_classes = tuple(len(d) for d in self.dictionaries)
            self._fresh_params = lambda seed: init_hubert_params_np(
                self.cfg, self.num_classes, seed)
            self._check_initial = self._check_label_embs
            self._make_grad_step = make_hubert_grad_step
            self._get_dataset = self._hubert_dataset
            self._collate = self._hubert_collate
            self._step_args = lambda step: {}
        else:
            self.task_cfg = Wav2vec2TaskConfig.from_dict(task)
            self.cfg = Wav2Vec2Config.from_dict(
                self.upstream_config["wav2vec2"])
            # the dataset pads (rather than crops) its batches
            self.pad = (self.task_cfg.labels is not None
                        or self.task_cfg.enable_padding)
            self._fresh_params = lambda seed: init_wav2vec2_params_np(
                self.cfg, seed)
            self._check_initial = lambda params: None
            self._make_grad_step = functools.partial(
                make_wav2vec2_grad_step, mask_shared_rounding=not self.pad)
            self._get_dataset = self._wav2vec2_dataset
            self._collate = self._wav2vec2_collate
            # reference set_num_updates: annealed per update
            self._step_args = lambda step: {
                "gumbel_temp": anneal_temp(self.cfg.latent_temp, step)}

    def _build_grad_step(self):
        self.grad_step = self._make_grad_step(
            self.model, accum_steps=self.accum_steps,
            compute_dtype=self.compute_dtype)

    def _heads_each_step(self, pc: dict) -> int:
        """JAX WaveRunner's rule: l1 only; one head a layer by_layer,
        ``num_heads_each_step`` by_whole."""
        if pc.get("metric", "l1") != "l1":
            raise NotImplementedError(
                "data-driven head scoring is MelHuBERT-only (as in the "
                "reference, hp_utils.py:242 uses MelFeatDataset)")
        if pc.get("target", "by_layer") == "by_layer":
            return self.cfg.encoder_layers
        return pc["num_heads_each_step"]

    @staticmethod
    def _weight_prune_artifact(global_step: int, total: int):
        """``before-pruning-{step}.npz``, without ``TotalStep``."""
        return f"before-pruning-{global_step}.npz", {}

    def _select_heads(self) -> dict:
        """One event's heads: l1 scores on the JAX-layout host view, the
        selection appended to ``Pruned_heads`` in JAX's form. Returns
        {layer: [head, ...]}."""
        group = hp.select_heads_to_prune(
            self._l1_scores(), self.num_heads_each_step,
            self.runner_config["prune"].get("target", "by_layer"),
            self.cfg.encoder_layers)
        print(f"[Head Pruning] - These heads are pruned: {group}")
        self.pruned_heads.append({int(k): list(v) for k, v in group.items()})
        return group

    def _model_from_named(self, named, cfg):
        return wave_model_from_named(
            named, cfg, self.upstream,
            self.num_classes if self.upstream == "hubert" else None)

    def _check_label_embs(self, params: dict):
        n_embs = int(params["label_embs_concat"].shape[0])
        assert n_embs == int(sum(self.num_classes)), (
            f"checkpoint was trained with {n_embs} label embeddings "
            f"but the dictionaries define {sum(self.num_classes)}")

    def _init_params(self, seed: int):
        """The model: fresh from the seed, or from ``-i`` (JAX
        ``WaveRunner._init_params``: the architecture of a pruned start
        rebuilt from the checkpoint, its masks kept in ``self.masks``)."""
        self.masks = None
        self.pruned_heads: list = []
        self._resumed_meta = None
        self._resumed_opt_leaves = None
        self._resumed_opt_treedef = None
        init_w = getattr(self.args, "initial_weight", None)
        if init_w:
            (params, masks, self.cfg, self._resumed_meta,
             self._resumed_opt_leaves, self._resumed_opt_treedef) = (
                load_wave_initial_weight(init_w, self.upstream, self.cfg))
            self.pruned_heads = list(
                (self._resumed_meta or {}).get("Pruned_heads", []))
            self._check_initial(params)
            print(f"[WaveRunner] Initialized model from {init_w}")
        else:
            params, masks = self._fresh_params(seed), None
        self.model = load_wave_model(params, self.cfg,
                                     self.upstream).to(self.device)
        self.params = dict(self.model.named_parameters())
        if masks:
            self.masks = named_masks(masks, self.device)

    def _label_sets(self):
        """Fine-tuning tasks use only the first label set (reference
        runner.py:206-207), for the dictionaries and the label files
        alike."""
        labels = list(self.task_cfg.labels)
        return labels[:1] if self.task_cfg.fine_tuning else labels

    def _load_dictionaries(self):
        label_dir = self.task_cfg.label_dir or self.task_cfg.data
        dicts = [Dictionary.load(f"{label_dir}/dict.{label}.txt")
                 for label in self._label_sets()]
        self._label_lookups = [build_label_lookup(d) for d in dicts]
        return dicts

    def _batch_size(self) -> int:
        datarc = self.runner_config.get("pretrain_expert", {}).get(
            "datarc", self.runner_config.get("datarc", {}))
        return int(datarc.get("train_batch_size", 4))

    def _wav2vec2_dataset(self):
        task = self.task_cfg
        conv_layers = self.cfg.conv_feature_layers
        return Wav2Vec2AudioDataset(
            manifest_path=f"{task.data}/train.tsv",
            sample_rate=task.sample_rate,
            batch_size=self._batch_size(),
            max_sample_size=task.max_sample_size,
            min_sample_size=task.min_sample_size or 0,
            pad=self.pad,
            normalize=task.normalize,
            num_buckets=task.num_batch_buckets,
            crop_seq_to_multiple=self.cfg.crop_seq_to_multiple,
            seed=getattr(self.args, "seed", 1337),
            precompute_mask_config=task.precompute_mask_config,
            frames_fn=lambda n: conv_output_length(n, conv_layers),
            **self._data_shard(),
        )

    def _hubert_dataset(self):
        task = self.task_cfg
        label_dir = task.label_dir or task.data
        return HubertWaveDataset(
            manifest_path=f"{task.data}/train.tsv",
            sample_rate=task.sample_rate,
            label_paths=[f"{label_dir}/train.{l}" for l in self._label_sets()],
            label_rates=task.label_rate,
            batch_size=self._batch_size(),
            max_keep_sample_size=task.max_keep_size,
            min_keep_sample_size=task.min_sample_size,
            max_sample_size=task.max_sample_size,
            pad_audio=task.pad_audio,
            normalize=task.normalize,
            random_crop=task.random_crop,
            single_target=task.single_target,
            seed=getattr(self.args, "seed", 1337),
            **self._data_shard(),
        )

    def _wav2vec2_collate(self, batch: dict) -> dict:
        """The source and a precomputed block mask moved to the device; the
        lengths stay a host array (the span mask is drawn on the host)."""
        out = {"source": torch.from_numpy(batch["source"]).to(self.device),
               "length": batch["length"]}
        if "precomputed_mask" in batch:
            out["precomputed_mask"] = torch.from_numpy(
                batch["precomputed_mask"]).to(self.device)
        return out

    def _hubert_collate(self, batch: dict) -> dict:
        """Labels aligned to conv frames and encoded through the
        dictionaries on the host (JAX ``_collate_device_batch``), then the
        source, targets and target-valid mask moved to the device. The
        lengths stay a host array (the span mask is drawn on the host)."""
        t_frames = conv_output_length(batch["source"].shape[1],
                                      self.cfg.conv_feature_layers)
        ratio = feat2tar_ratio(self.cfg, self.task_cfg.sample_rate)
        target_list, target_valid = [], None
        for di, frm_labels in enumerate(batch["target_lists"]):
            arr, valid = encode_aligned_targets_np(
                frm_labels, t_frames, ratio, self._label_lookups[di],
                self.dictionaries[di].unk())
            target_valid = valid if target_valid is None else target_valid | valid
            target_list.append(torch.from_numpy(arr).long().to(self.device))
        return {
            "source": torch.from_numpy(batch["source"]).to(self.device),
            "length": batch["length"],
            "target_list": target_list,
            "target_valid": torch.from_numpy(target_valid).to(self.device),
        }

    def save(self, global_step: int, name: str):
        """A checkpoint in the JAX package's format: params, masks, the
        Adam state's leaves [count, *mu, *nu] in JAX's leaf order and
        layout, and the meta (``Pruning`` and ``Pruned_heads`` where they
        apply; JAX's WaveRunner writes no ``TotalStep``). On a grid every
        rank calls it and the primary writes."""
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
        if self.wp_state is not None:
            meta["Pruning"] = self.wp_state.to_meta()
        if self.pruned_heads:
            meta["Pruned_heads"] = self.pruned_heads
        path = os.path.join(self.expdir, name)
        save_checkpoint(
            path, self._tree_from_named(params),
            opt_state=self._opt_leaves(opt_state),
            masks=None if masks is None else masks_tree(masks),
            meta=meta, opt_treedef=self._opt_treedef)
        print(f"[WaveRunner] - Saved checkpoint to {name}")

    def train(self):
        runner = self.runner_config["runner"]
        dataset = self._get_dataset()
        if not len(dataset):
            # an epoch of no batches would loop forever (JAX's does)
            raise ValueError("the training set gives no batch (the task's "
                             "manifest and min/max sample sizes leave no "
                             "utterance)")
        total_steps = runner.get("total_steps", -1)
        if total_steps is None or total_steps <= 0:
            total_steps = int(runner.get("n_epochs", 1) * len(dataset)
                              / self.accum_steps)
        self._finalize_schedule_total(total_steps)
        log_step = runner.get("log_step", 200)
        accum = self.accum_steps
        step_per_epoch = max(1, len(dataset) // accum)
        save_cadence = max(1, int(runner.get("save_every_x_epochs", 10)
                                  * step_per_epoch))
        pretrain = self.mode not in _PRUNING_MODES
        # the run's length: a deferred weight-prune event adds a period
        pbar = {"total": total_steps}

        step = backward = 0
        # an OOM rewinds the window: its prune event must not fire twice
        last_prune_fired = -1
        grads_acc = None
        sample_total = 0
        accum_loss = 0.0
        window_loss, window_n = 0.0, 0
        t0 = time.time()
        while step < pbar["total"]:
            batches = PrefetchIterator(dataset.epoch(shuffle=True))
            for batch in batches:
                if step >= pbar["total"]:
                    break
                first_accu = backward % accum == 0
                if (pretrain and first_accu and step > 0
                        and step % save_cadence == 0):
                    self.save(step,
                              f"states-epoch-{step // step_per_epoch}.npz")
                if (not pretrain and first_accu and step in self.prune_steps
                        and step != last_prune_fired):
                    last_prune_fired = step
                    self._prune_hook(step, pbar)
                try:
                    with span("sslc.train.upload"):
                        dev_batch = self._collate(batch)
                    loss, sample_size, grads, logs = self.grad_step(
                        self.params, dev_batch, self.rng,
                        masks=self.masks, **self._step_args(step))
                except torch.cuda.OutOfMemoryError as err:
                    self._raise_if_grid(err)
                    # reference runner.py:379-386: drop the whole window and
                    # rewind its counters, so the surviving windows divide
                    # by the right sample count
                    print(f"[WaveRunner] - OOM at step {step}; "
                          "dropping accumulation window")
                    grads_acc = None
                    backward -= backward % accum
                    sample_total = 0
                    accum_loss = 0.0
                    continue
                if "temp" in logs:
                    self.temp_history.append((step, logs["temp"]))
                grads_acc = accumulate_grads(grads_acc, grads)
                del grads  # no handle on a pruned-away shape past an event
                # device-side sums: no host sync per micro-batch
                sample_total = sample_total + sample_size
                accum_loss = accum_loss + loss
                backward += 1
                if backward % accum:
                    continue

                # the window's gradients, loss and masked frames over the
                # data group
                grads_acc, (accum_loss, sample_total) = self._reduce_window(
                    grads_acc, [accum_loss, sample_total])
                window_loss = window_loss + accum_loss
                window_n += accum
                st = torch.clamp_min(torch.as_tensor(
                    sample_total, device=self.device).float(), 1.0)
                if self.wp_state is not None:
                    # the controller's one host float a window: the
                    # window's loss per masked frame (JAX :682-694)
                    self.wp_state.update_smooth_loss(
                        float(accum_loss) / float(st))
                    self.wp_state.update_target_smooth_loss(
                        step, self.prune_steps)
                grad_norm = self.apply(grads_acc, st)
                grads_acc = None
                sample_total = 0
                accum_loss = 0.0
                step += 1

                if step % log_step == 0 or step == pbar["total"]:
                    norm_loss = float(window_loss) / max(window_n, 1)
                    lr_now = self._applied_lr()
                    prefix = f"{self.mode}/train-"
                    self.logger.scalar(f"{prefix}loss", norm_loss, step)
                    self.logger.scalar(f"{prefix}gradient norm",
                                       float(grad_norm), step)
                    if lr_now is not None:
                        self.logger.scalar(f"{prefix}lr", lr_now, step)
                    lr_text = "" if lr_now is None else f" lr={lr_now:.3e}"
                    rate = step / (time.time() - t0)
                    if self.primary:
                        print(f"[WaveRunner] step {step}/{pbar['total']} "
                              f"loss={norm_loss:.4f} "
                              f"gnorm={float(grad_norm):.3f}{lr_text} "
                              f"({rate:.2f} steps/s)", flush=True)
                    self.log_history.append({"step": step, "loss": norm_loss,
                                             "grad_norm": float(grad_norm)})
                    window_loss, window_n = 0.0, 0
            batches.close()
        self.save(step, "last-step.npz")
        self.logger.close()  # flush buffered scalars before returning
        print(f"[WaveRunner] - Done: {step} steps")
