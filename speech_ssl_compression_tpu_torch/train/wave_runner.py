"""The pre-training runner of the waveform models, HuBERT mode.

Port of ``speech_ssl_compression_tpu/train/wave_runner.py::WaveRunner``
for ``-u hubert`` pre-training in one process: the task config and its
label-rate checks, the label dictionaries and lookups, a seeded fresh
init, the collate step that aligns labels to conv frames on the host, the
grad step (on bf16 copies of the f32 masters on a GPU when the runner YAML
says ``bf16``, as the port's MelHuBERT runner decides; JAX's WaveRunner
takes bf16 only on a TPU), the accumulation window divided by the masked
frame count, the fused clip + Adam apply with its non-finite skip, log
lines, and ``states-epoch-*.npz`` / ``last-step.npz`` checkpoints in the
JAX package's format.

Not ported (each raises ``NotImplementedError``; ROADMAP.md Queue 1 item
12): wav2vec 2.0, the weight-, head- and row-pruning modes on HuBERT,
``-i`` (init from a checkpoint, resume), multi-process data parallelism,
meshes, dropping an accumulation window on out-of-memory and TensorBoard
logging.
"""

from __future__ import annotations

import os
import time

import torch

from ..configs import HuBERTConfig
from ..data.bucket_dataset import PrefetchIterator
from ..data.dictionary import Dictionary, build_label_lookup
from ..data.hubert_dataset import HubertWaveDataset
from ..data.task_config import HubertTaskConfig
from ..extract import resolve_device
from ..models.conv_frontend import conv_output_length
from ..models.hubert import encode_aligned_targets_np, feat2tar_ratio
from ..utils.checkpoint import save_checkpoint, tree_leaves
from ..utils.weights import (
    hubert_tree_from_named,
    init_hubert_params_np,
    load_hubert_model,
)
from .steps import (
    accumulate_grads,
    applied_lr,
    fused_apply,
    init_opt_state,
    make_hubert_grad_step,
    make_optimizer_from_config,
)

_UNPORTED_ARGS = ("model_parallel", "pipeline_parallel", "multi_host")


class WaveRunner:
    """``WaveRunner(args, runner_config, upstream_config).train()``, as the
    JAX runner, for ``args.upstream == "hubert"`` pre-training
    (``args.mode == "melhubert"``, the mode ``train.py`` passes for
    pre-training). ``args.device`` names the torch device
    (``cuda`` when absent: the CPU only when asked for)."""

    def __init__(self, args, runner_config: dict, upstream_config: dict):
        if args.upstream != "hubert":
            raise NotImplementedError(
                f"upstream {args.upstream!r} is not ported yet (hubert only)")
        if args.mode != "melhubert":
            raise NotImplementedError(
                f"mode {args.mode!r} on hubert is not ported yet "
                "(pre-training only)")
        if getattr(args, "initial_weight", None):
            raise NotImplementedError(
                "initial_weight (resume, init from a checkpoint) is not "
                "ported yet")
        for name in _UNPORTED_ARGS:
            if getattr(args, name, None) not in (None, False, 1):
                raise NotImplementedError(f"--{name} is not ported")
        self.args = args
        self.runner_config = runner_config
        self.upstream_config = upstream_config
        self.upstream = args.upstream
        self.mode = args.mode
        self.device = resolve_device(getattr(args, "device", "cuda"))
        self.expdir = args.expdir
        os.makedirs(self.expdir, exist_ok=True)

        seed = int(getattr(args, "seed", 1337))
        self.rng = torch.Generator().manual_seed(seed)
        runner = runner_config.get("runner", {})
        self.compute_dtype = (
            torch.bfloat16
            if runner.get("bf16", True) and self.device.type == "cuda"
            else torch.float32
        )

        self.task_cfg = HubertTaskConfig.from_dict(
            runner_config.get("task", {}))
        self.cfg = HuBERTConfig.from_dict(upstream_config["hubert"])
        if self.task_cfg.label_rate < 0:
            # sequence labels cannot be frame-aligned to cropped audio
            raise NotImplementedError(
                "task.label_rate = -1 (sequence labels) is not valid for "
                "HuBERT pre-training; set the frame label rate (e.g. 50)")
        if (self.task_cfg.label_rate > 0
                and float(self.task_cfg.label_rate) != float(self.cfg.label_rate)):
            raise ValueError(
                f"task.label_rate ({self.task_cfg.label_rate}) != model "
                f"label_rate ({self.cfg.label_rate})")
        self.dictionaries = self._load_dictionaries()
        self.num_classes = tuple(len(d) for d in self.dictionaries)

        self.model = load_hubert_model(
            init_hubert_params_np(self.cfg, self.num_classes, seed), self.cfg)
        self.model.to(self.device)
        self.params = dict(self.model.named_parameters())
        n = sum(p.numel() for p in self.params.values())
        print(f"[WaveRunner] - {self.upstream}: {n} parameters")

        self.optimizer = make_optimizer_from_config(runner_config)
        self.opt_state = init_opt_state(list(self.params.values()))
        self.accum_steps = int(runner.get("gradient_accumulate_steps", 1))
        self.grad_step = make_hubert_grad_step(
            self.model, accum_steps=self.accum_steps,
            compute_dtype=self.compute_dtype)
        # {"step", "loss", "grad_norm"} of every log line
        self.log_history: list = []

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

    def _finalize_schedule_total(self, total_steps: int):
        """Epoch-driven runs learn their length only in train(): a schedule
        built without a total is rebuilt with it."""
        sched = self.optimizer.get("schedule")
        if sched is None or not getattr(sched, "needs_total", False):
            return
        self.optimizer = make_optimizer_from_config(
            self.runner_config, total_steps=int(total_steps))

    def apply(self, grads, sample_size):
        """The fused apply on the parameters and Adam state, in place;
        returns the grad norm (a device tensor)."""
        return fused_apply(self.optimizer, list(self.params.values()),
                           self.opt_state, grads, sample_size)

    def _get_dataset(self) -> HubertWaveDataset:
        task = self.task_cfg
        datarc = self.runner_config.get("pretrain_expert", {}).get(
            "datarc", self.runner_config.get("datarc", {}))
        label_dir = task.label_dir or task.data
        return HubertWaveDataset(
            manifest_path=f"{task.data}/train.tsv",
            sample_rate=task.sample_rate,
            label_paths=[f"{label_dir}/train.{l}" for l in self._label_sets()],
            label_rates=task.label_rate,
            batch_size=int(datarc.get("train_batch_size", 4)),
            max_keep_sample_size=task.max_keep_size,
            min_keep_sample_size=task.min_sample_size,
            max_sample_size=task.max_sample_size,
            pad_audio=task.pad_audio,
            normalize=task.normalize,
            random_crop=task.random_crop,
            single_target=task.single_target,
            seed=getattr(self.args, "seed", 1337),
        )

    def _collate(self, batch: dict) -> dict:
        """Labels aligned to conv frames and encoded through the
        dictionaries on the host (JAX ``_collate_device_batch``), then the
        source, targets and target-valid mask moved to the device; the
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
        """A checkpoint in the JAX package's format: params and the Adam
        state's leaves [count, *mu, *nu] in JAX's leaf order and layout."""
        meta = {
            "Step": global_step,
            "Args": dict(vars(self.args)),
            "Runner": self.runner_config,
            "Upstream_Config": self.upstream_config,
            "Config": self.cfg.to_dict(),
        }
        names = list(self.params)
        n = len(names)
        count, mu, nu = (self.opt_state[0], self.opt_state[1:1 + n],
                         self.opt_state[1 + n:])
        opt_leaves = [count.cpu().numpy()]
        for moments in (mu, nu):
            opt_leaves += tree_leaves(hubert_tree_from_named(
                dict(zip(names, moments))))
        path = os.path.join(self.expdir, name)
        save_checkpoint(path, hubert_tree_from_named(self.params),
                        opt_state=opt_leaves, meta=meta)
        print(f"[WaveRunner] - Saved checkpoint to {name}")

    def train(self):
        runner = self.runner_config["runner"]
        dataset = self._get_dataset()
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

        step = backward = 0
        grads_acc = None
        sample_total = 0
        accum_loss = 0.0
        window_loss, window_n = 0.0, 0
        t0 = time.time()
        while step < total_steps:
            batches = PrefetchIterator(dataset.epoch(shuffle=True))
            for batch in batches:
                if step >= total_steps:
                    break
                if backward % accum == 0 and step > 0 and step % save_cadence == 0:
                    self.save(step, f"states-epoch-{step // step_per_epoch}.npz")
                loss, sample_size, grads, _ = self.grad_step(
                    self.params, self._collate(batch), self.rng)
                grads_acc = accumulate_grads(grads_acc, grads)
                # device-side sums: no host sync per micro-batch
                sample_total = sample_total + sample_size
                accum_loss = accum_loss + loss
                backward += 1
                if backward % accum:
                    continue

                window_loss = window_loss + accum_loss
                window_n += accum
                st = torch.clamp_min(torch.as_tensor(
                    sample_total, device=self.device).float(), 1.0)
                grad_norm = self.apply(grads_acc, st)
                grads_acc = None
                sample_total = 0
                accum_loss = 0.0
                step += 1

                if step % log_step == 0 or step == total_steps:
                    norm_loss = float(window_loss) / max(window_n, 1)
                    lr_now = applied_lr(self.optimizer, self.opt_state)
                    lr_text = "" if lr_now is None else f" lr={lr_now:.3e}"
                    print(f"[WaveRunner] step {step}/{total_steps} "
                          f"loss={norm_loss:.4f} gnorm={float(grad_norm):.3f}"
                          f"{lr_text} ({step / (time.time() - t0):.2f} steps/s)",
                          flush=True)
                    self.log_history.append({"step": step, "loss": norm_loss,
                                             "grad_norm": float(grad_norm)})
                    window_loss, window_n = 0.0, 0
            batches.close()
        self.save(step, "last-step.npz")
        print(f"[WaveRunner] - Done: {step} steps")
