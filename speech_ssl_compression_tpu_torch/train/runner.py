"""The pre-training runner (``melhubert`` mode).

Port of the ``melhubert`` mode of
``speech_ssl_compression_tpu/train/runner.py::Runner``: a seeded
full-width model, the bucketed CSV batches, the gradient-accumulation
window, the fused apply step with its non-finite skip, log lines with
loss, grad norm and steps/s, and ``states-epoch-*.npz`` /
``last-step.npz`` checkpoints in the JAX package's format (its
``load_checkpoint`` and ``restore_opt_state`` read them).

Not ported (each raises ``NotImplementedError``; ROADMAP.md Queue 1 item
5): the pruning and distillation modes, resuming from ``initial_weight``,
dropping an accumulation window on out-of-memory, TensorBoard logging,
meshes, pipeline parallelism and remat.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ..configs import MelHuBERTConfig
from ..data.bucket_dataset import MelFeatBuckets, PrefetchIterator
from ..extract import resolve_device
from ..utils.checkpoint import save_checkpoint, tree_leaves
from ..utils.weights import init_params_np, jax_tree_from_named, load_model
from .steps import (
    accumulate_grads,
    applied_lr,
    fused_apply,
    init_opt_state,
    make_melhubert_grad_step,
    make_optimizer_from_config,
)

_UNPORTED_ARGS = ("model_parallel", "pipeline_parallel", "multi_host")


class Runner:
    """``Runner(args, runner_config, upstream_config).train()``, as the JAX
    runner, for ``args.mode == "melhubert"``. ``args.device`` names the
    torch device."""

    def __init__(self, args, runner_config: dict, upstream_config: dict):
        if args.mode != "melhubert":
            raise NotImplementedError(
                f"mode {args.mode!r} is not ported yet (melhubert only)")
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
        self.mode = args.mode
        self.device = resolve_device(getattr(args, "device", "cpu"))
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

        self.cfg = MelHuBERTConfig.from_dict(
            dict(upstream_config["melhubert"]))
        self.model = load_model(init_params_np(self.cfg, seed), self.cfg)
        self.model.to(self.device)
        self.params = dict(self.model.named_parameters())
        n = sum(p.numel() for p in self.params.values())
        print(f"[Runner] - Number of parameters: {n}")

        # frame-period sanity (reference runner.py:48-52)
        fp = getattr(args, "frame_period", 20)
        expect = {20: 80, 10: 40}[fp]
        assert self.cfg.feat_emb_dim == expect, (
            f"feat_emb_dim should be {expect} at frame period {fp}")

        self.optimizer = make_optimizer_from_config(runner_config)
        self.opt_state = init_opt_state(list(self.params.values()))
        self.accum_steps = int(runner.get("gradient_accumulate_steps", 1))
        self.grad_step = make_melhubert_grad_step(
            self.model, accum_steps=self.accum_steps,
            compute_dtype=self.compute_dtype)
        # {"step", "loss", "grad_norm"} of every log line
        self.log_history: list = []

    def _finalize_schedule_total(self, total_steps: int):
        """Epoch-driven runs learn their length only in train(): a schedule
        built without a total is rebuilt with it (JAX
        ``OptimizerScheduleMixin._finalize_schedule_total``)."""
        sched = self.optimizer.get("schedule")
        if sched is None or not getattr(sched, "needs_total", False):
            return
        self.optimizer = make_optimizer_from_config(
            self.runner_config, total_steps=int(total_steps))

    def apply(self, grads, sample_size: float):
        """The fused apply on the parameters and Adam state, in place;
        returns the grad norm (a device tensor)."""
        return fused_apply(self.optimizer, list(self.params.values()),
                           self.opt_state, grads, sample_size)

    def _applied_lr(self) -> Optional[float]:
        return applied_lr(self.optimizer, self.opt_state)

    def _get_dataloader(self) -> MelFeatBuckets:
        datarc = self.runner_config["datarc"]
        task = self.upstream_config.get("task") or {"sequence_length": 0}
        return MelFeatBuckets(
            frame_period=getattr(self.args, "frame_period", 20),
            sequence_length=task.get("sequence_length", 0),
            bucket_size=int(datarc["train_batch_size"]),
            sets=datarc["sets"],
            max_timestep=int(datarc.get("max_timestep", 0)),
            seed=getattr(self.args, "seed", 1337),
        )

    def _device_batch(self, batch: dict) -> dict:
        """Device tensors for feat, label and pad_mask; ``length`` stays a
        host array (the span mask is drawn on the host)."""
        out = {k: torch.from_numpy(batch[k]).to(self.device)
               for k in ("feat", "label", "pad_mask")}
        out["label"] = out["label"].long()
        out["length"] = batch["length"]
        return out

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
            opt_leaves += tree_leaves(jax_tree_from_named(dict(zip(names,
                                                                   moments))))
        path = os.path.join(self.expdir, name)
        save_checkpoint(path, jax_tree_from_named(self.params),
                        opt_state=opt_leaves, meta=meta)
        print(f"[Runner] - Saved checkpoint to {path}")

    def train(self):
        runner = self.runner_config["runner"]
        dataset = self._get_dataloader()
        accum = self.accum_steps
        print("[Runner] - Accumulated batch size:",
              int(self.runner_config["datarc"]["train_batch_size"]) * accum)

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
        grads_acc = None
        t_start = time.time()

        while pbar["n"] < pbar["total"]:
            batches = PrefetchIterator(dataset.epoch(shuffle=True))
            for batch in batches:
                if pbar["n"] >= pbar["total"]:
                    break
                if backward_steps % accum == 0:
                    cadence = max(1, int(save_every_x_epochs * step_per_epoch))
                    if global_step % cadence == 0:
                        self.save(global_step, f"states-epoch-"
                                  f"{global_step // step_per_epoch}.npz")

                global_step = pbar["n"] + 1
                loss, grads, _ = self.grad_step(
                    self.params, self._device_batch(batch), self.rng)
                grads_acc = accumulate_grads(grads_acc, grads)
                all_sample_size += 1  # the melhubert expert returns (loss, 1)
                # the loss stays on the device until a log line reads it
                batch_loss = batch_loss + loss
                backward_steps += 1
                if backward_steps % accum > 0:
                    continue

                window_loss = window_loss + batch_loss
                window_count += all_sample_size
                batch_loss = 0.0
                grad_norm = self.apply(grads_acc, float(all_sample_size))
                grads_acc = None

                if global_step % log_step == 0 or pbar["n"] == pbar["total"] - 1:
                    norm_loss = float(window_loss) / max(window_count, 1)
                    steps_per_sec = global_step / (time.time() - t_start)
                    lr_now = self._applied_lr()
                    lr_text = "" if lr_now is None else f" lr={lr_now:.3e}"
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

                if pbar["n"] == pbar["total"] - 1:
                    self.save(global_step, "last-step.npz")
                pbar["n"] += 1
            batches.close()
        print(f"[Runner] - Done: {pbar['total']} steps")
