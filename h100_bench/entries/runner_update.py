"""Entry: one optimizer update of MelHuBERT pre-training, as
``train/runner.py::Runner.train`` runs it.

The Runner of the port is built from the configuration's model and runner
YAMLs (with the mix's ``runner`` settings over the runner YAML's: the
micro-batch and the accumulation) in the mode ``melhubert`` (bf16
compute on f32 masters, dropout on, span masks drawn on the host), and
its masters are overwritten with the seeded weights. An update is the train loop's body: ``grad_step`` on each
of ``gradient_accumulate_steps`` host micro-batches through
``_device_batch``, ``accumulate_grads``, ``_reduce_window`` and ``apply``;
the harness fences it to time it.

Set-up drives this one Runner through its first ``follow_steps`` updates
and keeps what the check compares: each update's loss, the first update's
gradient as Adam took it (its first moment over 1 - beta1, copied to the
host), and each leaf's change over those updates. Then it warms the micro-batch
shapes those updates did not use, and the window goes on with the same
Runner. The check lets the reference follow the same updates from the
same weights, micro-batches and seeds.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from h100_bench import flops, harness, traffic, weights
from h100_bench.reference import melhubert as ref_model
from h100_bench.reference import train as ref
from h100_bench.reference.numerics import Numerics
from h100_bench.trace import span


def program_yamls(config: dict) -> tuple:
    """(model YAML, runner YAML) as dicts."""
    from speech_ssl_compression_tpu_torch.configs import read_yaml

    prog = config["program"]
    if "inline" in prog:
        model = {"melhubert": dict(prog["inline"]),
                 "task": {"sequence_length": 750}}
    else:
        model = read_yaml(harness.ROOT / prog["yaml"])
    return model, read_yaml(harness.ROOT / prog["runner_yaml"])


def micro_batches(mix: dict, config: dict, seed: int, device) -> list:
    """The pool of host micro-batches: ``batch`` crops a micro-batch,
    their lengths the mix's grid at 20 ms frames cut at ``crop_frames``,
    padded to a multiple of ``pad_multiple`` (as ``_stack_buckets``
    pads), normal features and uniform cluster labels drawn on the device
    from the seed, label -100 and pad_mask 0 past each crop."""
    b = int(mix["batch"])
    rate = 1000 // config["frame_period_ms"]
    crops = [np.minimum(np.round(np.asarray(s) * rate).astype(np.int64),
                        mix["crop_frames"]) for s in traffic.pool(mix)]
    pads = [-(-int(c.max()) // mix["pad_multiple"]) * mix["pad_multiple"]
            for c in crops]
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.derive(seed, "features"))
    d_in = config["feat_emb_dim"]
    total = sum(b * t for t in pads)
    feat = torch.randn(total * d_in, generator=gen, device=device).cpu()
    label = torch.randint(0, config["num_cluster"], (total,), generator=gen,
                          device=device).cpu()
    out, at = [], 0
    for lens, t in zip(crops, pads):
        valid = np.arange(t)[None, :] < lens[:, None]
        f = feat[at * d_in:(at + b * t) * d_in].numpy().reshape(b, t, d_in)
        lab = label[at:at + b * t].numpy().reshape(b, t)
        at += b * t
        out.append({"feat": np.where(valid[..., None], f, 0.0).astype(
                        np.float32),
                    "label": np.where(valid, lab, -100).astype(np.int64),
                    "pad_mask": valid.astype(np.float32),
                    "length": lens.copy()})
    return out


def runner_hyper(runner_cfg: dict) -> dict:
    """The optimizer's settings as the runner YAML states them."""
    opt = runner_cfg["optimizer"]
    return {"lr": float(opt["lr"]), "b1": float(opt["betas"][0]),
            "b2": float(opt["betas"][1]), "eps": float(opt["eps"]),
            "clip": float(runner_cfg["runner"]["gradient_clipping"]),
            "accum": int(runner_cfg["runner"]["gradient_accumulate_steps"])}


class Cell:
    kind = "train"

    def __init__(self, config, mix, seed, device, workdir):
        from speech_ssl_compression_tpu_torch.train.runner import Runner

        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        model_yaml, runner_cfg = program_yamls(config)
        for key, value in mix.get("runner", {}).items():
            section = "datarc" if key == "train_batch_size" else "runner"
            runner_cfg[section][key] = value
        self.hyper = runner_hyper(runner_cfg)
        if runner_cfg["optimizer"].get("weight_decay", 0) or runner_cfg.get(
                "lr_scheduler"):
            raise ValueError("the reference's Adam has no weight decay and "
                             "no lr schedule")
        self.runner_seed = traffic.derive(seed, "runner")
        args = types.SimpleNamespace(
            mode="melhubert", expdir=str(workdir / "exp"),
            seed=self.runner_seed, device=str(self.device),
            frame_period=config["frame_period_ms"], initial_weight=None)
        self.runner = Runner(args, runner_cfg, model_yaml)
        harness.check_program_config(config, self.runner.cfg)
        self.specs = ref_model.specs(config)
        with torch.no_grad():
            for k, v in weights.make(self.specs, seed, self.device).items():
                self.runner.params[k].copy_(v)
        self.accum = self.runner.accum_steps
        self.pool = micro_batches(mix, config, seed, self.device)
        self.schedule = traffic.Schedule(len(self.pool), 1, seed,
                                           mix["pass_order"])
        self.taken = []  # pool indices, in the order the updates took them

    def _next(self) -> dict:
        idx, _ = self.schedule.next()
        self.taken.append(idx)
        return self.pool[idx]

    def _fence(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _update(self) -> tuple:
        """One update; returns (its loss, its crops' lengths per
        micro-batch)."""
        from speech_ssl_compression_tpu_torch.train.steps import (
            accumulate_grads,
        )

        r = self.runner
        grads_acc, batch_loss, segments = None, 0.0, []
        for _ in range(self.accum):
            batch = self._next()
            with span("bench.grad_step"):
                loss, grads, _ = r.grad_step(r.params, r._device_batch(batch),
                                             r.rng, masks=r.masks)
            with span("bench.accumulate"):
                grads_acc = accumulate_grads(grads_acc, grads)
            del grads
            batch_loss = batch_loss + loss
            segments.append([int(t) for t in batch["length"]])
        with span("bench.reduce_window"):
            grads_acc, (batch_loss,) = r._reduce_window(grads_acc,
                                                        [batch_loss])
        with span("bench.apply"):
            r.apply(grads_acc, float(self.accum))
        with span("bench.fence"):
            self._fence()
        return batch_loss, segments

    def _norms(self, tensors) -> dict:
        return {k: float(torch.linalg.vector_norm(t.float()))
                for k, t in zip(self.runner.params, tensors)}

    def warm(self):
        """The first ``follow_steps`` updates, with what the check compares
        taken on the way; then one grad step on each micro-batch shape
        they did not use (its gradients dropped)."""
        r = self.runner
        steps = int(self.mix["check"]["follow_steps"])
        n = len(r.params)
        self.prog = {"losses": []}
        for step in range(steps):
            loss, _ = self._update()
            self.prog["losses"].append(float(loss))
            if step == 0:
                scale = 1.0 / (1.0 - self.hyper["b1"])
                self.prog["first_grad_full"] = {
                    k: (m * scale).to("cpu") for k, m in
                    zip(r.params, r.opt_state[1:1 + n])}
                self.prog["first_grad"] = self._norms(
                    self.prog["first_grad_full"].values())
        p0 = weights.make(self.specs, self.seed, self.device)
        self.prog["change"] = self._norms(
            [r.params[k].detach() - p0[k] for k in r.params])
        del p0
        self.followed = list(self.taken)
        seen = {self.pool[i]["feat"].shape[1] for i in self.taken}
        for batch in self.pool:
            t = batch["feat"].shape[1]
            if t not in seen:
                seen.add(t)
                r.grad_step(r.params, r._device_batch(batch), r.rng,
                            masks=r.masks)
        self._fence()

    def window(self, seconds: float) -> dict:
        clock = time.perf_counter
        units, t0 = [], clock()
        while clock() - t0 < seconds:
            _, segments = self._update()
            units.append({
                "done_s": clock() - t0,
                "valid_frames": sum(map(sum, segments)),
                "flops": sum(flops.train_flops(flops.melhubert_fwd_flops(
                    self.config, t, final_proj=True))
                    for seg in segments for t in seg),
                "segments": segments})
        return {"units": units, "attempted": len(units), "failed": 0}

    def release(self):
        self.runner = None

    def _follow(self, num) -> dict:
        p0 = weights.make(self.specs, self.seed, self.device)
        return ref.follow(p0, [self.pool[i] for i in self.followed],
                          self.config, self.hyper, self.runner_seed,
                          self.device, num, len(self.prog["losses"]))

    def readings(self, prog=None) -> dict:
        """The numbers the check compares; ``prog`` replaces the port's
        readings (the controls)."""
        want = self._follow(Numerics("f32"))
        return ref.compare(prog or self.prog, want)

    def control(self, mode: str) -> dict:
        return self.readings(self._follow(Numerics(mode)))

    def check(self) -> list:
        limits = self.mix["check"]["limits"]
        got = self.readings()
        return [(k, got[k], limits[k]) for k in sorted(got)]
