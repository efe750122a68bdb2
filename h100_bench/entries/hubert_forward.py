"""Entry: HuBERT feature extraction from waveforms.

``models/hubert.py::hubert_forward(model, source, lengths, mask=False,
features_only=True)`` of the port under ``matmul_precision`` of the mix,
on a model the harness builds from the seeded weights, with the
configuration's ``conv_frontend_impl`` (the published default). A closed
loop, one batch at a time: the feed uploads the next batch, padded to its
longest utterance, the entry runs it, and the consumer fences it; a
batch's latency runs from the feed's hand-over to the fence.

The check recomputes each sampled utterance in the reference: its row as
the batch padded it through the conv frontend, then its valid frames
through the feature norm, the projection and the encoder, compared with
the port's ``x`` on the valid frames.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100_bench import flops, harness, traffic, weights
from h100_bench.reference import hubert as ref
from h100_bench.reference.numerics import Numerics
from h100_bench.trace import span

class Cell:
    kind = "serve"

    def __init__(self, config, mix, seed, device, workdir):
        from speech_ssl_compression_tpu_torch.configs import HuBERTConfig
        from speech_ssl_compression_tpu_torch.utils.weights import (
            wave_model_from_named,
        )

        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.dtype = harness.torch_dtype(mix["dtype"])
        pcfg = HuBERTConfig.from_dict(harness.program_section(config))
        harness.check_program_config(config, pcfg)
        self.specs = ref.specs(config, config["num_classes"])
        named = weights.make(self.specs, seed, self.device)
        self.model = wave_model_from_named(
            named, pcfg, "hubert", num_classes=(config["num_classes"],))
        self.model.to(self.dtype).eval().requires_grad_(False)

        self.pool = traffic.pool(mix)
        wavs = traffic.waveforms(np.concatenate(self.pool), seed,
                                 mix["audio"], self.device)
        b = int(mix["batch"])
        self.batches = []  # (pinned padded source, valid samples per row)
        for i in range(len(self.pool)):
            rows = wavs[i * b:(i + 1) * b]
            n = np.array([w.shape[0] for w in rows])
            src = np.zeros((b, n.max()), np.float32)
            for r, w in enumerate(rows):
                src[r, :n[r]] = w
            self.batches.append((torch.from_numpy(src).pin_memory()
                                 if self.device.type == "cuda"
                                 else torch.from_numpy(src), n))
        self.schedule = traffic.Schedule(len(self.pool), b, seed,
                                           mix["pass_order"])
        self._plan_check()

    def _plan_check(self):
        """As ``melhubert_stream``: the pool's longest utterance at its
        first turn and ``samples`` more among the first pass's (window
        batch number, row), into buffers made now."""
        lengths = [int(n) for _, ns in self.batches for n in ns]
        self.longest, self.turn_picks = traffic.check_picks(
            lengths, int(self.mix["batch"]), self.mix["check"]["samples"],
            self.seed)
        t_max = flops.conv_output_length(self.config["conv_feature_layers"],
                                         max(lengths))
        self.buffers = [torch.zeros((t_max, self.config["encoder_embed_dim"]),
                                    dtype=self.dtype, device=self.device)
                        for _ in range(len(self.turn_picks) + 1)]
        self.kept = []  # (buffer, pool index, row, frames)

    def _forward(self, idx):
        from speech_ssl_compression_tpu_torch.models.hubert import (
            hubert_forward,
        )
        from speech_ssl_compression_tpu_torch.utils.device import (
            matmul_precision,
        )

        src, n = self.batches[idx]
        src = src.to(self.device, non_blocking=True).to(self.dtype)
        with matmul_precision(self.mix["matmul_precision"]), \
                torch.inference_mode():
            return hubert_forward(self.model, src, n, mask=False,
                                  features_only=True)

    def _fence(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        for idx in range(len(self.batches)):
            self._forward(idx)
            self._fence()

    def window(self, seconds: float) -> dict:
        clock = time.perf_counter
        units, t0 = [], clock()
        self.longest_kept = False
        while clock() - t0 < seconds:
            t_hand = clock() - t0
            idx, _ = self.schedule.next()
            with span("bench.forward"):
                out = self._forward(idx)
            with span("bench.fence"):
                self._fence()
            done = clock() - t0
            self._keep(out, len(units), idx)
            n = self.batches[idx][1]
            valid = out["frame_lengths"]
            units.append({
                "done_s": done, "latency_s": done - t_hand,
                "valid_frames": int(valid.sum()),
                "computed_frames": int(out["x"].shape[0] * out["x"].shape[1]),
                "flops": sum(flops.hubert_fwd_flops(self.config, int(k))
                             for k in n),
                "segments": [int(t) for t in valid]})
            del out
        return {"units": units, "attempted": len(units), "failed": 0}

    def _keep(self, out, n, idx):
        rows = {row for m, row in self.turn_picks if m == n}
        if idx == self.longest[0] and not self.longest_kept:
            rows.add(self.longest[1])
            self.longest_kept = True
        for row in sorted(rows):
            t = int(out["frame_lengths"][row])
            buf = self.buffers[len(self.kept)]
            buf[:t].copy_(out["x"][row, :t])
            self.kept.append((buf, idx, row, t))

    def release(self):
        self.model = None

    def _reference(self, idx, row, num):
        src, n = self.batches[idx]
        with num.context(), torch.no_grad():
            return ref.serve(src[row].to(self.device), int(n[row]),
                             self.params, self.config, num)

    def readings(self, got_fn=None) -> dict:
        """The largest relative L2 distance over the kept utterances of the
        encoder's output from the reference's; ``got_fn(idx, row)``
        replaces the port's output (the controls)."""
        self.params = weights.make(self.specs, self.seed, self.device)
        worst = 0.0
        for buf, idx, row, t in self.kept:
            want = self._reference(idx, row, Numerics("f32"))
            if want.shape[0] != t:
                raise AssertionError(f"{want.shape[0]} frames, {t} served")
            got = buf[:t] if got_fn is None else got_fn(idx, row)
            worst = max(worst, float(torch.linalg.vector_norm(
                got.float() - want) / torch.linalg.vector_norm(want)))
        return {"hidden_rel_l2": worst}

    def control(self, mode: str) -> dict:
        num = Numerics(mode)
        return self.readings(lambda idx, row: self._reference(idx, row, num))

    def check(self) -> list:
        if not self.kept:
            return [("kept_utterances", 1.0, 0.0)]
        limits = self.mix["check"]["limits"]
        got = self.readings()
        return [(k, got[k], limits[k]) for k in sorted(got)]
