"""Entry: MelHuBERT feature extraction from waveforms, as its users run it.

``MelHuBERTExtractor.forward_stream(batches, featurizer="device",
depth=...)`` of the port, from a checkpoint the harness writes from the
seeded weights, at the mix's dtype and matmul precision. A closed loop:
the feed hands the stream its next batch as soon as the stream asks, until
the window closes; the consumer fences each batch's outputs in turn (an
S3PRL downstream reads its features), and keeps the hidden states of the
utterances sampled for the check. A batch's latency runs from when the
feed hands it over to its fence.

The check recomputes each sampled utterance in the reference (the fbank
in float64 from the same waveform, the model in float32 with TF32 off)
and compares every hidden state on the valid frames.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100_bench import flops, harness, traffic, weights
from h100_bench.reference import melhubert as ref
from h100_bench.reference.numerics import Numerics
from h100_bench.trace import span

def frames20(n_samples: int) -> int:
    """Valid 20 ms frames of an utterance: pairs of Kaldi's 10 ms frames
    (25 ms windows, snip edges)."""
    n10 = 1 + (n_samples - 400) // 160 if n_samples >= 400 else 0
    return (n10 + 1) // 2


class Cell:
    kind = "serve"

    def __init__(self, config, mix, seed, device, workdir):
        from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
        from speech_ssl_compression_tpu_torch.extract import (
            MelHuBERTExtractor,
        )
        from speech_ssl_compression_tpu_torch.utils.checkpoint import (
            save_checkpoint,
        )
        from speech_ssl_compression_tpu_torch.utils.weights import (
            jax_tree_from_named,
        )

        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.dtype = harness.torch_dtype(mix["dtype"])
        section = harness.program_section(config)
        harness.check_program_config(config,
                                     MelHuBERTConfig.from_dict(section))
        named = weights.make(ref.specs(config), seed, self.device)
        ckpt = workdir / "melhubert.npz"
        save_checkpoint(str(ckpt), jax_tree_from_named(
            {k: v.cpu() for k, v in named.items()}),
            meta={"Upstream_Config": {"melhubert": section}, "Step": 0})
        del named
        self.mean_std = harness.ROOT / config["fbank_mean_std"]
        self.ext = MelHuBERTExtractor(
            str(ckpt), fp=config["frame_period_ms"],
            mean_std_npy_path=str(self.mean_std),
            dtype=self.dtype,
            matmul_precision=mix["matmul_precision"], device=self.device)
        ckpt.unlink()

        self.pool = traffic.pool(mix)
        flat = np.concatenate(self.pool)
        wavs = traffic.waveforms(flat, seed, mix["audio"], self.device)
        b = int(mix["batch"])
        self.wavs = [wavs[i * b:(i + 1) * b] for i in range(len(self.pool))]
        self.schedule = traffic.Schedule(len(self.pool), b, seed,
                                           mix["pass_order"])
        self._plan_check(wavs)

    def _plan_check(self, wavs):
        """The utterances the check compares, drawn from the seed before
        the window: the pool's longest at its first turn, and ``samples``
        more among the first pass's batches (window batch number, row).
        Their hidden states are copied into buffers made now, sized for
        the longest, so that the memory they take is the same in every
        run."""
        chk = self.mix["check"]
        self.longest, self.turn_picks = traffic.check_picks(
            [w.shape[0] for w in wavs], int(self.mix["batch"]),
            chk["samples"], self.seed)
        t_max = max(frames20(w.shape[0]) for w in wavs)
        n_states = self.config["encoder_layers"] + 1
        self.buffers = [torch.zeros((n_states, t_max,
                                     self.config["encoder_embed_dim"]),
                                    dtype=self.dtype,
                                    device=self.device)
                        for _ in range(chk["samples"] + 1)]
        self.kept = []  # (buffer, waveform, frames)

    def _stream(self, feed):
        return self.ext.forward_stream(
            feed, featurizer=self.mix["featurizer"],
            depth=int(self.mix["depth"]))

    def _fence(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def warm(self):
        """Every batch of the pool once: the shapes the window uses."""
        for _ in self._stream(iter(self.wavs)):
            self._fence()

    def window(self, seconds: float) -> dict:
        clock = time.perf_counter
        handed = []  # (pool index, member order, seconds handed)
        t0 = clock()

        def feed():
            while True:
                now = clock() - t0
                if now >= seconds:
                    return
                idx, order = self.schedule.next()
                handed.append((idx, order, now))
                yield [self.wavs[idx][j] for j in order]

        units = []
        self.longest_kept = False
        stream = self._stream(feed())
        while True:
            with span("bench.next_batch"):
                out = next(stream, None)
            if out is None:
                break
            with span("bench.fence"):
                self._fence()
            done = clock() - t0
            n = len(units)
            idx, order, t_hand = handed[n]
            self._keep(out, n, idx, order)
            lengths = list(out["lengths"])
            cap = out["last_hidden_state"].shape[1]
            units.append({
                "done_s": done, "latency_s": done - t_hand,
                "valid_frames": sum(lengths),
                "computed_frames": out["n_packed_rows"] * cap,
                "flops": sum(flops.melhubert_fwd_flops(
                    self.config, t, final_proj=False) for t in lengths),
                "segments": lengths})
            del out
        return {"units": units, "attempted": len(handed),
                "failed": len(handed) - len(units)}

    def _keep(self, out, n, idx, order):
        rows = {row for m, row in self.turn_picks if m == n}
        if idx == self.longest[0] and not self.longest_kept:
            rows.add(int(np.flatnonzero(order == self.longest[1])[0]))
            self.longest_kept = True
        for row in sorted(rows):
            t = out["lengths"][row]
            buf = self.buffers[len(self.kept)]
            for j, h in enumerate(out["hidden_states"]):
                buf[j, :t].copy_(h[row, :t])
            self.kept.append((buf, self.wavs[idx][int(order[row])], t))

    def release(self):
        self.ext = None

    def _reference(self, wave, num):
        mean_std = np.load(self.mean_std)
        mean, std = (torch.as_tensor(a, dtype=torch.float64,
                                     device=self.device) for a in mean_std)
        with num.context(), torch.no_grad():
            return ref.serve(torch.as_tensor(wave, device=self.device),
                             self.params, self.config, mean, std, num)

    def readings(self, got_fn=None) -> dict:
        """The compared numbers: the largest relative L2 distance over the
        kept utterances of the pre-projected features and of the layers'
        outputs from the reference's. ``got_fn(wave)`` replaces the
        port's hidden states (the controls)."""
        self.params = weights.make(ref.specs(self.config), self.seed,
                                   self.device)
        f32 = Numerics("f32")
        worst = {"pre_feat_rel_l2": 0.0, "hidden_rel_l2": 0.0}
        for buf, wave, t in self.kept:
            want = self._reference(wave, f32)
            got = (got_fn(wave) if got_fn is not None
                   else [buf[j, :t].float() for j in range(len(want))])
            for j, (g, w) in enumerate(zip(got, want)):
                if w.shape[0] != t:
                    raise AssertionError(f"{w.shape[0]} frames, {t} served")
                err = float(torch.linalg.vector_norm(g.float() - w)
                            / torch.linalg.vector_norm(w))
                key = "pre_feat_rel_l2" if j == 0 else "hidden_rel_l2"
                worst[key] = max(worst[key], err)
        return worst

    def control(self, mode: str) -> dict:
        """The readings with the reference in ``mode``'s arithmetic in the
        port's place."""
        num = Numerics(mode)
        return self.readings(lambda wave: self._reference(wave, num))

    def check(self) -> list:
        if not self.kept:
            return [("kept_utterances", 1.0, 0.0)]
        limits = self.mix["check"]["limits"]
        got = self.readings()
        return [(k, got[k], limits[k]) for k in sorted(got)]

