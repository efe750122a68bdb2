"""Faults planted in the port under a run, for the tests and readings that
show the check catches them: each is a context manager that patches the
port for its duration.

- ``state_unchanged``: the optimizer's apply returns the gradient norm and
  leaves the parameters and its state as they were;
- ``half_batch``: each micro-batch (or served batch) loses its second half
  of rows, and the loss is the mean over the rest (a served batch's
  dropped rows come back as zeros);
- ``altered_answer``: every served batch's outputs are scaled by 1 + 1e-3
  where they are produced.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_batch", "altered_answer")


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _scale_outputs(out: dict, factor: float, rows=slice(None)):
    """Scale the outputs a served batch returns, in place (rows ``rows``
    only, where given)."""
    tensors = list(out.get("hidden_states", ())) + [
        out[k] for k in ("x", "last_hidden_state") if k in out]
    with torch.inference_mode():
        for t in tensors:
            t[rows] *= factor


@contextlib.contextmanager
def plant(fault: str):
    from speech_ssl_compression_tpu_torch import extract
    from speech_ssl_compression_tpu_torch.models import hubert
    from speech_ssl_compression_tpu_torch.train import optim_mixin, runner

    if fault == "state_unchanged":
        def make(apply):
            def frozen(hyper, params, opt_state, grads, sample_size,
                       sumsq=None):
                return torch.sqrt(sum(torch.sum(g.float() ** 2)
                                      for g in grads)) / sample_size
            return frozen
        with _patched(optim_mixin, "fused_apply", make):
            yield
    elif fault == "half_batch":
        def make_train(device_batch):
            def half(self, batch):
                b = len(batch["length"]) // 2
                return device_batch(self, {k: v[:b] for k, v in batch.items()})
            return half

        def make_serve(call):
            def half(*args, **kw):
                out = call(*args, **kw)
                key = "x" if "x" in out else "last_hidden_state"
                b = out[key].shape[0]
                _scale_outputs(out, 0.0, slice(b // 2, b))
                return out
            return half
        with _patched(runner.Runner, "_device_batch", make_train), \
                _patched(extract.MelHuBERTExtractor, "_pack_and_dispatch",
                         make_serve), \
                _patched(hubert, "hubert_forward", make_serve):
            yield
    elif fault == "altered_answer":
        def make(call):
            def altered(*args, **kw):
                out = call(*args, **kw)
                _scale_outputs(out, 1.0 + 1e-3)
                return out
            return altered
        with _patched(extract.MelHuBERTExtractor, "_pack_and_dispatch",
                      make), _patched(hubert, "hubert_forward", make):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
