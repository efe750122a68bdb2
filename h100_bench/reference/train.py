"""MelHuBERT pre-training in plain PyTorch: the masked cluster-prediction
loss, its gradients by autograd, the accumulation window and the Adam
update with the runner's trigger-style clip, as the reference recipe
(``config_runner_20ms.yaml``) runs them, in float32 with TF32 off.

The randomness is worked out again from the seeds the port draws from, in
the order it draws them: a host ``torch.Generator`` on the run's seed gives,
for each micro-batch, the span mask's seed (the mask then drawn by the
frozen sampler in :mod:`.masking`), the seed of the device generator whose
``randint`` bits the residual, input and activation dropouts keep below
the threshold, and each layer's attention seed (the keep bits by
:mod:`.philox`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import masking, melhubert, philox

SEED_BOUND = 2 ** 31 - 1


def draw_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, SEED_BOUND, (), generator=gen))


class Dropout:
    """Inverted dropout on the bits the port draws: ``randint`` words from
    a device generator seeded by the host generator, kept below
    ``(1 - p) * (2**32 - 1)``; attention keep bits by Philox."""

    def __init__(self, host: torch.Generator, device):
        self.host, self.device, self.gen = host, device, None

    def begin(self):
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(draw_seed(self.host))

    def layer_seed(self) -> int:
        return draw_seed(self.host)

    def apply(self, x, p: float):
        if p == 0.0:
            return x
        bits = torch.randint(0, 2 ** 32, x.shape, generator=self.gen,
                             device=x.device, dtype=torch.int64)
        return torch.where(bits < philox.keep_threshold(p),
                           x / (1.0 - p), torch.zeros_like(x))

    def attention(self, probs, p: float, seed: int):
        if p == 0.0:
            return probs
        b, h, tq, tk = probs.shape
        keep = philox.keep_mask(seed, b, h, tq, tk, p, probs.device)
        return torch.where(keep, probs / (1.0 - p), torch.zeros_like(probs))


def span_mask(cfg: dict, lengths, t: int, seed: int) -> np.ndarray:
    """(B, T) bool: MelHuBERT's span mask with ``min_masks=2``, each row its
    own count."""
    return masking.compute_mask_indices_np(
        (len(lengths), t), np.asarray(lengths), mask_prob=cfg["mask_prob"],
        mask_length=cfg["mask_length"], mask_selection="static",
        mask_other=0.0, min_masks=2, no_overlap=False, min_space=1,
        require_same_masks=False, rng=np.random.default_rng(seed))


def micro_loss(p: dict, batch: dict, cfg: dict, num, host, device):
    """One micro-batch's loss: cross entropy of the cluster logits over
    the masked valid frames, their mean. ``batch`` holds host arrays."""
    mask = torch.from_numpy(span_mask(cfg, batch["length"],
                                      batch["feat"].shape[1],
                                      draw_seed(host))).to(device)
    feat = torch.from_numpy(batch["feat"]).to(device)
    label = torch.from_numpy(batch["label"]).to(device).long()
    valid = torch.from_numpy(batch["pad_mask"]).to(device) > 0
    drop = Dropout(host, device)
    drop.begin()
    feat = feat.masked_fill(mask[:, :, None], 0.0)
    hidden = melhubert.hidden_states(feat, p, cfg, num, ~valid, drop)[-1]
    logits = num.linear(hidden, p["final_proj.weight"], p["final_proj.bias"])
    sel = valid & mask & (label != -100)
    logp = torch.log_softmax(logits, dim=-1)
    safe = torch.where(sel, label, 0)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(sel, nll, 0.0).sum() / sel.sum().clamp_min(1)


def follow(p0: dict, micro_batches: list, cfg: dict, hyper: dict,
           host_seed: int, device, num, steps: int) -> dict:
    """``steps`` updates from the weights ``p0`` over ``micro_batches`` (in
    the order the port took them, ``hyper["accum"]`` to an update).
    Returns each update's loss (the sum of its micro-batches' losses over
    the window's length), the first update's gradient as Adam takes it
    (after the clip and the division by the sample count) by leaf, and
    each leaf's change after the last update, as norms; and the first
    gradient itself (``first_grad_full``)."""
    host = torch.Generator()
    host.manual_seed(host_seed)
    names = list(p0)
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    accum = hyper["accum"]
    losses, first, first_full = [], None, {}
    it = iter(micro_batches)
    with num.context():
        for step in range(1, steps + 1):
            acc = {k: torch.zeros_like(v) for k, v in params.items()}
            total = 0.0
            for _ in range(accum):
                loss = micro_loss(params, next(it), cfg, num, host,
                                  device) / accum
                grads = torch.autograd.grad(loss, [params[k] for k in names],
                                            allow_unused=True)
                for k, g in zip(names, grads):
                    if g is not None:
                        acc[k] += g
                total += float(loss.detach())
            losses.append(total)
            with torch.no_grad():
                norm = math.sqrt(sum(float(torch.sum(g * g))
                                     for g in acc.values())) / accum
                clip = hyper["clip"]
                scale = 1.0 if (clip <= 0 or norm < clip) else clip / norm
                c1 = 1.0 - hyper["b1"] ** step
                c2 = 1.0 - hyper["b2"] ** step
                for k in names:
                    ge = acc[k] * (scale / accum)
                    if step == 1:
                        first = first or {}
                        first[k] = float(torch.linalg.vector_norm(ge))
                        first_full[k] = ge
                    m[k].mul_(hyper["b1"]).add_(ge, alpha=1 - hyper["b1"])
                    v2[k].mul_(hyper["b2"]).add_(ge * ge,
                                                 alpha=1 - hyper["b2"])
                    params[k] -= hyper["lr"] * (m[k] / c1) / (
                        torch.sqrt(v2[k] / c2) + hyper["eps"])
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(params[k] - p0[k]))
                  for k in names}
    return {"losses": losses, "first_grad": first, "change": change,
            "first_grad_full": first_full}


def worst_leaf_gap(got: dict, want: dict, counted) -> float:
    """The largest gap between the two sides' norms over the counted
    leaves, against the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    median = float(np.median([want[k] for k in counted]))
    return max(abs(got[k] - want[k]) / max(want[k], median)
               for k in counted)


def counted_leaves(first_grad: dict, floor: float = 1e-3) -> list:
    """The leaves whose reference gradient is not nought to rounding:
    at least ``floor`` times the median leaf's (a key projection's bias
    has none under softmax, and Adam moves it by round-off alone)."""
    median = float(np.median(list(first_grad.values())))
    return [k for k, g in first_grad.items() if g >= floor * median]


def compare(prog: dict, ref: dict) -> dict:
    """The cell's numbers: the largest relative gap of an update's loss,
    the worst leaf's gaps of the first gradient's norm and of the change's,
    and the relative L2 distance of the first gradient itself over the
    counted leaves (the norms are blind to errors that do not bias them,
    which is what a lower precision adds)."""
    counted = counted_leaves(ref["first_grad"])
    diff = sum(float(torch.sum((prog["first_grad_full"][k].to(
        ref["first_grad_full"][k].device) - ref["first_grad_full"][k]) ** 2))
        for k in counted)
    norm = sum(float(torch.sum(ref["first_grad_full"][k] ** 2))
               for k in counted)
    return {
        "loss_rel_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(prog["losses"], ref["losses"])),
        "first_grad_gap": worst_leaf_gap(prog["first_grad"],
                                         ref["first_grad"], counted),
        "change_gap": worst_leaf_gap(prog["change"], ref["change"], counted),
        "first_grad_rel_l2": math.sqrt(diff / norm),
    }
