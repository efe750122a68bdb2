"""The pre-training grad step and the optimizer's apply step.

Port of ``speech_ssl_compression_tpu/train/steps.py`` for MelHuBERT
pre-training and distillation, and of the HuBERT and wav2vec 2.0 grad
steps of ``speech_ssl_compression_tpu/train/wave_runner.py``. Grad
semantics match JAX's, which match the reference:

  * the micro-batch loss is divided by ``gradient_accumulate_steps``;
  * the accumulated grads are divided again by ``sample_size`` in the apply
    step (MelHuBERT: the number of micro-batches; HuBERT: the number of
    masked frames the loss summed over);
  * the global-norm clip is trigger-style at ``gradient_clipping``;
  * a non-finite grad norm skips the update, and the Adam count with it.

Parameters stay f32 (the "masters"). With ``compute_dtype=bfloat16`` the
grad step runs the model on bf16 copies through
``torch.func.functional_call``; the casts are differentiable, so the
gradients arrive at the f32 masters, as JAX's ``cast_for_compute`` inside
``value_and_grad`` does.

Weight pruning: the grad steps take the masks of the trainer's pruned
parameters and differentiate through ``p * m`` (:func:`mask_params`), as
JAX's do; the masters keep their masked entries between prune events.

The apply step is plain PyTorch (JAX left it to XLA) and updates the
parameters and the Adam state IN PLACE. The Adam state is the list
[count, *mu, *nu], mu and nu in the order of the parameter list; the
trainer saves it in JAX's leaf order (``utils/checkpoint.py``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..compress.distillation import distill_forward, distill_selections
from ..models.melhubert import (
    loss_selections,
    melhubert_pretrain_loss,
    span_mask,
)
from ..ops.dropout import draw_seed
from ..parallel.mesh import all_reduce_tensors, local_rows
from ..utils.profiling import span

_MAX_I32 = 2**31 - 1


def polynomial_decay_schedule(base_lr, warmup_updates=0,
                              total_num_update=None,
                              end_learning_rate=0.0, power=1.0):
    """fairseq-style warmup + polynomial decay (reference runner.py:184-197,
    JAX ``polynomial_decay_schedule``): a linear ramp over
    ``warmup_updates``, then ``(lr - end) * pct_remaining**power + end``,
    ``end`` past ``total_num_update``; without a total the post-warmup lr
    stays at ``base_lr``. Returns ``f(num_updates) -> lr`` on a 1-based
    update count, an int or a tensor (f32 0-dim tensor out)."""
    base_lr = float(base_lr)
    end = float(end_learning_rate)
    warmup = int(warmup_updates)

    def f(num_updates):
        nu = torch.as_tensor(num_updates).to(torch.float32)
        lr = torch.full_like(nu, base_lr)
        if total_num_update is not None:
            total = float(total_num_update)
            pct = 1.0 - (nu - warmup) / max(total - warmup, 1.0)
            decayed = (base_lr - end) * torch.clamp_min(pct, 0.0) ** power + end
            lr = torch.where(nu >= total, torch.full_like(nu, end), decayed)
        if warmup > 0:
            lr = torch.where(nu <= warmup, base_lr * nu / warmup, lr)
        return lr

    return f


def build_lr_schedule(runner_config: dict, base_lr: float, total_steps=None):
    """The runner YAML's ``lr_scheduler:`` section as a schedule, or None
    without one (JAX ``build_lr_schedule``). Keys: warmup_updates,
    total_num_update (default: ``total_steps``, else a positive
    ``runner.total_steps``), power, end_learning_rate. Without a known
    total the schedule carries ``needs_total=True``."""
    sched = runner_config.get("lr_scheduler")
    if not sched:
        return None
    total = sched.get("total_num_update")
    if total is None and total_steps is not None and int(total_steps) > 0:
        total = int(total_steps)
    if total is None:
        rt = runner_config.get("runner", {}).get("total_steps", -1)
        total = int(rt) if rt and int(rt) > 0 else None
    f = polynomial_decay_schedule(
        base_lr,
        warmup_updates=int(sched.get("warmup_updates", 0)),
        total_num_update=total,
        end_learning_rate=float(sched.get("end_learning_rate", 0.0)),
        power=float(sched.get("power", 1.0)),
    )
    f.needs_total = total is None
    return f


def parse_betas(betas):
    """Adam betas from YAML: a [b1, b2] list, or the fairseq string form
    ``(0.9,0.98)``."""
    if isinstance(betas, str):
        betas = ast.literal_eval(betas)
    return tuple(float(b) for b in betas)


def make_optimizer(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                   gradient_clipping=10.0, lr_schedule=None) -> dict:
    """torch.optim.Adam's update with the runner's trigger-style clip and
    coupled L2 (JAX ``make_optimizer``), as the hyperparameter dict that
    :func:`fused_apply` takes (JAX's ``optimizer.hyper``).
    ``lr_schedule`` is a ``f(num_updates) -> lr`` evaluated on the
    incremented Adam count (JAX's fused path). A callable ``lr`` (JAX's
    generic path, ``optax.adam(lr)``) is evaluated per update on the count
    before the increment, 0 at the first update, as optax's
    ``scale_by_schedule`` reads its own count; the state keeps the fused
    path's [count, mu*, nu*] (optax's extra schedule count moves in
    lockstep with Adam's). Both together raise, as in JAX."""
    if callable(lr) and lr_schedule is not None:
        raise ValueError(
            "pass either a callable lr (generic optax path) or a float lr "
            "+ lr_schedule (fused path), not both")
    return dict(
        lr=lr if callable(lr) else float(lr), b1=float(betas[0]),
        b2=float(betas[1]), eps=float(eps),
        weight_decay=float(weight_decay),
        clip=float(gradient_clipping or 0.0), schedule=lr_schedule,
    )


def make_optimizer_from_config(runner_config: dict, *, sched_offset: int = 0,
                               total_steps=None):
    """The optimizer from the runner YAML (``optimizer:``,
    ``runner.gradient_clipping``, ``lr_scheduler:``), as JAX's
    ``make_optimizer_from_config`` builds it. ``sched_offset`` keeps an
    active lr schedule on the global update count where the Adam count it
    is evaluated on was reset (a structured prune event) or restored from
    a checkpoint whose count lags its ``Step``; ``total_steps`` gives
    polynomial decay its length when the YAML runs by epochs."""
    opt_cfg = runner_config.get("optimizer", {})
    base_lr = float(opt_cfg.get("lr", 1e-4))
    sched = build_lr_schedule(runner_config, base_lr, total_steps=total_steps)
    if sched is not None and sched_offset:
        inner = sched

        def sched(n, _f=inner, _o=int(sched_offset)):
            return _f(n + _o)

        sched.needs_total = inner.needs_total
    return make_optimizer(
        lr=base_lr,
        betas=parse_betas(opt_cfg.get("betas", (0.9, 0.999))),
        eps=float(opt_cfg.get("eps", 1e-8)),
        weight_decay=float(opt_cfg.get("weight_decay", 0.0)),
        gradient_clipping=float(
            runner_config.get("runner", {}).get("gradient_clipping", 10.0)),
        lr_schedule=sched,
    )


def init_opt_state(params: List[torch.Tensor]) -> list:
    """Fresh Adam state [count (int32 0-dim), *mu, *nu], f32 zeros."""
    dev = params[0].device
    zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    return ([torch.zeros((), dtype=torch.int32, device=dev)] + zeros
            + [torch.zeros_like(z) for z in zeros])


def applied_lr(hyper: dict, opt_state: list) -> Optional[float]:
    """The lr the last update used (the schedule at the Adam count), or
    None without a schedule. Reads the count from the device."""
    sched = hyper.get("schedule")
    if sched is None:
        return None
    return float(sched(int(opt_state[0])))


@torch.no_grad()
def fused_apply(hyper: dict, params: List[torch.Tensor], opt_state: list,
                grads: List[torch.Tensor], sample_size,
                sumsq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One clip + Adam (+ coupled L2) update with the non-finite skip, port
    of JAX ``_fused_apply``. Updates ``params`` and ``opt_state`` IN PLACE
    and returns the grad norm (a 0-dim f32 tensor; nothing waits for the
    device). The order of operations is JAX's: the norm of grads /
    sample_size; the clip scale only when norm >= clip; L2 added after
    clipping and before the moments; the count increment saturating at the
    int32 maximum; bias corrections and the schedule on the incremented
    count (a callable lr on the count before it); every write a ``where`` on the norm being finite, never a
    multiply (0 * NaN would poison the parameters). ``sumsq`` is the
    gradient's squared norm where the caller takes it (a tensor-parallel
    rank holds slices of some gradients: their squares are summed over the
    model group)."""
    lr, b1, b2 = hyper["lr"], hyper["b1"], hyper["b2"]
    eps, wd, clip = hyper["eps"], hyper["weight_decay"], hyper["clip"]
    schedule = hyper.get("schedule")
    n = len(params)
    if len(opt_state) != 2 * n + 1:
        raise ValueError(f"Adam state must be [count, mu*{n}, nu*{n}], got "
                         f"{len(opt_state)} tensors")
    count, mu, nu = opt_state[0], opt_state[1:1 + n], opt_state[1 + n:]

    if sumsq is None:
        sumsq = grad_sumsq(grads)
    grad_norm = torch.sqrt(sumsq) / sample_size
    ok = torch.isfinite(grad_norm)
    one = torch.ones((), device=grad_norm.device)
    clip_scale = (torch.where(grad_norm < clip, one, clip / grad_norm)
                  if clip > 0 else one)
    eff = clip_scale / sample_size

    count_inc = torch.where(count < _MAX_I32, count + 1, count)
    c1 = 1.0 - torch.pow(b1, count_inc.float())
    c2 = 1.0 - torch.pow(b2, count_inc.float())
    if schedule is not None:
        lr = schedule(count_inc)
    elif callable(lr):
        lr = lr(count)
    for p, m, v, g in zip(params, mu, nu, grads):
        ge = g.float() * eff
        if wd > 0:
            ge = ge + wd * p.float()
        m2 = b1 * m + (1.0 - b1) * ge
        v2 = b2 * v + (1.0 - b2) * torch.square(ge)
        upd = lr * (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        p.copy_(torch.where(ok, p - upd.to(p.dtype), p))
        m.copy_(torch.where(ok, m2, m))
        v.copy_(torch.where(ok, v2, v))
    count.copy_(torch.where(ok, count_inc, count))
    return grad_norm


def grad_sumsq(grads: List[torch.Tensor]) -> torch.Tensor:
    """The sum of the squares of ``grads``' entries, in f32."""
    return sum(torch.sum(torch.square(g.float())) for g in grads)


def global_totals(mesh, selections: dict) -> Optional[dict]:
    """The counts of ``selections`` (name -> (B, T) bool) over the data
    group's global batch, or None off a data-parallel grid: one
    all-reduce, before the forward, of the divisors a rank's loss takes."""
    if mesh is None or mesh.dp == 1:
        return None
    names = list(selections)
    counts = torch.stack([selections[k].sum() for k in names]).float()
    return dict(zip(names, all_reduce_tensors([counts],
                                              mesh.data_group)[0]))


def cast_for_compute(params: Dict[str, torch.Tensor], dtype: torch.dtype):
    """Floating tensors in ``dtype`` (differentiable casts; a no-op where
    the dtype already matches)."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


def mask_params(params: Dict[str, torch.Tensor],
                masks: Optional[Dict[str, torch.Tensor]]):
    """``p * m`` on the parameters ``masks`` names (weight pruning; a new
    dict, differentiable), the rest as they are."""
    if not masks:
        return params
    return {k: v * masks[k] if k in masks else v for k, v in params.items()}


def _grads(loss, params: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d params in ``params``' order, zeros for unused ones;
    traced as ``sslc.train.backward``."""
    leaves = list(params.values())
    with span("sslc.train.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def accumulate_grads(acc: Optional[List[torch.Tensor]],
                     grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Micro-batch gradient accumulation: ``acc += grads`` in place (one
    fused add over the list); the first micro-batch's grads become the
    accumulator."""
    if acc is None:
        return grads
    torch._foreach_add_(acc, grads)
    return acc


def host_span_mask(cfg, batch: dict, rng: torch.Generator, mesh=None):
    """The (B, T) span mask of a batch, drawn on the host from the batch's
    ``length`` (numpy) and a seed drawn from ``rng``, on the device of
    ``batch["feat"]``; None where the config masks nothing. On a
    data-parallel grid (``mesh``) the mask is drawn over the global batch
    and this rank's rows are taken (``parallel/mesh.py::local_rows``).
    Traced as ``sslc.train.span_mask``."""
    if cfg.mask_prob <= 0:
        return None
    with span("sslc.train.span_mask"):
        feat = batch["feat"]
        gen = np.random.default_rng(draw_seed(rng))
        mask = local_rows(mesh, lambda lens: span_mask(
            cfg, lens, feat.shape[1], gen), batch["length"])
        return torch.from_numpy(mask).to(feat.device)


def make_melhubert_grad_step(model, *, accum_steps: int = 1,
                             compute_dtype=torch.float32,
                             attn_impl: str = "auto",
                             deterministic: bool = False,
                             remat: bool = False):
    """Returns ``grad_step(params, batch, rng, mask_indices=None,
    masks=None) -> (loss, grads, logs)``, port of JAX
    ``make_melhubert_grad_step``. ``remat=True`` recomputes each encoder
    layer in the backward (JAX's ``remat=``: less memory, the same
    gradients bit for bit, dropout included).

    ``params`` maps ``model``'s parameter names to the f32 masters;
    ``masks`` (weight pruning) maps some of those names to 0/1 tensors of
    the same shapes: the step differentiates through ``p * m`` before the
    cast to ``compute_dtype``, as JAX applies its masks inside
    ``value_and_grad``, so the forward sees masked weights and the masters'
    gradients are ``m * g`` (exactly 0 where masked);
    ``batch`` holds device tensors ``feat`` (B, T, F), ``label`` (B, T)
    and ``pad_mask`` (B, T), and host ``length`` (B,) numpy; ``rng`` is a
    host ``torch.Generator``. The span mask is drawn on the host from the
    lengths and that generator unless ``mask_indices`` (B, T) is given.
    Returns the loss / accum_steps (a detached 0-dim tensor), the list of
    gradients in ``params``' order (zeros for unused parameters) and the
    loss's logs (detached). ``deterministic=True`` turns the dropouts off
    (for parity checks; training keeps them on)."""
    cfg = model.cfg

    def grad_step(params: Dict[str, torch.Tensor], batch: dict,
                  rng: torch.Generator, mask_indices=None, masks=None):
        feat = batch["feat"]
        mesh = getattr(model, "mesh", None)
        if mask_indices is None:
            mask_indices = host_span_mask(cfg, batch, rng, mesh)
        totals = global_totals(mesh, loss_selections(
            mask_indices, batch["label"], batch["pad_mask"]))
        with span("sslc.train.forward"):
            out = functional_call(
                model,
                cast_for_compute(mask_params(params, masks), compute_dtype),
                (feat.to(compute_dtype), batch["pad_mask"]),
                dict(mask=True, teacher_mask_indices=mask_indices, rng=rng,
                     deterministic=deterministic, attn_impl=attn_impl,
                     remat=remat),
            )
            loss, logs = melhubert_pretrain_loss(
                out, batch["label"], batch["pad_mask"], cfg, totals)
            loss = loss / accum_steps
        # detached: a log entry on the graph would keep its leaves, the
        # masters, alive until the next step (past a prune event's rebuild)
        return (loss.detach(), _grads(loss, params),
                {k: v.detach() for k, v in logs.items()})

    return grad_step


def make_distill_grad_step(teacher, student, *, temperature: float,
                           alpha: float, loss_type: str = "masked",
                           accum_steps: int = 1,
                           compute_dtype=torch.float32,
                           attn_impl: str = "auto",
                           deterministic: bool = False):
    """Returns ``grad_step(params, batch, rng, mask_indices=None,
    masks=None) -> (loss, grads, logs)``, port of JAX
    ``make_distill_grad_step``: the teacher's forward and the student's
    forward and backward in one micro-step, with the call shape and
    returns of :func:`make_melhubert_grad_step`.

    ``teacher`` is a ``MelHuBERTModel`` set to ``eval()`` and
    ``requires_grad_(False)`` here; it runs without grad and without
    dropout on one copy of its parameters in ``compute_dtype``, made once
    (a bf16 cast is deterministic, so the copy holds the values a cast per
    micro-batch would give). ``params`` maps ``student``'s parameter names
    to the f32 masters, differentiated through the cast to
    ``compute_dtype`` (and through ``p * m`` for ``masks``, as in
    pre-training). With ``loss_type="masked"`` the span mask is drawn on
    the host from the TEACHER's config, the batch's lengths and ``rng``,
    unless ``mask_indices`` is given; nomasked draws none. Returns the
    loss / accum_steps (detached), the student's gradients in ``params``'
    order and the detached logs ``hard_loss``, ``soft_loss`` and
    ``teacher_loss``. ``deterministic=True`` turns the student's dropouts
    off (for parity checks; training keeps them on)."""
    teacher.eval().requires_grad_(False)
    teacher_params = {k: v.detach().to(compute_dtype)
                      for k, v in teacher.named_parameters()}
    masked = loss_type == "masked"

    def grad_step(params: Dict[str, torch.Tensor], batch: dict,
                  rng: torch.Generator, mask_indices=None, masks=None):
        mesh = getattr(student, "mesh", None)
        if masked and mask_indices is None:
            mask_indices = host_span_mask(teacher.cfg, batch, rng, mesh)
        totals = global_totals(mesh, distill_selections(
            mask_indices if masked else None, batch["label"],
            batch["pad_mask"], loss_type))
        with span("sslc.train.forward"):
            loss, logs = distill_forward(
                teacher, student, batch["feat"].to(compute_dtype),
                batch["pad_mask"], batch["label"], temperature=temperature,
                alpha=alpha, loss_type=loss_type, mask_indices=mask_indices,
                rng=rng, deterministic_student=deterministic,
                attn_impl=attn_impl, teacher_params=teacher_params,
                student_params=cast_for_compute(mask_params(params, masks),
                                                compute_dtype),
                totals=totals)
            loss = loss / accum_steps
        return (loss.detach(), _grads(loss, params),
                {k: v.detach() for k, v in logs.items()})

    return grad_step


def make_hubert_grad_step(model, *, accum_steps: int = 1,
                          compute_dtype=torch.float32,
                          attn_impl: str = "auto",
                          deterministic: bool = False):
    """Returns ``grad_step(params, batch, rng, mask_indices=None,
    masks=None) -> (loss, sample_size, grads, logs)``, port of the HuBERT
    branch of JAX ``WaveRunner._build_grad_step`` (``masks`` as in
    :func:`make_melhubert_grad_step`: a weight-pruned checkpoint trains on
    at its sparsity).

    ``params`` maps ``model``'s (a ``HuBERTModel``) parameter names to the
    f32 masters; ``batch`` holds the device tensors ``source`` (B, T_wave),
    ``target_list`` (list of (B, T') int64) and ``target_valid`` (B, T')
    bool, and the host ``length`` (B,) numpy. The span mask is drawn on the
    host from ``rng`` unless ``mask_indices`` is given. Returns the summed
    NCE loss / accum_steps (detached), the masked-frame count (a device
    tensor), the gradients in ``params``' order (zeros for unused ones)
    and the loss's logs. ``deterministic=True`` turns the dropouts off."""

    def grad_step(params: Dict[str, torch.Tensor], batch: dict,
                  rng: torch.Generator, mask_indices=None, masks=None):
        with span("sslc.train.forward"):
            out = functional_call(
                model,
                cast_for_compute(mask_params(params, masks), compute_dtype),
                (batch["source"].to(compute_dtype), batch["length"]),
                dict(mask=True, mask_indices=mask_indices, rng=rng,
                     deterministic=deterministic, attn_impl=attn_impl,
                     target_list=batch["target_list"],
                     target_valid=batch["target_valid"]),
            )
            loss = out["loss"] / accum_steps
        # detached: a log entry on the graph would keep the masters alive
        # past a prune event's rebuild
        logs = {k: v.detach() if isinstance(v, torch.Tensor) else v
                for k, v in out["logs"].items()}
        return (loss.detach(), out["sample_size"], _grads(loss, params),
                logs)

    return grad_step


def make_wav2vec2_grad_step(model, *, accum_steps: int = 1,
                            compute_dtype=torch.float32,
                            attn_impl: str = "auto",
                            mask_shared_rounding: bool = False):
    """Returns ``grad_step(params, batch, rng, gumbel_temp,
    mask_indices=None, masks=None, gumbel_uniform=None,
    negative_counts=None) -> (loss, sample_size, grads, logs)``, port of
    the wav2vec 2.0 branch of JAX ``WaveRunner._build_grad_step``
    (train/wave_runner.py:332-385).

    ``params`` maps ``model``'s (a ``Wav2Vec2Model``) parameter names to
    the f32 masters (``masks`` as in :func:`make_melhubert_grad_step`);
    ``batch`` holds the device tensor ``source`` (B, T_wave), the host
    ``length`` (B,) numpy and, from a dataset with a mask config, the
    ``precomputed_mask`` (B, T') the forward uses in place of a span mask.
    ``gumbel_temp`` is the quantizer's temperature of this step (the
    trainer anneals it on the host). ``mask_shared_rounding``: one
    span-count draw per batch, for crop-collated (unpadded) batches.
    Returns the loss / accum_steps (detached), the masked-frame count (a
    device tensor), the gradients in ``params``' order (zeros for unused
    ones) and the detached logs, with ``temp``, the temperature the
    quantizer ran at. ``mask_indices``, ``gumbel_uniform`` and
    ``negative_counts`` fix the step's draws for parity checks."""

    def grad_step(params: Dict[str, torch.Tensor], batch: dict,
                  rng: torch.Generator, gumbel_temp: float,
                  mask_indices=None, masks=None, gumbel_uniform=None,
                  negative_counts=None):
        if mask_indices is None:
            mask_indices = batch.get("precomputed_mask")
        with span("sslc.train.forward"):
            out = functional_call(
                model,
                cast_for_compute(mask_params(params, masks), compute_dtype),
                (batch["source"].to(compute_dtype), batch["length"]),
                dict(compute_loss=True, mask=True, mask_indices=mask_indices,
                     rng=rng, deterministic=False,
                     gumbel_temp=gumbel_temp, attn_impl=attn_impl,
                     mask_shared_rounding=mask_shared_rounding,
                     gumbel_uniform=gumbel_uniform,
                     negative_counts=negative_counts),
            )
            loss = out["loss"] / accum_steps
        logs = {k: v.detach() for k, v in out["logs"].items()}
        if "temp" in out:
            logs["temp"] = out["temp"]
        return loss.detach(), out["sample_size"], _grads(loss, params), logs

    return grad_step
