"""Optimizer and lr-schedule state shared by Runner and WaveRunner.

Port of ``speech_ssl_compression_tpu/train/optim_mixin.py``: one
implementation of the schedule-offset bookkeeping (prune-event resets, the
re-sync after a resume, epoch-derived totals), plus what both port
trainers do with the Adam state: the fused apply, its leaves for a
checkpoint and their restore.

Host attributes the mixin relies on: ``runner_config``, ``params`` (the
named f32 masters), ``_resumed_meta``, ``_resumed_opt_treedef``, and
``_tree_from_named`` / ``_named_from_tree``, the trainer's weight bridge
(named tensors -> JAX-layout tree, and back to arrays under the names).
It sets ``optimizer``, ``opt_state``, ``_opt_treedef`` and the
``_sched_offset`` / ``_sched_total`` pair.
"""

from __future__ import annotations

from ..utils.checkpoint import opt_leaves_of, restore_opt_state
from ..utils.profiling import span
from .steps import (
    applied_lr,
    fused_apply,
    init_opt_state,
    make_optimizer_from_config,
)


class OptimizerScheduleMixin:
    def _init_optimizer_state(self):
        self._sched_offset = 0
        self._sched_total = None
        # the optax tree string of a restored state, written back on save
        self._opt_treedef = None
        self.optimizer = self._build_optimizer()
        self.opt_state = init_opt_state(list(self.params.values()))

    def _build_optimizer(self):
        return make_optimizer_from_config(
            self.runner_config, sched_offset=self._sched_offset,
            total_steps=self._sched_total)

    def _resync_schedule_offset(self):
        """After restoring the Adam state from a checkpoint: its count may
        be a post-reset count while the checkpoint's ``Step`` is the global
        update count, so the optimizer is rebuilt to keep the schedule on
        the global count across the resume."""
        if self.optimizer.get("schedule") is None:
            return
        count = int(self.opt_state[0])
        step = int((self._resumed_meta or {}).get("Step", count) or count)
        if step > count:
            self._sched_offset = step - count
            self.optimizer = self._build_optimizer()

    def _finalize_schedule_total(self, total_steps: int):
        """Epoch-driven runs resolve their length only in train(): a
        schedule built without a total (``needs_total``) is rebuilt with
        the real run length."""
        sched = self.optimizer.get("schedule")
        if sched is None or not getattr(sched, "needs_total", False):
            return
        self._sched_total = int(total_steps)
        self.optimizer = self._build_optimizer()

    def _reset_optimizer(self, global_step: int = 0):
        """Fresh Adam state (the reference re-creates its optimizer after
        structured prune events, runner.py:348,356); with an lr schedule
        the optimizer is rebuilt offset by the global step, so the lr does
        not re-warm from zero."""
        if self.optimizer.get("schedule") is not None and global_step:
            self._sched_offset = int(global_step)
            self.optimizer = self._build_optimizer()
        self.opt_state = init_opt_state(list(self.params.values()))

    def _applied_lr(self):
        return applied_lr(self.optimizer, self.opt_state)

    def apply(self, grads, sample_size):
        """The fused apply on the parameters and Adam state, in place;
        returns the grad norm (a device tensor). Traced as
        ``sslc.train.apply``."""
        with span("sslc.train.apply"):
            return fused_apply(self.optimizer, list(self.params.values()),
                               self.opt_state, grads, sample_size,
                               sumsq=self._grad_sumsq(grads))

    def _grad_sumsq(self, grads):
        """The gradient's squared norm where the trainer takes it itself
        (``parallel_mixin.py``), else None."""
        return None

    def _opt_leaves(self, opt_state=None, names=None) -> list:
        """The Adam state (``opt_state``, the trainer's own by default;
        its moments in the order of ``names``, the trainer's parameters by
        default) as checkpoint leaves, in JAX's order and layout."""
        return opt_leaves_of(self.opt_state if opt_state is None
                             else opt_state,
                             list(self.params) if names is None else names,
                             self._tree_from_named)

    def _restore_opt_state(self, opt_leaves: list) -> None:
        """The Adam state from a checkpoint's leaves (refused on a
        mismatch, utils/checkpoint.py::restore_opt_state)."""
        self.opt_state = restore_opt_state(
            self.opt_state, list(self.params),
            self._tree_from_named(self.params), opt_leaves,
            self._named_from_tree, self._resumed_opt_treedef)
        self._opt_treedef = self._resumed_opt_treedef
