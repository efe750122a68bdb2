"""The prune machinery shared by Runner and WaveRunner.

Port of what JAX's two runners (``speech_ssl_compression_tpu/train/
runner.py::Runner`` and ``wave_runner.py::WaveRunner``) each do for the
weight-, head- and row-pruning modes, written once: the construction of
each mode's schedule and state (masks of a weight-pruned start folded
before head or row pruning; the budgets asserted; the weight-pruning
controller with its meta restored and all-ones masks where ``-i`` has
none), the prune hook, a weight-prune event (the schedule grows by one
period while the loss has not converged; else the before-pruning
artifact, then fold and re-threshold) and a structured event
(``states_prune_{n}.npz``, the choice, the slicing, and a new model, a
fresh Adam state and grad step for the new widths, with the event's host
seconds (its artifact's save apart) and the device memory around it in
``prune_event_log``).

Host attributes the mixin relies on: ``mode``, ``runner_config``,
``cfg``, ``params`` (the named f32 masters), ``masks``, ``model``,
``device``, ``_resumed_meta``, ``pruned_heads``, ``prune_event_log``,
``save(step, name, **kwargs)`` and the optimizer mixin's
``_reset_optimizer``; and where JAX's two runners differ:

  ``_log_tag``                    the log lines' prefix;
  ``_strict_prune_schedule``      assert one step per event (Runner);
  ``_heads_each_step(pc)``        the heads of one event (Runner: the
                                  layers for any l1 target; WaveRunner:
                                  ``num_heads_each_step`` for by_whole
                                  even under l1, and l1 only);
  ``_weight_prune_artifact(step, total)``  the before-pruning file's name
                                  and the keyword arguments of its
                                  ``save`` (Runner: ``total_step``);
  ``_select_heads()``             score and choose one event's heads;
  ``_model_from_named(named, cfg)``  the model for the new widths;
  ``_build_grad_step()``          ``self.grad_step`` for ``self.model``.
"""

from __future__ import annotations

import time

import torch

from ..compress import head_pruning as hp
from ..compress import row_pruning as rp
from ..compress import weight_pruning as wp
from ..compress.schedule import (
    set_prune_interval,
    sparsity_ladder,
    weight_prune_steps,
)
from ..utils.weights import prunable_names, prunable_tree


class PruneMixin:
    _strict_prune_schedule = False

    def _init_mode_schedules(self):
        """The prune steps and each pruning mode's state (JAX
        ``_init_mode_schedules`` and WaveRunner's construction); no prune
        steps in pre-training."""
        self.wp_state = None
        self.prune_steps = []
        if self.mode in ("head-pruning", "row-pruning"):
            self._init_structured_schedule()
        if self.mode != "weight-pruning":
            return
        pc = self.runner_config["prune"]
        n_iters = pc.get("n_iters", 38)
        self.wp_state = wp.WeightPruningState(
            sparsity=sparsity_ladder(pc["sparsity"], n_iters),
            prune_condition=pc.get("pruning_condition", "converge"),
            smooth_factor=pc.get("smooth_factor", 0.999),
            avg_len=pc.get("average_length", 15000),
            con_tol=pc.get("converge_loss_tolerance", 0.001),
            warnup=pc.get("warnup", 25000),
            period=pc.get("period", 25000),
        )
        self.prune_steps = weight_prune_steps(
            self.wp_state.warnup, self.wp_state.period, n_iters)
        if self.masks is None:
            self.masks = {k: torch.ones_like(self.params[k])
                          for k in prunable_names(self.params)}
        if self._resumed_meta and "Pruning" in self._resumed_meta:
            self.wp_state.load_meta(self._resumed_meta["Pruning"])

    def _init_structured_schedule(self):
        """Head and row pruning: masks of a weight-pruned ``-i`` folded
        into the weights for good (the scores must see the zeros, and the
        events change shapes the masks would no longer match), the prune
        steps, and JAX's construction-time checks of the budget."""
        if self.masks is not None:
            print(f"{self._log_tag} - Folding weight-pruning masks into "
                  "params")
            with torch.no_grad():
                for name, m in self.masks.items():
                    self.params[name].mul_(m)
            self.masks = None
        pc = self.runner_config["prune"]
        self.total_prune_step = pc["total_steps"]
        self.prune_steps = set_prune_interval(pc["interval"], pc["warm_up"],
                                              pc["total_steps"])
        if self._strict_prune_schedule:
            assert len(self.prune_steps) == self.total_prune_step
        cfg = self.cfg
        if self.mode == "row-pruning":
            self.num_rows_each_step = pc["num_rows_each_step"]
            # strict <: an FFN pruned to zero rows is degenerate
            assert (self.num_rows_each_step * self.total_prune_step
                    < min(cfg.encoder_ffn_embed_dim)), (
                "row-prune schedule would empty the FFN")
            return
        self.num_heads_each_step = self._heads_each_step(pc)
        if pc.get("target", "by_layer") == "by_layer":
            assert self.total_prune_step < min(cfg.encoder_attention_heads), (
                f"{self.total_prune_step} by_layer head-prune events would "
                "empty a layer")
        else:  # by_whole protects each layer's top head
            prunable = sum(cfg.encoder_attention_heads) - cfg.encoder_layers
            assert self.num_heads_each_step * self.total_prune_step <= (
                prunable), "by_whole schedule exceeds the prunable head pool"

    def _prune_hook(self, global_step: int, pbar_state: dict):
        """A prune event where ``global_step`` is a prune step (reference
        runner.py:329-356, JAX ``_prune_hook``). ``pbar_state["total"]``
        is the run's length, which a deferred weight-prune event grows."""
        if global_step not in self.prune_steps:
            return
        if self.mode == "weight-pruning":
            self._weight_prune_event(global_step, pbar_state)
        else:
            self._structured_prune_event(global_step)

    def _weight_prune_event(self, global_step: int, pbar_state: dict):
        """Not converged, the schedule and the run grow by one period;
        else the before-pruning artifact, then fold and re-threshold."""
        state = self.wp_state
        if not state.converged():
            print("[Weight Pruning] - Not converge, keep training")
            pbar_state["total"] += state.period
            self.prune_steps.append(max(self.prune_steps) + state.period)
            return
        name, save_kwargs = self._weight_prune_artifact(global_step,
                                                        pbar_state["total"])
        t0 = time.perf_counter()
        self.save(global_step, name, **save_kwargs)
        t1 = time.perf_counter()
        self.params, self.masks, _ = wp.prune_event(self.params, self.masks,
                                                    state)
        seconds = time.perf_counter() - t1
        self.prune_event_log.append({"step": global_step, "seconds": seconds,
                                     "save_seconds": t1 - t0})
        print(f"[Weight Pruning] - iter {state.pruning_times} at step "
              f"{global_step}, sparsity {wp.sparsity_of(self.masks):.4f} "
              f"({seconds:.2f} s on the host)")

    def _structured_prune_event(self, global_step: int):
        """A head- or row-prune event: ``states_prune_{n}.npz`` of the
        state before it, the scores and what they choose, the slicing, and
        a new model for the new widths (on the sliced tensors, no copy of
        the rest), with a fresh Adam state and grad step, so nothing holds
        the old model or its Adam state."""
        cfg = self.cfg
        before = self._allocated()
        t0 = time.perf_counter()
        self.save(global_step, self._states_prune_name())
        save_seconds, t0 = time.perf_counter() - t0, time.perf_counter()
        if self.mode == "head-pruning":
            group = self._select_heads()
            record = {"group": group}
            t1 = time.perf_counter()
            named, new_cfg = hp.prune_heads(self.params, cfg, group)
        else:
            keeps = rp.select_rows(self.params, self.num_rows_each_step)
            record = {"kept": keeps}
            t1 = time.perf_counter()
            named, new_cfg = rp.prune_rows(self.params, cfg, keeps)
        n_old = sum(p.numel() for p in self.params.values())
        self.cfg = new_cfg
        self.model = self._model_from_named(named, new_cfg)
        del named
        self.params = dict(self.model.named_parameters())
        self._reset_optimizer(global_step)
        self._build_grad_step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        record.update(step=global_step, save_seconds=save_seconds,
                      score_seconds=t1 - t0, slice_seconds=t2 - t1,
                      params=(n_old, sum(
                          p.numel() for p in self.params.values())),
                      memory=(before, self._allocated()))
        self.prune_event_log.append(record)
        if self.mode == "head-pruning":
            print(f"[Head Pruning] {sum(new_cfg.encoder_attention_heads)} "
                  f"heads remain ({t1 - t0:.2f} s scoring, {t2 - t1:.2f} s "
                  "slicing)")
        else:
            print(f"[Row Pruning] {min(new_cfg.encoder_ffn_embed_dim)} hidden "
                  f"dims remain in FFN ({t2 - t0:.2f} s on the host)")

    def _states_prune_name(self) -> str:
        """``states_prune_{n}.npz``, n the heads left (head pruning) or the
        narrowest FFN (row pruning), as JAX names its artifacts."""
        left = (sum(self.cfg.encoder_attention_heads)
                if self.mode == "head-pruning"
                else min(self.cfg.encoder_ffn_embed_dim))
        return f"states_prune_{left}.npz"

    def _allocated(self):
        """(memory_allocated, the bytes the live tensors requested) on the
        card, None off it. The allocator may place a tensor in a cached
        block up to 1 MB larger than it asked for, so memory_allocated can
        rise where the live tensors shrink; the requested bytes count them
        exactly."""
        if self.device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(self.device)
        return (stats["allocated_bytes.all.current"],
                stats["requested_bytes.all.current"])

    def _l1_scores(self):
        """l1 head scores on the JAX-layout host view of q/k/v."""
        return hp.l1_head_scores(
            prunable_tree(self.params, modules=("q_proj", "k_proj",
                                                "v_proj")), self.cfg)
