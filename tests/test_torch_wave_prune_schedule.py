"""The prune schedules of the port's WaveRunner against JAX's: events at
JAX's steps (a deferred weight-prune event extending the schedule and the
run), the head and row budgets refused at construction, and an
OOM-dropped window that must not fire its event twice. The runs start
from the JAX-written checkpoint of ``test_torch_wave_pruning.py``."""

import pytest
import torch

from speech_ssl_compression_tpu.train.wave_runner import (
    WaveRunner as JaxWaveRunner,
)
from speech_ssl_compression_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from speech_ssl_compression_tpu_torch.train.wave_runner import WaveRunner
from test_torch_wave_pruning import (
    MODELS,
    PRUNE,
    _args,
    _data,
    _meta,
    _npz,
    _runner_config,
    _start,
)


def _count_applies(runner, attr):
    applied = []
    orig = getattr(runner, attr)

    def counting(*a, **kw):
        applied.append(1)
        return orig(*a, **kw)

    setattr(runner, attr, counting)
    return applied


@pytest.mark.parametrize("deferred", [False, True])
def test_weight_prune_events_fire_at_jax_steps(tmp_path, deferred):
    # events at warnup + i * period, each after that many updates (its
    # artifact's Step and Adam count); a deferred event extends the
    # schedule and the run by one period, as JAX's does
    data, task = _data(tmp_path, "hubert")
    start = _start(tmp_path, "hubert", data)
    prune = ({"sparsity": [0.5], "n_iters": 1, "warnup": 1, "period": 1,
              "pruning_condition": "converge"} if deferred else
             {"sparsity": [0.2, 0.4], "n_iters": 2, "warnup": 1, "period": 2,
              "pruning_condition": "always"})
    rc = _runner_config(task, prune, total_steps=2 if deferred else 5,
                        lr=1e-4)
    seen = {}
    for name, cls, attr in (("jax", JaxWaveRunner, "apply_step"),
                            ("port", WaveRunner, "apply")):
        runner = cls(_args(tmp_path / name, "weight-pruning", "hubert",
                           start), rc, {"hubert": MODELS["hubert"]})
        if deferred:
            verdicts = iter([False, True])
            runner.wp_state.converged = lambda v=verdicts: next(v, True)
        applied = _count_applies(runner, attr)
        runner.train()
        files = _npz(tmp_path / name)
        seen[name] = (len(applied), list(map(int, runner.prune_steps)),
                      files, {f: _meta(str(tmp_path / name / f))["Step"]
                              for f in files},
                      runner.wp_state.pruning_times)
        counts = {f: int(jax_load_checkpoint(str(tmp_path / name / f))[
            "opt_leaves"][0]) for f in files}
        assert counts == seen[name][3]  # each artifact after Step updates
    assert seen["port"] == seen["jax"]
    if deferred:
        assert seen["port"][:3] == (3, [1, 2], ["before-pruning-2.npz",
                                                "last-step.npz"])
    else:
        assert seen["port"][2:4] == (
            ["before-pruning-1.npz", "before-pruning-3.npz", "last-step.npz"],
            {"before-pruning-1.npz": 1, "before-pruning-3.npz": 3,
             "last-step.npz": 5})


def test_head_prune_events_fire_at_jax_steps(tmp_path):
    data, task = _data(tmp_path, "hubert")
    start = _start(tmp_path, "hubert", data)
    rc = _runner_config(task, {"metric": "l1", "target": "by_layer",
                               "total_steps": 2, "interval": [0, 2],
                               "warm_up": 1}, total_steps=4, lr=1e-4)
    seen = {}
    for name, cls in (("jax", JaxWaveRunner), ("port", WaveRunner)):
        runner = cls(_args(tmp_path / name, "head-pruning", "hubert", start),
                     rc, {"hubert": MODELS["hubert"]})
        runner.train()
        files = _npz(tmp_path / name)
        seen[name] = {f: _meta(str(tmp_path / name / f))["Step"]
                      for f in files}
    assert seen["port"] == seen["jax"] == {
        "states_prune_8.npz": 1, "states_prune_6.npz": 3,
        "last-step.npz": 4}


@pytest.mark.parametrize("mode,prune,error", [
    ("head-pruning", {"metric": "l1", "target": "by_layer", "total_steps": 4,
                      "interval": 1, "warm_up": 1}, AssertionError),
    ("head-pruning", {"metric": "l1", "target": "by_whole",
                      "num_heads_each_step": 4, "total_steps": 2,
                      "interval": 1, "warm_up": 1}, AssertionError),
    ("row-pruning", {"num_rows_each_step": 32, "total_steps": 2,
                     "interval": 1, "warm_up": 1}, AssertionError),
    ("head-pruning", {"metric": "data-driven", "target": "by_whole",
                      "num_heads_each_step": 1, "total_steps": 1,
                      "interval": 1, "warm_up": 1, "data_ratio": 1.0},
     NotImplementedError),
])
def test_budgets_refused_at_construction_as_jax(tmp_path, mode, prune,
                                                error):
    data, task = _data(tmp_path, "hubert")
    rc = _runner_config(task, prune)
    for cls in (JaxWaveRunner, WaveRunner):
        with pytest.raises(error):
            cls(_args(tmp_path / cls.__module__, mode, "hubert", None), rc,
                {"hubert": MODELS["hubert"]})


def test_oom_dropped_window_does_not_refire_its_event(tmp_path):
    # the event at step 0 fires, the window's second micro-batch runs out
    # of memory, the window restarts at step 0: no second event
    data, task = _data(tmp_path, "hubert")
    start = _start(tmp_path, "hubert", data)
    rc = _runner_config(task, PRUNE["head-pruning"] | {"total_steps": 1},
                        total_steps=2, lr=1e-4, accum=2)
    seen = {}
    for name, cls, oom in (
            ("jax", JaxWaveRunner,
             RuntimeError("RESOURCE_EXHAUSTED: out of memory")),
            ("port", WaveRunner,
             torch.cuda.OutOfMemoryError("CUDA out of memory"))):
        runner = cls(_args(tmp_path / name, "head-pruning", "hubert", start),
                     rc, {"hubert": MODELS["hubert"]})
        calls, build = [], runner._build_grad_step

        def rebuild(_runner=runner, _build=build, _calls=calls, _oom=oom):
            # the event at step 0 rebuilds the grad step before any call
            _build()
            step = _runner.grad_step

            def failing(*a, **kw):
                _calls.append(1)
                if len(_calls) == 2:
                    raise _oom
                return step(*a, **kw)

            _runner.grad_step = failing

        runner._build_grad_step = rebuild
        runner.train()
        seen[name] = (len(calls), runner.pruned_heads,
                      runner.cfg.encoder_attention_heads, _npz(tmp_path / name))
    # a window of one call and its OOM dropped, then two windows of two
    assert seen["port"][0] == seen["jax"][0] == 6
    assert seen["port"][2] == seen["jax"][2] == (3, 3)
    assert seen["port"][1] == seen["jax"][1] and len(seen["port"][1]) == 1
    assert seen["port"][3] == seen["jax"][3] == ["last-step.npz",
                                                 "states_prune_8.npz"]
