"""Init from a checkpoint and resume, across the two packages: a JAX
weight-pruning checkpoint (params, masks, Adam state, ``Pruning`` meta)
resumes in the port and the port's resumes in JAX; the lr schedule's
offset re-syncs as in JAX; one update from a restored state equals one
from the state in memory; the optimizer restore refuses a state that does
not match; an out-of-memory micro-batch drops its window as JAX's does;
a JAX HuBERT npz initialises the port's WaveRunner. Tiny widths on the
CPU."""

import types

import numpy as np
import pytest
import torch
import jax

from speech_ssl_compression_tpu.compress import weight_pruning as jwp
from speech_ssl_compression_tpu import configs as jconfigs
from speech_ssl_compression_tpu.models import hubert as jhubert
from speech_ssl_compression_tpu.train import steps as jsteps
from speech_ssl_compression_tpu.train.runner import Runner as JaxRunner
from speech_ssl_compression_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu_torch.configs import read_yaml
from speech_ssl_compression_tpu_torch.train.runner import Runner
from speech_ssl_compression_tpu_torch.train.wave_runner import WaveRunner
from speech_ssl_compression_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_opt_state,
    tree_leaves,
)
from speech_ssl_compression_tpu_torch.utils.torch_convert import (
    params_to_state_dict,
)
from speech_ssl_compression_tpu_torch.utils.weights import (
    jax_tree_from_named,
    masks_tree,
    wave_tree_from_named,
)
from test_torch_hubert import (
    MODEL_YAML as HUBERT_MODEL_YAML,
    N_CLASSES,
    RUNNER_YAML as HUBERT_RUNNER_YAML,
    make_wav_dataset,
)
from test_torch_weight_pruning import (
    make_args,
    make_dataset,
    model_config,
    runner_config,
    start_checkpoint,
)


def _config(csv, total_steps, **over):
    """Weight pruning at 0.2 then 0.4 (steps 2 and 4), with a warmup lr
    schedule so the schedule's offset shows in the lr."""
    rc = runner_config(csv, total_steps=total_steps, warnup=2, period=2,
                       n_iters=2)
    rc["lr_scheduler"] = {"warmup_updates": 5}
    rc.update(over)
    return rc


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX weight-pruning run of 4 updates: its last-step.npz holds the
    masks of the event at step 2, the Adam state and ``Pruning``."""
    tmp = tmp_path_factory.mktemp("jax_run")
    csv = make_dataset(tmp)
    start = start_checkpoint(tmp)
    runner = JaxRunner(make_args(tmp / "exp", initial_weight=start),
                       _config(csv, 4), model_config())
    runner.train()
    return csv, str(tmp / "exp" / "last-step.npz")


def _moments(runner):
    """The port's [count, mu tree, nu tree] in JAX's layout."""
    names, n = list(runner.params), len(runner.params)
    return [int(runner.opt_state[0])] + [
        jax_tree_from_named(dict(zip(names, part)))
        for part in (runner.opt_state[1:1 + n], runner.opt_state[1 + n:])]


def _jax_moments(runner):
    adam = next(s for s in jax.tree.leaves(
        runner.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu"))
    return [int(adam.count), jax.tree.map(np.asarray, adam.mu),
            jax.tree.map(np.asarray, adam.nu)]


def _same_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(jax.tree.map(np.asarray, b))
    return len(la) == len(lb) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(la, lb))


def _assert_same_state(port, jax_runner):
    assert _same_tree(jax_tree_from_named(port.params), jax_runner.params)
    assert _same_tree(masks_tree(port.masks), jax_runner.masks)
    got, want = _moments(port), _jax_moments(jax_runner)
    assert got[0] == want[0]
    assert _same_tree(got[1], want[1]) and _same_tree(got[2], want[2])
    assert port.wp_state.to_meta() == jax_runner.wp_state.to_meta()


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    csv, ckpt = jax_run
    state = jax_load_checkpoint(ckpt)
    assert state["meta"]["Pruning"]["pruning_times"] == 1
    args = dict(initial_weight=ckpt, init_optimizer_from_initial_weight=True)
    port = Runner(make_args(tmp_path / "p", **args), _config(csv, 4),
                  model_config())
    ref = JaxRunner(make_args(tmp_path / "j", **args), _config(csv, 4),
                    model_config())
    # params, masks and moments come back transposed and bitwise equal
    _assert_same_state(port, ref)
    assert port.params["encoder.layers.0.fc1.weight"].shape == (128, 64)
    assert port.masks["encoder.layers.1.self_attn.q_proj.weight"].shape == (
        64, 64)
    assert port._applied_lr() == pytest.approx(ref._applied_lr(), rel=1e-7)
    assert port._opt_treedef == state["opt_treedef"] is not None


def test_schedule_offset_resyncs_as_in_jax(jax_run, tmp_path):
    # a checkpoint whose Adam count (4) lags its Step (9), as after a reset
    csv, ckpt = jax_run
    args = dict(initial_weight=ckpt, init_optimizer_from_initial_weight=True)
    ref = JaxRunner(make_args(tmp_path / "j0", **args), _config(csv, 12),
                    model_config())
    lagging = str(tmp_path / "lagging.npz")
    meta = dict(jax_load_checkpoint(ckpt)["meta"], Step=9)
    jax_save_checkpoint(lagging, ref.params, opt_state=ref.opt_state,
                        masks=ref.masks, meta=meta)
    args["initial_weight"] = lagging
    ref = JaxRunner(make_args(tmp_path / "j", **args), _config(csv, 12),
                    model_config())
    port = Runner(make_args(tmp_path / "p", **args), _config(csv, 12),
                  model_config())
    assert port._sched_offset == ref._sched_offset == 5
    assert port._applied_lr() == pytest.approx(ref._applied_lr(), rel=1e-7)
    # the schedule at the global step 9: past the warmup of 5, decaying
    # linearly to 0 at the run's 12 steps
    assert port._applied_lr() == pytest.approx(1e-4 * 3 / 7, rel=1e-6)
    fresh = Runner(make_args(tmp_path / "f", initial_weight=lagging),
                   _config(csv, 12), model_config())
    assert fresh._sched_offset == 0 and int(fresh.opt_state[0]) == 0


def test_optimizer_reset_keeps_the_schedule_on_the_global_step(jax_run,
                                                                tmp_path):
    # a structured prune event's reset: fresh moments, the schedule offset
    # by the global step so the lr does not re-warm (JAX _reset_optimizer)
    csv, ckpt = jax_run
    args = dict(initial_weight=ckpt, init_optimizer_from_initial_weight=True)
    port = Runner(make_args(tmp_path / "p", **args), _config(csv, 12),
                  model_config())
    ref = JaxRunner(make_args(tmp_path / "j", **args), _config(csv, 12),
                    model_config())
    for runner in (port, ref):
        runner._reset_optimizer(7)
    assert port._sched_offset == ref._sched_offset == 7
    assert int(port.opt_state[0]) == _jax_moments(ref)[0] == 0
    assert not any(bool(m.any()) for m in port.opt_state[1:])
    # the schedule at count 3 reads the global step 10
    port.opt_state[0].fill_(3)
    assert port._applied_lr() == pytest.approx(1e-4 * 2 / 7, rel=1e-6)


def test_port_checkpoint_resumes_in_jax(jax_run, tmp_path):
    csv, ckpt = jax_run
    port = Runner(make_args(tmp_path / "p", initial_weight=ckpt,
                            init_optimizer_from_initial_weight=True),
                  _config(csv, 4), model_config())
    port.train()  # the second event (0.4) fires at step 2
    out = str(tmp_path / "p" / "last-step.npz")
    assert port.wp_state.pruning_times == 2
    ref = JaxRunner(make_args(tmp_path / "j", initial_weight=out,
                              init_optimizer_from_initial_weight=True),
                    _config(csv, 4), model_config())
    _assert_same_state(port, ref)
    assert _jax_moments(ref)[0] == 4 + 4
    assert jwp.sparsity_of(ref.masks) == pytest.approx(0.4, abs=1e-5)


def _one_update(runner, batch, mask):
    step = runner.grad_step
    loss, grads, _ = step(runner.params, batch, torch.Generator(),
                          mask_indices=mask, masks=runner.masks)
    runner.apply(grads, 1.0)
    return float(loss)


def test_one_update_from_the_restored_state_is_bitwise_the_same(tmp_path):
    csv = make_dataset(tmp_path)
    start = start_checkpoint(tmp_path)
    rc = _config(csv, 4, prune=dict(_config(csv, 4)["prune"], warnup=0))
    first = Runner(make_args(tmp_path / "a", initial_weight=start), rc,
                   model_config())
    first.train()
    resumed = Runner(make_args(
        tmp_path / "b", initial_weight=str(tmp_path / "a" / "last-step.npz"),
        init_optimizer_from_initial_weight=True), rc, model_config())
    for a, b in zip(first.opt_state, resumed.opt_state):
        assert torch.equal(a, b)
    assert all(torch.equal(first.masks[k], resumed.masks[k])
               for k in first.masks)
    batch = first._device_batch(first._get_dataloader().get_batch(0))
    mask = torch.zeros(batch["feat"].shape[:2], dtype=torch.bool)
    mask[:, 3:9] = True
    losses = [_one_update(r, batch, mask) for r in (first, resumed)]
    assert losses[0] == losses[1]
    for k in first.params:
        assert torch.equal(first.params[k], resumed.params[k]), k
    for a, b in zip(first.opt_state, resumed.opt_state):
        assert torch.equal(a, b)


def test_optimizer_restore_refuses_a_state_that_does_not_match(jax_run,
                                                                tmp_path):
    csv, ckpt = jax_run
    port = Runner(make_args(tmp_path / "p", initial_weight=ckpt),
                  _config(csv, 4), model_config())
    state = load_checkpoint(ckpt)
    leaves, treedef = state["opt_leaves"], state["opt_treedef"]
    names = list(port.params)
    template = jax_tree_from_named(port.params)

    def restore(opt_leaves, saved_treedef=treedef):
        return restore_opt_state(port.opt_state, names, template, opt_leaves,
                                 params_to_state_dict, saved_treedef)

    restored = restore(leaves)
    assert int(restored[0]) == 4 and len(restored) == len(port.opt_state)
    assert load_checkpoint(ckpt, load_opt=False)["opt_leaves"] == []
    with pytest.raises(ValueError, match="mismatch"):
        restore(leaves[:-1])
    with pytest.raises(ValueError, match="mismatch"):
        restore(leaves + [leaves[-1]])
    swapped = list(leaves)
    i = next(i for i, leaf in enumerate(leaves) if np.ndim(leaf) == 2
             and leaf.shape[0] != leaf.shape[1])
    swapped[i] = leaves[i].T
    with pytest.raises(ValueError, match="shape"):
        restore(swapped)
    with pytest.raises(ValueError, match="structure differs"):
        restore(leaves, treedef.replace("ScaleByAdamState", "ScaleByLion"))


def test_oom_drops_the_window_as_jax_does(tmp_path):
    csv = make_dataset(tmp_path)
    rc = runner_config(csv, total_steps=2, warnup=0, period=1, n_iters=1,
                       accum=2)
    del rc["prune"]
    seen = {}
    for name, cls, apply_attr, error in (
            ("jax", JaxRunner, "apply_step",
             RuntimeError("RESOURCE_EXHAUSTED: out of memory")),
            ("port", Runner, "apply",
             torch.cuda.OutOfMemoryError("CUDA out of memory"))):
        runner = cls(make_args(tmp_path / name, mode="melhubert"), rc,
                     model_config())
        calls, sizes = [], []
        grad_step, apply = runner.grad_step, getattr(runner, apply_attr)

        def failing(*a, _step=grad_step, _error=error, **kw):
            calls.append(1)
            if len(calls) == 2:  # the second micro-batch of the first window
                raise _error
            return _step(*a, **kw)

        def recording(*a, _apply=apply, **kw):
            sizes.append(float(a[-1]))
            return _apply(*a, **kw)

        runner.grad_step = failing
        setattr(runner, apply_attr, recording)
        runner.train()
        seen[name] = (len(calls), sizes)
    assert seen["port"] == seen["jax"] == (6, [2.0, 2.0])
    with pytest.raises(ValueError):  # any other error still raises
        runner = Runner(make_args(tmp_path / "e", mode="melhubert"), rc,
                        model_config())
        runner.grad_step = lambda *a, **kw: (_ for _ in ()).throw(
            ValueError("not an OOM"))
        runner.train()


def test_hubert_npz_initialises_the_wave_runner(tmp_path, capsys):
    data = make_wav_dataset(tmp_path / "data", n_utts=6)
    (tmp_path / "model.yaml").write_text(HUBERT_MODEL_YAML)
    (tmp_path / "runner.yaml").write_text(
        HUBERT_RUNNER_YAML.format(data=data))
    upstream = read_yaml(tmp_path / "model.yaml")
    runner_cfg = read_yaml(tmp_path / "runner.yaml")
    jcfg = jconfigs.HuBERTConfig.from_dict(upstream["hubert"])
    params = jax.tree.map(np.asarray, jhubert.init_hubert_params(
        jax.random.PRNGKey(2), jcfg, N_CLASSES))
    masks = jwp.global_magnitude_prune(params, 0.3)
    opt = jsteps.make_optimizer_from_config(runner_cfg)
    meta = {"Config": jcfg.to_dict(), "Upstream_Config": upstream, "Step": 0}
    with_opt, bare = str(tmp_path / "with_opt.npz"), str(tmp_path / "bare.npz")
    jax_save_checkpoint(with_opt, params, opt_state=opt.init(params),
                        masks=masks, meta=meta)
    jax_save_checkpoint(bare, params, meta=meta)

    def wave_args(expdir, path, restore):
        return types.SimpleNamespace(
            mode="melhubert", upstream="hubert", expdir=str(expdir),
            initial_weight=path, init_optimizer_from_initial_weight=restore,
            seed=0, device="cpu")

    runner = WaveRunner(wave_args(tmp_path / "a", with_opt, True), runner_cfg,
                        upstream)
    assert _same_tree(wave_tree_from_named(runner.params, "hubert"), params)
    assert _same_tree(masks_tree(runner.masks), masks)
    assert "Loaded optimizer state" in capsys.readouterr().out
    runner.train()  # trains on at the checkpoint's sparsity
    saved = load_checkpoint(str(tmp_path / "a" / "last-step.npz"))
    assert _same_tree(saved["masks"], masks)
    assert int(saved["opt_leaves"][0]) == 2
    # from fresh moments, masked entries get zero gradients and so no
    # update at all; the kept ones move
    got = saved["params"]["encoder"]["layers"][0]["fc1"]["kernel"]
    was = params["encoder"]["layers"][0]["fc1"]["kernel"]
    m = masks["layer_0"]["fc1"]["kernel"] > 0
    assert (~m).any() and np.array_equal(got[~m], was[~m])
    assert not np.array_equal(got[m], was[m])
    WaveRunner(wave_args(tmp_path / "b", bare, True), runner_cfg, upstream)
    assert "WARNING" in capsys.readouterr().out
