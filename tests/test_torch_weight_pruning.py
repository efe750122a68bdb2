"""The port's weight pruning against the JAX package: the global magnitude
masks (bitwise, ties included, on the JAX-layout view of the port's
weights), the schedules, the convergence gate over a fixed loss sequence,
the masked grad step, and the two trainers' prune events run from one
checkpoint. Tiny widths, inputs from numpy seeds, on the CPU."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.compress import schedule as jschedule
from speech_ssl_compression_tpu.compress import weight_pruning as jwp
from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.ops.masking import compute_span_mask
from speech_ssl_compression_tpu.train import steps as jsteps
from speech_ssl_compression_tpu.train.runner import Runner as JaxRunner
from speech_ssl_compression_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu_torch.compress import schedule as tschedule
from speech_ssl_compression_tpu_torch.compress import weight_pruning as twp
from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig as PortConfig,
)
from speech_ssl_compression_tpu_torch.train import steps as tsteps
from speech_ssl_compression_tpu_torch.train.runner import Runner
from speech_ssl_compression_tpu_torch.utils.checkpoint import tree_leaves
from speech_ssl_compression_tpu_torch.utils.weights import (
    jax_tree_from_named,
    load_model,
    masks_tree,
    named_masks,
    prunable_names,
    prunable_tree,
    state_dict_from_jax_params,
)

GRAD_BAR = 1e-4  # loss and each gradient, rel. L2
TINY = dict(feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=64,
            encoder_ffn_embed_dim=128, encoder_attention_heads=4, head_dim=16,
            conv_pos=16, conv_pos_groups=4, num_cluster=10, mask_prob=0.65,
            mask_length=4, dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0)


def _params(seed=0, quantum=None):
    """JAX-layout numpy params of the tiny model; with ``quantum`` every
    weight is rounded to a multiple of it, so magnitudes tie across
    leaves (the biases, zero at init, tie already)."""
    cfg = MelHuBERTConfig.from_dict(TINY)
    params = jax.tree.map(np.asarray,
                          init_melhubert_params(jax.random.PRNGKey(seed), cfg))
    if quantum:
        params = jax.tree.map(
            lambda a: (np.round(a / quantum) * quantum).astype(np.float32),
            params)
    return cfg, params


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(jax.tree.map(np.asarray, b))
    assert len(la) == len(lb)
    return all(np.array_equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------------------------------ masks

@pytest.mark.parametrize("amount", [0.0, 0.3, 0.7])
@pytest.mark.parametrize("quantum", [None, 0.01])
def test_global_magnitude_prune_matches_jax_bitwise(quantum, amount):
    _, params = _params(seed=1, quantum=quantum)
    want = jwp.global_magnitude_prune(params, amount)
    got = twp.global_magnitude_prune(params, amount)
    assert _equal_trees(got, want)
    n = sum(m.size for m in tree_leaves(got))
    assert n - sum(int(m.sum()) for m in tree_leaves(got)) == round(amount * n)


def test_prune_event_on_named_tensors_ranks_ties_in_jax_layout():
    # the trainer's masters are (out, in): prune_event must still give
    # JAX's masks where magnitudes tie across and within leaves
    _, params = _params(seed=2, quantum=0.01)
    named = {k: v.clone() for k, v in state_dict_from_jax_params(params).items()}
    masks = named_masks(jwp.init_masks(params), torch.device("cpu"))
    state = twp.WeightPruningState(sparsity=[0.4], prune_condition="always")
    _, masks, status = twp.prune_event(named, masks, state)
    assert status == "pruned" and state.pruning_times == 1
    want = jwp.global_magnitude_prune(params, 0.4)
    assert _equal_trees(masks_tree(masks), want)
    # the control: the same rule on a ravel in the torch layout masks
    # other entries at the ties, so the layout matters for these params
    flipped = {"encoder": {"layers": [
        {mod: {"kernel": np.ascontiguousarray(leaves["kernel"].T),
               "bias": leaves["bias"]} for mod, leaves in layer.items()}
        for layer in prunable_tree(named)["encoder"]["layers"]]}}
    torch_layout = twp.global_magnitude_prune(flipped, 0.4)
    back = jax.tree.map(lambda m: m, torch_layout)
    for layer in back.values():
        for leaves in layer.values():
            leaves["kernel"] = np.ascontiguousarray(leaves["kernel"].T)
    assert not _equal_trees(back, want)


def test_prune_event_folds_in_place_and_respects_the_gate():
    _, params = _params(seed=3)
    named = {k: v.clone() for k, v in state_dict_from_jax_params(params).items()}
    names = prunable_names(named)
    masks = {k: (torch.rand(named[k].shape,
                            generator=torch.Generator().manual_seed(i)) > 0.2
                 ).float() for i, k in enumerate(names)}
    gated = twp.WeightPruningState(sparsity=[0.5], con_tol=0.0)
    gated.smooth_loss, gated.tgt_smooth_loss = 1.0, 2.0  # not converged
    before = {k: v.clone() for k, v in named.items()}
    _, same, status = twp.prune_event(named, masks, gated)
    assert status == "not-converge" and same is masks
    assert all(torch.equal(before[k], named[k]) for k in named)
    state = twp.WeightPruningState(sparsity=[0.5], prune_condition="always")
    folded = jwp.fold_masks(params, masks_tree(masks))
    _, new, _ = twp.prune_event(named, masks, state)
    for k in names:  # folded IN PLACE, the rest untouched
        assert torch.equal(named[k], before[k] * masks[k])
    assert torch.equal(named["final_proj.weight"], before["final_proj.weight"])
    assert _equal_trees(masks_tree(new),
                        jwp.global_magnitude_prune(folded, 0.5))
    assert abs(twp.sparsity_of(new) - 0.5) < 1e-6
    assert twp.sparsity_of(new) == pytest.approx(
        jwp.sparsity_of(masks_tree(new)))


# -------------------------------------------------------------- schedules

def test_schedules_match_jax():
    for sparsity, n in ((0.9, 5), ([0.2, 0.3, 0.45], 3), (0.5, 1)):
        assert (tschedule.sparsity_ladder(sparsity, n)
                == jschedule.sparsity_ladder(sparsity, n))
    for args in ((25000, 25000, 38), (0, 2, 4), (3, 1, 1)):
        assert (list(map(int, tschedule.weight_prune_steps(*args)))
                == list(map(int, jschedule.weight_prune_steps(*args))))
    for args in ((5, 10, 4), ([1, 4, 9], 2, 3)):
        assert (tschedule.set_prune_interval(*args)
                == jschedule.set_prune_interval(*args))
    with pytest.raises(AssertionError):
        tschedule.sparsity_ladder([0.1, 0.2], 3)


@pytest.mark.parametrize("condition", ["converge", "always"])
def test_pruning_state_decisions_match_jax(condition):
    rng = np.random.default_rng(7)
    # a loss that falls, stalls, rises and falls again
    losses = np.concatenate([np.linspace(3.0, 2.0, 40), np.full(20, 2.0),
                             np.linspace(2.0, 2.4, 20),
                             np.linspace(2.4, 1.5, 40)])
    losses = losses + 0.01 * rng.standard_normal(losses.size)
    kw = dict(sparsity=[0.2, 0.4, 0.6], prune_condition=condition,
              smooth_factor=0.9, avg_len=5, con_tol=0.01, warnup=20,
              period=20)
    ours, ref = twp.WeightPruningState(**kw), jwp.WeightPruningState(**kw)
    steps = tschedule.weight_prune_steps(20, 20, 3)
    decisions = []
    for step, loss in enumerate(losses, start=1):
        for s in (ours, ref):
            s.update_smooth_loss(float(loss))
            s.update_target_smooth_loss(step, steps)
        assert ours.to_meta() == ref.to_meta()
        assert ours.converged() == ref.converged()
        if step in steps or step % 17 == 0:
            decisions.append(ours.converged())
            if ours.converged():  # what prune_event does to the state
                for s in (ours, ref):
                    s.pruning_times = min(s.pruning_times + 1, 2)
                    s.smooth_loss, s.buffer_loss = None, []
    if condition == "converge":
        assert False in decisions and True in decisions
    restored = twp.WeightPruningState(**kw)
    restored.load_meta(json.loads(json.dumps(ours.to_meta())))
    assert restored.to_meta() == ours.to_meta()
    assert restored.next_amount() == ref.next_amount()


# ---------------------------------------------------- the masked grad step

def test_masked_grad_step_matches_jax():
    cfg, params = _params(seed=4)
    masks = jwp.global_magnitude_prune(params, 0.5)
    rng = np.random.default_rng(0)
    b, t = 3, 40
    feat = rng.standard_normal((b, t, 80)).astype(np.float32)
    lengths = np.array([40, 27, 12])
    pad = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    label = rng.integers(0, cfg.num_cluster, (b, t)).astype(np.int32)
    label[pad == 0] = -100
    key = jax.random.PRNGKey(5)
    jbatch = {"feat": jnp.asarray(feat), "pad_mask": jnp.asarray(pad),
              "label": jnp.asarray(label)}
    step = jsteps.make_melhubert_grad_step(cfg, accum_steps=2)
    ref_loss, ref_grads, _ = step(params, masks, jbatch, key)
    # the span mask JAX drew inside its step (models/melhubert.py)
    span = compute_span_mask(
        jax.random.split(key)[0], jnp.sum(jnp.asarray(pad), -1).astype(
            jnp.int32), t, mask_prob=cfg.mask_prob,
        mask_length=cfg.mask_length, mask_selection=cfg.mask_selection,
        mask_other=cfg.mask_other, min_masks=2, no_overlap=cfg.no_mask_overlap,
        min_space=cfg.mask_min_space, require_same_masks=False)

    model = load_model(params, PortConfig.from_dict(cfg.to_dict()))
    named = dict(model.named_parameters())
    tmasks = named_masks(masks, torch.device("cpu"))
    ours = tsteps.make_melhubert_grad_step(model, accum_steps=2)
    batch = {"feat": torch.from_numpy(feat), "pad_mask": torch.from_numpy(pad),
             "label": torch.from_numpy(label).long(), "length": lengths}
    loss, grads, _ = ours(named, batch, torch.Generator(),
                          mask_indices=torch.from_numpy(np.array(span)),
                          masks=tmasks)
    assert abs(float(loss) - float(ref_loss)) / float(ref_loss) < GRAD_BAR
    got_named = dict(zip(named, grads))
    for name, m in tmasks.items():  # masked gradients are exactly zero
        assert bool((got_named[name][m == 0] == 0).all()), name
    for (i, mod, leaf), m in jwp.iter_prunable_leaves(
            {"encoder": {"layers": [masks[f"layer_{i}"] for i in
                                    range(cfg.encoder_layers)]}}):
        g = np.asarray(ref_grads["encoder"]["layers"][i][mod][leaf])
        assert (g[np.asarray(m) == 0] == 0).all()
    got = tree_leaves(jax_tree_from_named(got_named))
    ref = tree_leaves(jax.tree.map(np.asarray, ref_grads))
    total = np.sqrt(sum(float(np.sum(np.square(r, dtype=np.float64)))
                        for r in ref))
    for g, r in zip(got, ref):
        err = np.linalg.norm(np.float64(g) - r) / max(np.linalg.norm(r),
                                                       1e-3 * total)
        assert err < GRAD_BAR
    # the masters are not touched, and the forward saw masked weights: the
    # unmasked step differs
    loss_free, _, _ = ours(named, batch, torch.Generator(),
                           mask_indices=torch.from_numpy(np.array(span)))
    assert float(loss_free) != float(loss)


# ------------------------------------------------ the trainers' prune events

def make_dataset(tmp_path, n_utts=8, seed=0):
    """tests/test_runner.py's synthetic CSV set."""
    rng = np.random.default_rng(seed)
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    rows = ["file_path,label_path,length"]
    for i in range(n_utts):
        n = int(rng.integers(30, 60))
        np.save(data / f"feat_{i}.npy",
                rng.standard_normal((n, 40)).astype(np.float32))
        np.save(data / f"label_{i}.npy",
                rng.integers(0, 10, (n,)).astype(np.int64))
        rows.append(f"{data}/feat_{i}.npy,{data}/label_{i}.npy,{n}")
    csv = tmp_path / "train.csv"
    csv.write_text("\n".join(rows) + "\n")
    return str(csv)


def runner_config(csv, total_steps, warnup, period, n_iters, accum=1):
    return {
        "runner": {"n_epochs": 0, "total_steps": total_steps,
                   "gradient_clipping": 10.0,
                   "gradient_accumulate_steps": accum, "log_step": 2,
                   "save_every_x_epochs": 100, "bf16": False},
        "optimizer": {"lr": 1.0e-4, "betas": [0.9, 0.999], "eps": 1.0e-8,
                      "weight_decay": 0},
        "datarc": {"num_workers": 0, "train_batch_size": 2,
                   "max_timestep": 0, "sets": [csv]},
        "prune": {"pruning_condition": "always",
                  "strategy": "L1Unstructured", "n_iters": n_iters,
                  "warnup": warnup, "period": period, "average_length": 1,
                  "converge_loss_tolerance": 0.001,
                  "sparsity": [0.2, 0.4, 0.6][:n_iters]},
    }


def model_config():
    return {"melhubert": dict(TINY), "task": {"sequence_length": 0}}


def make_args(expdir, mode="weight-pruning", **kw):
    args = types.SimpleNamespace(
        mode=mode, upstream="melhubert", expdir=str(expdir),
        initial_weight=None, init_optimizer_from_initial_weight=False,
        frame_period=20, seed=0, device="cpu")
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def start_checkpoint(tmp_path, quantum=0.01):
    """A pre-trained start: JAX-layout params with ties, as the JAX
    package's npz."""
    cfg, params = _params(seed=6, quantum=quantum)
    path = str(tmp_path / "start.npz")
    jax_save_checkpoint(path, params, meta={
        "Upstream_Config": model_config(), "Step": 0})
    return path


class _FakeWriter:
    """tensorboardX.SummaryWriter stand-in that records its scalars."""

    records: list = []

    def __init__(self, logdir):
        self.logdir = logdir

    def add_scalar(self, tag, value, global_step=None):
        _FakeWriter.records.append((tag, global_step))

    def close(self):
        pass


def test_runners_prune_the_same_masks_from_one_checkpoint(tmp_path,
                                                           monkeypatch):
    # warnup 0: the first event fires before any update, on the
    # checkpoint's weights, so both trainers must give the same masks; the
    # TensorBoard tags are JAX's
    monkeypatch.setitem(sys.modules, "tensorboardX",
                        types.SimpleNamespace(SummaryWriter=_FakeWriter))
    csv = make_dataset(tmp_path)
    start = start_checkpoint(tmp_path)
    rc = runner_config(csv, total_steps=2, warnup=0, period=2, n_iters=1)
    runs = {}
    for name, cls in (("jax", JaxRunner), ("port", Runner)):
        _FakeWriter.records = []
        runner = cls(make_args(tmp_path / name, initial_weight=start), rc,
                     model_config())
        runner.train()
        runs[name] = (runner, sorted(os.listdir(tmp_path / name)),
                      list(_FakeWriter.records))
    (jr, jfiles, jtags), (tr, tfiles, ttags) = runs["jax"], runs["port"]
    assert _equal_trees(masks_tree(tr.masks), jr.masks)
    assert twp.sparsity_of(tr.masks) == pytest.approx(0.2, abs=1e-5)
    assert [f for f in tfiles if f.endswith(".npz")] == [
        f for f in jfiles if f.endswith(".npz")] == [
        "before-pruning-states-0-sparsity-0.npz", "last-step.npz"]
    assert ttags == jtags and ("weight-pruning/train-loss", 2) in ttags
    assert tr.wp_state.to_meta() == jr.wp_state.to_meta()


def test_prune_events_fire_at_jax_steps(tmp_path):
    # an event at step N fires after exactly N updates, with JAX's
    # artifact names and meta (tests/test_runner.py)
    csv = make_dataset(tmp_path)
    start = start_checkpoint(tmp_path)
    rc = runner_config(csv, total_steps=6, warnup=2, period=2, n_iters=2)
    fired, metas = {}, {}
    for name, cls, apply_attr in (("jax", JaxRunner, "apply_step"),
                                  ("port", Runner, "apply")):
        runner = cls(make_args(tmp_path / name, initial_weight=start), rc,
                     model_config())
        applied = {"n": 0}
        events = []
        orig_apply, orig_hook = getattr(runner, apply_attr), runner._prune_hook

        def counting(*a, _orig=orig_apply, **kw):
            applied["n"] += 1
            return _orig(*a, **kw)

        def spy(global_step, pbar, _runner=runner, _orig=orig_hook):
            if global_step in _runner.prune_steps:
                events.append((global_step, applied["n"]))
            return _orig(global_step, pbar)

        setattr(runner, apply_attr, counting)
        runner._prune_hook = spy
        runner.train()
        fired[name] = events
        files = sorted(f for f in os.listdir(tmp_path / name)
                       if f.endswith(".npz"))
        metas[name] = (files, {f: {k: v for k, v in json.load(open(
            tmp_path / name / (f + ".json"))).items()
            if k in ("Step", "TotalStep", "Pruning")} for f in files})
    assert fired["port"] == fired["jax"] == [(2, 2), (4, 4)]
    assert metas["port"] == metas["jax"]
    files, meta = metas["port"]
    assert files == ["before-pruning-states-2-sparsity-0.npz",
                     "last-step.npz",
                     "mask-before-pruning-states-4-sparsity-0.2.npz"]
    assert meta["last-step.npz"]["Pruning"]["pruning_times"] == 2
    assert meta["last-step.npz"]["TotalStep"] == 6
