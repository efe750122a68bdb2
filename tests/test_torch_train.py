"""The port's pre-training slice against the JAX package: span masks, the
pretrain loss and its gradients, the fused apply step, the lr schedule,
the bucketed batches, the YAML reader and the trainer's checkpoints. Inputs
come from numpy seeds and weights through the weight bridge; dropout is off
wherever numbers are compared (the random streams differ by design)."""

import os
import pathlib

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.data.bucket_dataset import (
    MelFeatBuckets as JaxBuckets,
)
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.models.melhubert import (
    melhubert_forward as jax_forward,
    melhubert_pretrain_loss as jax_loss,
)
from speech_ssl_compression_tpu.ops import masking as jmask
from speech_ssl_compression_tpu.train import steps as jsteps
from speech_ssl_compression_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    restore_opt_state,
)
from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig as PortConfig,
    read_yaml,
)
from speech_ssl_compression_tpu_torch.data.bucket_dataset import MelFeatBuckets
from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
from speech_ssl_compression_tpu_torch.models.encoder import encoder_forward
from speech_ssl_compression_tpu_torch.models.melhubert import (
    melhubert_forward,
    span_mask,
)
from speech_ssl_compression_tpu_torch.ops import masking as tmask
from speech_ssl_compression_tpu_torch.train import steps as tsteps
from speech_ssl_compression_tpu_torch.train.__main__ import main as train_main
from speech_ssl_compression_tpu_torch.utils.checkpoint import tree_leaves
from speech_ssl_compression_tpu_torch.utils.weights import (
    jax_tree_from_named,
    load_model,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
LOSS_BAR, GRAD_BAR = 1e-5, 1e-4  # loss rel.; each gradient rel. L2
TINY = dict(feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=128,
            encoder_ffn_embed_dim=256, encoder_attention_heads=2, head_dim=64,
            conv_pos=16, conv_pos_groups=4, num_cluster=32, mask_prob=0.5,
            mask_length=3)


# --------------------------------------------------------------- span masks

MASK_KW = dict(mask_prob=0.65, mask_length=4, mask_other=1.0, min_masks=2)


@pytest.mark.parametrize("no_overlap", [False, True])
@pytest.mark.parametrize("selection", ["static", "uniform", "normal",
                                       "poisson"])
def test_span_mask_matches_jax_bit_for_bit(selection, no_overlap):
    lengths = np.array([120, 97, 40, 120])
    for same, drop in ((False, 0.0), (True, 0.1)):
        kw = dict(MASK_KW, mask_selection=selection, no_overlap=no_overlap,
                  min_space=1, require_same_masks=same, mask_dropout=drop)
        ref = jmask.compute_mask_indices_np(
            (4, 128), lengths, rng=np.random.default_rng(5), **kw)
        got = tmask.compute_mask_indices_np(
            (4, 128), lengths, rng=np.random.default_rng(5), **kw)
        np.testing.assert_array_equal(got, ref)
        assert got[:, 120:].sum() == 0 and got.any()


def test_span_mask_without_lengths_shares_one_count():
    kw = dict(MASK_KW, mask_selection="static")
    ref = jmask.compute_mask_indices_np((3, 64), None,
                                        rng=np.random.default_rng(1), **kw)
    got = tmask.compute_mask_indices_np((3, 64), None,
                                        rng=np.random.default_rng(1), **kw)
    np.testing.assert_array_equal(got, ref)


def test_model_span_mask_uses_jax_model_arguments():
    # melhubert_forward (JAX) passes min_masks=2 and require_same_masks=False
    cfg = MelHuBERTConfig.from_dict(dict(TINY, mask_prob=0.02))
    lengths = np.array([60, 20])
    got = span_mask(_port(cfg), lengths, 64, np.random.default_rng(0))
    ref = jmask.compute_mask_indices_np(
        (2, 64), lengths, mask_prob=0.02, mask_length=3, min_masks=2,
        mask_selection="static", require_same_masks=False, min_space=1,
        rng=np.random.default_rng(0))
    np.testing.assert_array_equal(got, ref)
    assert (got.sum(axis=1) >= 2).all()  # min_masks engaged per row


# ------------------------------------------------- pretrain loss and grads

def _port(cfg):
    """The port's own config for a JAX one (the two classes differ)."""
    return PortConfig.from_dict(cfg.to_dict())


def _cfg(variant):
    if variant == "post_ln":
        return MelHuBERTConfig.from_dict(TINY)
    if variant == "pre_ln_mask_emb":
        return MelHuBERTConfig.from_dict(dict(
            TINY, layer_norm_first=True, learnable_mask_emb=True,
            mask_before_proj=False, skip_nomask=False,
            pred_nomask_weight=0.5))
    # head- and row-pruned
    return MelHuBERTConfig.from_dict(TINY).with_heads((2, 1)).with_ffn_dims(
        (256, 96))


def _batch(cfg, seed=0, b=3, t=40):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, t, 80)).astype(np.float32)
    lengths = np.array([t, 25, 9])[:b]
    pad = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    label = rng.integers(0, cfg.num_cluster, (b, t)).astype(np.int32)
    label[pad == 0] = -100
    mask = span_mask(_port(cfg), lengths, t, np.random.default_rng(seed + 1))
    return feat, pad, label, lengths, mask


def grad_errors(names, got, ref):
    """rel. L2 per gradient. The k_proj biases' gradients are zero up to
    rounding (softmax is invariant to a shift of a row's scores), so
    theirs is taken against the norm of all gradients."""
    total = np.sqrt(sum(float(np.sum(np.square(r, dtype=np.float64)))
                        for r in ref))
    out = []
    for n, g, r in zip(names, got, ref):
        den = total if n.endswith("k_proj/bias") else np.linalg.norm(r)
        out.append(np.linalg.norm(np.float64(g) - r) / den)
    return out


def _paths(tree):
    flat = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{prefix}/[{i}]")
        else:
            flat[prefix] = t

    walk(tree, "")
    return list(flat)


@pytest.mark.parametrize("attn_impl", ["auto", "dense"])
@pytest.mark.parametrize("variant", ["post_ln", "pre_ln_mask_emb", "pruned"])
def test_pretrain_loss_and_grads_match_jax(variant, attn_impl):
    cfg = _cfg(variant)
    params = jax.tree.map(np.asarray,
                          init_melhubert_params(jax.random.PRNGKey(3), cfg))
    feat, pad, label, lengths, mask = _batch(cfg)

    def loss_fn(p):
        out = jax_forward(p, cfg, jnp.asarray(feat), jnp.asarray(pad),
                          mask=True, teacher_mask_indices=jnp.asarray(mask),
                          deterministic=True, attn_impl="dense")
        return jax_loss(out, jnp.asarray(label), jnp.asarray(pad), cfg)[0]

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    model = load_model(params, _port(cfg))
    step = tsteps.make_melhubert_grad_step(model, attn_impl=attn_impl,
                                           deterministic=True)
    named = dict(model.named_parameters())
    batch = {"feat": torch.from_numpy(feat), "pad_mask": torch.from_numpy(pad),
             "label": torch.from_numpy(label).long(), "length": lengths}
    loss, grads, logs = step(named, batch, torch.Generator(),
                             mask_indices=torch.from_numpy(mask))
    assert abs(float(loss) - float(ref_loss)) / float(ref_loss) < LOSS_BAR
    assert int(logs["n_masked"]) == int((mask & (pad > 0)).sum())
    got = tree_leaves(jax_tree_from_named(dict(zip(named, grads))))
    ref = [np.asarray(g) for g in tree_leaves(jax.tree.map(np.asarray,
                                                             ref_grads))]
    names = _paths(params)
    assert len(got) == len(ref) == len(names)
    errs = grad_errors(names, got, ref)
    worst = int(np.argmax(errs))
    assert errs[worst] < GRAD_BAR, (names[worst], errs[worst])


def test_grad_step_draws_its_mask_from_the_host_lengths():
    cfg = _cfg("post_ln")
    model = load_model(jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(4), cfg)), _port(cfg))
    feat, pad, label, lengths, _ = _batch(cfg, seed=2)
    batch = {"feat": torch.from_numpy(feat), "pad_mask": torch.from_numpy(pad),
             "label": torch.from_numpy(label).long(), "length": lengths}
    step = tsteps.make_melhubert_grad_step(model, accum_steps=4)
    named = dict(model.named_parameters())
    a = step(named, batch, torch.Generator().manual_seed(1))
    b = step(named, batch, torch.Generator().manual_seed(1))
    c = step(named, batch, torch.Generator().manual_seed(2))
    assert float(a[0]) == float(b[0]) and float(a[0]) != float(c[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert int(a[2]["n_masked"]) > 0


def test_grad_step_returns_nothing_that_holds_the_masters():
    # a prune event replaces the masters between two steps: no output of
    # the step may keep the old ones alive through the autograd graph
    import gc
    import weakref

    cfg = _cfg("post_ln")
    model = load_model(jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(4), cfg)), _port(cfg))
    feat, pad, label, lengths, _ = _batch(cfg, seed=2)
    batch = {"feat": torch.from_numpy(feat), "pad_mask": torch.from_numpy(pad),
             "label": torch.from_numpy(label).long(), "length": lengths}
    step = tsteps.make_melhubert_grad_step(model)
    named = {k: v.detach().clone().requires_grad_() for k, v in
             model.named_parameters()}
    loss, grads, logs = step(named, batch, torch.Generator().manual_seed(1))
    assert not loss.requires_grad and logs
    assert not any(v.requires_grad for v in logs.values())
    ref = weakref.ref(named["encoder.layers.0.self_attn.q_proj.weight"])
    del named, grads
    gc.collect()
    assert ref() is None


def test_fixed_batch_loss_falls():
    cfg = _cfg("post_ln")
    model = load_model(jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(5), cfg)), _port(cfg))
    feat, pad, label, lengths, mask = _batch(cfg, seed=3)
    batch = {"feat": torch.from_numpy(feat), "pad_mask": torch.from_numpy(pad),
             "label": torch.from_numpy(label).long(), "length": lengths}
    named = dict(model.named_parameters())
    params = list(named.values())
    step = tsteps.make_melhubert_grad_step(model)
    hyper = tsteps.make_optimizer(lr=1e-3)
    state = tsteps.init_opt_state(params)
    rng = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(8):
        loss, grads, _ = step(named, batch, rng,
                              mask_indices=torch.from_numpy(mask))
        tsteps.fused_apply(hyper, params, state, grads, 1.0)
        losses.append(float(loss))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert int(state[0]) == 8


# ----------------------------------------------------- training forward

def _enc_model(**over):
    cfg = MelHuBERTConfig.from_dict({**TINY, "dropout": 0.1,
                                     "attention_dropout": 0.1,
                                     "activation_dropout": 0.1, **over})
    params = jax.tree.map(np.asarray,
                          init_melhubert_params(jax.random.PRNGKey(6), cfg))
    return load_model(params, _port(cfg)), _port(cfg)


def test_training_forward_dropout_is_seeded_and_off_when_deterministic():
    model, cfg = _enc_model()
    x = torch.randn(2, 30, 128, generator=torch.Generator().manual_seed(0))
    pad = torch.zeros(2, 30, dtype=torch.bool)
    pad[1, 20:] = True
    with torch.no_grad():
        ref, _ = encoder_forward(x, model.encoder, cfg, padding_mask=pad)
        det, _ = encoder_forward(x, model.encoder, cfg, padding_mask=pad,
                                 rng=torch.Generator(), deterministic=True)
        a, _ = encoder_forward(x, model.encoder, cfg, padding_mask=pad,
                               rng=torch.Generator().manual_seed(1),
                               deterministic=False)
        b, _ = encoder_forward(x, model.encoder, cfg, padding_mask=pad,
                               rng=torch.Generator().manual_seed(1),
                               deterministic=False)
    assert torch.equal(ref, det)
    assert torch.equal(a, b) and not torch.allclose(a, ref)
    with pytest.raises(ValueError, match="rng"):
        encoder_forward(x, model.encoder, cfg, deterministic=False)


def test_layerdrop_skips_whole_layers():
    model, cfg = _enc_model(encoder_layerdrop=1.0, dropout=0.0,
                            attention_dropout=0.0, activation_dropout=0.0)
    x = torch.randn(1, 20, 128)
    with torch.no_grad():
        out, hiddens = encoder_forward(
            x, model.encoder, cfg, get_hidden=True,
            rng=torch.Generator().manual_seed(0), deterministic=False)
    # every layer dropped: the prologue's output passes through
    assert len(hiddens) == 2 and torch.equal(hiddens[0], hiddens[1])
    assert torch.equal(out, hiddens[1])


def test_mask_emb_replaces_masked_frames():
    model, cfg = _enc_model(learnable_mask_emb=True, mask_before_proj=True)
    feat = torch.randn(1, 12, 80)
    mask = torch.zeros(1, 12, dtype=torch.bool)
    mask[0, 3:6] = True
    with torch.no_grad():
        out = melhubert_forward(model, feat, torch.ones(1, 12), mask=True,
                                teacher_mask_indices=mask)
        ref = model.pre_extract_proj(
            torch.where(mask[..., None], model.mask_emb, feat))
    assert torch.equal(out["mask_indices"], mask)
    torch.testing.assert_close(out["pre_feat"], ref)


# -------------------------------------------------------------- apply step

def _apply_trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {"b": rng.standard_normal(3).astype(np.float32),
              "w": rng.standard_normal((4, 3)).astype(np.float32),
              "layers": [{"k": rng.standard_normal((2, 5)).astype(np.float32)}]}
    grads = [jax.tree.map(lambda p, s=s: (s * rng.standard_normal(p.shape))
                          .astype(np.float32), params) for s in (40.0, 1, 0.5)]
    grads[1]["w"][1, 2] = np.nan  # the second update is skipped
    return params, grads


def test_fused_apply_matches_jax_over_three_steps():
    params, grads = _apply_trees()
    sched_kw = dict(warmup_updates=2, total_num_update=10,
                    end_learning_rate=1e-5, power=1.0)
    hyper_kw = dict(lr=1e-2, betas=(0.9, 0.98), eps=1e-6, weight_decay=0.01,
                    gradient_clipping=1.0)
    jopt = jsteps.make_optimizer(
        lr_schedule=jsteps.polynomial_decay_schedule(1e-2, **sched_kw),
        **hyper_kw)
    topt = tsteps.make_optimizer(
        lr_schedule=tsteps.polynomial_decay_schedule(1e-2, **sched_kw),
        **hyper_kw)
    jp, jstate = params, jopt.init(params)
    tp = [torch.tensor(a) for a in jax.tree.leaves(params)]
    tstate = tsteps.init_opt_state(tp)
    for i, g in enumerate(grads):
        jp, jstate, jnorm = jsteps._fused_apply(jopt.hyper, jp, jstate, g,
                                                np.float32(2.0))
        tnorm = tsteps.fused_apply(topt, tp, tstate,
                                   [torch.tensor(a) for a in jax.tree.leaves(g)],
                                   2.0)
        if i == 0:
            assert float(jnorm) > 1.0  # the clip engaged
        if i == 1:
            assert not np.isfinite(float(tnorm)) and int(tstate[0]) == 1
        else:
            np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        jleaves = jax.tree.leaves(jstate)
        assert int(tstate[0]) == int(jleaves[0])
        for a, b in zip(tp + tstate[1:], jax.tree.leaves(jp) + jleaves[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                       atol=1e-9)
    assert int(tstate[0]) == 2


def test_count_increment_saturates():
    p = [torch.ones(2)]
    state = tsteps.init_opt_state(p)
    state[0].fill_(2**31 - 1)
    tsteps.fused_apply(tsteps.make_optimizer(), p, state,
                       [torch.ones(2)], 1.0)
    assert int(state[0]) == 2**31 - 1


def test_accumulate_grads_adds_in_place():
    a = [torch.ones(3), torch.zeros(2)]
    assert tsteps.accumulate_grads(None, a) is a
    out = tsteps.accumulate_grads(a, [torch.ones(3), torch.ones(2)])
    assert out is a and float(a[0][0]) == 2.0 and float(a[1][1]) == 1.0


# ------------------------------------------------------- lr schedule, betas

@pytest.mark.parametrize("kw", [
    dict(warmup_updates=3),
    dict(warmup_updates=2, total_num_update=8, end_learning_rate=1e-5),
    dict(total_num_update=6, power=2.0),
])
def test_schedule_matches_jax(kw):
    j = jsteps.polynomial_decay_schedule(5e-4, **kw)
    t = tsteps.polynomial_decay_schedule(5e-4, **kw)
    for n in range(0, 12):
        np.testing.assert_allclose(float(t(n)), float(j(n)), rtol=1e-6)


def test_lr_schedule_from_runner_config():
    rc = {"runner": {"total_steps": -1}, "lr_scheduler": {"warmup_updates": 2}}
    sched = tsteps.build_lr_schedule(rc, 1e-3)
    assert sched.needs_total
    assert tsteps.build_lr_schedule({"runner": {}}, 1e-3) is None
    opt = tsteps.make_optimizer_from_config(dict(rc, optimizer={"lr": 1e-3}),
                                            total_steps=10)
    assert not opt["schedule"].needs_total
    assert tsteps.parse_betas("(0.9,0.98)") == (0.9, 0.98)
    assert tsteps.parse_betas([0.9, 0.999]) == (0.9, 0.999)
    # a callable lr is JAX's generic path; with a schedule too it raises
    with pytest.raises(ValueError, match="not both"):
        tsteps.make_optimizer(lr=lambda n: 1e-3, lr_schedule=sched)


# ------------------------------------------------------------- YAML reader

YAMLS = sorted(str(p.relative_to(REPO))
               for p in REPO.glob("configs/**/*.yaml"))


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_reader_matches_safe_load(path):
    with open(REPO / path) as f:
        assert read_yaml(REPO / path) == yaml.safe_load(f)


def test_yaml_reader_scalars_and_refusals(tmp_path):
    p = tmp_path / "a.yaml"
    p.write_text("a:\n  b: 1e-4  # a string in YAML 1.1\n  c: 1.0e-4\n"
                 "  d: yes\n  e: ~\n  g: 'q # r'\n  h:\n")
    assert read_yaml(p) == yaml.safe_load(p.read_text())
    for bad in ("a:\n  - b: 1\n", "a: &x 1\n", "a: {b: 1}\n", "a: [1]\n"):
        p.write_text(bad)
        with pytest.raises(ValueError):
            read_yaml(p)


# ------------------------------------------------- data and the trainer

def make_dataset(tmp_path, n_utts=8, seed=0, tied=False):
    """A CSV manifest of ``n_utts`` 40-d feature files with labels, of
    distinct lengths, or with ``tied`` of lengths drawn from [40, 46)."""
    rng = np.random.default_rng(seed)
    rows = ["file_path,label_path,length"]
    lengths = (rng.integers(40, 46, n_utts) if tied
               else rng.permutation(np.arange(40, 40 + 3 * n_utts, 3)))
    for i, n in enumerate(lengths):
        fp, lp = tmp_path / f"feat_{i}.npy", tmp_path / f"label_{i}.npy"
        np.save(fp, rng.standard_normal((n, 40)).astype(np.float32))
        np.save(lp, rng.integers(0, 10, (n,)).astype(np.int64))
        rows.append(f"{fp},{lp},{n}")
    csv = tmp_path / "train.csv"
    csv.write_text("\n".join(rows) + "\n")
    return str(csv)


@pytest.mark.parametrize("lengths", ["distinct", "tied"])
def test_buckets_match_jax_batches(tmp_path, lengths):
    if lengths == "distinct":
        csv = make_dataset(tmp_path, n_utts=9)
        kw = dict(bucket_size=2, max_timestep=-41)
        n_buckets = 4  # 8 kept, a trailing singleton dropped
    else:  # pandas' sort is not stable: tied lengths follow its quicksort
        csv = make_dataset(tmp_path, n_utts=40, seed=3, tied=True)
        kw = dict(bucket_size=4, max_timestep=0)
        n_buckets = 10
    kw.update(frame_period=20, sequence_length=24, sets=[csv], seed=3)
    ours, ref = MelFeatBuckets(**kw), JaxBuckets(**kw)
    assert len(ours) == len(ref) == n_buckets
    assert ours.buckets == [tuple(map(list, b)) for b in ref.buckets]
    for _ in range(2):  # two epochs: the shuffle and crop streams advance
        for a, b in zip(ours.epoch(), ref.epoch()):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


MODEL_YAML = """melhubert:
  feat_emb_dim: 80
  encoder_layers: 2
  encoder_embed_dim: 128
  encoder_ffn_embed_dim: 256
  encoder_attention_heads: 2
  num_cluster: 10
  conv_pos: 16
  conv_pos_groups: 4
  mask_prob: 0.65
  mask_length: 4
  dropout: 0.1
  attention_dropout: 0.1
  activation_dropout: 0.1
task:
  sequence_length: 0
"""

RUNNER_YAML = """runner:
  n_epochs: 0
  total_steps: 2
  gradient_clipping: 10.0
  gradient_accumulate_steps: 2
  log_step: 1
  save_every_x_epochs: 100
  bf16: true
optimizer:
  lr: 1.0e-03
  betas:
  - 0.9
  - 0.999
  eps: 1.0e-08
  weight_decay: 0
datarc:
  train_batch_size: 2
  max_timestep: 0
  sets:
  - {csv}
"""


def test_trainer_writes_checkpoints_jax_reads(tmp_path):
    csv = make_dataset(tmp_path)
    (tmp_path / "model.yaml").write_text(MODEL_YAML)
    (tmp_path / "runner.yaml").write_text(RUNNER_YAML.format(csv=csv))
    exp = tmp_path / "exp"
    runner = train_main(["-m", "melhubert", "-g", str(tmp_path / "model.yaml"),
                         "-c", str(tmp_path / "runner.yaml"), "-n", str(exp),
                         "--device", "cpu", "--seed", "0"])
    assert runner.compute_dtype == torch.float32  # bf16 only on the GPU
    assert [h["step"] for h in runner.log_history] == [1, 2]
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all()
               for h in runner.log_history)
    files = set(os.listdir(exp))
    assert {"last-step.npz", "states-epoch-0.npz", "config_model.yaml",
            "config_runner.yaml"} <= files

    state = jax_load_checkpoint(str(exp / "last-step.npz"))
    assert state["meta"]["Step"] == 2
    cfg = MelHuBERTConfig.from_dict(state["meta"]["Upstream_Config"]
                                    ["melhubert"])
    template = jax.tree.map(np.asarray,
                            init_melhubert_params(jax.random.PRNGKey(0), cfg))
    assert jax.tree.structure(state["params"]) == jax.tree.structure(template)
    opt = jsteps.make_optimizer_from_config(read_yaml(tmp_path / "runner.yaml"))
    restored = restore_opt_state(opt.init(template), state["opt_leaves"])
    leaves = jax.tree.leaves(restored)
    assert int(leaves[0]) == 2  # two updates counted
    # mu of the first layer's q_proj kernel is the port's mu, transposed
    names = list(runner.params)
    n = len(names)
    mu = dict(zip(names, runner.opt_state[1:1 + n]))
    adam = next(s for s in jax.tree.leaves(
        restored, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    jmu = adam.mu
    np.testing.assert_array_equal(
        np.asarray(jmu["encoder"]["layers"][0]["q_proj"]["kernel"]),
        mu["encoder.layers.0.self_attn.q_proj.weight"].numpy().T)
    np.testing.assert_array_equal(
        state["params"]["encoder"]["layers"][1]["fc1"]["kernel"],
        runner.params["encoder.layers.1.fc1.weight"].detach().numpy().T)

    ext = MelHuBERTExtractor(str(exp / "last-step.npz"), device="cpu")
    out = ext.forward([np.random.default_rng(0).standard_normal(8000)
                       .astype(np.float32) * 0.1])
    assert out["last_hidden_state"].shape == (1, 128, 128)
    assert torch.isfinite(out["last_hidden_state"]).all()


def test_trainer_refuses_what_is_not_ported(tmp_path):
    csv = make_dataset(tmp_path)
    (tmp_path / "model.yaml").write_text(MODEL_YAML)
    (tmp_path / "runner.yaml").write_text(RUNNER_YAML.format(csv=csv))
    base = ["-g", str(tmp_path / "model.yaml"), "-c",
            str(tmp_path / "runner.yaml"), "-n", str(tmp_path / "e"),
            "--device", "cpu"]
    # the waveform models' pruning modes are ported
    # (tests/test_torch_wave_pruning.py); their distillation stays refused
    for extra, exc, match in (
            (["-m", "distillation", "-u", "hubert"], NotImplementedError,
             None),
            (["-m", "distillation", "-u", "wav2vec2"], NotImplementedError,
             None),
            # two pipeline stages or two ranks of tensor parallel need two
            # processes (tests/test_torch_pipeline.py,
            # tests/test_torch_parallel.py); one refuses them as JAX's
            # pipeline_mesh and make_mesh do
            (["-m", "melhubert", "--pipeline_parallel", "2"], ValueError,
             "needs 2 ranks"),
            (["-m", "melhubert", "--model_parallel", "2"], ValueError,
             None),
            # JAX's runner takes the pipeline for pre-training alone
            (["-m", "head-pruning", "--pipeline_parallel", "2"],
             NotImplementedError, "melhubert pre-train mode only")):
        with pytest.raises(exc, match=match):
            train_main(base + extra)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_main(base[:-1] + ["cuda", "-m", "melhubert"])


def test_trainer_refuses_a_set_with_no_batch(tmp_path):
    # max_timestep -1000 drops every utterance shorter than 1000 frames:
    # an epoch of no batches, which would otherwise loop forever
    csv = make_dataset(tmp_path)
    (tmp_path / "model.yaml").write_text(MODEL_YAML)
    (tmp_path / "runner.yaml").write_text(
        RUNNER_YAML.format(csv=csv).replace("max_timestep: 0",
                                            "max_timestep: -1000"))
    with pytest.raises(ValueError, match="no batch"):
        train_main(["-m", "melhubert", "-g", str(tmp_path / "model.yaml"),
                    "-c", str(tmp_path / "runner.yaml"), "-n",
                    str(tmp_path / "e"), "--device", "cpu"])


def test_hubert_trainer_refuses_a_set_with_no_batch(tmp_path):
    # min_sample_size past every utterance of the manifest: an epoch of no
    # batches, which would otherwise loop forever
    from test_torch_hubert import (
        MODEL_YAML as HUBERT_MODEL_YAML,
        RUNNER_YAML as HUBERT_RUNNER_YAML,
        make_wav_dataset,
    )

    data = make_wav_dataset(tmp_path / "data")
    (tmp_path / "model.yaml").write_text(HUBERT_MODEL_YAML)
    (tmp_path / "runner.yaml").write_text(
        HUBERT_RUNNER_YAML.format(data=data).replace(
            "min_sample_size: 1000", "min_sample_size: 100000"))
    with pytest.raises(ValueError, match="no batch"):
        train_main(["-m", "melhubert", "-u", "hubert", "-g",
                    str(tmp_path / "model.yaml"), "-c",
                    str(tmp_path / "runner.yaml"), "-n", str(tmp_path / "e"),
                    "--device", "cpu"])
