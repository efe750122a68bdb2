"""The port's knowledge distillation against the JAX package: the KD loss
terms, the student's init from the teacher, the distill grad step's loss,
logs and every student gradient (nomasked through JAX's
``make_distill_grad_step``, masked by replaying one host mask through JAX's
forward and loss), and the trainer's ``-m distillation`` from a teacher
npz JAX wrote: its checkpoint read by JAX as the student and served alike,
its first loss at lr 0 equal to JAX's grad step. Tiny widths, inputs from
numpy seeds, dropout off wherever numbers are compared, on the CPU."""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.compress import distillation as jdist
from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.data.bucket_dataset import (
    MelFeatBuckets as JaxBuckets,
)
from speech_ssl_compression_tpu.extract import (
    MelHuBERTExtractor as JaxExtractor,
    load_any_checkpoint as jax_load_any_checkpoint,
)
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.models.melhubert import (
    melhubert_forward as jax_forward,
)
from speech_ssl_compression_tpu.train import steps as jsteps
from speech_ssl_compression_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu_torch.compress import distillation as tdist
from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig as PortConfig,
)
from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
from speech_ssl_compression_tpu_torch.train import steps as tsteps
from speech_ssl_compression_tpu_torch.train.__main__ import main as train_main
from speech_ssl_compression_tpu_torch.utils.checkpoint import tree_leaves
from speech_ssl_compression_tpu_torch.utils.weights import (
    init_params_np,
    jax_tree_from_named,
    load_model,
)
from test_torch_train import GRAD_BAR, LOSS_BAR, _paths, grad_errors

KD_BAR = 1e-6  # the KD loss terms, rel.
SERVE_BAR = 1e-4  # max |d| / mean |ref| on valid frames
WIDE = dict(feat_emb_dim=80, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
            encoder_attention_heads=2, head_dim=64, conv_pos=16,
            conv_pos_groups=4, num_cluster=32, mask_prob=0.5, mask_length=3,
            dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
TEACHER = dict(WIDE, encoder_layers=3)
STUDENT = dict(WIDE, encoder_layers=2)


def _port(cfg):
    return PortConfig.from_dict(cfg.to_dict())


# ----------------------------------------------------------- KD loss terms

def _loss_inputs(seed=0, b=3, t=24, c=16):
    rng = np.random.default_rng(seed)
    s_logits = (2.0 * rng.standard_normal((b, t, c))).astype(np.float32)
    t_logits = (2.0 * rng.standard_normal((b, t, c))).astype(np.float32)
    lengths = np.array([t, 17, 6])[:b]
    pad = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    labels = rng.integers(0, c, (b, t)).astype(np.int32)
    labels[pad == 0] = -100
    labels[0, 3:6] = -100  # ignored inside valid frames too
    mask = rng.random((b, t)) < 0.5
    return s_logits, t_logits, pad, labels, mask


@pytest.mark.parametrize("loss_type", ["masked", "nomasked"])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("temperature", [1.0, 2.0, 4.0])
def test_kd_losses_match_jax(temperature, alpha, loss_type):
    s_logits, t_logits, pad, labels, mask = _loss_inputs()
    j = lambda a: jnp.asarray(a)
    t = torch.from_numpy
    ref, ref_logs = jdist.distillation_loss(
        {"logits": j(s_logits), "mask_indices": j(mask)},
        {"logits": j(t_logits)}, j(labels), j(pad),
        temperature=temperature, alpha=alpha, loss_type=loss_type)
    got, logs = tdist.distillation_loss(
        {"logits": t(s_logits), "mask_indices": t(mask)},
        {"logits": t(t_logits)}, t(labels).long(), t(pad),
        temperature=temperature, alpha=alpha, loss_type=loss_type)
    select = (pad > 0) & (mask if loss_type == "masked" else ~mask)
    ref_soft = jdist.kd_soft_loss(j(s_logits), j(t_logits), j(select),
                                  temperature)
    soft = tdist.kd_soft_loss(t(s_logits), t(t_logits), t(select),
                              temperature)
    pairs = [(got, ref), (soft, ref_soft)] + [
        (logs[k], ref_logs[k]) for k in ("hard_loss", "soft_loss",
                                         "teacher_loss")]
    for a, b in pairs:
        assert float(b) > 0
        assert abs(float(a) - float(b)) / float(b) < KD_BAR, (a, b)
    with pytest.raises(NotImplementedError):
        tdist.distillation_loss(
            {"logits": t(s_logits), "mask_indices": t(mask)},
            {"logits": t(t_logits)}, t(labels).long(), t(pad),
            temperature=1.0, alpha=1.0, loss_type="both")


# --------------------------------------------------- student from teacher

def _trees(seed=0):
    tcfg = MelHuBERTConfig.from_dict(TEACHER)
    scfg = MelHuBERTConfig.from_dict(dict(STUDENT, learnable_mask_emb=True))
    tparams = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(seed), tcfg))
    sparams = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(seed + 1), scfg))
    return tcfg, scfg, tparams, sparams


def test_init_student_from_teacher_copies_as_jax_without_aliasing():
    _, scfg, tparams, sparams = _trees()
    before = jax.tree.map(np.copy, sparams)
    ref = jax.tree.map(np.asarray, jdist.init_student_from_teacher(
        sparams, tparams, scfg.encoder_layers))
    got = tdist.init_student_from_teacher(sparams, tparams,
                                          scfg.encoder_layers)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    enc, tenc = got["encoder"], tparams["encoder"]
    for a, b in zip(tree_leaves(enc["pos_conv"]),
                    tree_leaves(tenc["pos_conv"])):
        np.testing.assert_array_equal(a, b)
    assert len(enc["layers"]) == scfg.encoder_layers
    for i in range(scfg.encoder_layers):
        for a, b in zip(tree_leaves(enc["layers"][i]),
                        tree_leaves(tenc["layers"][i])):
            np.testing.assert_array_equal(a, b)
    # the rest is the student's own init, and the input tree is untouched
    for key in ("pre_extract_proj", "final_proj", "mask_emb"):
        for a, b in zip(tree_leaves(got[key]), tree_leaves(before[key])):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(enc["layer_norm"]),
                    tree_leaves(before["encoder"]["layer_norm"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(sparams), tree_leaves(before)):
        np.testing.assert_array_equal(a, b)
    # no aliasing: an in-place update of the student leaves the teacher
    teacher_before = jax.tree.map(np.copy, tparams)
    for leaf in tree_leaves(enc["pos_conv"]) + tree_leaves(enc["layers"]):
        leaf += 1.0
    for a, b in zip(tree_leaves(tparams), tree_leaves(teacher_before)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------- the distill grad step

def _teacher_cfg(variant):
    cfg = MelHuBERTConfig.from_dict(TEACHER)
    if variant == "pruned":
        return cfg.with_heads((2, 1, 2)).with_ffn_dims((256, 96, 256))
    return cfg


def _batch(cfg, seed=0, b=3, t=40):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, t, 80)).astype(np.float32)
    lengths = np.array([t, 25, 9])[:b]
    pad = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    label = rng.integers(0, cfg.num_cluster, (b, t)).astype(np.int32)
    label[pad == 0] = -100
    mask = span_mask(_port(cfg), lengths, t, np.random.default_rng(seed + 1))
    return feat, pad, label, lengths, mask


def _torch_batch(feat, pad, label, lengths):
    return {"feat": torch.from_numpy(feat), "pad_mask": torch.from_numpy(pad),
            "label": torch.from_numpy(label).long(), "length": lengths}


KD = dict(temperature=2.0, alpha=0.5)


def _jax_reference(tparams, tcfg, sparams, scfg, batch_np, loss_type, mask):
    """JAX's loss, logs and student gradients: nomasked through
    make_distill_grad_step, masked by replaying ``mask`` through JAX's
    forward (the teacher's mask, then the student's from the teacher's
    output) and distillation_loss."""
    feat, pad, label, _ = batch_np
    jb = {"feat": jnp.asarray(feat), "pad_mask": jnp.asarray(pad),
          "label": jnp.asarray(label)}
    if loss_type == "nomasked":
        step = jsteps.make_distill_grad_step(
            tcfg, scfg, loss_type="nomasked", attn_impl="dense", **KD)
        return step(sparams, tparams, jb, jax.random.PRNGKey(0))

    def loss_fn(sp):
        t_out = jax_forward(tparams, tcfg, jb["feat"], jb["pad_mask"],
                            mask=True, teacher_mask_indices=jnp.asarray(mask),
                            deterministic=True, attn_impl="dense")
        s_out = jax_forward(sp, scfg, jb["feat"], jb["pad_mask"], mask=True,
                            teacher_mask_indices=t_out["mask_indices"],
                            deterministic=True, attn_impl="dense")
        return jdist.distillation_loss(s_out, t_out, jb["label"],
                                       jb["pad_mask"], loss_type="masked",
                                       **KD)

    (loss, logs), grads = jax.value_and_grad(loss_fn, has_aux=True)(sparams)
    return loss, grads, logs


@pytest.mark.parametrize("attn_impl", ["auto", "dense"])
@pytest.mark.parametrize("teacher", ["post_ln", "pruned"])
@pytest.mark.parametrize("loss_type", ["nomasked", "masked"])
def test_distill_grad_step_matches_jax(loss_type, teacher, attn_impl):
    tcfg = _teacher_cfg(teacher)
    scfg = MelHuBERTConfig.from_dict(STUDENT)
    tparams = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(7), tcfg))
    sparams = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(8), scfg))
    feat, pad, label, lengths, mask = _batch(tcfg)
    ref_loss, ref_grads, ref_logs = _jax_reference(
        tparams, tcfg, sparams, scfg, (feat, pad, label, lengths), loss_type,
        mask)

    t_model = load_model(tparams, _port(tcfg))
    s_model = load_model(sparams, _port(scfg))
    step = tsteps.make_distill_grad_step(
        t_model, s_model, loss_type=loss_type, attn_impl=attn_impl,
        deterministic=True, **KD)
    named = dict(s_model.named_parameters())
    loss, grads, logs = step(
        named, _torch_batch(feat, pad, label, lengths), torch.Generator(),
        mask_indices=torch.from_numpy(mask) if loss_type == "masked" else None)
    for a, b in [(loss, ref_loss)] + [(logs[k], ref_logs[k]) for k in (
            "hard_loss", "soft_loss", "teacher_loss")]:
        assert abs(float(a) - float(b)) / abs(float(b)) < LOSS_BAR, (a, b)
    got = tree_leaves(jax_tree_from_named(dict(zip(named, grads))))
    ref = [np.asarray(g) for g in tree_leaves(jax.tree.map(np.asarray,
                                                             ref_grads))]
    names = _paths(sparams)
    assert len(got) == len(ref) == len(names)
    errs = grad_errors(names, got, ref)
    worst = int(np.argmax(errs))
    assert errs[worst] < GRAD_BAR, (names[worst], errs[worst])
    # the teacher is frozen: no grad, nothing on it changed
    assert not any(p.requires_grad or p.grad is not None
                   for p in t_model.parameters())
    assert not loss.requires_grad
    assert not any(v.requires_grad for v in logs.values())


def test_distill_grad_step_draws_the_teachers_mask_on_the_host():
    # masked: the mask comes from the teacher's config and the host
    # generator; a student whose mask_prob is 0 masks nothing (JAX's rule,
    # models/melhubert.py:93), so its masked loss selects no frame
    tcfg = MelHuBERTConfig.from_dict(TEACHER)
    tparams = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(7), tcfg))
    feat, pad, label, lengths, _ = _batch(tcfg, seed=3)
    batch = _torch_batch(feat, pad, label, lengths)
    t_model = load_model(tparams, _port(tcfg))
    outs = {}
    for mask_prob in (0.5, 0.0):
        scfg = PortConfig.from_dict(dict(STUDENT, mask_prob=mask_prob))
        s_model = load_model(init_params_np(scfg, 0), scfg)
        step = tsteps.make_distill_grad_step(t_model, s_model,
                                             loss_type="masked", **KD)
        named = dict(s_model.named_parameters())
        outs[mask_prob] = [step(named, batch, torch.Generator().manual_seed(s))
                           for s in (1, 1, 2)]
    a, b, c = outs[0.5]
    assert float(a[0]) == float(b[0]) and float(a[0]) != float(c[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    for loss, grads, logs in outs[0.0]:
        assert float(loss) == 0.0 and float(logs["teacher_loss"]) == 0.0
        assert all(not g.any() for g in grads)

    # JAX gives the same zero for that student
    scfg = MelHuBERTConfig.from_dict(dict(STUDENT, mask_prob=0.0))
    sparams = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(1), scfg))
    loss, _ = jdist.distill_forward(
        tparams, tcfg, sparams, scfg, jnp.asarray(feat), jnp.asarray(pad),
        jnp.asarray(label), rng=jax.random.PRNGKey(0), loss_type="masked",
        attn_impl="dense", **KD)
    assert float(loss) == 0.0


def test_teacher_forward_keeps_only_logits_and_runs_without_grad():
    tcfg = PortConfig.from_dict(TEACHER)
    teacher = load_model(init_params_np(tcfg, 0), tcfg)
    feat, pad, _, lengths, mask = _batch(MelHuBERTConfig.from_dict(TEACHER))
    out = tdist.teacher_forward(teacher, torch.from_numpy(feat),
                                torch.from_numpy(pad), mask=True,
                                mask_indices=torch.from_numpy(mask))
    assert set(out) == {"logits", "mask_indices"}
    assert not out["logits"].requires_grad
    assert not out["logits"].is_inference()
    assert torch.equal(out["mask_indices"], torch.from_numpy(mask))


# --------------------------------------------------------------- the runner

MODEL_YAML = """teacher:
{teacher}student:
{student}  initial_from_teacher: {init}
loss_param:
  T: {temperature}
  alpha: {alpha}
  type: {loss_type}
task:
  sequence_length: 0
"""

RUNNER_YAML = """runner:
  n_epochs: 0
  total_steps: {steps}
  gradient_clipping: 10.0
  gradient_accumulate_steps: {accum}
  log_step: 1
  save_every_x_epochs: 100
  bf16: true
optimizer:
  lr: {lr}
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


def _section(cfg: dict) -> str:
    return "".join(f"  {k}: {v}\n" for k, v in cfg.items())


def _setup(tmp_path, *, loss_type="nomasked", temperature=1, alpha=1,
           init="false", lr="1.0e-03", steps=2, accum=2):
    from test_torch_train import make_dataset

    csv = make_dataset(tmp_path)
    tcfg = MelHuBERTConfig.from_dict(TEACHER)
    tparams = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(11), tcfg))
    teacher = str(tmp_path / "teacher.npz")
    jax_save_checkpoint(teacher, tparams, meta={
        "Upstream_Config": {"melhubert": TEACHER}, "Step": 0})
    (tmp_path / "model.yaml").write_text(MODEL_YAML.format(
        teacher=_section(TEACHER), student=_section(STUDENT), init=init,
        temperature=temperature, alpha=alpha, loss_type=loss_type))
    (tmp_path / "runner.yaml").write_text(RUNNER_YAML.format(
        steps=steps, accum=accum, lr=lr, csv=csv))
    return csv, teacher, tparams


def _train(tmp_path, teacher, *extra):
    return train_main(["-m", "distillation", "-g",
                       str(tmp_path / "model.yaml"), "-c",
                       str(tmp_path / "runner.yaml"), "-n",
                       str(tmp_path / "exp"), "-i", teacher, "--device", "cpu",
                       "--seed", "0", *extra])


def test_trainer_distills_a_jax_teacher_into_a_student_jax_reads(tmp_path):
    _, teacher, tparams = _setup(tmp_path, loss_type="masked", temperature=2,
                                 alpha=0.5, init="true")
    runner = _train(tmp_path, teacher, "--init_optimizer_from_initial_weight")
    assert runner.compute_dtype == torch.float32  # bf16 only on the GPU
    assert runner.teacher_cfg.encoder_layers == 3
    assert runner.cfg.encoder_layers == 2
    assert [h["step"] for h in runner.log_history] == [1, 2]
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all()
               for h in runner.log_history)
    assert int(runner.opt_state[0]) == 2  # a fresh Adam state, 2 updates
    # the teacher is frozen and as it was loaded
    for name, p in runner.teacher.named_parameters():
        assert not p.requires_grad and p.grad is None, name
    ref = load_model(tparams, _port(MelHuBERTConfig.from_dict(TEACHER)))
    for (name, p), (_, q) in zip(runner.teacher.named_parameters(),
                                 ref.named_parameters()):
        assert torch.equal(p, q), name
    exp = tmp_path / "exp"
    assert {"last-step.npz", "states-epoch-0.npz"} <= set(os.listdir(exp))

    params, cfg, meta = jax_load_any_checkpoint(str(exp / "last-step.npz"))
    assert cfg.encoder_layers == 2 and meta["Step"] == 2
    assert meta["Config"]["encoder_layers"] == 2
    assert set(meta["Upstream_Config"]) >= {"teacher", "student",
                                            "loss_param"}
    template = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(0), MelHuBERTConfig.from_dict(STUDENT)))
    assert jax.tree.structure(params) == jax.tree.structure(template)
    np.testing.assert_array_equal(
        params["encoder"]["layers"][1]["fc1"]["kernel"],
        runner.params["encoder.layers.1.fc1.weight"].detach().numpy().T)

    wavs = [np.random.default_rng(i).standard_normal(n).astype(np.float32)
            * 0.1 for i, n in enumerate((8000, 5000, 11000))]
    ckpt = str(exp / "last-step.npz")
    ref = JaxExtractor(ckpt, dtype=jnp.float32).forward_packed(wavs)
    out = MelHuBERTExtractor(ckpt, device="cpu").forward_packed(wavs)
    assert len(out["hidden_states"]) == 3  # pre_feat + 2 layers
    assert out["lengths"] == ref["lengths"]
    t = out["last_hidden_state"].shape[1]
    valid = np.arange(t)[None, :] < np.asarray(out["lengths"])[:, None]
    pairs = list(zip(out["hidden_states"], ref["hidden_states"]))
    pairs.append((out["last_hidden_state"], ref["last_hidden_state"]))
    for a, b in pairs:
        a, b = a.numpy()[valid], np.asarray(b)[valid]
        assert np.abs(a - b).max() / np.abs(b).mean() < SERVE_BAR


def test_trainer_copies_the_teachers_layers_into_the_student(tmp_path):
    _, teacher, tparams = _setup(tmp_path, init="true", steps=1, accum=1,
                                 lr="0.0")
    runner = _train(tmp_path, teacher)
    fresh = load_model(init_params_np(runner.cfg, 0), runner.cfg)
    t_named = dict(runner.teacher.named_parameters())
    copied = 0
    for name, p in fresh.named_parameters():
        got = runner.params[name].detach()
        if name.startswith(("encoder.pos_conv.", "encoder.layers.")):
            assert torch.equal(got, t_named[name]), name
            assert got.data_ptr() != t_named[name].data_ptr()
            copied += 1
        else:
            assert torch.equal(got, p.detach()), name
    assert copied == len([k for k in t_named if k.startswith(
        ("encoder.pos_conv.", "encoder.layers.0.", "encoder.layers.1."))])


def test_trainer_first_loss_at_lr_0_equals_jax_grad_step(tmp_path):
    # the shipped recipe's loss (nomasked, T = 1, alpha = 1), one update of
    # one micro-batch at lr 0: the runner's logged loss is the grad step's
    # on its first batch, and the weights it saves are those it started
    # from
    csv, teacher, tparams = _setup(tmp_path, steps=1, accum=1, lr="0.0")
    runner = _train(tmp_path, teacher)
    params, scfg, _ = jax_load_any_checkpoint(
        str(tmp_path / "exp" / "last-step.npz"))
    fresh = init_params_np(runner.cfg, 0)
    for a, b in zip(tree_leaves(params), tree_leaves(fresh)):
        np.testing.assert_array_equal(a, b)
    batch = next(iter(JaxBuckets(
        frame_period=20, sequence_length=0, bucket_size=2, sets=[csv],
        max_timestep=0, seed=0).epoch(shuffle=True)))
    step = jsteps.make_distill_grad_step(
        MelHuBERTConfig.from_dict(TEACHER), scfg, temperature=1.0, alpha=1.0,
        loss_type="nomasked", attn_impl="dense")
    loss, _, _ = step(params, tparams, {
        "feat": jnp.asarray(batch["feat"]),
        "pad_mask": jnp.asarray(batch["pad_mask"]),
        "label": jnp.asarray(batch["label"])}, jax.random.PRNGKey(0))
    got = runner.log_history[0]["loss"]
    assert abs(got - float(loss)) / float(loss) < LOSS_BAR, (got, loss)


def test_trainer_refuses_distillation_without_a_teacher(tmp_path):
    _setup(tmp_path)
    with pytest.raises(ValueError, match="teacher"):
        train_main(["-m", "distillation", "-g", str(tmp_path / "model.yaml"),
                    "-c", str(tmp_path / "runner.yaml"), "-n",
                    str(tmp_path / "exp"), "--device", "cpu"])


def test_trainer_takes_a_reference_ckpt_teacher(tmp_path):
    # a reference .ckpt (a torch.save dict in the reference naming) as the
    # teacher: its config from the file, its weights as the npz's
    from speech_ssl_compression_tpu_torch.utils.torch_convert import (
        params_to_state_dict,
    )

    _, _, tparams = _setup(tmp_path, steps=1, accum=1)
    ckpt = str(tmp_path / "teacher.ckpt")
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in
                          params_to_state_dict(tparams).items()},
                "Upstream_Config": {"melhubert": TEACHER}, "Step": 0}, ckpt)
    runner = _train(tmp_path, ckpt)
    ref = load_model(tparams, _port(MelHuBERTConfig.from_dict(TEACHER)))
    for (name, p), (_, q) in zip(runner.teacher.named_parameters(),
                                 ref.named_parameters()):
        assert torch.equal(p, q), name
    assert np.isfinite(runner.log_history[-1]["loss"])
