"""The port past JAX's stream threshold (T > 4096) and MelHuBERT's remat,
against the JAX package on the CPU. At T = 4352 (as
``tests/test_flash_attention.py`` uses) JAX's flash attention runs its
streamed Pallas kernels (``_fa_fwd_stream_kernel``, and in the backward
``_fa_bwd_dq_stream_kernel`` and ``_fa_bwd_dkv_stream_kernel``), here in
interpret mode, and the port's CPU route its plain versions: the forward
and the gradients of square attention, causal and not, and of
``flash_attention_kv_full``, with key padding; the plain dense attention;
the 2-layer 10 ms model served from one long utterance; a dropout-free
distillation grad step; dropout past 4096 refused by the op and by the
trainers. Remat: the port's MelHuBERT grad step with ``remat=True``
bitwise without it (dropout on), and within rel. L2 1e-4 of JAX's
``remat=True`` (dropout off, one span mask)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.extract import (
    MelHuBERTExtractor as JaxExtractor,
)
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.ops import attention as jattention
from speech_ssl_compression_tpu.ops import flash_attention as jfa
from speech_ssl_compression_tpu.ops.masking import compute_span_mask
from speech_ssl_compression_tpu.train import steps as jsteps
from speech_ssl_compression_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig as PortConfig,
)
from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
from speech_ssl_compression_tpu_torch.models import encoder as tencoder
from speech_ssl_compression_tpu_torch.ops import attention as tattention
from speech_ssl_compression_tpu_torch.ops import flash_attention as tfa
from speech_ssl_compression_tpu_torch.train import steps as tsteps
from speech_ssl_compression_tpu_torch.train.__main__ import main as train_main
from speech_ssl_compression_tpu_torch.utils.checkpoint import tree_leaves
from speech_ssl_compression_tpu_torch.utils.weights import (
    jax_tree_from_named,
    load_model,
)
from test_torch_10ms import write_set
from test_torch_flash_bwd import _arrays, _rel
from test_torch_train import GRAD_BAR, LOSS_BAR, _paths, grad_errors

T_LONG = 4352  # past JAX's _STREAM_THRESHOLD (4096)
RTOL, ATOL = 2e-4, 2e-5  # tests/test_torch_flash.py's forward bar
BAR = 1e-4  # max |d| / mean |ref|: the golden bar (test_model_golden.py:65)
TINY_10MS = dict(feat_emb_dim=40, encoder_layers=2, encoder_embed_dim=128,
                 encoder_ffn_embed_dim=256, encoder_attention_heads=2,
                 head_dim=64, conv_pos=16, conv_pos_groups=4, num_cluster=32,
                 mask_prob=0.7, mask_length=10, dropout=0.0,
                 attention_dropout=0.0, activation_dropout=0.0)


# ------------------------------------------------------------- the kernels

def test_the_threshold_is_jaxs():
    assert tfa.STREAM_THRESHOLD == jfa._STREAM_THRESHOLD == 4096
    assert tfa.DROPOUT_MAX_T == tfa.STREAM_THRESHOLD
    assert T_LONG > tfa.STREAM_THRESHOLD


@pytest.mark.parametrize("causal", [False, True])
def test_square_attention_past_4096_matches_pallas_streamed(causal):
    # forward and gradients, key padding (the last 300 keys), d = 64
    q, k, v, dout = _arrays(1, 2, T_LONG, seed=1)
    pad = np.arange(T_LONG)[None, :] >= T_LONG - 300

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, key_padding_mask=jnp.asarray(pad),
                                  causal=causal)
        return jnp.sum(out * jnp.asarray(dout)), out

    with pltpu.force_tpu_interpret_mode():
        (_, ref_out), ref = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, key_padding_mask=torch.from_numpy(
        pad), causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=RTOL, atol=ATOL)
    out.backward(torch.from_numpy(dout))
    for name, g, r in zip("qkv", (qt.grad, kt.grad, vt.grad), ref):
        assert _rel(g.numpy(), r) < BAR, name


def test_kv_full_past_4096_matches_pallas_streamed():
    # flash_attention_kv_full: 512 query rows against 4352 keys, the last
    # 200 padded (the sequence-parallel shape, whose kernels stream in JAX
    # at any T)
    q, k, v, dout = _arrays(1, 2, 512, T_LONG, seed=2)
    pad = np.arange(T_LONG)[None, :] >= T_LONG - 200

    def loss(q, k, v):
        out = jfa.flash_attention_kv_full(q, k, v,
                                          key_padding_mask=jnp.asarray(pad))
        return jnp.sum(out * jnp.asarray(dout)), out

    with pltpu.force_tpu_interpret_mode():
        (_, ref_out), ref = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention_kv_full(qt, kt, vt,
                                      key_padding_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=RTOL, atol=ATOL)
    out.backward(torch.from_numpy(dout))
    for name, g, r in zip("qkv", (qt.grad, kt.grad, vt.grad), ref):
        assert _rel(g.numpy(), r) < BAR, name


def test_dense_attention_past_4096_matches_jax():
    # the plain O(T^2) route (impl="dense"), the card's yardstick at long T
    q, k, v, _ = _arrays(1, 2, T_LONG, seed=3)
    pad = np.arange(T_LONG)[None, :] >= T_LONG - 100
    ref = jattention.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v),
                                     key_padding_mask=jnp.asarray(pad))
    got = tattention.dense_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     key_padding_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_launches_past_the_threshold_are_counted_apart():
    tfa.reset_launch_counts()
    for tq, tk, dtype in ((768, 768, torch.float32),
                          (4096, 4096, torch.bfloat16),
                          (4097, 4097, torch.float32),
                          (1024, 5000, torch.bfloat16),
                          (8192, 8192, torch.bfloat16)):
        q = torch.zeros(1, 1, tq, 64, dtype=dtype)
        tfa._count("flash_attn_fwd", q, tk)
    assert tfa.launch_counts["flash_attn_fwd"] == 5
    assert tfa.dtype_launch_counts["flash_attn_fwd"] == {"f32": 2, "bf16": 3}
    assert tfa.long_launch_counts["flash_attn_fwd"] == {"f32": 1, "bf16": 2}
    assert tfa.long_launch_counts["flash_attn_bwd_dq"] == {"f32": 0,
                                                           "bf16": 0}
    tfa.reset_launch_counts()
    assert all(c == {"f32": 0, "bf16": 0}
               for c in tfa.long_launch_counts.values())


# --------------------------------------------------------------- the model

def _checkpoint(tmp_path, cfg_dict, seed=0):
    cfg = MelHuBERTConfig.from_dict(cfg_dict)
    params = jax.tree.map(np.asarray,
                          init_melhubert_params(jax.random.PRNGKey(seed), cfg))
    path = str(tmp_path / "ckpt_10ms.npz")
    jax_save_checkpoint(path, params, meta={
        "Upstream_Config": {"melhubert": cfg_dict}, "Step": 0})
    return cfg, params, path


@pytest.mark.parametrize("featurizer", ["host", "device"])
def test_long_utterance_served_at_10ms_matches_jax(tmp_path, featurizer):
    # one utterance of 4352 10 ms frames ((N - 400) / 160 + 1 with snip
    # edges), no padding: JAX's extractor (the dense route on the CPU)
    # against the port's forward (the plain flash route), every layer
    n = (T_LONG - 1) * 160 + 400
    wav = (0.1 * np.random.default_rng(5).standard_normal(n)).astype(
        np.float32)
    _, _, ckpt = _checkpoint(tmp_path, TINY_10MS)
    ref = JaxExtractor(ckpt, fp=10, dtype=jnp.float32).forward([wav])
    out = MelHuBERTExtractor(ckpt, fp=10, device="cpu").forward(
        [wav], featurizer=featurizer)
    assert out["lengths"] == ref["lengths"] == [T_LONG]
    assert out["last_hidden_state"].shape == (1, T_LONG, 128)
    pairs = list(zip(out["hidden_states"], ref["hidden_states"]))
    pairs.append((out["last_hidden_state"], ref["last_hidden_state"]))
    assert len(pairs) == 4
    for a, b in pairs:
        assert _rel(a.numpy()[0, :T_LONG], np.asarray(b)[0, :T_LONG]) < BAR


def test_long_wav_file_through_the_10ms_expert_and_cli_matches_jax(
        tmp_path):
    # a 16-bit WAV file of 4352 frames through the S3PRL expert's 10 ms
    # factory and through the extraction CLI at -f 10 (its packed route,
    # one row of 4352; the last layer dumped), both with the 960-hour
    # mean-std, against JAX's extractor on the samples the file holds
    from scipy.io import wavfile

    from speech_ssl_compression_tpu_torch import extract_feature
    from speech_ssl_compression_tpu_torch.extract import read_wavs
    from speech_ssl_compression_tpu_torch.s3prl import hubconf

    n = (T_LONG - 1) * 160 + 400
    wav = 0.1 * np.random.default_rng(6).standard_normal(n)
    path = str(tmp_path / "long.wav")
    wavfile.write(path, 16000, (wav * 32767).astype(np.int16))
    _, _, ckpt = _checkpoint(tmp_path, TINY_10MS)
    expert = hubconf.compression_10ms_melhubert_960hours_local(
        ckpt, device="cpu")
    assert expert.get_downsample_rates() == 160
    out = expert([path])
    samples = read_wavs([path])[0]
    ref = JaxExtractor(ckpt, fp=10, dtype=jnp.float32,
                       mean_std_npy_path=hubconf._default_mean_std(960)
                       ).forward([samples])
    pairs = list(zip(out["hidden_states"], ref["hidden_states"]))
    pairs.append((out["last_hidden_state"], ref["last_hidden_state"]))
    for a, b in pairs:
        assert a.shape[1] >= T_LONG
        assert _rel(a.numpy()[0, :T_LONG], np.asarray(b)[0, :T_LONG]) < BAR
    extract_feature.main(["-c", ckpt, "-f", "10", "--device", "cpu",
                          "--wav", path, "--dump-dir", str(tmp_path / "d")])
    dumped = np.load(next((tmp_path / "d").glob("*.npy")))
    assert dumped.shape == (T_LONG, 128)
    assert _rel(dumped, np.asarray(ref["last_hidden_state"])[0, :T_LONG]) < BAR


def _long_batch(t, num_cluster, seed=0):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((1, t, 40)).astype(np.float32)
    label = rng.integers(0, num_cluster, (1, t)).astype(np.int32)
    pad = np.ones((1, t), np.float32)
    return feat, pad, label


def test_distill_grad_step_past_4096_matches_jax():
    # bench.py's long-form distillation step (B = 1, nomasked, dropouts 0)
    # at T = 4352: a 2-layer 10 ms teacher into a 1-layer student; JAX on
    # its dense route, the port on the plain flash route
    tcfg = MelHuBERTConfig.from_dict(TINY_10MS)
    scfg = MelHuBERTConfig.from_dict(dict(TINY_10MS, encoder_layers=1))
    tparams = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(0), tcfg))
    sparams = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(1), scfg))
    feat, pad, label = _long_batch(T_LONG, tcfg.num_cluster)
    step = jsteps.make_distill_grad_step(
        tcfg, scfg, temperature=1.0, alpha=1.0, loss_type="nomasked",
        attn_impl="dense")
    ref_loss, ref_grads, _ = step(sparams, tparams, {
        "feat": jnp.asarray(feat), "pad_mask": jnp.asarray(pad),
        "label": jnp.asarray(label)}, jax.random.PRNGKey(2))

    teacher = load_model(tparams, PortConfig.from_dict(tcfg.to_dict()))
    student = load_model(sparams, PortConfig.from_dict(scfg.to_dict()))
    ours = tsteps.make_distill_grad_step(teacher, student, temperature=1.0,
                                         alpha=1.0, loss_type="nomasked")
    named = dict(student.named_parameters())
    loss, grads, _ = ours(named, {
        "feat": torch.from_numpy(feat), "pad_mask": torch.from_numpy(pad),
        "label": torch.from_numpy(label).long(),
        "length": np.array([T_LONG])}, torch.Generator())
    assert abs(float(loss) - float(ref_loss)) / float(ref_loss) < LOSS_BAR
    got = tree_leaves(jax_tree_from_named(dict(zip(named, grads))))
    ref = [np.asarray(g) for g in tree_leaves(jax.tree.map(np.asarray,
                                                             ref_grads))]
    names = _paths(sparams)
    errs = grad_errors(names, got, ref)
    worst = int(np.argmax(errs))
    assert errs[worst] < GRAD_BAR, (names[worst], errs[worst])


# ----------------------------------------------------- dropout past 4096

def test_dropout_past_4096_is_refused_by_both_ops():
    q = np.zeros((1, 1, T_LONG, 64), np.float32)
    with pltpu.force_tpu_interpret_mode():
        with pytest.raises(NotImplementedError, match="dropout"):
            jfa.flash_attention(*(jnp.asarray(q),) * 3, dropout_p=0.1,
                                dropout_rng=jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="dropout"):
        tfa.flash_attention(*(torch.from_numpy(q),) * 3, dropout_p=0.1,
                            dropout_seed=1)
    # at the threshold both take it (the port's plain route here)
    t = tfa.STREAM_THRESHOLD
    out = tfa.flash_attention(*(torch.zeros(1, 1, t, 64),) * 3,
                              dropout_p=0.1, dropout_seed=1)
    assert out.shape == (1, 1, t, 64)


def test_dropout_past_4096_is_refused_by_both_trainers(tmp_path):
    # the shipped 10 ms recipe's dropout 0.1 on utterances of 4352 frames
    # (sequence_length 0: no crop): the port's trainer refuses in its first
    # grad step; JAX's routes the CPU to its dense attention, so its grad
    # step is held on its flash route (interpret mode)
    csv = write_set(tmp_path / "data", [T_LONG] * 2 + [T_LONG + 7] * 2)
    model = dict(TINY_10MS, dropout=0.1, attention_dropout=0.1,
                 activation_dropout=0.1)
    (tmp_path / "model.yaml").write_text(
        "melhubert:\n" + "".join(f"  {k}: {v}\n" for k, v in model.items())
        + "task:\n  sequence_length: 0\n")
    (tmp_path / "runner.yaml").write_text(
        "runner:\n  n_epochs: 0\n  total_steps: 1\n  gradient_clipping: 10.0\n"
        "  gradient_accumulate_steps: 1\n  log_step: 1\n"
        "  save_every_x_epochs: 100\n  bf16: false\noptimizer:\n"
        "  lr: 0.0001\ndatarc:\n  train_batch_size: 2\n  max_timestep: -320\n"
        f"  sets:\n  - {csv}\n")
    with pytest.raises(NotImplementedError, match="dropout"):
        train_main(["-m", "melhubert", "-f", "10", "-g",
                    str(tmp_path / "model.yaml"), "-c",
                    str(tmp_path / "runner.yaml"), "-n", str(tmp_path / "e"),
                    "--device", "cpu"])
    cfg = MelHuBERTConfig.from_dict(model)
    params = init_melhubert_params(jax.random.PRNGKey(0), cfg)
    feat, pad, label = _long_batch(T_LONG, cfg.num_cluster)
    step = jsteps.make_melhubert_grad_step(cfg, attn_impl="flash")
    with pltpu.force_tpu_interpret_mode():
        with pytest.raises(NotImplementedError, match="dropout"):
            step(params, None, {"feat": jnp.asarray(feat),
                                "pad_mask": jnp.asarray(pad),
                                "label": jnp.asarray(label)},
                 jax.random.PRNGKey(1))


# ------------------------------------------------------------------ remat

def _pretrain_batch(cfg, t=96, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, 70, 33])
    feat = rng.standard_normal((3, t, 40)).astype(np.float32)
    pad = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    label = rng.integers(0, cfg.num_cluster, (3, t)).astype(np.int32)
    label[pad == 0] = -100
    return feat, pad, label, lengths


def _torch_batch(feat, pad, label, lengths):
    return {"feat": torch.from_numpy(feat), "pad_mask": torch.from_numpy(pad),
            "label": torch.from_numpy(label).long(), "length": lengths}


def test_remat_gradients_are_bitwise_with_dropout_on(monkeypatch):
    # the same generator state into both steps: residual, activation and
    # attention dropout draw the same bits in the forward and again in the
    # recompute, so every gradient is the same bits
    cfg = PortConfig.from_dict(dict(TINY_10MS, dropout=0.1,
                                    attention_dropout=0.1,
                                    activation_dropout=0.1))
    model = load_model(jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(4), MelHuBERTConfig.from_dict(cfg.to_dict()))),
        cfg)
    named = dict(model.named_parameters())
    batch = _torch_batch(*_pretrain_batch(cfg))
    results, calls = {}, []
    checkpoint_layer = tencoder.checkpoint_layer

    def counting(*a, **kw):
        calls.append(1)
        return checkpoint_layer(*a, **kw)

    monkeypatch.setattr(tencoder, "checkpoint_layer", counting)
    for remat in (False, True):
        step = tsteps.make_melhubert_grad_step(model, remat=remat)
        results[remat] = step(named, batch, torch.Generator().manual_seed(9))
    assert len(calls) == cfg.encoder_layers  # only the remat step
    (loss_a, grads_a, _), (loss_b, grads_b, _) = results[False], results[True]
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))
    # the control: another generator state gives other gradients
    other = tsteps.make_melhubert_grad_step(model)(
        named, batch, torch.Generator().manual_seed(10))
    assert not torch.equal(other[0], loss_a)


def test_remat_grad_step_matches_jax_remat():
    cfg = MelHuBERTConfig.from_dict(TINY_10MS)
    params = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(5), cfg))
    feat, pad, label, lengths = _pretrain_batch(cfg, seed=1)
    # the span mask JAX's step draws (models/melhubert.py), replayed into
    # the port's step
    key = jax.random.PRNGKey(6)
    step = jsteps.make_melhubert_grad_step(cfg, attn_impl="dense",
                                           remat=True)
    ref_loss, ref_grads, _ = step(params, None, {
        "feat": jnp.asarray(feat), "pad_mask": jnp.asarray(pad),
        "label": jnp.asarray(label)}, key)
    span = compute_span_mask(
        jax.random.split(key)[0], jnp.asarray(lengths, jnp.int32),
        feat.shape[1], mask_prob=cfg.mask_prob, mask_length=cfg.mask_length,
        mask_selection=cfg.mask_selection, mask_other=cfg.mask_other,
        min_masks=2, no_overlap=cfg.no_mask_overlap,
        min_space=cfg.mask_min_space, require_same_masks=False)
    model = load_model(params, PortConfig.from_dict(cfg.to_dict()))
    ours = tsteps.make_melhubert_grad_step(model, remat=True,
                                           deterministic=True)
    named = dict(model.named_parameters())
    loss, grads, _ = ours(named, _torch_batch(feat, pad, label, lengths),
                          torch.Generator(),
                          mask_indices=torch.from_numpy(np.asarray(span)))
    assert abs(float(loss) - float(ref_loss)) / float(ref_loss) < LOSS_BAR
    got = tree_leaves(jax_tree_from_named(dict(zip(named, grads))))
    ref = [np.asarray(g) for g in tree_leaves(jax.tree.map(np.asarray,
                                                             ref_grads))]
    errs = grad_errors(_paths(params), got, ref)
    assert max(errs) < GRAD_BAR, max(errs)


def test_remat_frees_the_layers_activations():
    # the recompute keeps only each layer's input: the saved tensors of a
    # remat forward are fewer than without it
    cfg = PortConfig.from_dict(TINY_10MS)
    model = load_model(jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(4), MelHuBERTConfig.from_dict(cfg.to_dict()))),
        cfg)
    feat, pad, _, _ = _pretrain_batch(cfg)
    saved = {}
    for remat in (False, True):
        n = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: (n.append(t.numel()), t)[1], lambda t: t):
            model(torch.from_numpy(feat), torch.from_numpy(pad),
                  deterministic=True, remat=remat)
        saved[remat] = sum(n)
    assert saved[True] < 0.5 * saved[False], saved
