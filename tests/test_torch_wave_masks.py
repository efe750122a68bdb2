"""Channel masks and activation checkpointing of the port's HuBERT and
wav2vec 2.0 against the JAX package: features, loss and every gradient
with JAX's time and channel masks injected (HuBERT; wav2vec 2.0 with the
channel mask before and after the time mask), the host channel sampler
against JAX's device sampler by distribution, the span-mask stream left as
it was, and ``checkpoint_activations`` giving the loss and gradients of
the run without it, dropout on, with a control that recomputes without
restoring the dropout generator and must fail."""

import functools

import numpy as np
import pytest
import torch
import torch.utils.checkpoint
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu import configs as jconfigs
from speech_ssl_compression_tpu.models import hubert as jhubert
from speech_ssl_compression_tpu.models import wav2vec2 as jw2v
from speech_ssl_compression_tpu.ops import masking as jmasking
from speech_ssl_compression_tpu_torch import configs as tconfigs
from speech_ssl_compression_tpu_torch.models import encoder as tencoder
from speech_ssl_compression_tpu_torch.models import hubert as thubert
from speech_ssl_compression_tpu_torch.models import wav2vec2 as tw2v
from speech_ssl_compression_tpu_torch.models.conv_frontend import (
    frame_lengths,
)
from speech_ssl_compression_tpu_torch.ops import masking as tmasking
from speech_ssl_compression_tpu_torch.ops.dropout import (
    device_generator,
    draw_seed,
)
from speech_ssl_compression_tpu_torch.train.steps import (
    make_hubert_grad_step,
    make_wav2vec2_grad_step,
)
from speech_ssl_compression_tpu_torch.utils.weights import (
    load_wave_model,
    prunable_names,
    wave_tree_from_named,
)

GRAD_BAR = 1e-4   # rel. L2: features, loss and every gradient
REMAT_LOSS = 1e-6  # JAX's own remat test: loss
REMAT_GRAD = 1e-5  # and gradients
CONV = "[(32,10,5)] + [(32,3,2)] + [(32,2,2)]"  # as tests/test_wave_runner.py
ENCODER = dict(
    encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
    encoder_attention_heads=2, head_dim=16, conv_feature_layers=CONV,
    final_dim=16, conv_pos=16, conv_pos_groups=4, feature_grad_mult=0.1,
    mask_prob=0.65, mask_length=4, dropout=0.0, attention_dropout=0.0,
    activation_dropout=0.0, encoder_layerdrop=0.0,
)
HUBERT = dict(ENCODER, label_rate=100, untie_final_proj=True)
W2V2 = dict(ENCODER, quantize_targets=True, latent_vars=8, latent_groups=2,
            num_negatives=4)
CHANNELS = dict(mask_channel_prob=0.3, mask_channel_length=4)
N_CLASSES = (12,)
LENGTHS = np.array([2400, 1930])  # 119 frames, 96 valid in row 1
T_FRAMES = 119


def _cfgs(upstream, **over):
    d = dict(HUBERT if upstream == "hubert" else W2V2, **over)
    name = "HuBERTConfig" if upstream == "hubert" else "Wav2Vec2Config"
    return (getattr(jconfigs, name).from_dict(d),
            getattr(tconfigs, name).from_dict(d))


def _params(upstream, jcfg, seed=0):
    key = jax.random.PRNGKey(seed)
    p = (jhubert.init_hubert_params(key, jcfg, N_CLASSES)
         if upstream == "hubert" else jw2v.init_wav2vec2_params(key, jcfg))
    return jax.tree.map(np.asarray, p)


def _source(seed=0):
    rng = np.random.default_rng(seed)
    src = np.zeros((len(LENGTHS), LENGTHS.max()), np.float32)
    for i, n in enumerate(LENGTHS):
        src[i, :n] = 0.3 * rng.standard_normal(n)
    return src


def _masks(tcfg, seed=0):
    """A fixed span mask and channel mask (the port's host samplers)."""
    frames = frame_lengths(LENGTHS, tcfg.conv_feature_layers, T_FRAMES)
    rng = np.random.default_rng(seed)
    span = (thubert.span_mask(tcfg, frames, T_FRAMES, rng)
            & (np.arange(T_FRAMES)[None, :] < frames[:, None]))
    chan = tmasking.channel_mask(tcfg, len(LENGTHS), tcfg.encoder_embed_dim,
                                 rng)
    assert span.any() and chan.any() and not chan.all()
    return span, chan


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _grad_tree(model, loss, upstream):
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return wave_tree_from_named({
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(named.items(), grads)}, upstream)


def _assert_grads(tree, jgrads):
    got = jax.tree.leaves_with_path(tree)
    want = jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    total = np.sqrt(sum(float(np.sum(np.square(w))) for w in want))
    for (path, g), w in zip(got, want):
        name = jax.tree_util.keystr(path)
        w = np.asarray(w)
        # k_proj biases' gradients are zero up to rounding (softmax is
        # shift-invariant): take theirs against the norm of all gradients
        ref = total if "k_proj" in name and "bias" in name else np.linalg.norm(w)
        assert np.linalg.norm(g - w) / max(ref, 1e-30) < GRAD_BAR, name


def test_hubert_channel_mask_matches_jax(monkeypatch):
    jcfg, tcfg = _cfgs("hubert", **CHANNELS)
    params = _params("hubert", jcfg)
    src = _source()
    span, chan = _masks(tcfg)
    monkeypatch.setattr(jhubert, "compute_span_mask",
                        lambda *a, **k: jnp.asarray(span))
    monkeypatch.setattr(jhubert, "compute_channel_mask",
                        lambda *a, **k: jnp.asarray(chan))
    rng = np.random.default_rng(1)
    tgt = rng.integers(0, N_CLASSES[0], (len(LENGTHS), T_FRAMES))
    tvalid = np.ones_like(tgt, bool)

    def jax_loss(p):
        out = jhubert.hubert_forward(
            p, jcfg, jnp.asarray(src), jnp.asarray(LENGTHS), mask=True,
            rng=jax.random.PRNGKey(1), deterministic=True, attn_impl="dense")
        loss, n, _ = jhubert.hubert_pretrain_loss(
            p, jcfg, out, [jnp.asarray(tgt)], N_CLASSES,
            target_valid=jnp.asarray(tvalid))
        return loss, (n, out["features"])

    (jloss, (jn, jfeat)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))

    model = load_wave_model(params, tcfg, "hubert")
    out = model(torch.from_numpy(src), LENGTHS, mask=True,
                mask_indices=torch.from_numpy(span),
                mask_channel_indices=torch.from_numpy(chan),
                target_list=[torch.from_numpy(tgt).long()],
                target_valid=torch.from_numpy(tvalid))
    feat = out["features"].detach().numpy()
    # each row's masked channels are zero on every frame, as JAX's
    for i in range(len(LENGTHS)):
        assert not feat[i][:, chan[i]].any()
        assert not np.asarray(jfeat)[i][:, chan[i]].any()
    assert _rel_l2(feat, jfeat) < GRAD_BAR
    assert int(out["sample_size"]) == int(jn) > 0
    loss = float(out["loss"].detach())
    assert abs(loss - float(jloss)) / abs(float(jloss)) < GRAD_BAR
    _assert_grads(_grad_tree(model, out["loss"], "hubert"), jgrads)


@pytest.mark.parametrize("before", [True, False])
def test_wav2vec2_channel_mask_matches_jax(monkeypatch, before):
    jcfg, tcfg = _cfgs("wav2vec2", mask_channel_before=before, **CHANNELS)
    params = _params("wav2vec2", jcfg)
    src = _source()
    span, chan = _masks(tcfg)
    monkeypatch.setattr(jw2v, "compute_channel_mask",
                        lambda *a, **k: jnp.asarray(chan))
    neg_mask = torch.from_numpy(span)
    draws, _ = tw2v._negative_draws(torch.Generator().manual_seed(3),
                                    neg_mask, jcfg.num_negatives)
    counts = tw2v.negative_counts(draws, neg_mask)
    monkeypatch.setattr(jw2v, "sample_negative_counts",
                        lambda *a: jnp.asarray(counts.numpy()))
    key = jax.random.PRNGKey(1)
    uniform = np.asarray(jax.random.uniform(
        jax.random.split(key, 6)[4],
        (len(LENGTHS) * T_FRAMES * jcfg.latent_groups, jcfg.latent_vars)))
    temp = 1.3

    def jax_loss(p):
        out = jw2v.wav2vec2_forward(
            p, jcfg, jnp.asarray(src), jnp.asarray(LENGTHS), mask=True,
            rng=key, deterministic=False, gumbel_temp=temp, attn_impl="dense",
            mask_indices=jnp.asarray(span), features_only=False)
        loss, n, logs = jw2v.wav2vec2_pretrain_loss(out, jcfg)
        return loss, (n, logs)

    (jloss, (jn, jlogs)), jgrads = jax.value_and_grad(
        jax_loss, has_aux=True)(jax.tree.map(jnp.asarray, params))
    jfeat = jw2v.wav2vec2_forward(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(src),
        jnp.asarray(LENGTHS), mask=True, rng=key, deterministic=True,
        attn_impl="dense", mask_indices=jnp.asarray(span),
        features_only=True)["features"]

    model = load_wave_model(params, tcfg, "wav2vec2")
    kw = dict(mask=True, mask_indices=torch.from_numpy(span),
              mask_channel_indices=torch.from_numpy(chan))
    with torch.no_grad():
        feat = model(torch.from_numpy(src), LENGTHS, features_only=True,
                     **kw)["features"].numpy()
    assert _rel_l2(feat, jfeat) < GRAD_BAR
    # a frame the time mask replaced by mask_emb shows the order: its
    # masked channels hold mask_emb's values (channels zeroed before) or
    # zeros (after)
    emb = params["mask_emb"][chan[0]]
    spanned = feat[0][span[0]][:, chan[0]]
    np.testing.assert_allclose(spanned, np.broadcast_to(
        emb if before else 0.0, spanned.shape), rtol=1e-6)
    out = model(torch.from_numpy(src), LENGTHS, compute_loss=True,
                rng=torch.Generator(), deterministic=False, gumbel_temp=temp,
                gumbel_uniform=torch.from_numpy(uniform),
                negative_counts=counts, **kw)
    assert int(out["sample_size"]) == int(jn) > 0
    loss = float(out["loss"].detach())
    assert abs(loss - float(jloss)) / abs(float(jloss)) < GRAD_BAR
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(out["logs"][k]), float(v),
                                   rtol=GRAD_BAR, err_msg=k)
    _assert_grads(_grad_tree(model, out["loss"], "wav2vec2"), jgrads)


@pytest.mark.parametrize("kw", [
    dict(mask_prob=0.3, mask_length=4),
    dict(mask_prob=0.5, mask_length=10, no_overlap=True, min_space=2),
    dict(mask_prob=0.2, mask_length=6, mask_selection="uniform",
         mask_other=2.0),
])
def test_channel_sampler_matches_jax_by_distribution(kw):
    # per draw, the masked share of a (4, 256) mask; both samplers' means
    # within 5 sigma of each other, and each row's count equal in a draw
    # (one shared count draw, require_same_masks)
    b, c, n = 4, 256, 400
    rng = np.random.default_rng(0)
    got = []
    for _ in range(n):
        m = tmasking.compute_channel_mask_np(b, c, rng=rng, **kw)
        assert (m.sum(-1) == m.sum(-1)[0]).all()
        got.append(m.mean())
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    sample = jax.jit(functools.partial(jmasking.compute_channel_mask,
                                       batch=b, channels=c, **kw))
    want = [float(jnp.mean(sample(k))) for k in keys]
    got, want = np.array(got), np.array(want)
    sigma = np.sqrt(got.var() / n + want.var() / n)
    assert abs(got.mean() - want.mean()) < 5 * sigma + 1e-9, (
        got.mean(), want.mean(), sigma)


@pytest.mark.parametrize("upstream", ["hubert", "wav2vec2"])
def test_channel_masks_leave_the_span_stream_as_it_was(upstream):
    # the span mask is drawn first (HuBERT; wav2vec 2.0 with the channel
    # mask after it) from one host stream: with or without channel masks,
    # the same seed gives the span mask the port drew before channel masks
    # were ported
    src = torch.from_numpy(_source())
    got = {}
    for prob in (0.0, 0.3):
        _, tcfg = _cfgs(upstream, mask_channel_prob=prob,
                        mask_channel_length=4)
        model = load_wave_model(
            _params(upstream, _cfgs(upstream)[0]), tcfg, upstream)
        with torch.no_grad():
            out = model(src, LENGTHS, mask=True, deterministic=False,
                        rng=torch.Generator().manual_seed(5),
                        features_only=True)
        got[prob] = out["mask_indices"].numpy()
    rng = torch.Generator().manual_seed(5)
    device_generator(rng, torch.device("cpu"))
    frames = frame_lengths(LENGTHS, tcfg.conv_feature_layers, T_FRAMES)
    span = (thubert.span_mask if upstream == "hubert" else tw2v.span_mask)(
        tcfg, frames, T_FRAMES, np.random.default_rng(draw_seed(rng)))
    if upstream == "wav2vec2":
        span &= np.arange(T_FRAMES)[None, :] < frames[:, None]
    np.testing.assert_array_equal(got[0.0], span)
    np.testing.assert_array_equal(got[0.3], span)


def _remat_grads(upstream, remat, monkeypatch=None, restore=True):
    """Loss and gradients of one training forward with dropout on, from
    fixed generators, with or without checkpoint_activations."""
    over = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
                checkpoint_activations=remat)
    _, tcfg = _cfgs(upstream, **over)
    params = _params(upstream, _cfgs(upstream)[0])
    model = load_wave_model(params, tcfg, upstream)
    if not restore:
        # a plain wrap: checkpoint stashes only the default generators
        monkeypatch.setattr(
            tencoder, "checkpoint_layer",
            lambda run, x, layer, gen: torch.utils.checkpoint.checkpoint(
                run, x, use_reentrant=False, preserve_rng_state=False))
    src = torch.from_numpy(_source())
    rng = torch.Generator().manual_seed(7)
    if upstream == "hubert":
        tgt = torch.from_numpy(np.random.default_rng(1).integers(
            0, N_CLASSES[0], (len(LENGTHS), T_FRAMES))).long()
        out = model(src, LENGTHS, mask=True, rng=rng, deterministic=False,
                    target_list=[tgt])
    else:
        out = model(src, LENGTHS, compute_loss=True, mask=True, rng=rng,
                    deterministic=False, gumbel_temp=1.5)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(out["loss"], list(named.values()),
                                allow_unused=True)
    return float(out["loss"]), {k: g for k, g in zip(named, grads)
                                if g is not None}


@pytest.mark.parametrize("upstream", ["hubert", "wav2vec2"])
def test_checkpoint_activations_gives_the_same_loss_and_gradients(
        upstream, monkeypatch):
    calls = []
    real = tencoder.encoder_layer_forward

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tencoder, "encoder_layer_forward", counting)
    loss, grads = _remat_grads(upstream, False)
    assert len(calls) == 2  # one forward a layer
    calls.clear()
    loss_r, grads_r = _remat_grads(upstream, True)
    assert len(calls) == 4  # each layer recomputed in the backward
    assert grads.keys() == grads_r.keys()
    assert abs(loss_r - loss) <= REMAT_LOSS * abs(loss)
    for k, g in grads.items():
        err = float(torch.linalg.vector_norm(grads_r[k] - g)
                    / torch.linalg.vector_norm(g).clamp_min(1e-30))
        assert err < REMAT_GRAD, k


@pytest.mark.parametrize("upstream", ["hubert", "wav2vec2"])
def test_checkpoint_control_without_the_generator_restore_fails(
        upstream, monkeypatch):
    # the recompute draws new dropout bits: the loss is the forward's, the
    # gradients are not those of the run without checkpointing
    loss, grads = _remat_grads(upstream, False)
    loss_c, grads_c = _remat_grads(upstream, True, monkeypatch, restore=False)
    assert abs(loss_c - loss) <= REMAT_LOSS * abs(loss)
    worst = max(float(torch.linalg.vector_norm(grads_c[k] - g)
                      / torch.linalg.vector_norm(g).clamp_min(1e-30))
                for k, g in grads.items())
    assert worst > 100 * REMAT_GRAD


def _masked_step_grads(upstream, remat, dtype):
    """One training grad step of the trainers' grad step factories (the
    model on masked, ``dtype`` copies of the masters through
    functional_call), dropout on, from fixed generators."""
    over = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
                checkpoint_activations=remat)
    _, tcfg = _cfgs(upstream, **over)
    model = load_wave_model(_params(upstream, _cfgs(upstream)[0]), tcfg,
                            upstream)
    params = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(3)
    masks = {k: (torch.rand(params[k].shape, generator=gen) < 0.5).float()
             for k in prunable_names(params)}
    batch = {"source": torch.from_numpy(_source()), "length": LENGTHS}
    rng = torch.Generator().manual_seed(7)
    if upstream == "hubert":
        batch["target_list"] = [torch.from_numpy(np.random.default_rng(
            1).integers(0, N_CLASSES[0], (len(LENGTHS), T_FRAMES))).long()]
        batch["target_valid"] = torch.ones((len(LENGTHS), T_FRAMES),
                                           dtype=torch.bool)
        step = make_hubert_grad_step(model, compute_dtype=dtype)
        loss, _, grads, _ = step(params, batch, rng, masks=masks)
    else:
        step = make_wav2vec2_grad_step(model, compute_dtype=dtype)
        loss, _, grads, _ = step(params, batch, rng, 1.5, masks=masks)
    return float(loss), dict(zip(params, grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("upstream", ["hubert", "wav2vec2"])
def test_checkpoint_activations_in_a_masked_grad_step(upstream, dtype):
    # the grad step swaps masked, cast copies into the model only while
    # its forward runs: the recompute must run on those, not the masters
    loss, grads = _masked_step_grads(upstream, False, dtype)
    loss_r, grads_r = _masked_step_grads(upstream, True, dtype)
    assert abs(loss_r - loss) <= REMAT_LOSS * abs(loss)
    for k, g in grads.items():
        err = float(torch.linalg.vector_norm(grads_r[k] - g)
                    / torch.linalg.vector_norm(g).clamp_min(1e-30))
        assert err < REMAT_GRAD, k


def test_checkpoint_activations_only_in_a_training_graph():
    # no checkpoint (and no recompute) without grad or with dropout off
    _, tcfg = _cfgs("hubert", checkpoint_activations=True)
    model = load_wave_model(_params("hubert", _cfgs("hubert")[0]), tcfg,
                            "hubert")
    src = torch.from_numpy(_source())
    with torch.no_grad():
        a = model(src, LENGTHS, mask=False)["x"]
    b = model(src, LENGTHS, mask=False)["x"]
    assert torch.equal(a, b.detach())
