"""The port's wav2vec 2.0 model against the JAX package: the config, task
config, block-mask, dataset and weight-bridge copies (bitwise), the Gumbel
quantizer's forward and gradient on injected noise, the negative counts
against JAX's (B, T, N, S) formula on the same draws, the port's own
negative sampler by distribution, the three contrastive formulations, the
features, and the loss, logs and every gradient with the mask, the counts
and the Gumbel noise injected and the dropouts off. Inputs come from numpy
seeds; weights go through the weight bridge. The JAX side runs the Pallas
conv kernel in interpret mode where ``tc_pallas`` is set, as
``tests/test_conv1d.py`` does."""

import os

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from scipy import stats

from speech_ssl_compression_tpu import configs as jconfigs
from speech_ssl_compression_tpu.data import task_config as jtask
from speech_ssl_compression_tpu.data import wav2vec2_dataset as jdata
from speech_ssl_compression_tpu.models import gumbel_vq as jvq
from speech_ssl_compression_tpu.models import wav2vec2 as jw2v
from speech_ssl_compression_tpu.ops import block_masking as jblock
from speech_ssl_compression_tpu.ops import masking as jmasking
from speech_ssl_compression_tpu.utils import torch_convert as jconvert
from speech_ssl_compression_tpu_torch import configs as tconfigs
from speech_ssl_compression_tpu_torch.data import task_config as ttask
from speech_ssl_compression_tpu_torch.data import wav2vec2_dataset as tdata
from speech_ssl_compression_tpu_torch.models import gumbel_vq as tvq
from speech_ssl_compression_tpu_torch.models import wav2vec2 as tw2v
from speech_ssl_compression_tpu_torch.models.conv_frontend import (
    conv_output_length,
    frame_lengths,
)
from speech_ssl_compression_tpu_torch.ops import block_masking as tblock
from speech_ssl_compression_tpu_torch.ops import conv1d as tconv
from speech_ssl_compression_tpu_torch.utils import torch_convert as tconvert
from speech_ssl_compression_tpu_torch.utils.weights import (
    init_wav2vec2_params_np,
    load_wave_model,
    wave_tree_from_named,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAR = 1e-4          # max |d| / mean |ref| on valid frames
GRAD_BAR = 1e-4     # rel. L2: loss, logs and every gradient
SECTION_BAR = 1e-5  # the contrastive section and the quantizer
CONV = "[(32,10,5)] + [(32,3,2)] + [(32,2,2)]"  # as tests/test_wave_runner.py
# layers 1-2 take the strided-conv kernel route (C = O = 128)
CONV_TC = "[(128,10,5)] + [(128,3,2)] + [(128,2,2)]"
TINY = dict(
    encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
    encoder_attention_heads=2, head_dim=16, conv_feature_layers=CONV,
    final_dim=16, conv_pos=16, conv_pos_groups=4, quantize_targets=True,
    latent_vars=8, latent_groups=2, num_negatives=4, feature_grad_mult=0.1,
    mask_prob=0.65, mask_length=4, dropout=0.0, attention_dropout=0.0,
    activation_dropout=0.0,
)
LENGTHS = np.array([2400, 1930])  # 119 frames, 96 valid in row 1
T_FRAMES = 119


def _cfgs(**over):
    d = dict(TINY, **over)
    return (jconfigs.Wav2Vec2Config.from_dict(d),
            tconfigs.Wav2Vec2Config.from_dict(d))


def _params(jcfg, seed=0):
    p = jw2v.init_wav2vec2_params(jax.random.PRNGKey(seed), jcfg)
    return jax.tree.map(np.asarray, p)


def _source(seed=0):
    rng = np.random.default_rng(seed)
    src = np.zeros((len(LENGTHS), LENGTHS.max()), np.float32)
    for i, n in enumerate(LENGTHS):
        src[i, :n] = 0.3 * rng.standard_normal(n)
    return src


def _rel(got, ref, valid=None):
    got, ref = np.asarray(got), np.asarray(ref)
    if valid is not None:
        got, ref = got[valid], ref[valid]
    return np.abs(got - ref).max() / np.abs(ref).mean()


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _valid_frames():
    cfg = tconfigs.Wav2Vec2Config.from_dict(TINY)
    n = frame_lengths(LENGTHS, cfg.conv_feature_layers, T_FRAMES)
    return np.arange(T_FRAMES)[None, :] < n[:, None]


def _fixed_mask(seed=0):
    cfg = tconfigs.Wav2Vec2Config.from_dict(TINY)
    return tw2v.span_mask(cfg, frame_lengths(
        LENGTHS, cfg.conv_feature_layers, T_FRAMES), T_FRAMES,
        np.random.default_rng(seed))


def test_configs_are_copies_of_jax():
    with open(os.path.join(REPO, "configs/wav2vec2/config_model.yaml")) as f:
        section = yaml.safe_load(f)["wav2vec2"]
    for d in (section, TINY, dict(TINY, quantizer_depth=2,
                                  encoder_attention_heads=[2, 1])):
        want = jconfigs.Wav2Vec2Config.from_dict(d)
        got = tconfigs.Wav2Vec2Config.from_dict(d)
        assert got.to_dict() == want.to_dict()
        assert tconfigs.Wav2Vec2Config.from_dict(want.to_dict()) == got
        assert (got.with_heads([1] * got.encoder_layers).to_dict()
                == want.with_heads([1] * want.encoder_layers).to_dict())
        assert (got.with_ffn_dims([8] * got.encoder_layers).to_dict()
                == want.with_ffn_dims([8] * want.encoder_layers).to_dict())
    assert type(got).__module__.startswith("speech_ssl_compression_tpu_torch")
    got = tconfigs.wav2vec2_config_from_yaml(
        os.path.join(REPO, "configs/wav2vec2/config_model.yaml"))
    assert (got.final_dim, got.latent_vars, got.num_negatives) == (256, 320, 100)
    assert got.conv_frontend_impl == "auto" and got.contrastive_impl == "auto"
    with pytest.raises(ValueError, match="wav2vec2"):
        tconfigs.wav2vec2_config_from_yaml(
            os.path.join(REPO, "configs/hubert/config_model.yaml"))


def test_task_configs_are_copies_of_jax():
    for path in ("configs/wav2vec2/config_runner.yaml",
                 "configs/weight_pruning/wav2vec2_config_runner.yaml",
                 "configs/row_pruning/wav2vec2_config_runner.yaml"):
        with open(os.path.join(REPO, path)) as f:
            task = yaml.safe_load(f)["task"]
        task["precompute_mask_config"] = {"mask_prob": 0.5, "mask_length": 3}
        want = jtask.Wav2vec2TaskConfig.from_dict(task)
        got = ttask.Wav2vec2TaskConfig.from_dict(task)
        assert vars(got) == vars(want), path


@pytest.mark.parametrize("kw", [
    dict(mask_prob=0.65, mask_length=5),
    dict(mask_prob=0.5, mask_length=4, non_overlapping=True),
    dict(mask_prob=0.4, mask_length=3, inverse_mask=True, mask_dropout=0.1,
         mask_prob_adjust=0.05),
    dict(mask_prob=0.3, mask_length=6, require_same_masks=False),
])
def test_block_masks_match_jax(kw):
    for seed in range(3):
        got = tblock.compute_block_mask_1d(
            (4, 97), rng=np.random.default_rng(seed), **kw)
        want = jblock.compute_block_mask_1d(
            (4, 97), rng=np.random.default_rng(seed), **kw)
        assert got.dtype == bool
        np.testing.assert_array_equal(got, want)


def make_w2v_dataset(root, n_utts=9, seed=0, low=3000, high=6000):
    """A TSV manifest of 16 kHz WAVs (no labels)."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n_utts):
        n = int(rng.integers(low, high))
        pcm = (rng.uniform(-0.3, 0.3, n) * 32767).astype(np.int16)
        wavfile.write(root / f"u{i}.wav", 16000, pcm)
        lines.append(f"u{i}.wav\t{n}")
    (root / "train.tsv").write_text(f"{root}\n" + "\n".join(lines) + "\n")
    return str(root)


@pytest.mark.parametrize("pad,mask_cfg,multiple", [
    (False, None, 1),
    (True, None, 1),
    (False, {"mask_prob": 0.5, "mask_length": 3}, 320),
    (True, {"mask_prob": 0.4, "mask_length": 2, "non_overlapping": True}, 1),
])
def test_dataset_batches_match_jax(tmp_path, pad, mask_cfg, multiple):
    data = make_w2v_dataset(tmp_path)
    conv = tconfigs.Wav2Vec2Config.from_dict(TINY).conv_feature_layers
    kw = dict(manifest_path=f"{data}/train.tsv", batch_size=3,
              max_sample_size=5000, min_sample_size=3200, pad=pad,
              normalize=pad, num_buckets=3, crop_seq_to_multiple=multiple,
              seed=5, precompute_mask_config=mask_cfg,
              frames_fn=lambda n: conv_output_length(n, conv))
    want_ds, got_ds = jdata.Wav2Vec2AudioDataset(**kw), tdata.Wav2Vec2AudioDataset(**kw)
    np.testing.assert_array_equal(got_ds.bucket_bounds, want_ds.bucket_bounds)
    assert got_ds.batches == want_ds.batches and len(got_ds) == len(want_ds) > 0
    n = 0
    for _ in range(2):  # two epochs: the shuffle and crop streams go on
        for got, want in zip(got_ds.epoch(), want_ds.epoch()):
            assert sorted(got) == sorted(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key])
            assert got["source"].shape[1] % multiple == 0
            n += 1
    assert n == 2 * len(want_ds)
    sizes = np.random.default_rng(1).integers(1000, 9000, 50)
    for k in (1, 4, 8):
        np.testing.assert_array_equal(tdata.get_percentile_buckets(sizes, k),
                                      jdata.get_percentile_buckets(sizes, k))
    for n_samples in (1, 319, 320, 250001):
        assert (tdata.crop_to_multiple(n_samples, 320)
                == jw2v.crop_to_multiple(n_samples, 320))


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [1, 3])
def test_weight_bridge_is_a_copy_of_jax(tmp_path, depth):
    jcfg, tcfg = _cfgs(conv_feature_layers=CONV_TC, quantizer_depth=depth,
                       quantizer_factor=2)
    params = _params(jcfg)
    want = jconvert.wave_params_to_state_dict(params, "wav2vec2")
    got = tconvert.wave_params_to_state_dict(params, "wav2vec2")
    assert sorted(got) == sorted(want)
    assert ("quantizer.weight_proj.2.weight" in got) == (depth == 3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back, masks, info = tconvert.wave_state_dict_to_params(got, "wav2vec2")
    jback, _, jinfo = jconvert.wave_state_dict_to_params(want, "wav2vec2")
    assert masks is None and info == jinfo
    _assert_trees_equal(back, jback)
    # the module's names are the reference's, and the bridge is lossless
    model = load_wave_model(params, tcfg, "wav2vec2")
    assert sorted(k for k, _ in model.named_parameters()) == sorted(got)
    _assert_trees_equal(
        wave_tree_from_named(dict(model.named_parameters()), "wav2vec2"),
        params)
    # prune.py's weight_orig/weight_mask form of the quantizer's Linear
    if depth == 1:
        sd = dict(want)
        w = sd.pop("quantizer.weight_proj.weight")
        m = (np.arange(w.size).reshape(w.shape) % 3 > 0).astype(np.float32)
        sd["quantizer.weight_proj.weight_orig"] = w
        sd["quantizer.weight_proj.weight_mask"] = m
        a = tconvert.wave_state_dict_to_params(sd, "wav2vec2")[0]
        b = jconvert.wave_state_dict_to_params(sd, "wav2vec2")[0]
        _assert_trees_equal(a, b)
        np.testing.assert_array_equal(a["quantizer"]["weight_proj"]["kernel"],
                                      (w * m).T)
    # a reference .ckpt: the architecture from its metadata
    ckpt = str(tmp_path / "w2v.ckpt")
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in want.items()},
                "Upstream_Config": {"wav2vec2": jcfg.to_dict()},
                "Step": 7}, ckpt)
    gp, gm, gcfg, gx = tconvert.load_wave_reference_checkpoint(ckpt, "wav2vec2")
    wp, wm, wcfg, wx = jconvert.load_wave_reference_checkpoint(ckpt, "wav2vec2")
    _assert_trees_equal(gp, wp)
    assert gm is wm is None and gx == wx == {"Step": 7}
    assert gcfg.to_dict() == wcfg.to_dict()
    assert isinstance(gcfg, tconfigs.Wav2Vec2Config)
    gp, _, gcfg, _, _, _ = tconvert.load_wave_initial_weight(ckpt, "wav2vec2",
                                                             tcfg)
    _assert_trees_equal(gp, wp)
    assert gcfg.to_dict() == wcfg.to_dict()


@pytest.mark.parametrize("over", [{}, dict(quantizer_depth=2),
                                  dict(quantize_targets=False),
                                  dict(latent_dim=12, final_dim=0)])
def test_init_params_np_has_the_jax_tree(over):
    jcfg, tcfg = _cfgs(**over)
    got = init_wav2vec2_params_np(tcfg, seed=0)
    want = _params(jcfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    model = load_wave_model(got, tcfg, "wav2vec2")  # strict
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(want))


def _quantizer_sd(p) -> dict:
    """A JAX-layout quantizer tree (or its gradients) under the module's
    names, kernels as (out, in)."""
    sd = {"vars": np.asarray(p["vars"])}
    wp = p["weight_proj"]
    layers = wp.get("layers")
    items = ([("weight_proj", wp)] if layers is None else
             [(f"weight_proj.{i}.0", lp) for i, lp in enumerate(layers[:-1])]
             + [(f"weight_proj.{len(layers) - 1}", layers[-1])])
    for name, lp in items:
        sd[f"{name}.weight"] = np.ascontiguousarray(np.asarray(lp["kernel"]).T)
        sd[f"{name}.bias"] = np.asarray(lp["bias"])
    return sd


def _vq_params(depth, seed=0):
    p = jvq.init_gumbel_vq(jax.random.PRNGKey(seed), 24, 8, 2, 16,
                           weight_proj_depth=depth, weight_proj_factor=2)
    p = jax.tree.map(np.asarray, p)
    vq = tvq.GumbelVectorQuantizer(24, 8, 2, 16, weight_proj_depth=depth,
                                   weight_proj_factor=2)
    vq.load_state_dict({k: torch.from_numpy(v)
                        for k, v in _quantizer_sd(p).items()})
    return p, vq


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("training", [True, False])
def test_gumbel_vq_matches_jax(depth, training):
    p, vq = _vq_params(depth)
    x = np.random.default_rng(0).standard_normal((2, 37, 24)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (2 * 37 * 2, 8)))
    w = np.random.default_rng(1).standard_normal((2, 37, 16)).astype(np.float32)
    kw = dict(num_vars=8, groups=2, temperature=1.7, training=training,
              produce_targets=True)

    def jax_fn(params, xx):
        q = jvq.gumbel_vq_forward(params, xx, rng=key, **kw)
        return (jnp.sum(q["x"] * w) + 3.0 * q["prob_perplexity"]), q

    (jval, jq), (jgp, jgx) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    q = tvq.gumbel_vq_forward(vq, xt, uniform=torch.from_numpy(u), **kw)
    val = (q["x"] * torch.from_numpy(w)).sum() + 3.0 * q["prob_perplexity"]
    np.testing.assert_array_equal(q["targets"].numpy(), np.asarray(jq["targets"]))
    assert q["num_vars"] == jq["num_vars"] == 16 and q["temp"] == jq["temp"]
    for name in ("code_perplexity", "prob_perplexity"):
        np.testing.assert_allclose(float(q[name]), float(jq[name]), rtol=1e-6)
    assert _rel(q["x"].detach(), jq["x"]) < SECTION_BAR
    assert abs(float(val) - float(jval)) / abs(float(jval)) < SECTION_BAR
    named = dict(vq.named_parameters())
    grads = torch.autograd.grad(val, [xt] + list(named.values()))
    assert _rel_l2(grads[0], jgx) < SECTION_BAR
    want = _quantizer_sd(jax.tree.map(np.asarray, jgp))
    assert sorted(named) == sorted(want)
    for name, g in zip(named, grads[1:]):
        assert _rel_l2(g, want[name]) < SECTION_BAR, name


def test_codebook_samples_and_temperature_match_jax():
    p, vq = _vq_params(1)
    for n in (0, 5, 1000):
        assert tvq.anneal_temp((2.0, 0.5, 0.999995), n) == jvq.anneal_temp(
            (2.0, 0.5, 0.999995), n)
    assert tvq.anneal_temp((2.0, 0.5, 0.9), 100) == 0.5
    gen = torch.Generator().manual_seed(0)
    z = tvq.sample_from_codebook(vq, gen, 3, 5, num_vars=8, groups=2)
    assert z.shape == (3, 5, 16)
    cb = p["vars"].reshape(2, 8, 8)
    for row in z.reshape(-1, 2, 8).detach().numpy():  # every half a codeword
        for g in range(2):
            assert (np.abs(cb[g] - row[g]).max(-1) == 0).any()
    with pytest.raises(ValueError, match="greater than size"):
        tvq.sample_from_codebook(vq, gen, 1, 64, num_vars=8, groups=2)


def _mask_rows(seed=0, b=3, t=60):
    rng = np.random.default_rng(seed)
    mask = rng.random((b, t)) < 0.4
    mask[-1] = False
    mask[-1, 7] = True  # one masked frame: its draws have nowhere to go
    return mask


def test_negative_counts_match_jax_eq_formula(monkeypatch):
    mask = np.concatenate([_mask_rows(), np.zeros((1, 60), bool)])
    draws, ordinal = tw2v._negative_draws(
        torch.Generator().manual_seed(1), torch.from_numpy(mask), 7)
    np.testing.assert_array_equal(ordinal.numpy(), np.cumsum(mask, -1) - 1)
    got = tw2v.negative_counts(draws, torch.from_numpy(mask))
    monkeypatch.setattr(jw2v, "_negative_draws", lambda rng, m, n: (
        jnp.asarray(draws.numpy()), jnp.asarray(ordinal.numpy())))
    want = jw2v.sample_negative_counts(None, jnp.asarray(mask), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the indices JAX's gathered path takes from the same draws
    want_idx = jw2v.sample_negative_indices(None, jnp.asarray(mask), 7)
    np.testing.assert_array_equal(
        tw2v.negative_times(draws, torch.from_numpy(mask)).numpy(),
        np.asarray(want_idx))
    assert not got[-1].any()  # no masked frame: no counts
    # one masked frame: every draw lands on it (the loss excludes it by
    # its codes)
    np.testing.assert_array_equal(got[-2].sum(-1), 7)
    assert got[-2, :, 7].sum() == 7 * 60


def test_negative_sampler_by_distribution():
    b, t, n = 3, 60, 50
    mask = torch.from_numpy(_mask_rows())
    gen = torch.Generator().manual_seed(0)
    idx = tw2v.sample_negative_indices(gen, mask, n)
    counts = tw2v.sample_negative_counts(gen, mask, n)
    assert idx.shape == (b, t, n) and counts.shape == (b, t, t)
    m = mask.numpy()
    for row in range(b - 1):  # the last row has one masked frame
        frames = np.flatnonzero(m[row])
        # counts: only masked frames of the same row, never self, N each
        c = counts[row].numpy()
        assert (c[:, ~m[row]] == 0).all()
        assert (np.diag(c)[m[row]] == 0).all()
        np.testing.assert_array_equal(c[m[row]].sum(-1), n)
        # the draws of masked frames: uniform over the others (chi^2)
        pooled = np.zeros(t)
        for f in frames:
            sel = idx[row, f].numpy()
            assert m[row][sel].all() and not (sel == f).any()
            pooled += np.bincount(sel, minlength=t)
        # each masked frame is drawn n times in expectation
        p = stats.chisquare(pooled[frames], np.full(len(frames), n)).pvalue
        assert p > 1e-4, p
    # the last row's one masked frame takes every draw
    assert counts[-1, :, 7].sum() == counts[-1].sum() == n * t


def test_negative_draws_are_jaxs_mapping_of_the_same_bits(monkeypatch):
    mask = np.concatenate([_mask_rows(), np.zeros((1, 60), bool)])
    raw = np.random.default_rng(5).integers(0, 2**31 - 1, (4, 60, 9))
    monkeypatch.setattr(tw2v, "_raw_draws",
                        lambda *a: torch.from_numpy(raw))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(raw, jnp.int32))
    got, got_ord = tw2v._negative_draws(None, torch.from_numpy(mask), 9)
    want, want_ord = jw2v._negative_draws(None, jnp.asarray(mask), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_ord.numpy(), np.asarray(want_ord))
    got = tw2v.sample_cross_negative_indices(None, torch.from_numpy(mask), 9)
    want = jw2v.sample_cross_negative_indices(None, jnp.asarray(mask), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert mask.reshape(-1)[got.numpy()].all()
    assert set((got.numpy() // 60).ravel()) == {0, 1, 2}  # from every row


def _section_inputs(all_excluded: bool, seed=0, b=2, t=23, d=8, g=2):
    """Predictions, targets made from their codes (equal codes, equal
    targets, as a quantizer's), the codes and a mask; some negatives equal
    their positive, which every formulation excludes. With
    ``all_excluded`` row 1's mask holds two frames of equal codes, so
    neither has a negative left."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    codes = rng.integers(0, 3, (b, t, g)).astype(np.int32)
    mask = rng.random((b, t)) < 0.6
    if all_excluded:
        codes[1, 9] = codes[1, 3]
        mask[1] = False
        mask[1, [3, 9]] = True
    table = rng.standard_normal((g, 3, d // g)).astype(np.float32)
    y = np.concatenate([table[i][codes[..., i]] for i in range(g)], -1)
    return x, y, codes, mask


def _jax_section(impl, x, y, codes, mask, counts, idx, temp):
    """JAX's value and gradients of the summed InfoNCE of one contrastive
    formulation, and its (pos, neg_lse, best_neg)."""
    def fn(xx, yy):
        if impl == "dense":
            pos, lse, best = jw2v.contrastive_dense(
                xx, yy, jnp.asarray(counts), temp, jnp.asarray(codes))
        else:
            if impl == "index":
                pos, neg = jw2v.contrastive_logits_from_idx(
                    xx, yy, jnp.asarray(idx), temp, jnp.asarray(codes))
            else:
                negs = jnp.take_along_axis(
                    yy[:, :, None, :], jnp.asarray(idx)[..., None], axis=1)
                pos, neg = jw2v.contrastive_logits(xx, yy, negs, temp)
            lse = jax.scipy.special.logsumexp(neg, axis=-1)
            best = jnp.max(neg, axis=-1)
        sel = jnp.asarray(mask)
        val = jnp.sum(jnp.where(sel, jnp.logaddexp(pos, lse) - pos, 0.0))
        return val, (pos, lse, best)

    return jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(y))


@pytest.mark.parametrize("all_excluded", [False, True])
@pytest.mark.parametrize("impl", ["dense", "index", "gathered"])
def test_contrastive_formulations_match_jax(impl, all_excluded):
    x, y, codes, mask = _section_inputs(all_excluded)
    tmask = torch.from_numpy(mask)
    draws, _ = tw2v._negative_draws(torch.Generator().manual_seed(2), tmask, 5)
    idx = tw2v.negative_times(draws, tmask)
    counts = tw2v.negative_counts(draws, tmask)
    temp = 0.1
    args = (x, y, codes, mask, counts.numpy(), idx.numpy(), temp)
    (jval, (jpos, jlse, jbest)), (jgx, jgy) = _jax_section(impl, *args)
    if impl == "dense" and all_excluded:
        # JAX's floor of 1e-38 flushes to 0 on XLA: its dense gradients of
        # the row are NaN; hold the port's to JAX's index formulation
        assert np.isnan(np.asarray(jgy)[1]).all()
        _, (jgx, jgy) = _jax_section("index", *args)

    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    tcodes = torch.from_numpy(codes).long()
    if impl == "dense":
        pos, lse, best = tw2v.contrastive_dense(xt, yt, counts, temp, tcodes)
    else:
        if impl == "index":
            pos, neg = tw2v.contrastive_logits_from_idx(xt, yt, idx, temp,
                                                        tcodes)
        else:
            pos, neg = tw2v.contrastive_logits(
                xt, yt, tw2v._gather_frames(yt, idx), temp)
        lse, best = torch.logsumexp(neg, -1), neg.amax(-1)
    val = torch.where(tmask, torch.logaddexp(pos, lse) - pos,
                      torch.zeros(())).sum()
    gx, gy = torch.autograd.grad(val, (xt, yt))
    lse, best = lse.detach().numpy(), best.detach().numpy()
    assert _rel(pos.detach(), jpos) < SECTION_BAR
    m = np.asarray(jlse) > -1e29  # frames with a negative left
    np.testing.assert_array_equal(lse > -1e29, m)
    assert m.sum() > 20 and m[1, [3, 9]].all() != all_excluded
    assert _rel(lse[m], np.asarray(jlse)[m]) < SECTION_BAR
    assert _rel(best[m], np.asarray(jbest)[m]) < SECTION_BAR
    assert (best[~m] < -1e29).all()
    assert abs(float(val) - float(jval)) / abs(float(jval)) < SECTION_BAR
    assert _rel_l2(gx, jgx) < SECTION_BAR and _rel_l2(gy, jgy) < SECTION_BAR


def test_span_mask_is_jaxs_host_sampler():
    cfg = tconfigs.Wav2Vec2Config.from_dict(dict(TINY, mask_dropout=0.1))
    lengths = np.array([180, 199, 150])
    for shared in (False, True):
        got = tw2v.span_mask(cfg, lengths, 199, np.random.default_rng(4),
                             shared_rounding=shared)
        want = jmasking.compute_mask_indices_np(
            (3, 199), None if shared else lengths, mask_prob=0.65,
            mask_length=4, min_masks=2, require_same_masks=True,
            mask_dropout=0.1, rng=np.random.default_rng(4))
        want &= np.arange(199)[None, :] < lengths[:, None]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl,conv", [("tc_pallas", CONV_TC),
                                       ("auto", CONV)])
def test_features_match_jax(impl, conv):
    jcfg, tcfg = _cfgs(conv_frontend_impl=impl, conv_feature_layers=conv)
    params = _params(jcfg)
    src = _source()
    with pltpu.force_tpu_interpret_mode():
        want = jw2v.wav2vec2_forward(
            jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(src),
            jnp.asarray(LENGTHS), mask=False, features_only=True,
            get_hidden=True, attn_impl="dense")
    model = load_wave_model(params, tcfg, "wav2vec2")
    tconv.reset_launch_counts()
    with torch.no_grad():
        got = tw2v.wav2vec2_forward(model, torch.from_numpy(src), LENGTHS,
                                    mask=False, features_only=True,
                                    get_hidden=True)
    valid = ~np.asarray(want["padding_mask"])
    np.testing.assert_array_equal(valid, _valid_frames())
    np.testing.assert_array_equal(got["frame_lengths"],
                                  np.asarray(want["frame_lengths"]))
    np.testing.assert_array_equal(~got["padding_mask"].numpy(), valid)
    assert got["x"].shape == want["x"].shape == (2, T_FRAMES, 32)
    for key in ("x", "features"):
        assert _rel(got[key].numpy(), want[key], valid) < BAR, key
    for g, w in zip(got["layer_hiddens"], want["layer_hiddens"]):
        assert _rel(g.numpy(), w, valid) < BAR
    np.testing.assert_allclose(float(got["features_pen"]),
                               float(want["features_pen"]), rtol=1e-5)
    assert not got["mask_indices"].any()
    assert not any(tconv.launch_counts.values())  # the CPU route


def _jax_vq_uniform(jcfg, b, rng_key):
    """The uniforms JAX's training forward draws for its Gumbel noise: the
    forward's key split 6 ways, index 4 (models/wav2vec2.py:182-183)."""
    vq_rng = jax.random.split(rng_key, 6)[4]
    shape = (b * T_FRAMES * jcfg.latent_groups, jcfg.latent_vars)
    return np.asarray(jax.random.uniform(vq_rng, shape))


@pytest.mark.parametrize("impl,conv", [("tc_pallas", CONV_TC),
                                       ("auto", CONV)])
def test_loss_and_gradients_match_jax(monkeypatch, impl, conv):
    jcfg, tcfg = _cfgs(conv_frontend_impl=impl, conv_feature_layers=conv)
    params = _params(jcfg)
    src = _source()
    mask = _fixed_mask()
    neg_mask = torch.from_numpy(mask & _valid_frames())
    draws, _ = tw2v._negative_draws(torch.Generator().manual_seed(3),
                                    neg_mask, jcfg.num_negatives)
    counts = tw2v.negative_counts(draws, neg_mask)
    monkeypatch.setattr(jw2v, "sample_negative_counts",
                        lambda *a: jnp.asarray(counts.numpy()))
    key = jax.random.PRNGKey(1)
    uniform = _jax_vq_uniform(jcfg, len(LENGTHS), key)
    temp = 1.3

    def jax_loss(p):
        out = jw2v.wav2vec2_forward(
            p, jcfg, jnp.asarray(src), jnp.asarray(LENGTHS), mask=True,
            rng=key, deterministic=False, gumbel_temp=temp, attn_impl="dense",
            mask_indices=jnp.asarray(mask))
        loss, n, logs = jw2v.wav2vec2_pretrain_loss(out, jcfg)
        return loss, (n, logs, out["mask_indices"])

    with pltpu.force_tpu_interpret_mode():
        (jloss, (jn, jlogs, jmask)), jgrads = jax.value_and_grad(
            jax_loss, has_aux=True)(jax.tree.map(jnp.asarray, params))

    model = load_wave_model(params, tcfg, "wav2vec2")
    out = model(torch.from_numpy(src), LENGTHS, compute_loss=True, mask=True,
                mask_indices=torch.from_numpy(mask), rng=torch.Generator(),
                deterministic=False, gumbel_temp=temp,
                gumbel_uniform=torch.from_numpy(uniform),
                negative_counts=counts)
    np.testing.assert_array_equal(out["mask_indices"].numpy(),
                                  np.asarray(jmask))
    assert int(out["sample_size"]) == int(jn) > 0
    assert float(out["temp"]) == temp
    loss = float(out["loss"].detach())
    assert abs(loss - float(jloss)) / abs(float(jloss)) < GRAD_BAR
    assert sorted(out["logs"]) == sorted(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(out["logs"][k]), float(v),
                                   rtol=GRAD_BAR, err_msg=k)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(out["loss"], list(named.values()),
                                allow_unused=True)
    tree = wave_tree_from_named({
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(named.items(), grads)}, "wav2vec2")
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
        assert np.linalg.norm(g - w) / ref < GRAD_BAR, name


def test_index_formulation_matches_dense_on_the_model(monkeypatch):
    """The index formulation gives the dense one's loss and gradients on
    the same draws. (The gathered one excludes a negative by exact vector
    equality with its positive, which follows each framework's rounding of
    the straight-through sum: it is held to JAX's on given vectors, in
    test_contrastive_formulations_match_jax.)"""
    mask = _fixed_mask()
    neg_mask = torch.from_numpy(mask & _valid_frames())
    draws, _ = tw2v._negative_draws(torch.Generator().manual_seed(3),
                                    neg_mask, 4)
    counts = tw2v.negative_counts(draws, neg_mask)
    monkeypatch.setattr(tw2v, "sample_negative_indices",
                        lambda *a: tw2v.negative_times(draws, neg_mask))
    uniform = torch.rand((2 * T_FRAMES * 2, 8),
                         generator=torch.Generator().manual_seed(4))
    params = init_wav2vec2_params_np(_cfgs()[1], 0)
    results = []
    for impl in ("dense", "index"):
        model = load_wave_model(params, _cfgs(contrastive_impl=impl)[1],
                                "wav2vec2")
        out = model(torch.from_numpy(_source()), LENGTHS, compute_loss=True,
                    mask_indices=torch.from_numpy(mask), rng=torch.Generator(),
                    deterministic=False, gumbel_uniform=uniform,
                    negative_counts=counts)
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(out["loss"], list(named.values()),
                                    allow_unused=True)
        results.append((out["loss"].detach(), out["logs"],
                        dict(zip(named, grads))))
    (loss_d, logs_d, g_d), (loss_i, logs_i, g_i) = results
    assert abs(float(loss_d - loss_i)) / abs(float(loss_d)) < SECTION_BAR
    assert float(logs_d["accuracy"]) == float(logs_i["accuracy"])
    total = np.sqrt(sum(float((g ** 2).sum()) for g in g_d.values()
                        if g is not None))
    for name, a in g_d.items():
        b = g_i[name]
        assert (a is None) == (b is None), name
        if a is not None:  # k_proj biases: zero up to rounding
            ref = total if "k_proj.bias" in name else float(a.norm())
            assert float((a - b).norm()) / ref < SECTION_BAR, name


def test_training_forward_draws_its_own_mask_and_negatives():
    _, tcfg = _cfgs(dropout=0.1, dropout_input=0.1, dropout_features=0.1,
                    encoder_layerdrop=0.5)
    model = load_wave_model(init_wav2vec2_params_np(tcfg, 0), tcfg, "wav2vec2")
    src = torch.from_numpy(_source())
    outs = []
    for seed in (0, 0, 1):
        out = model(src, LENGTHS, compute_loss=True, mask=True,
                    rng=torch.Generator().manual_seed(seed),
                    deterministic=False, mask_shared_rounding=seed == 1)
        outs.append(out)
        assert torch.isfinite(out["loss"]) and int(out["sample_size"]) > 0
        assert not (out["mask_indices"] & out["padding_mask"]).any()
        if seed == 0:  # require_same_masks (shared rounding cuts row 1)
            n = out["mask_indices"].sum(-1)
            assert (n == n[0]).all()
    assert torch.equal(outs[0]["loss"], outs[1]["loss"])  # the seed decides
    assert not torch.equal(outs[0]["mask_indices"], outs[2]["mask_indices"])
    with pytest.raises(ValueError, match="rng"):
        model(src, LENGTHS, deterministic=False)


def test_model_refuses_what_is_not_ported():
    # channel masks and checkpoint_activations are ported now: the model
    # builds with them; an unknown contrastive formulation stays refused
    for over in (dict(mask_channel_prob=0.1),
                 dict(checkpoint_activations=True)):
        model = tw2v.Wav2Vec2Model(_cfgs(**over)[1])
        for key, value in over.items():
            assert getattr(model.cfg, key) == value
    with pytest.raises(ValueError, match="contrastive_impl"):
        tw2v.Wav2Vec2Model(_cfgs(contrastive_impl="fused")[1])
