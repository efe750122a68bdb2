"""The port's HuBERT slice against the JAX package: the config and weight
bridge copies, ``hubert_forward`` (features only, both conv routes), the
pretrain loss and every gradient with a fixed span mask and dropout off,
the aligned targets, the dataset's batches, and ``-u hubert`` training
through the CLI. Inputs come from numpy seeds; weights go through the
weight bridge. The JAX side runs the Pallas conv kernel in interpret mode,
as ``tests/test_conv1d.py`` does."""

import os

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from speech_ssl_compression_tpu import configs as jconfigs
from speech_ssl_compression_tpu.data import hubert_dataset as jdata
from speech_ssl_compression_tpu.data.dictionary import (
    Dictionary as JaxDictionary,
    build_label_lookup as jax_lookup,
)
from speech_ssl_compression_tpu.models import hubert as jhubert
from speech_ssl_compression_tpu.models import wav2vec2 as jw2v
from speech_ssl_compression_tpu.utils import torch_convert as jconvert
from speech_ssl_compression_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    restore_opt_state,
)
from speech_ssl_compression_tpu.train import steps as jsteps
from speech_ssl_compression_tpu_torch import configs as tconfigs
from speech_ssl_compression_tpu_torch.data import hubert_dataset as tdata
from speech_ssl_compression_tpu_torch.data.dictionary import (
    Dictionary,
    build_label_lookup,
)
from speech_ssl_compression_tpu_torch.models import hubert as thubert
from speech_ssl_compression_tpu_torch.models.conv_frontend import frame_lengths
from speech_ssl_compression_tpu_torch.ops import conv1d as tconv
from speech_ssl_compression_tpu_torch.train.__main__ import main as train_main
from speech_ssl_compression_tpu_torch.utils import torch_convert as tconvert
from speech_ssl_compression_tpu_torch.utils.weights import (
    init_hubert_params_np,
    load_wave_model,
    wave_tree_from_named,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAR = 1e-4       # max |d| / mean |ref| on valid frames
GRAD_BAR = 1e-4  # rel. L2: loss and every gradient
# 2 layers, 128 wide, 2 heads of 64; a frontend whose layers 1-2 take the
# strided-conv kernel route (C = O = 128)
TINY = dict(
    encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
    encoder_attention_heads=2, head_dim=64,
    conv_feature_layers="[(128,10,5),(128,3,2),(128,2,2)]",
    final_dim=32, untie_final_proj=True, conv_pos=16, conv_pos_groups=4,
    feature_grad_mult=0.1, label_rate=100, mask_prob=0.8, mask_length=4,
    dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
)
N_CLASSES = (12,)
LENGTHS = np.array([4000, 3210])


def _cfgs(**over):
    d = dict(TINY, **over)
    return jconfigs.HuBERTConfig.from_dict(d), tconfigs.HuBERTConfig.from_dict(d)


def _params(jcfg, seed=0):
    p = jhubert.init_hubert_params(jax.random.PRNGKey(seed), jcfg, N_CLASSES)
    return jax.tree.map(np.asarray, p)


def _source(seed=0):
    rng = np.random.default_rng(seed)
    src = np.zeros((len(LENGTHS), LENGTHS.max()), np.float32)
    for i, n in enumerate(LENGTHS):
        src[i, :n] = 0.3 * rng.standard_normal(n)
    return src


def _rel(got, ref, valid):
    got, ref = np.asarray(got)[valid], np.asarray(ref)[valid]
    return np.abs(got - ref).max() / np.abs(ref).mean()


def test_configs_are_copies_of_jax():
    for path, key, cls in (
            ("configs/hubert/config_model.yaml", "hubert", "HuBERTConfig"),
            ("configs/melhubert/config_model_20ms.yaml", "melhubert",
             "MelHuBERTConfig")):
        with open(os.path.join(REPO, path)) as f:
            section = yaml.safe_load(f)[key]
        want = getattr(jconfigs, cls).from_dict(section)
        got = getattr(tconfigs, cls).from_dict(section)
        assert got.to_dict() == want.to_dict()
        assert type(got).__module__.startswith("speech_ssl_compression_tpu_torch")
        back = getattr(tconfigs, cls).from_dict(want.to_dict())
        assert back == got
    got = tconfigs.hubert_config_from_yaml(
        os.path.join(REPO, "configs/hubert/config_model.yaml"))
    assert got.conv_feature_layers[0] == (512, 10, 5) and got.final_dim == 256
    with pytest.raises(ValueError, match="hubert"):
        tconfigs.hubert_config_from_yaml(
            os.path.join(REPO, "configs/melhubert/config_model_20ms.yaml"))


def test_weight_bridge_is_a_copy_of_jax():
    jcfg, _ = _cfgs(target_glu=True)
    params = _params(jcfg)
    want = jconvert.wave_params_to_state_dict(params, "hubert")
    got = tconvert.wave_params_to_state_dict(params, "hubert")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back, masks, info = tconvert.wave_state_dict_to_params(got, "hubert")
    jback, _, jinfo = jconvert.wave_state_dict_to_params(want, "hubert")
    assert masks is None and info == jinfo
    assert jax.tree.structure(back) == jax.tree.structure(jback)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(a, b)
    model = load_wave_model(params, tconfigs.HuBERTConfig.from_dict(
        jcfg.to_dict()), "hubert")
    tree = wave_tree_from_named(dict(model.named_parameters()), "hubert")
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert tconvert.infer_pruned_dims(params, 64) == jconvert.infer_pruned_dims(
        params, 64)
    # the wav2vec 2.0 branches are copies too (quantizer and project_q)
    wcfg = jconfigs.Wav2Vec2Config.from_dict(dict(
        TINY, quantize_targets=True, latent_vars=8, latent_groups=2))
    w2v = jax.tree.map(np.asarray, jw2v.init_wav2vec2_params(
        jax.random.PRNGKey(1), wcfg))
    want = jconvert.wave_params_to_state_dict(w2v, "wav2vec2")
    got = tconvert.wave_params_to_state_dict(w2v, "wav2vec2")
    assert sorted(got) == sorted(want) and "quantizer.vars" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(NotImplementedError):
        tconvert.wave_params_to_state_dict(params, "melhubert")


def test_init_params_np_has_the_jax_tree():
    jcfg, tcfg = _cfgs(target_glu=True)
    got = init_hubert_params_np(tcfg, N_CLASSES, seed=0)
    want = _params(jcfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("impl", ["tc_pallas", "auto"])
def test_features_match_jax(impl):
    jcfg, tcfg = _cfgs(conv_frontend_impl=impl)
    params = _params(jcfg)
    src = _source()
    with pltpu.force_tpu_interpret_mode():
        want = jhubert.hubert_forward(
            jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(src),
            jnp.asarray(LENGTHS), mask=False, features_only=True,
            attn_impl="dense")
    model = load_wave_model(params, tcfg, "hubert")
    tconv.reset_launch_counts()
    with torch.no_grad():
        got = thubert.hubert_forward(model, torch.from_numpy(src), LENGTHS,
                                     mask=False, features_only=True,
                                     get_hidden=True)
    valid = ~np.asarray(want["padding_mask"])
    np.testing.assert_array_equal(got["frame_lengths"],
                                  np.asarray(want["frame_lengths"]))
    np.testing.assert_array_equal(~got["padding_mask"].numpy(), valid)
    assert got["x"].shape == want["x"].shape == (2, 199, 128)
    for key in ("x", "features", "unmasked_features"):
        assert _rel(got[key].numpy(), want[key], valid) < BAR, key
    np.testing.assert_allclose(float(got["features_pen"]),
                               float(want["features_pen"]), rtol=1e-5)
    assert not got["mask_indices"].any()
    assert len(got["layer_hiddens"]) == 2
    assert not any(tconv.launch_counts.values())  # the CPU route


def _targets(t_frames, seed=0):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, N_CLASSES[0], (len(LENGTHS), t_frames))
    valid = np.ones((len(LENGTHS), t_frames), bool)
    valid[1, 150:] = False
    return tgt.astype(np.int32), valid


def _fixed_mask(t_frames, seed=0):
    cfg = tconfigs.HuBERTConfig.from_dict(TINY)
    frames = frame_lengths(LENGTHS, cfg.conv_feature_layers, t_frames)
    return thubert.span_mask(cfg, frames, t_frames,
                             np.random.default_rng(seed))


def test_loss_and_gradients_match_jax(monkeypatch):
    jcfg, tcfg = _cfgs(conv_frontend_impl="tc_pallas")
    params = _params(jcfg)
    src = _source()
    t_frames = 199
    mask = _fixed_mask(t_frames)
    tgt, tvalid = _targets(t_frames)
    monkeypatch.setattr(jhubert, "compute_span_mask",
                        lambda *a, **k: jnp.asarray(mask))

    def jax_loss(p):
        out = jhubert.hubert_forward(
            p, jcfg, jnp.asarray(src), jnp.asarray(LENGTHS), mask=True,
            rng=jax.random.PRNGKey(1), deterministic=True, attn_impl="dense")
        loss, n, _ = jhubert.hubert_pretrain_loss(
            p, jcfg, out, [jnp.asarray(tgt)], N_CLASSES,
            target_valid=jnp.asarray(tvalid))
        return loss, n

    with pltpu.force_tpu_interpret_mode():
        (jloss, jn), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
            jax.tree.map(jnp.asarray, params))

    model = load_wave_model(params, tcfg, "hubert")
    out = model(torch.from_numpy(src), LENGTHS, mask=True,
                mask_indices=torch.from_numpy(mask),
                target_list=[torch.from_numpy(tgt).long()],
                target_valid=torch.from_numpy(tvalid))
    assert int(out["sample_size"]) == int(jn) > 0
    loss = float(out["loss"].detach())
    assert abs(loss - float(jloss)) / abs(float(jloss)) < GRAD_BAR
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(out["loss"], list(named.values()),
                                allow_unused=True)
    tree = wave_tree_from_named({
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(named.items(), grads)}, "hubert")
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


def test_aligned_targets_match_jax():
    rng = np.random.default_rng(0)
    lut = rng.permutation(20).astype(np.int32) + 4
    for ratio, t_frames in ((0.5, 40), (1.0, 33), (0.64, 50)):
        labels = [rng.integers(-1, 24, n) for n in (17, 40, 26)]
        got = thubert.encode_aligned_targets_np(labels, t_frames, ratio, lut, 3)
        want = jhubert.encode_aligned_targets_np(labels, t_frames, ratio, lut, 3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    cfg = tconfigs.HuBERTConfig.from_dict(TINY)
    assert thubert.feat2tar_ratio(cfg) == jhubert.feat2tar_ratio(
        jconfigs.HuBERTConfig.from_dict(TINY))


def make_wav_dataset(root, n_utts=7, label_rate=100, seed=0):
    """A TSV manifest of 16 kHz WAVs, ``train.km`` frame labels < 12 and
    ``dict.km.txt``, as ``tests/test_wave_runner.py`` builds them."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    audio = root / "audio"
    audio.mkdir(parents=True, exist_ok=True)
    lines, label_lines = [], []
    for i in range(n_utts):
        n = int(rng.integers(3000, 6000))
        pcm = (rng.uniform(-0.3, 0.3, n) * 32767).astype(np.int16)
        wavfile.write(audio / f"u{i}.wav", 16000, pcm)
        lines.append(f"u{i}.wav\t{n}")
        labs = rng.integers(0, N_CLASSES[0] - 4, int(round(n / 16000 * label_rate)))
        label_lines.append(" ".join(map(str, labs)))
    (root / "train.tsv").write_text(f"{audio}\n" + "\n".join(lines) + "\n")
    (root / "train.km").write_text("\n".join(label_lines) + "\n")
    (root / "dict.km.txt").write_text(
        "".join(f"{c} 100\n" for c in range(N_CLASSES[0] - 4)))
    return str(root)


def test_dataset_batches_match_jax(tmp_path):
    data = make_wav_dataset(tmp_path)
    kw = dict(manifest_path=f"{data}/train.tsv", sample_rate=16000,
              label_paths=[f"{data}/train.km"], label_rates=100,
              batch_size=3, min_keep_sample_size=1000, max_sample_size=4000,
              seed=5)
    want_ds, got_ds = jdata.HubertWaveDataset(**kw), tdata.HubertWaveDataset(**kw)
    assert got_ds.buckets == want_ds.buckets and len(got_ds) == len(want_ds)
    for _ in range(2):  # two epochs: the shuffle and crop streams go on
        for got, want in zip(got_ds.epoch(), want_ds.epoch()):
            np.testing.assert_array_equal(got["source"], want["source"])
            np.testing.assert_array_equal(got["length"], want["length"])
            assert got["starts"] == want["starts"]
            for a, b in zip(got["target_lists"][0], want["target_lists"][0]):
                np.testing.assert_array_equal(a, b)
    d = Dictionary.load(f"{data}/dict.km.txt")
    jd = JaxDictionary.load(f"{data}/dict.km.txt")
    assert d.symbols == jd.symbols and len(d) == N_CLASSES[0]
    np.testing.assert_array_equal(build_label_lookup(d), jax_lookup(jd))


MODEL_YAML = """hubert:
  label_rate: 100
  encoder_layers: 1
  encoder_embed_dim: 128
  encoder_ffn_embed_dim: 256
  encoder_attention_heads: 2
  head_dim: 64
  conv_feature_layers: '[(128,10,5),(128,3,2),(128,2,2)]'
  final_dim: 32
  untie_final_proj: true
  conv_pos: 16
  conv_pos_groups: 4
  mask_prob: 0.8
  mask_length: 4
  dropout: 0.1
  attention_dropout: 0.1
  dropout_input: 0.1
  encoder_layerdrop: 0.05
  feature_grad_mult: 0.1
  conv_frontend_impl: tc_pallas
"""

RUNNER_YAML = """runner:
  total_steps: 2
  gradient_clipping: 10.0
  gradient_accumulate_steps: 2
  log_step: 1
  bf16: true
optimizer:
  lr: 0.0005
  betas:
  - 0.9
  - 0.98
datarc:
  train_batch_size: 2
task:
  data: {data}
  labels:
  - km
  label_rate: 100
  sample_rate: 16000
  max_sample_size: 4000
  min_sample_size: 1000
"""


def test_cli_trains_hubert_and_jax_reads_the_checkpoint(tmp_path):
    data = make_wav_dataset(tmp_path / "data", n_utts=8)
    (tmp_path / "model.yaml").write_text(MODEL_YAML)
    (tmp_path / "runner.yaml").write_text(RUNNER_YAML.format(data=data))
    exp = tmp_path / "exp"
    runner = train_main(["-m", "melhubert", "-u", "hubert", "-g",
                         str(tmp_path / "model.yaml"), "-c",
                         str(tmp_path / "runner.yaml"), "-n", str(exp),
                         "--device", "cpu", "--seed", "0"])
    assert runner.compute_dtype == torch.float32  # bf16 only on the GPU
    assert [h["step"] for h in runner.log_history] == [1, 2]
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all()
               for h in runner.log_history)
    assert {"last-step.npz", "config_model.yaml",
            "config_runner.yaml"} <= set(os.listdir(exp))

    state = jax_load_checkpoint(str(exp / "last-step.npz"))
    assert state["meta"]["Step"] == 2
    jcfg = jconfigs.HuBERTConfig.from_dict(state["meta"]["Config"])
    template = jax.tree.map(np.asarray, jhubert.init_hubert_params(
        jax.random.PRNGKey(0), jcfg, runner.num_classes))
    assert jax.tree.structure(state["params"]) == jax.tree.structure(template)
    opt = jsteps.make_optimizer_from_config(runner.runner_config)
    leaves = jax.tree.leaves(restore_opt_state(opt.init(template),
                                               state["opt_leaves"]))
    assert int(leaves[0]) == 2  # two updates counted
    np.testing.assert_array_equal(
        state["params"]["feature_extractor"][1]["weight"],
        runner.params["feature_extractor.conv_layers.1.0.weight"]
        .detach().numpy())
    back = load_wave_model(state["params"], tconfigs.HuBERTConfig.from_dict(
        state["meta"]["Config"]), "hubert")
    for k, v in back.named_parameters():
        assert torch.equal(v, runner.params[k].detach()), k


def test_hubert_refuses_what_is_not_ported(tmp_path):
    # channel masks and checkpoint_activations are ported now: the model
    # builds; what stays refused is -m distillation (JAX's WaveRunner
    # trains plain pre-training under that name), a head metric other
    # than l1, --pipeline_parallel and a set with no batch;
    # --model_parallel 2 on one process is refused as JAX's make_mesh
    # refuses it (two ranks: tests/test_torch_parallel.py)
    _, tcfg = _cfgs(mask_channel_prob=0.1, checkpoint_activations=True)
    model = thubert.HuBERTModel(tcfg, N_CLASSES)
    assert model.cfg.mask_channel_prob == 0.1
    data = make_wav_dataset(tmp_path / "data", n_utts=3)
    (tmp_path / "model.yaml").write_text(MODEL_YAML)
    (tmp_path / "runner.yaml").write_text(RUNNER_YAML.format(data=data))
    base = ["-g", str(tmp_path / "model.yaml"), "-c",
            str(tmp_path / "runner.yaml"), "-n", str(tmp_path / "e"),
            "--device", "cpu"]
    for extra in (["-m", "distillation", "-u", "hubert"],
                  ["-m", "distillation", "-u", "wav2vec2"],
                  ["-m", "melhubert", "-u", "hubert", "--pipeline_parallel",
                   "2"]):
        with pytest.raises(NotImplementedError):
            train_main(base + extra)
    with pytest.raises(ValueError, match="model_parallel=2"):
        train_main(base + ["-m", "melhubert", "-u", "hubert",
                           "--model_parallel", "2"])
    (tmp_path / "dd.yaml").write_text(
        RUNNER_YAML.format(data=data) + "prune:\n  metric: data-driven\n"
        "  target: by_whole\n  num_heads_each_step: 1\n  total_steps: 1\n"
        "  interval: 1\n  warm_up: 0\n  data_ratio: 1.0\n")
    with pytest.raises(NotImplementedError, match="data-driven"):
        train_main(base[:2] + ["-c", str(tmp_path / "dd.yaml")] + base[4:]
                   + ["-m", "head-pruning", "-u", "hubert"])
    (tmp_path / "none.yaml").write_text(
        RUNNER_YAML.format(data=data).replace("min_sample_size: 1000",
                                              "min_sample_size: 100000"))
    with pytest.raises(ValueError, match="no batch"):
        train_main(base[:2] + ["-c", str(tmp_path / "none.yaml")] + base[4:]
                   + ["-m", "melhubert", "-u", "hubert"])
