"""``-u wav2vec2`` pre-training through the port's CLI against the JAX
package: two updates on the CPU whose checkpoint JAX's ``load_checkpoint``
reads and JAX's WaveRunner starts from, the Gumbel temperature of every
micro-step, a resume, the dataset's block masks reaching the grad step,
the OOM window drop, what stays refused, a weight-pruned start, and the
two pretrain experts agreeing on the same weights with the mask, the
counts and the Gumbel noise injected."""

import os
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu import configs as jconfigs
from speech_ssl_compression_tpu.models import wav2vec2 as jw2v
from speech_ssl_compression_tpu.models.gumbel_vq import (
    anneal_temp as jax_anneal_temp,
)
from speech_ssl_compression_tpu.train import steps as jsteps
from speech_ssl_compression_tpu.train.wave_runner import (
    WaveRunner as JaxWaveRunner,
)
from speech_ssl_compression_tpu.upstream.wav2vec2 import (
    Wav2Vec2PretrainExpert as JaxExpert,
)
from speech_ssl_compression_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    restore_opt_state,
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu_torch import configs as tconfigs
from speech_ssl_compression_tpu_torch.configs import read_yaml
from speech_ssl_compression_tpu_torch.data.wav2vec2_dataset import (
    Wav2Vec2AudioDataset,
)
from speech_ssl_compression_tpu_torch.models import wav2vec2 as tw2v
from speech_ssl_compression_tpu_torch.models.conv_frontend import (
    conv_output_length,
)
from speech_ssl_compression_tpu_torch.train import wave_runner
from speech_ssl_compression_tpu_torch.train.__main__ import get_args
from speech_ssl_compression_tpu_torch.train.__main__ import main as train_main
from speech_ssl_compression_tpu_torch.upstream import get_pretrain_expert
from speech_ssl_compression_tpu_torch.utils.weights import load_wave_model
from test_torch_wav2vec2 import make_w2v_dataset

CONV = "[(32,10,5)] + [(32,3,2)] + [(32,2,2)]"  # as tests/test_wave_runner.py
GRAD_BAR = 1e-4

MODEL_YAML = f"""wav2vec2:
  encoder_layers: 2
  encoder_embed_dim: 32
  encoder_ffn_embed_dim: 64
  encoder_attention_heads: 2
  head_dim: 16
  conv_feature_layers: '{CONV}'
  final_dim: 16
  conv_pos: 16
  conv_pos_groups: 4
  quantize_targets: true
  latent_vars: 8
  latent_groups: 2
  latent_temp:
  - 2.0
  - 0.5
  - 0.9
  num_negatives: 4
  mask_prob: 0.65
  mask_length: 4
  dropout: 0.1
  attention_dropout: 0.1
  dropout_input: 0.1
  dropout_features: 0.1
  encoder_layerdrop: 0.05
  feature_grad_mult: 0.1
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
  eps: 1.0e-06
  weight_decay: 0.01
datarc:
  train_batch_size: 2
task:
  data: {data}
  max_sample_size: 4000
  min_sample_size: 3200
  normalize: false
  num_batch_buckets: 2
  sample_rate: 16000
"""


def _write(tmp_path, runner_yaml=RUNNER_YAML, model_yaml=MODEL_YAML):
    data = make_w2v_dataset(tmp_path / "data", n_utts=8)
    (tmp_path / "model.yaml").write_text(model_yaml)
    (tmp_path / "runner.yaml").write_text(runner_yaml.format(data=data))
    return ["-g", str(tmp_path / "model.yaml"), "-c",
            str(tmp_path / "runner.yaml"), "--device", "cpu"]


def test_cli_trains_wav2vec2_and_jax_reads_the_checkpoint(tmp_path):
    base = _write(tmp_path)
    exp = tmp_path / "exp"
    runner = train_main(["-m", "melhubert", "-u", "wav2vec2", "-n", str(exp),
                         "--seed", "0"] + base)
    assert runner.compute_dtype == torch.float32  # bf16 only on the GPU
    assert not runner.pad  # crop-collated: one span-count draw per batch
    assert [h["step"] for h in runner.log_history] == [1, 2]
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all()
               for h in runner.log_history)
    # the temperature the quantizer ran at, per micro-step, is the host's
    # anneal of the update count
    cfg = runner.cfg
    assert list(runner.temp_history) == [
        (s, jax_anneal_temp(cfg.latent_temp, s)) for s in (0, 0, 1, 1)]
    assert runner.temp_history[2][1] == pytest.approx(1.8)
    assert {"last-step.npz", "config_model.yaml",
            "config_runner.yaml"} <= set(os.listdir(exp))

    state = jax_load_checkpoint(str(exp / "last-step.npz"))
    assert state["meta"]["Step"] == 2
    jcfg = jconfigs.Wav2Vec2Config.from_dict(state["meta"]["Config"])
    template = jax.tree.map(np.asarray, jw2v.init_wav2vec2_params(
        jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(state["params"]) == jax.tree.structure(template)
    for a, b in zip(jax.tree.leaves(state["params"]),
                    jax.tree.leaves(template)):
        assert a.shape == b.shape and a.dtype == b.dtype
    opt = jsteps.make_optimizer_from_config(runner.runner_config)
    leaves = jax.tree.leaves(restore_opt_state(opt.init(template),
                                               state["opt_leaves"]))
    assert int(leaves[0]) == 2  # two updates counted
    np.testing.assert_array_equal(
        state["params"]["quantizer"]["vars"],
        runner.params["quantizer.vars"].detach().numpy())
    back = load_wave_model(state["params"],
                               tconfigs.Wav2Vec2Config.from_dict(
                                   state["meta"]["Config"]), "wav2vec2")
    for k, v in back.named_parameters():
        assert torch.equal(v, runner.params[k].detach()), k

    # JAX's trainer starts from the port's checkpoint, Adam state included
    args = types.SimpleNamespace(
        mode="melhubert", upstream="wav2vec2", expdir=str(tmp_path / "jax"),
        initial_weight=str(exp / "last-step.npz"),
        init_optimizer_from_initial_weight=True, seed=0)
    jrunner = JaxWaveRunner(args, runner.runner_config, runner.upstream_config)
    for a, b in zip(jax.tree.leaves(jrunner.params),
                    jax.tree.leaves(state["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(jax.tree.leaves(jrunner.opt_state)[0]) == 2

    # and the port resumes from it: two more updates on the restored Adam
    resumed = train_main(["-m", "melhubert", "-u", "wav2vec2", "-n",
                          str(tmp_path / "resumed"), "-i",
                          str(exp / "last-step.npz"),
                          "--init_optimizer_from_initial_weight"] + base)
    assert int(resumed.opt_state[0]) == 4
    assert [h["step"] for h in resumed.log_history] == [1, 2]


def test_block_masks_reach_the_grad_step(tmp_path, monkeypatch):
    runner_yaml = RUNNER_YAML.replace(
        "  sample_rate: 16000\n",
        "  sample_rate: 16000\n  precompute_mask_config:\n"
        "    mask_prob: 0.5\n    mask_length: 3\n")
    base = _write(tmp_path, runner_yaml)
    args = ["-m", "melhubert", "-u", "wav2vec2", "-n", str(tmp_path / "e"),
            "--seed", "3"] + base
    cfg = read_yaml(tmp_path / "runner.yaml")
    assert cfg["task"]["precompute_mask_config"] == {"mask_prob": 0.5,
                                                     "mask_length": 3}
    seen = []
    orig = wave_runner.make_wav2vec2_grad_step

    def recording(*a, **kw):
        step = orig(*a, **kw)

        def wrapped(params, batch, *rest, **kwargs):
            seen.append(batch["precomputed_mask"].clone())
            return step(params, batch, *rest, **kwargs)
        return wrapped

    monkeypatch.setattr(wave_runner, "make_wav2vec2_grad_step", recording)
    runner = train_main(args)
    assert len(seen) == 4 and runner.log_history[-1]["step"] == 2
    # the dataset's masks, in its order, for the same seed
    conv = runner.cfg.conv_feature_layers
    ds = Wav2Vec2AudioDataset(
        f"{cfg['task']['data']}/train.tsv", batch_size=2,
        max_sample_size=4000, min_sample_size=3200, num_buckets=2, seed=3,
        precompute_mask_config={"mask_prob": 0.5, "mask_length": 3},
        frames_fn=lambda n: conv_output_length(n, conv))
    want = [b["precomputed_mask"] for b in ds.epoch()]
    want += [b["precomputed_mask"] for b in ds.epoch()]
    for got, w in zip(seen, want):
        np.testing.assert_array_equal(got.numpy(), w)


def test_oom_drops_the_window(tmp_path):
    base = _write(tmp_path)
    args = get_args(["-m", "melhubert", "-u", "wav2vec2", "-n",
                     str(tmp_path / "e")] + base)
    runner = wave_runner.WaveRunner(args, read_yaml(args.runner_config),
                        read_yaml(args.upstream_config))
    calls, sizes, applied = [], [], []
    step, apply = runner.grad_step, runner.apply

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 2:  # the second micro-batch of the first window
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        out = step(*a, **kw)
        sizes.append(int(out[1]))
        return out

    def recording(grads, sample_size):
        applied.append(float(sample_size))
        return apply(grads, sample_size)

    runner.grad_step, runner.apply = failing, recording
    runner.train()
    # window 1 dropped whole (its first micro-batch's count with it)
    assert len(calls) == 6
    assert applied == [sizes[1] + sizes[2], sizes[3] + sizes[4]]


def test_wav2vec2_refuses_what_is_not_ported(tmp_path):
    # the pruning modes, channel masks and checkpoint_activations are
    # ported now; what stays refused is -m distillation (JAX's WaveRunner
    # trains plain pre-training under that name), a head metric other
    # than l1, --pipeline_parallel and a set with no batch;
    # --model_parallel 2 on one process is refused as JAX's make_mesh
    # refuses it (two ranks: tests/test_torch_parallel.py)
    base = _write(tmp_path)
    with pytest.raises(NotImplementedError, match="distillation"):
        train_main(["-m", "distillation", "-u", "wav2vec2", "-n",
                    str(tmp_path / "e")] + base)
    with pytest.raises(NotImplementedError, match="pipeline_parallel"):
        train_main(["-m", "melhubert", "-u", "wav2vec2", "-n",
                    str(tmp_path / "e"), "--pipeline_parallel", "2"] + base)
    with pytest.raises(ValueError, match="model_parallel=2"):
        train_main(["-m", "melhubert", "-u", "wav2vec2", "-n",
                    str(tmp_path / "e"), "--model_parallel", "2"] + base)
    (tmp_path / "dd.yaml").write_text(
        (tmp_path / "runner.yaml").read_text() + "prune:\n"
        "  metric: data-driven\n  target: by_whole\n"
        "  num_heads_each_step: 1\n  total_steps: 1\n  interval: 1\n"
        "  warm_up: 0\n  data_ratio: 1.0\n")
    with pytest.raises(NotImplementedError, match="data-driven"):
        train_main(["-m", "head-pruning", "-u", "wav2vec2", "-n",
                    str(tmp_path / "e"), "-g", base[1], "-c",
                    str(tmp_path / "dd.yaml"), "--device", "cpu"])
    (tmp_path / "chan.yaml").write_text(
        MODEL_YAML + "  mask_channel_prob: 0.1\n"
        "  checkpoint_activations: true\n")
    runner = wave_runner.WaveRunner(
        get_args(["-m", "melhubert", "-u", "wav2vec2", "-n",
                  str(tmp_path / "c"), "-g", str(tmp_path / "chan.yaml")]
                 + base[2:]),
        read_yaml(base[3]), read_yaml(str(tmp_path / "chan.yaml")))
    assert runner.cfg.mask_channel_prob == 0.1
    assert runner.cfg.checkpoint_activations
    # a set with no batch would loop forever
    (tmp_path / "none.yaml").write_text(
        (tmp_path / "runner.yaml").read_text().replace(
            "min_sample_size: 3200", "min_sample_size: 100000"))
    with pytest.raises(ValueError, match="no batch"):
        train_main(["-m", "melhubert", "-u", "wav2vec2", "-n",
                    str(tmp_path / "e"), "-g", base[1], "-c",
                    str(tmp_path / "none.yaml"), "--device", "cpu"])


def test_the_two_experts_agree(tmp_path, monkeypatch):
    up = read_yaml(_write(tmp_path)[1])
    for key in ("dropout", "attention_dropout", "dropout_input",
                "dropout_features", "encoder_layerdrop"):
        up["wav2vec2"][key] = 0.0
    jcfg = jconfigs.Wav2Vec2Config.from_dict(up["wav2vec2"])
    params = jw2v.init_wav2vec2_params(jax.random.PRNGKey(7), jcfg)
    ckpt = str(tmp_path / "init.npz")
    jax_save_checkpoint(ckpt, params, meta={"Config": jcfg.to_dict()})

    rng = np.random.default_rng(0)
    b, n = 2, 3600
    source = 0.3 * rng.standard_normal((b, n)).astype(np.float32)
    pad = np.zeros((b, n), bool)
    pad[1, 3000:] = True
    data = {"net_input": {"source": source, "padding_mask": pad}}
    t = conv_output_length(n, jcfg.conv_feature_layers)
    lengths = np.array([n, 3000])
    tcfg = tconfigs.Wav2Vec2Config.from_dict(jcfg.to_dict())
    mask = tw2v.span_mask(tcfg, conv_output_length(3000, tcfg.conv_feature_layers)
                          * np.array([0, 1]) + np.array([t, 0]), t,
                          np.random.default_rng(1))
    valid = np.arange(t)[None, :] < np.array(
        [t, conv_output_length(3000, tcfg.conv_feature_layers)])[:, None]
    neg_mask = torch.from_numpy(mask & valid)
    draws, _ = tw2v._negative_draws(torch.Generator().manual_seed(2),
                                    neg_mask, jcfg.num_negatives)
    counts = tw2v.negative_counts(draws, neg_mask)
    # JAX's expert draws its Gumbel uniforms from PRNGKey(0) split once
    # (a loaded expert keeps the key), then the forward's split 6 ways
    k = jax.random.split(jax.random.PRNGKey(0))[1]
    uniform = np.asarray(jax.random.uniform(
        jax.random.split(k, 6)[4], (b * t * jcfg.latent_groups,
                                    jcfg.latent_vars)))
    monkeypatch.setattr(jw2v, "compute_span_mask",
                        lambda *a, **kw: jnp.asarray(mask))
    monkeypatch.setattr(jw2v, "sample_negative_counts",
                        lambda *a: jnp.asarray(counts.numpy()))
    monkeypatch.setattr(tw2v, "span_mask", lambda *a, **kw: mask)
    monkeypatch.setattr(tw2v, "sample_negative_counts", lambda *a: counts)
    vq = tw2v.gumbel_vq_forward
    monkeypatch.setattr(tw2v, "gumbel_vq_forward", lambda *a, **kw: vq(
        *a, **dict(kw, uniform=torch.from_numpy(uniform))))

    jexpert = JaxExpert(up, initial_weight=ckpt)
    jloss, jn = jexpert.forward(data, global_step=3)
    expert = get_pretrain_expert("wav2vec2")(up, initial_weight=ckpt,
                                             device="cpu")
    loss, n_masked = expert.forward(data, global_step=3)
    assert loss.requires_grad and n_masked == jn == int((mask & valid).sum())
    assert abs(float(loss) - float(jloss)) / abs(float(jloss)) < GRAD_BAR
    # add_state_to_save / load_model round trip, in the reference naming
    state = expert.add_state_to_save({})
    assert "quantizer.weight_proj.weight" in state["model"]
    again = get_pretrain_expert("wav2vec2")(up, device="cpu")
    again.load_model(state)
    for (k1, v1), (k2, v2) in zip(expert.model.named_parameters(),
                                  again.model.named_parameters()):
        assert k1 == k2 and torch.equal(v1, v2), k1


def test_a_weight_pruned_start_trains_at_its_sparsity(tmp_path):
    # a JAX wav2vec 2.0 checkpoint with weight-pruning masks: the trainer
    # keeps them, and every masked entry's gradient is exactly 0
    from speech_ssl_compression_tpu.compress import weight_pruning as jwp

    base = _write(tmp_path)
    up = read_yaml(base[1])
    jcfg = jconfigs.Wav2Vec2Config.from_dict(up["wav2vec2"])
    params = jw2v.init_wav2vec2_params(jax.random.PRNGKey(3), jcfg)
    masks = jwp.global_magnitude_prune(params, 0.5)
    ckpt = str(tmp_path / "pruned.npz")
    jax_save_checkpoint(ckpt, params, masks=masks,
                        meta={"Config": jcfg.to_dict(), "Step": 0})
    args = get_args(["-m", "melhubert", "-u", "wav2vec2", "-n",
                     str(tmp_path / "e"), "-i", ckpt] + base)
    runner = wave_runner.WaveRunner(args, read_yaml(args.runner_config), up)
    assert runner.masks and len(runner.masks) == 2 * 6 * jcfg.encoder_layers
    batch = runner._collate(next(runner._get_dataset().epoch()))
    _, n, grads, _ = runner.grad_step(runner.params, batch, runner.rng,
                                      masks=runner.masks, gumbel_temp=2.0)
    named = dict(zip(runner.params, grads))
    zeros = 0
    for name, m in runner.masks.items():
        assert torch.equal(named[name][m == 0],
                           torch.zeros_like(named[name][m == 0])), name
        zeros += int((m == 0).sum())
    assert zeros > 0 and int(n) > 0
    expert = get_pretrain_expert("wav2vec2")(up, initial_weight=ckpt,
                                             device="cpu")
    assert sorted(expert.masks) == sorted(runner.masks)
