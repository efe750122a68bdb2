"""The port's pretrain experts, mirroring ``tests/test_experts.py``: the
reference contract (forward -> (loss, sample_size), load_model,
add_state_to_save with state-dict names) of the MelHuBERT, distiller and
HuBERT experts, the dispatch (wav2vec 2.0 refused until it is ported), the
weight-pruning masks of an ``initial_weight`` kept, and the distiller's
nomasked loss against JAX's distiller expert on the same weights. Tiny
widths, on the CPU."""

import numpy as np
import pytest
import torch
import jax

from speech_ssl_compression_tpu.compress import weight_pruning as jwp
from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.upstream import (
    MelHuBERTDistillerExpert as JaxDistillerExpert,
)
from speech_ssl_compression_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu_torch.compress import weight_pruning as twp
from speech_ssl_compression_tpu_torch.data.dictionary import Dictionary
from speech_ssl_compression_tpu_torch.upstream import (
    MelHuBERTDistillerExpert,
    MelHuBERTPretrainExpert,
    get_pretrain_expert,
)
from speech_ssl_compression_tpu_torch.utils.weights import masks_tree

TINY = {
    "feat_emb_dim": 16,
    "encoder_layers": 1,
    "encoder_embed_dim": 32,
    "encoder_attention_heads": 2,
    "head_dim": 16,
    "encoder_ffn_embed_dim": 64,
    "num_cluster": 8,
    "conv_pos": 8,
    "conv_pos_groups": 2,
    "mask_prob": 0.65,
    "mask_length": 3,
    "dropout": 0.0,
    "attention_dropout": 0.0,
    "activation_dropout": 0.0,
}
LOSS_BAR = 1e-5  # rel.


def _data(seed=0):
    rng = np.random.default_rng(seed)
    pad = np.ones((2, 16), np.float32)
    pad[1, 12:] = 0.0
    return [
        rng.standard_normal((2, 16, 16)).astype(np.float32),
        rng.integers(0, 8, (2, 16)),
        pad,
        [16, 12],
    ]


def _teacher(tmp_path, cfg_dict=TINY, seed=0):
    cfg = MelHuBERTConfig.from_dict(cfg_dict)
    tparams = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(seed), cfg))
    path = str(tmp_path / "teacher.npz")
    jax_save_checkpoint(path, tparams,
                        meta={"Upstream_Config": {"melhubert": cfg_dict}})
    return path, tparams


def test_melhubert_expert_contract():
    exp = MelHuBERTPretrainExpert({"melhubert": TINY}, device="cpu")
    for attr in ("forward", "load_model", "add_state_to_save"):
        assert hasattr(exp, attr)
    loss, sample_size = exp.forward(_data(), global_step=1, log_step=10)
    assert torch.isfinite(loss) and sample_size == 1
    loss.backward()  # the reference runner's backward on the loss
    assert all(p.grad is not None for p in exp.model.parameters())

    states = exp.add_state_to_save({"Step": 3})
    assert "model" in states and "Upstream_Config" in states
    assert states["Step"] == 3
    # torch-style naming in the exported state dict
    assert "encoder.layers.0.self_attn.q_proj.weight" in states["model"]

    before = {k: v.detach().clone() for k, v in exp.model.named_parameters()}
    exp.load_model({"model": states["model"]})
    for k, v in exp.model.named_parameters():
        assert torch.equal(v, before[k]), k
    loss2, _ = exp(_data())
    assert torch.isfinite(loss2)


def test_distiller_expert_contract(tmp_path):
    teacher, _ = _teacher(tmp_path)
    up = {
        "student": dict(TINY, initial_from_teacher=True),
        "teacher": dict(TINY),
        "loss_param": {"T": 2, "alpha": 0.5, "type": "masked"},
    }
    exp = MelHuBERTDistillerExpert(up, teacher, device="cpu")
    # (loss, sample_size): the reference returns a bare loss and would
    # crash its own runner
    loss, sample_size = exp.forward(_data(), global_step=1)
    assert torch.isfinite(loss) and sample_size == 1
    loss.backward()
    assert all(p.grad is None for p in exp.teacher.parameters())
    assert exp.model.encoder.layers[0].fc1.weight.grad is not None
    # initial_from_teacher copied the layer
    assert torch.equal(exp.model.encoder.layers[0].fc1.weight.detach(),
                       exp.teacher.encoder.layers[0].fc1.weight)

    states = exp.add_state_to_save({})
    assert "model" in states and states["Upstream_Config"] is up
    assert "encoder.layers.0.fc1.weight" in states["model"]
    exp.load_model({"model": states["model"]})
    loss2, _ = exp.forward(_data())
    assert torch.isfinite(loss2)
    with pytest.raises(ValueError, match="teacher"):
        MelHuBERTDistillerExpert(up, None, device="cpu")


def test_distiller_accepts_legacy_melhubert_key(tmp_path):
    teacher, _ = _teacher(tmp_path)
    # the legacy distillation config ships the student under "melhubert"
    up = {
        "melhubert": dict(TINY),
        "teacher": dict(TINY),
        "loss_param": {"T": 1, "alpha": 1, "type": "nomasked"},
    }
    exp = MelHuBERTDistillerExpert(up, teacher, device="cpu")
    loss, _ = exp.forward(_data())
    assert torch.isfinite(loss)


def test_distiller_nomasked_loss_matches_jax_expert(tmp_path):
    # dropout 0, nomasked: no random stream is drawn, so JAX's expert and
    # the port's give one loss on the same teacher and student weights
    teacher, _ = _teacher(tmp_path)
    up = {
        "student": dict(TINY),
        "teacher": dict(TINY),
        "loss_param": {"T": 2, "alpha": 0.5, "type": "nomasked"},
    }
    ref = JaxDistillerExpert(up, teacher)
    exp = MelHuBERTDistillerExpert(up, teacher, device="cpu")
    exp.load_model({"params": jax.tree.map(np.asarray, ref.params)})
    for seed in (0, 1):
        want, n = ref.forward(_data(seed))
        got, m = exp.forward(_data(seed))
        assert n == m == 1
        assert abs(float(got.detach()) - float(want)) / float(want) < LOSS_BAR


def test_expert_keeps_weight_pruning_masks(tmp_path):
    """Resuming from a weight-pruned npz keeps the masks, so training
    cannot regrow the zeroed weights."""
    cfg = MelHuBERTConfig.from_dict(TINY)
    params = init_melhubert_params(jax.random.PRNGKey(0), cfg)
    masks = jwp.global_magnitude_prune(params, 0.5)
    ckpt = str(tmp_path / "wp.npz")
    jax_save_checkpoint(ckpt, params, masks=masks,
                        meta={"Upstream_Config": {"melhubert": TINY},
                              "Pruning": {"pruning_times": 1}})

    exp = MelHuBERTPretrainExpert({"melhubert": TINY}, initial_weight=ckpt,
                                  device="cpu")
    assert exp.masks is not None
    assert abs(twp.sparsity_of(masks_tree(exp.masks)) - 0.5) < 1e-6
    loss, _ = exp.forward(_data())
    assert torch.isfinite(loss)
    loss.backward()
    for name, m in exp.masks.items():
        grad = dict(exp.model.named_parameters())[name].grad
        assert not grad[m == 0].any(), name
    states = exp.add_state_to_save({})
    assert "encoder.layers.0.fc1.weight_mask" in states["model"]


HUBERT = {
    "label_rate": 50,
    "encoder_layers": 2, "encoder_embed_dim": 32,
    "encoder_attention_heads": 2, "head_dim": 16,
    "encoder_ffn_embed_dim": 64,
    "conv_feature_layers": "[(32,10,5)] + [(32,3,2)] + [(32,2,2)]",
    "final_dim": 16, "conv_pos": 16, "conv_pos_groups": 4,
    "mask_prob": 0.65, "mask_length": 4,
    "dropout": 0.0, "attention_dropout": 0.0, "activation_dropout": 0.0,
}


def _wave_data(seed=0, b=2, t_wave=4000):
    rng = np.random.default_rng(seed)
    n_lab = int(round(t_wave / 16000 * 50))
    return {
        "net_input": {
            "source": rng.standard_normal((b, t_wave)).astype(np.float32),
            "padding_mask": np.zeros((b, t_wave), bool),
        },
        "target_list": [[rng.integers(0, 8, n_lab) for _ in range(b)]],
    }


def test_hubert_expert_contract():
    Expert = get_pretrain_expert("hubert")
    dicts = [Dictionary([str(i) for i in range(8)])]
    expert = Expert({"hubert": HUBERT, "sample_rate": 16000}, dicts=dicts,
                    device="cpu")
    for attr in ("forward", "load_model", "add_state_to_save"):
        assert hasattr(expert, attr)  # reference runner.py:149-152
    loss, sample_size = expert.forward(_wave_data(), global_step=0)
    assert torch.isfinite(loss) and sample_size > 0
    loss.backward()

    states = expert.add_state_to_save({})
    assert "model" in states and "Upstream_Config" in states
    assert "encoder.layers.0.self_attn.q_proj.weight" in states["model"]
    before = {k: v.detach().clone() for k, v in
              expert.model.named_parameters()}
    expert.load_model({"model": states["model"]})
    for k, v in expert.model.named_parameters():
        assert torch.equal(v, before[k]), k


def test_hubert_expert_initial_weight_keeps_masks_and_pruned_dims(tmp_path):
    """The HuBERT expert's initial_weight loads a pruned architecture and
    keeps the weight-pruning masks."""
    from speech_ssl_compression_tpu.compress import head_pruning as jhp
    from speech_ssl_compression_tpu.configs import HuBERTConfig
    from speech_ssl_compression_tpu.models import init_hubert_params

    cfg = HuBERTConfig.from_dict(HUBERT)
    dicts = [Dictionary([str(i) for i in range(8)])]
    params = init_hubert_params(jax.random.PRNGKey(0), cfg, (len(dicts[0]),))
    params, cfg = jhp.prune_heads(params, cfg, {0: [1]})
    masks = jwp.global_magnitude_prune(params, 0.5)
    ckpt = str(tmp_path / "pruned.npz")
    jax_save_checkpoint(ckpt, params, masks=masks,
                        meta={"Config": cfg.to_dict(), "Step": 0})

    expert = get_pretrain_expert("hubert")(
        {"hubert": HUBERT, "sample_rate": 16000}, initial_weight=ckpt,
        dicts=dicts, device="cpu")
    assert expert.cfg.encoder_attention_heads == (1, 2)  # pruned arch
    assert expert.masks is not None
    assert abs(twp.sparsity_of(masks_tree(expert.masks)) - 0.5) < 0.01
    loss, sample_size = expert.forward(_wave_data(), global_step=0)
    assert torch.isfinite(loss) and sample_size > 0


def test_dispatch_resolves_the_ported_experts_and_refuses_wav2vec2():
    # the name is older than the wav2vec 2.0 expert: dispatch now resolves
    # all four upstreams and refuses only a name that has no module
    for name in ("melhubert", "melhubert_distiller", "hubert", "wav2vec2"):
        cls = get_pretrain_expert(name)
        assert cls.__name__.endswith("Expert"), (name, cls)
        assert cls.__module__.startswith("speech_ssl_compression_tpu_torch.")
    assert get_pretrain_expert("wav2vec2").__name__ == "Wav2Vec2PretrainExpert"
    with pytest.raises(ModuleNotFoundError):
        get_pretrain_expert("wav2vec3")


def test_experts_never_land_on_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MelHuBERTPretrainExpert({"melhubert": TINY})
