"""The port's ``melhubert_forward`` against the JAX one
(``attn_impl="dense"``) on the same weights, carried over by the weight
bridge, and against the independent torch oracle
``tests/golden/melhubert_tiny.npz``."""

import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.models import (
    init_melhubert_params,
    melhubert_forward as jax_forward,
)
from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig as PortConfig,
)
from speech_ssl_compression_tpu_torch.models import (
    MelHuBERTModel,
    melhubert_forward,
)
from speech_ssl_compression_tpu_torch.utils.weights import load_model

BAR = 1e-4  # max |d| / mean |ref| on valid frames (tests/test_model_golden.py)
GOLDEN = pathlib.Path(__file__).parent / "golden" / "melhubert_tiny.npz"
TINY = dict(feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=128,
            encoder_ffn_embed_dim=256, encoder_attention_heads=2, head_dim=64,
            conv_pos=16, conv_pos_groups=4, num_cluster=32)


def _cfg(variant):
    cfg = MelHuBERTConfig.from_dict(
        dict(TINY, layer_norm_first=variant == "pre_ln",
             attention_type="causal" if variant == "causal" else "original")
    )
    if variant == "pruned":
        cfg = cfg.with_heads((2, 1)).with_ffn_dims((256, 96))
    return cfg


def _port(cfg):
    """The port's own config for a JAX one (the two classes differ)."""
    return PortConfig.from_dict(cfg.to_dict())


def _inputs(seed=0, b=3, t=40):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, t, 80)).astype(np.float32)
    lengths = np.array([t, 25, 7])[:b]
    pad_mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return feat, pad_mask


def _rel(got, ref, valid):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref)[valid].max() / np.abs(ref)[valid].mean()


@pytest.mark.parametrize("attn_impl", ["auto", "dense"])
@pytest.mark.parametrize("variant", ["post_ln", "pruned", "pre_ln", "causal"])
def test_forward_matches_jax(variant, attn_impl):
    cfg = _cfg(variant)
    params = jax.tree.map(np.asarray,
                          init_melhubert_params(jax.random.PRNGKey(0), cfg))
    feat, pad_mask = _inputs()
    ref = jax_forward(params, cfg, jnp.asarray(feat), jnp.asarray(pad_mask),
                      get_hidden=True, attn_impl="dense")
    model = load_model(params, _port(cfg))
    if variant == "pruned":
        layers = model.encoder.layers
        assert [l.self_attn.num_heads for l in layers] == [2, 1]
        assert [l.fc1.out_features for l in layers] == [256, 96]
    with torch.no_grad():
        out = melhubert_forward(model, torch.from_numpy(feat),
                                torch.from_numpy(pad_mask), get_hidden=True,
                                attn_impl=attn_impl)
    valid = pad_mask.astype(bool)
    for key in ("pre_feat", "hidden", "logits"):
        assert _rel(out[key].numpy(), ref[key], valid) < BAR, key
    assert len(out["layer_hiddens"]) == cfg.encoder_layers
    for i, (a, b) in enumerate(zip(out["layer_hiddens"], ref["layer_hiddens"])):
        assert _rel(a.numpy(), b, valid) < BAR, i


def test_zero_layer_model_is_gelu_of_projection():
    cfg = MelHuBERTConfig.from_dict(dict(TINY, encoder_layers=0))
    params = jax.tree.map(np.asarray,
                          init_melhubert_params(jax.random.PRNGKey(1), cfg))
    feat, pad_mask = _inputs(seed=1)
    ref = jax_forward(params, cfg, jnp.asarray(feat), jnp.asarray(pad_mask))
    with torch.no_grad():
        out = melhubert_forward(load_model(params, _port(cfg)),
                                torch.from_numpy(feat),
                                torch.from_numpy(pad_mask))
    valid = pad_mask.astype(bool)
    assert _rel(out["hidden"].numpy(), ref["hidden"], valid) < BAR
    assert _rel(out["logits"].numpy(), ref["logits"], valid) < BAR


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="pos_conv_depth"):
        MelHuBERTModel(PortConfig.from_dict(dict(TINY, pos_conv_depth=2)))
    # span masking is ported; without a mask or an rng to draw one it raises
    model = MelHuBERTModel(PortConfig.from_dict(TINY))
    with pytest.raises(ValueError, match="masking"):
        melhubert_forward(model, torch.zeros(1, 4, 80), torch.ones(1, 4),
                          mask=True)


def test_forward_matches_golden_oracle():
    golden = np.load(GOLDEN)
    sd = {k[len("sd/"):]: torch.tensor(golden[k])
          for k in golden.files if k.startswith("sd/")}
    n_layers = int(golden["config/encoder_layers"])
    cfg = MelHuBERTConfig.from_dict({
        key: int(golden[f"config/{key}"])
        for key in ("feat_emb_dim", "encoder_embed_dim",
                    "encoder_attention_heads", "encoder_ffn_embed_dim",
                    "encoder_layers", "num_cluster", "conv_pos",
                    "conv_pos_groups")
    })
    model = MelHuBERTModel(_port(cfg))
    model.load_state_dict(sd)  # strict: every reference name is matched
    with torch.no_grad():
        out = melhubert_forward(
            model, torch.tensor(golden["feat"], dtype=torch.float32),
            torch.tensor(golden["pad_mask"]), get_hidden=True,
        )
    valid = golden["pad_mask"].astype(bool)
    assert _rel(out["hidden"].numpy(), golden["hidden"], valid) < BAR
    assert _rel(out["logits"].numpy(), golden["logits"], valid) < BAR
    for i in range(n_layers):
        got = out["layer_hiddens"][i].numpy()
        assert _rel(got, golden[f"layer_hidden_{i}"], valid) < BAR, i
