"""The port's deep positional conv (``pos_conv_depth > 1``,
``models/encoder.py::pos_conv_embed_deep``) against the JAX package, on a
2-layer, 64-wide MelHuBERT at depth 3 (k = 5, odd) and depth 4 (k = 4,
even, the SamePad crop): ``forward``, ``forward_packed`` and the grad
step held to JAX's dense path (the golden bar, max |d| / mean |ref| <
1e-4; each gradient within 1e-4 rel. L2), the weight bridge both ways
(npz and the reference ``.ckpt``, bitwise), the distilled student's copy
of the teacher's stack, the port's seeded init, and the refusals of
streaming and sequence parallel, which JAX refuses too."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_ssl_compression_tpu.compress.distillation import (
    init_student_from_teacher as jax_init_student,
)
from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.extract import MelHuBERTExtractor as JaxExtractor
from speech_ssl_compression_tpu.models import (
    init_melhubert_params,
    melhubert_forward as jax_forward,
)
from speech_ssl_compression_tpu.models.melhubert import (
    melhubert_pretrain_loss as jax_loss,
)
from speech_ssl_compression_tpu.utils import checkpoint as jax_ckpt
from speech_ssl_compression_tpu_torch import extract as port
from speech_ssl_compression_tpu_torch.compress.distillation import (
    init_student_from_teacher,
)
from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig as PortConfig,
)
from speech_ssl_compression_tpu_torch.models.encoder import (
    pos_conv_kernel_size,
)
from speech_ssl_compression_tpu_torch.models.melhubert import (
    melhubert_forward,
    span_mask,
)
from speech_ssl_compression_tpu_torch.parallel.seqpar import _check_seqpar
from speech_ssl_compression_tpu_torch.streaming import StreamingCausalExtractor
from speech_ssl_compression_tpu_torch.train import steps as tsteps
from speech_ssl_compression_tpu_torch.utils import checkpoint as port_ckpt
from speech_ssl_compression_tpu_torch.utils.checkpoint import tree_leaves
from speech_ssl_compression_tpu_torch.utils.torch_convert import (
    load_reference_checkpoint,
    params_to_state_dict,
)
from speech_ssl_compression_tpu_torch.utils.weights import (
    init_params_np,
    jax_tree_from_named,
    load_model,
    model_from_named,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
MEAN_STD = REPO / "example" / "libri-960-mean-std.npy"
BAR = 1e-4       # max |d| / mean |ref| on valid frames (the golden bar)
GRAD_BAR = 1e-4  # rel. L2 per gradient; the loss relative
DEPTHS = {3: 5, 4: 4}  # depth -> per-layer kernel size of conv_pos 16
TINY = dict(feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=64,
            encoder_ffn_embed_dim=128, encoder_attention_heads=1,
            head_dim=64, conv_pos=16, conv_pos_groups=4, num_cluster=32,
            mask_prob=0.5, mask_length=3)


def _cfg(depth, **kw):
    return MelHuBERTConfig.from_dict(dict(TINY, pos_conv_depth=depth, **kw))


def _port(cfg):
    return PortConfig.from_dict(cfg.to_dict())


def _params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        init_melhubert_params(jax.random.PRNGKey(seed), cfg))


def _inputs(seed=0, b=3, t=40):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, t, 80)).astype(np.float32)
    lengths = np.array([t, 25, 9])[:b]
    pad = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return feat, pad, lengths


def _rel(got, ref, valid):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref)[valid].max() / np.abs(ref)[valid].mean()


def _tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_tree_equal, a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_kernel_size_is_jax():
    from speech_ssl_compression_tpu.models.encoder import (
        pos_conv_kernel_size as jax_k,
    )
    for conv_pos, depth in [(16, 3), (16, 4), (95, 5), (128, 1), (8, 5)]:
        assert pos_conv_kernel_size(conv_pos, depth) == jax_k(conv_pos, depth)
    assert pos_conv_kernel_size(95, 5) == 19  # data2vec 2.0's audio setting


@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_forward_matches_jax(depth):
    cfg = _cfg(depth)
    params = _params(cfg)
    model = load_model(params, _port(cfg))
    blocks = model.encoder.pos_conv
    assert len(blocks) == depth
    assert blocks[0][0].kernel_size == (DEPTHS[depth],)
    feat, pad, _ = _inputs()
    ref = jax_forward(params, cfg, jnp.asarray(feat), jnp.asarray(pad),
                      get_hidden=True, attn_impl="dense")
    with torch.no_grad():
        out = melhubert_forward(model, torch.from_numpy(feat),
                                torch.from_numpy(pad), get_hidden=True,
                                attn_impl="dense")
    valid = pad.astype(bool)
    for key in ("hidden", "logits"):
        assert _rel(out[key].numpy(), ref[key], valid) < BAR, key
    for a, b in zip(out["layer_hiddens"], ref["layer_hiddens"]):
        assert _rel(a.numpy(), b, valid) < BAR


@pytest.fixture(scope="module")
def deep_ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("deep")
    out = {}
    for depth in DEPTHS:
        cfg = _cfg(depth)
        params = _params(cfg, seed=depth)
        path = str(d / f"depth{depth}.npz")
        jax_ckpt.save_checkpoint(path, params, meta={
            "Upstream_Config": {"melhubert": cfg.to_dict()}, "Step": 0})
        out[depth] = (path, params, cfg)
    return out


def _wavs(seed=0, n_samples=(16000, 9000, 23000, 4000)):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32)
            for n in n_samples]


@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_forward_packed_matches_jax(deep_ckpts, depth):
    path, _, _ = deep_ckpts[depth]
    wavs = _wavs(depth)
    ref = JaxExtractor(path, mean_std_npy_path=str(MEAN_STD),
                       dtype=jnp.float32).forward_packed(wavs)
    ext = port.MelHuBERTExtractor(path, mean_std_npy_path=str(MEAN_STD),
                                  device="cpu")
    out = ext.forward_packed(wavs)
    assert out["lengths"] == ref["lengths"]
    t = out["last_hidden_state"].shape[1]
    valid = np.arange(t)[None, :] < np.asarray(out["lengths"])[:, None]
    pairs = list(zip(out["hidden_states"], ref["hidden_states"]))
    pairs.append((out["last_hidden_state"], ref["last_hidden_state"]))
    for i, (a, b) in enumerate(pairs):
        assert _rel(a.numpy(), b, valid) < BAR, i
    # packed equals unpacked: the prologue runs per utterance
    unpacked = ext.forward(wavs)["last_hidden_state"].numpy()
    assert _rel(out["last_hidden_state"].numpy(), unpacked, valid) < 2e-4


def _leaf_names(tree, prefix=""):
    """Leaf paths in ``tree_leaves`` order (sorted keys, lists in order)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}/[{i}]")]
    return [prefix]


def _grad_errors(names, got, ref):
    """rel. L2 per gradient; the k_proj biases' gradients are zero up to
    rounding (softmax ignores a shift of a row's scores), so theirs is
    taken against the norm of all gradients."""
    total = np.sqrt(sum(float(np.sum(np.square(r, dtype=np.float64)))
                        for r in ref))
    return [np.linalg.norm(np.float64(g) - r)
            / (total if n.endswith("k_proj/bias") else np.linalg.norm(r))
            for n, g, r in zip(names, got, ref)]


@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_grad_step_matches_jax(depth):
    cfg = _cfg(depth)
    params = _params(cfg, seed=7)
    feat, pad, lengths = _inputs(seed=2)
    label = np.random.default_rng(3).integers(
        0, cfg.num_cluster, pad.shape).astype(np.int32)
    label[pad == 0] = -100
    mask = span_mask(_port(cfg), lengths, pad.shape[1],
                     np.random.default_rng(4))

    def loss_fn(p):
        out = jax_forward(p, cfg, jnp.asarray(feat), jnp.asarray(pad),
                          mask=True, teacher_mask_indices=jnp.asarray(mask),
                          deterministic=True, attn_impl="dense")
        return jax_loss(out, jnp.asarray(label), jnp.asarray(pad), cfg)[0]

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    model = load_model(params, _port(cfg))
    step = tsteps.make_melhubert_grad_step(model, attn_impl="dense",
                                           deterministic=True)
    named = dict(model.named_parameters())
    batch = {"feat": torch.from_numpy(feat), "pad_mask": torch.from_numpy(pad),
             "label": torch.from_numpy(label).long(), "length": lengths}
    loss, grads, _ = step(named, batch, torch.Generator(),
                          mask_indices=torch.from_numpy(mask))
    assert abs(float(loss) - float(ref_loss)) / float(ref_loss) < GRAD_BAR
    tree = jax_tree_from_named(dict(zip(named, grads)))
    assert len(tree["encoder"]["pos_conv"]["layers"]) == depth
    got = tree_leaves(tree)
    ref = [np.asarray(g) for g in tree_leaves(jax.tree.map(np.asarray,
                                                             ref_grads))]
    names = _leaf_names(params)
    assert len(got) == len(ref) == len(names)
    errs = _grad_errors(names, got, ref)
    assert max(errs) < GRAD_BAR, names[int(np.argmax(errs))]


@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_bridge_both_ways(deep_ckpts, tmp_path, depth):
    path, params, cfg = deep_ckpts[depth]
    # npz: JAX's file -> the port's model -> the port's file, unchanged
    got, got_cfg, _ = port.load_any_checkpoint(path)
    assert got_cfg.pos_conv_depth == depth and _tree_equal(got, params)
    model = load_model(got, got_cfg)
    names = [n for n, _ in model.named_parameters() if "pos_conv" in n]
    assert names == [f"encoder.pos_conv.{i}.0.{leaf}" for i in range(depth)
                     for leaf in ("weight", "bias")]
    back = jax_tree_from_named(dict(model.named_parameters()))
    assert _tree_equal(back, params)
    # the rebuild after a prune event holds the same tensors, strictly
    rebuilt = model_from_named(dict(model.named_parameters()), got_cfg)
    assert rebuilt.encoder.pos_conv[depth - 1][0].weight.data_ptr() == (
        model.encoder.pos_conv[depth - 1][0].weight.data_ptr())
    out = str(tmp_path / "back.npz")
    port_ckpt.save_checkpoint(out, back, meta={
        "Upstream_Config": {"melhubert": cfg.to_dict()}})
    assert _tree_equal(jax.tree.map(np.asarray,
                                    jax_ckpt.load_checkpoint(out)["params"]),
                       params)
    # the reference .ckpt: a torch.save'd state dict in the reference names
    sd = {k: torch.tensor(np.asarray(v))
          for k, v in params_to_state_dict(params).items()}
    ckpt = str(tmp_path / "ref.ckpt")
    torch.save({"model": sd, "Upstream_Config": {
        "melhubert": cfg.to_dict()}}, ckpt)
    ref_params, _, ref_cfg, _ = load_reference_checkpoint(ckpt)
    assert ref_cfg.pos_conv_depth == depth and _tree_equal(ref_params, params)
    model2 = load_model(ref_params, ref_cfg)
    assert all(torch.equal(model2.state_dict()[k], v) for k, v in sd.items())


@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_student_copies_the_teachers_deep_stack(depth):
    teacher = _params(_cfg(depth), seed=1)
    student = _params(_cfg(depth, encoder_layers=1), seed=2)
    got = init_student_from_teacher(student, teacher, 1)
    ref = jax.tree.map(np.asarray, jax_init_student(student, teacher, 1))
    assert _tree_equal(got, ref)
    for mine, theirs in zip(got["encoder"]["pos_conv"]["layers"],
                            teacher["encoder"]["pos_conv"]["layers"]):
        assert np.array_equal(mine["weight"], theirs["weight"])
        assert not np.shares_memory(mine["weight"], theirs["weight"])
    load_model(got, _port(_cfg(depth, encoder_layers=1)))  # strict


@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_seeded_init_is_torch_default_conv_init(depth):
    cfg = _port(_cfg(depth, encoder_embed_dim=128))
    params = init_params_np(cfg, seed=0)
    model = load_model(params, cfg)  # strict: every name matched
    k = DEPTHS[depth]
    bound = 1.0 / np.sqrt((128 // 4) * k)
    for block in params["encoder"]["pos_conv"]["layers"]:
        w = block["weight"]
        assert w.shape == (128, 32, k) and np.abs(w).max() <= bound
        assert abs(w.std() - bound / np.sqrt(3)) < 0.05 * bound
        assert np.abs(block["bias"]).max() <= bound
    # the depth-1 stream is unchanged by the new branch
    flat = init_params_np(_port(_cfg(1)), seed=0)
    assert "weight_v" in flat["encoder"]["pos_conv"]
    assert len(model.encoder.pos_conv) == depth


def test_streaming_and_seqpar_refuse_deep_pos_conv():
    cfg = _cfg(3, attention_type="causal")
    params = _params(cfg)
    with pytest.raises(NotImplementedError, match="depth-1"):
        StreamingCausalExtractor(params=params, cfg=_port(cfg), device="cpu")
    with pytest.raises(NotImplementedError, match="pos_conv_depth"):
        _check_seqpar(_port(_cfg(3)))
