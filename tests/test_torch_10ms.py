"""The 10 ms recipe (``-f 10``) of every MelHuBERT mode in the port against
the JAX package on the CPU: the fp = 10 batches (no frame stacking, labels
at the feature rate, seeded crops, signed ``max_timestep``) bitwise JAX's,
and each of the five modes (pre-training, weight, head (l1 and
data-driven) and row pruning, distillation) through both trainers from one
checkpoint, with the shipped ``config_{model,runner}_10ms.yaml`` pairs
narrowed in width (and cut to 2 layers and a few updates for the CPU),
dropout off. Both trainers draw their span masks from one host function of
the batch's lengths (the port on the host as always, JAX through a
``pure_callback`` in place of its device sampler), so the losses and the
parameters after the updates are held within rel. L2 1e-4, and the prune
choices bitwise."""

import json
import os
import pathlib
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.data.bucket_dataset import (
    MelFeatBuckets as JaxBuckets,
)
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.models import melhubert as jmelhubert
from speech_ssl_compression_tpu.ops import masking as jmask
from speech_ssl_compression_tpu.train.runner import Runner as JaxRunner
from speech_ssl_compression_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig as PortConfig,
    read_yaml,
)
from speech_ssl_compression_tpu_torch.data.bucket_dataset import MelFeatBuckets
from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
from speech_ssl_compression_tpu_torch.train import runner as trunner
from speech_ssl_compression_tpu_torch.train import steps as tsteps
from speech_ssl_compression_tpu_torch.train.runner import Runner
from speech_ssl_compression_tpu_torch.utils.checkpoint import tree_leaves
from speech_ssl_compression_tpu_torch.utils.weights import (
    jax_tree_from_named,
    masks_tree,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"
BAR = 1e-4  # each logged loss (rel.) and each parameter (rel. L2)
# the width cut of the shipped 10 ms models (40-d input kept); 2 layers
NARROW = dict(encoder_layers=2, encoder_embed_dim=128,
              encoder_ffn_embed_dim=256, encoder_attention_heads=2,
              num_cluster=64, dropout=0.0, attention_dropout=0.0,
              activation_dropout=0.0)


# ------------------------------------------------------------ fp = 10 data

def write_set(root: pathlib.Path, lengths, seed: int = 0) -> str:
    """A CSV manifest of 40-d 10 ms features with one label per frame (the
    10 ms recipe's data: nothing stacked, nothing halved)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    rows = ["file_path,label_path,length"]
    for i, n in enumerate(lengths):
        fp, lp = root / f"feat_{i}.npy", root / f"label_{i}.npy"
        np.save(fp, rng.standard_normal((int(n), 40)).astype(np.float32))
        np.save(lp, rng.integers(0, 64, (int(n),)).astype(np.int64))
        rows.append(f"{fp},{lp},{int(n)}")
    csv = root / "train.csv"
    csv.write_text("\n".join(rows) + "\n")
    return str(csv)


@pytest.mark.parametrize("max_timestep", [-32, 0, 70])
def test_fp10_batches_match_jax_bitwise(tmp_path, max_timestep):
    # lengths around and past a scaled-down sequence_length (60) and
    # max_timestep (the shipped -320 drops utterances of 320 frames or
    # fewer; a positive one drops those of as many or more), ties included;
    # two epochs, so the shuffle and crop streams advance
    rng = np.random.default_rng(4)
    lengths = np.concatenate([rng.integers(20, 110, 30),
                              [32, 33, 32, 60, 61, 60, 70, 69, 71]])
    csv = write_set(tmp_path / "data", lengths)
    kw = dict(frame_period=10, sequence_length=60, bucket_size=4, sets=[csv],
              max_timestep=max_timestep, seed=5)
    ours, ref = MelFeatBuckets(**kw), JaxBuckets(**kw)
    assert len(ours) == len(ref) > 3
    assert ours.buckets == [tuple(map(list, b)) for b in ref.buckets]
    cropped = False
    for _ in range(2):
        for a, b in zip(ours.epoch(), ref.epoch()):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
            assert a["feat"].shape[2] == 40  # no stacking at 10 ms
            # labels at the feature rate, -100 past each length
            for row, n in zip(a["label"], a["length"]):
                assert (row[n:] == -100).all() and (row[:n] >= 0).all()
            cropped |= int(a["length"].max()) == 60
    assert cropped


@pytest.mark.parametrize("mask_length", [5, 10])
def test_span_masks_at_t1500_match_jax(mask_length):
    # the 10 ms recipes' spans (pre-training 5, the pruning and
    # distillation models 10) at the crop length, drawn on the host
    cfg = read_yaml(CONFIGS / "melhubert" / "config_model_10ms.yaml")
    port_cfg = PortConfig.from_dict(
        dict(cfg["melhubert"], mask_length=mask_length))
    lengths = np.array([1500, 1500, 1371, 402])
    got = span_mask(port_cfg, lengths, 1536, np.random.default_rng(3))
    ref = jmask.compute_mask_indices_np(
        (4, 1536), lengths, mask_prob=0.7, mask_length=mask_length,
        mask_selection="static", mask_other=0.0, min_masks=2,
        no_overlap=False, min_space=1, require_same_masks=False,
        rng=np.random.default_rng(3))
    np.testing.assert_array_equal(got, ref)
    assert not got[3, 402:].any()
    assert 0.4 < got[0].mean() < 0.75


# ---------------------------------------------------- the five modes at -f 10

def _host_mask(lengths, t: int, **kw) -> np.ndarray:
    """The span mask both trainers draw: JAX's host sampler with the
    arguments JAX's melhubert_forward passes, from a generator seeded by the
    batch's T and lengths (so neither trainer's order of draws matters)."""
    seed = [int(t)] + [int(n) for n in lengths]
    return jmask.compute_mask_indices_np(
        (len(lengths), int(t)), np.asarray(lengths), rng=np.random.default_rng(
            seed), **kw)


def _jax_span_mask(rng, lengths, max_len=None, *, shared_rounding=False,
                   **kw):
    """In place of JAX's device sampler: :func:`_host_mask` through a
    ``pure_callback`` (the key is not used)."""
    assert not shared_rounding
    shape = jax.ShapeDtypeStruct((lengths.shape[0], max_len), jnp.bool_)
    return jax.pure_callback(
        lambda lens: _host_mask(np.asarray(lens), max_len, **kw), shape,
        lengths)


def _port_span_mask(cfg, batch, rng, mesh=None):
    """In place of the port's host_span_mask: the same host function (one
    process: ``mesh`` has one data rank)."""
    assert mesh is None or mesh.dp == 1
    if cfg.mask_prob <= 0:
        return None
    feat = batch["feat"]
    mask = span_mask(cfg, batch["length"], feat.shape[1],
                     np.random.default_rng([int(feat.shape[1])] + [
                         int(n) for n in batch["length"]]))
    return torch.from_numpy(mask).to(feat.device)


def _model_config(path: pathlib.Path, **over) -> dict:
    cfg = read_yaml(path)
    key = "student" if "student" in cfg else "melhubert"
    cfg[key] = dict(cfg[key], **dict(NARROW, **over))
    if "teacher" in cfg:
        cfg["teacher"] = dict(cfg["teacher"], **NARROW)
    return cfg


def _runner_config(path: pathlib.Path, csv: str, prune=None) -> dict:
    """The shipped 10 ms runner YAML: 2 updates of one micro-batch (the
    recipe's 8), f32 (bf16 only on the card), the data path ours; the
    batch size (4) and max_timestep (-320) as shipped."""
    rc = read_yaml(path)
    rc["runner"] = dict(rc["runner"], n_epochs=0, total_steps=2,
                        gradient_accumulate_steps=1, log_step=1, bf16=False,
                        save_every_x_epochs=1000)
    rc["datarc"] = dict(rc["datarc"], num_workers=0, sets=[csv])
    if prune is not None:
        rc["prune"] = dict(rc["prune"], **prune)
    return rc


def _start(tmp_path, model_cfg: dict, key: str = "melhubert") -> tuple:
    """A 10 ms checkpoint of the narrowed model as the JAX package writes
    it, weights rounded to 0.01 so that magnitudes tie."""
    cfg = MelHuBERTConfig.from_dict(model_cfg[key])
    params = jax.tree.map(
        lambda a: (np.round(np.asarray(a) / 0.01) * 0.01).astype(np.float32),
        init_melhubert_params(jax.random.PRNGKey(7), cfg))
    path = str(tmp_path / f"start_{key}.npz")
    jax_save_checkpoint(path, params, meta={
        "Upstream_Config": {"melhubert": model_cfg[key],
                            "task": {"sequence_length": 1500}},
        "Step": 0})
    return path


def _args(expdir, mode, start):
    return types.SimpleNamespace(
        mode=mode, upstream="melhubert", expdir=str(expdir),
        initial_weight=start, init_optimizer_from_initial_weight=False,
        frame_period=10, seed=0, device="cpu")


def _artifacts(expdir) -> dict:
    """Every npz artifact's name and the meta entries both trainers write
    alike, and every npy artifact (head scores) as an array."""
    out = {}
    for f in sorted(os.listdir(expdir)):
        if f.endswith(".npz"):
            meta = json.load(open(os.path.join(expdir, f + ".json")))
            out[f] = {k: v for k, v in meta.items() if k in (
                "Step", "TotalStep", "Pruned_heads", "Pruning", "Config")}
        elif f.endswith(".npy"):
            out[f] = np.load(os.path.join(expdir, f))
    return out


def _check_artifacts(tmp_path, score_rtol: float = 0.0):
    """The two trainers' artifacts: the same files and meta; head scores
    (``heads_and_score_*.npy``: layer, head, score) bitwise, or for
    data-driven scores, sums of gradients, within ``score_rtol``."""
    got, ref = _artifacts(tmp_path / "port"), _artifacts(tmp_path / "jax")
    assert got.keys() == ref.keys()
    for name, a in got.items():
        b = ref[name]
        if isinstance(a, dict):
            assert a == b, name
        else:
            np.testing.assert_array_equal(a[:, :2], b[:, :2])
            np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=score_rtol,
                                       atol=0)


def _train_both(tmp_path, monkeypatch, mode, model_cfg, rc, start):
    """Both trainers on one config and start, the span masks from
    :func:`_host_mask`. Returns {"jax": (runner, [(step, loss)]),
    "port": ...}."""
    monkeypatch.setattr(jmelhubert, "compute_span_mask", _jax_span_mask)
    monkeypatch.setattr(tsteps, "host_span_mask", _port_span_mask)
    monkeypatch.setattr(trunner, "host_span_mask", _port_span_mask)
    runs = {}
    for name, cls in (("jax", JaxRunner), ("port", Runner)):
        runner = cls(_args(tmp_path / name, mode, start), rc, model_cfg)
        if name == "jax":
            losses = []
            runner._log_scalar = (lambda tag, v, step, _l=losses:
                                  _l.append((step, float(v)))
                                  if tag.endswith("-loss") else None)
            runner.train()
        else:
            runner.train()
            losses = [(h["step"], h["loss"]) for h in runner.log_history]
        runs[name] = runner, losses
    return runs


def _paths(tree, prefix=""):
    """(path, leaf) of a JAX-layout parameter tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/[{i}]")
    else:
        yield prefix, np.asarray(tree)


def _check_losses_and_params(runs):
    """Each logged loss within BAR (rel.) and each parameter within BAR
    (rel. L2). The k_proj biases start at 0 and their gradients are zero up
    to rounding (softmax is invariant to a shift of a row's scores), so
    Adam moves them by +-lr in the sign of rounding noise: theirs is taken
    against the norm of all parameters, as is a leaf of zeros (a bias
    weight pruning masked whole)."""
    (jr, jlosses), (tr, tlosses) = runs["jax"], runs["port"]
    assert [s for s, _ in tlosses] == [s for s, _ in jlosses] == [1, 2]
    for (_, a), (_, b) in zip(tlosses, jlosses):
        assert abs(a - b) / abs(b) < BAR, (tlosses, jlosses)
    got = dict(_paths(jax_tree_from_named(tr.params)))
    ref = dict(_paths(jr.params))
    assert got.keys() == ref.keys()
    total = np.sqrt(sum(float(np.sum(np.square(r, dtype=np.float64)))
                        for r in ref.values()))
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape, name
        den = (total if name.endswith("k_proj/bias") or not r.any()
               else np.linalg.norm(r))
        err = np.linalg.norm(np.float64(g) - r) / den
        assert err < BAR, (name, err)


def test_pretraining_at_10ms_matches_jax(tmp_path, monkeypatch):
    model_cfg = _model_config(CONFIGS / "melhubert" / "config_model_10ms.yaml")
    csv = write_set(tmp_path / "data", np.arange(1501, 1501 + 16 * 13, 13))
    rc = _runner_config(CONFIGS / "melhubert" / "config_runner_10ms.yaml",
                        csv)
    runs = _train_both(tmp_path, monkeypatch, "melhubert", model_cfg, rc,
                       _start(tmp_path, model_cfg))
    _check_losses_and_params(runs)
    assert runs["port"][0].cfg.feat_emb_dim == 40
    _check_artifacts(tmp_path)


def test_weight_pruning_at_10ms_matches_jax(tmp_path, monkeypatch):
    d = CONFIGS / "weight_pruning"
    model_cfg = _model_config(d / "config_model_10ms.yaml")
    csv = write_set(tmp_path / "data", np.arange(1501, 1501 + 16 * 13, 13))
    # warnup 0: the event falls before any update, on the checkpoint's
    # weights, whose ties both trainers must break alike
    rc = _runner_config(d / "config_runner_10ms.yaml", csv, prune=dict(
        warnup=0, period=1, n_iters=1, sparsity=[0.2],
        pruning_condition="always", average_length=1))
    runs = _train_both(tmp_path, monkeypatch, "weight-pruning", model_cfg,
                       rc, _start(tmp_path, model_cfg))
    jr, tr = runs["jax"][0], runs["port"][0]
    masks = tree_leaves(masks_tree(tr.masks))
    want = tree_leaves(jax.tree.map(np.asarray, jr.masks))
    assert all(np.array_equal(a, b) for a, b in zip(masks, want))
    n = sum(m.size for m in masks)
    assert n - sum(int(m.sum()) for m in masks) == round(0.2 * n)
    _check_losses_and_params(runs)
    _check_artifacts(tmp_path)


@pytest.mark.parametrize("metric", ["l1", "data_driven"])
def test_head_pruning_at_10ms_matches_jax(tmp_path, monkeypatch, metric):
    d = CONFIGS / "head_pruning" / metric
    model_cfg = _model_config(d / "config_model_10ms.yaml")
    # data-driven: data_ratio 0.25 of 16 buckets = 4, stacked into 1
    # scoring group of B = 16 at T = 1536
    n = 64 if metric == "data_driven" else 16
    csv = write_set(tmp_path / "data", 1501 + (np.arange(n) * 37) % 200)
    rc = _runner_config(d / "config_runner_10ms.yaml", csv, prune=dict(
        total_steps=1, interval=1, warm_up=0, num_heads_each_step=2))
    runs = _train_both(tmp_path, monkeypatch, "head-pruning", model_cfg, rc,
                       _start(tmp_path, model_cfg))
    jr, tr = runs["jax"][0], runs["port"][0]
    assert tr.pruned_heads == jr.pruned_heads and tr.pruned_heads
    assert (tr.cfg.encoder_attention_heads == jr.cfg.encoder_attention_heads
            != (2, 2))
    _check_losses_and_params(runs)
    _check_artifacts(tmp_path, BAR if metric == "data_driven" else 0.0)


def test_row_pruning_at_10ms_matches_jax(tmp_path, monkeypatch):
    d = CONFIGS / "row_pruning"
    model_cfg = _model_config(d / "config_model_10ms.yaml")
    csv = write_set(tmp_path / "data", np.arange(1501, 1501 + 16 * 13, 13))
    rc = _runner_config(d / "config_runner_10ms.yaml", csv, prune=dict(
        total_steps=1, interval=1, warm_up=0, num_rows_each_step=64))
    runs = _train_both(tmp_path, monkeypatch, "row-pruning", model_cfg, rc,
                       _start(tmp_path, model_cfg))
    jr, tr = runs["jax"][0], runs["port"][0]
    assert (tr.cfg.encoder_ffn_embed_dim == jr.cfg.encoder_ffn_embed_dim
            == (192, 192))
    _check_losses_and_params(runs)
    _check_artifacts(tmp_path)


@pytest.mark.parametrize("loss_type", ["nomasked", "masked"])
def test_distillation_at_10ms_matches_jax(tmp_path, monkeypatch, loss_type):
    # the shipped recipe (nomasked, T = 1, alpha = 1) and its masked loss,
    # whose spans come from the teacher's mask_length of 10; a 2-layer 10 ms
    # teacher into a 1-layer student
    d = CONFIGS / "distillation"
    model_cfg = _model_config(d / "config_model_10ms.yaml", encoder_layers=1)
    model_cfg["loss_param"] = dict(model_cfg["loss_param"], type=loss_type)
    assert model_cfg["teacher"]["mask_length"] == 10
    csv = write_set(tmp_path / "data", np.arange(1501, 1501 + 16 * 13, 13))
    rc = _runner_config(d / "config_runner_10ms.yaml", csv)
    teacher = _start(tmp_path, model_cfg, key="teacher")

    def jax_student_init(cfg, seed):
        # the student JAX's Runner seeds (split(PRNGKey(seed))[1]), so
        # that both trainers start from the same weights
        key = jax.random.split(jax.random.PRNGKey(seed))[1]
        return jax.tree.map(np.asarray, init_melhubert_params(
            key, MelHuBERTConfig.from_dict(cfg.to_dict())))

    monkeypatch.setattr(trunner, "init_params_np", jax_student_init)
    runs = _train_both(tmp_path, monkeypatch, "distillation", model_cfg, rc,
                       teacher)
    assert runs["port"][0].teacher_cfg.encoder_layers == 2
    assert runs["port"][0].cfg.encoder_layers == 1
    _check_losses_and_params(runs)
    _check_artifacts(tmp_path)
