"""Weight, head and row pruning of HuBERT and wav2vec 2.0 through the
port's WaveRunner against JAX's, from one JAX-written checkpoint (encoder
weights on a grid, so that magnitudes and scores tie): the masks, heads
and rows each event chooses, bitwise; the sliced tensors through the
weight bridge, bitwise; the artifacts' names and their ``Pruning`` /
``Pruned_heads`` meta; JAX's ``load_checkpoint`` on every artifact; the
port's expert on every artifact and both packages' experts on
``last-step.npz``, at the pruned widths with the masks kept. With
lr 0 the weights stay the checkpoint's between events, so every event of
a run is held to JAX's. ``test_torch_wave_prune_schedule.py`` holds the
events' steps, the budgets and the OOM guard."""

import json
import os
import types

import numpy as np
import pytest
import jax

from speech_ssl_compression_tpu import configs as jconfigs
from speech_ssl_compression_tpu.data.dictionary import (
    Dictionary as JaxDictionary,
)
from speech_ssl_compression_tpu.models import hubert as jhubert
from speech_ssl_compression_tpu.models import wav2vec2 as jw2v
from speech_ssl_compression_tpu.train.wave_runner import (
    WaveRunner as JaxWaveRunner,
)
from speech_ssl_compression_tpu.upstream.hubert import (
    HuBERTPretrainExpert as JaxHubertExpert,
)
from speech_ssl_compression_tpu.upstream.wav2vec2 import (
    Wav2Vec2PretrainExpert as JaxW2v2Expert,
)
from speech_ssl_compression_tpu.utils import torch_convert as jconvert
from speech_ssl_compression_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu_torch.data.dictionary import Dictionary
from speech_ssl_compression_tpu_torch.train.wave_runner import WaveRunner
from speech_ssl_compression_tpu_torch.upstream import get_pretrain_expert
from speech_ssl_compression_tpu_torch.utils.weights import (
    masks_tree,
    wave_tree_from_named,
)
from test_torch_wav2vec2 import make_w2v_dataset
from test_wave_runner import make_wav_dataset

CONV = "[(32,10,5)] + [(32,3,2)] + [(32,2,2)]"  # as tests/test_wave_runner.py
ENCODER = dict(
    encoder_layers=2, encoder_embed_dim=32, encoder_attention_heads=4,
    head_dim=8, encoder_ffn_embed_dim=64, conv_feature_layers=CONV,
    final_dim=16, conv_pos=16, conv_pos_groups=4, mask_prob=0.65,
    mask_length=4, dropout=0.0, attention_dropout=0.0,
    activation_dropout=0.0,
)
MODELS = {
    "hubert": dict(ENCODER, label_rate=50),
    "wav2vec2": dict(ENCODER, quantize_targets=True, latent_vars=8,
                     latent_groups=2, num_negatives=4),
}
QUANTUM = 0.01  # the start's encoder weights on this grid: ties
PRUNE = {
    "weight-pruning": {"sparsity": [0.3, 0.5], "n_iters": 2, "warnup": 0,
                       "period": 1, "pruning_condition": "always"},
    "head-pruning": {"metric": "l1", "target": "by_layer", "total_steps": 2,
                     "interval": 1, "warm_up": 0},
    "by_whole": {"metric": "l1", "target": "by_whole",
                 "num_heads_each_step": 3, "total_steps": 2, "interval": 1,
                 "warm_up": 0},
    "row-pruning": {"num_rows_each_step": 8, "total_steps": 2, "interval": 1,
                    "warm_up": 0},
}


def _data(root, upstream):
    if upstream == "hubert":
        data = make_wav_dataset(root)
        return data, {"data": data, "label_dir": data, "labels": ["km"],
                      "label_rate": 50, "sample_rate": 16000,
                      "max_sample_size": 4000, "min_sample_size": 1000,
                      "pad_audio": False, "random_crop": True}
    data = make_w2v_dataset(root / "w2v", n_utts=8)
    return data, {"data": data, "max_sample_size": 4000,
                  "min_sample_size": 3200, "normalize": False,
                  "num_batch_buckets": 2, "sample_rate": 16000}


def _runner_config(task, prune, total_steps=2, lr=0.0, accum=1):
    return {
        "runner": {"total_steps": total_steps, "gradient_clipping": 10.0,
                   "gradient_accumulate_steps": accum, "log_step": 1,
                   "bf16": False},
        "optimizer": {"lr": lr},
        "datarc": {"train_batch_size": 2},
        "prune": dict(prune),
        "task": task,
    }


def _args(expdir, mode, upstream, start):
    return types.SimpleNamespace(
        mode=mode, upstream=upstream, expdir=str(expdir),
        initial_weight=start, init_optimizer_from_initial_weight=False,
        frame_period=20, seed=0, device="cpu")


def _start(tmp_path, upstream, data):
    """A JAX-initialised checkpoint, its encoder layers on QUANTUM's grid,
    written by JAX's save_checkpoint."""
    cls = "HuBERTConfig" if upstream == "hubert" else "Wav2Vec2Config"
    cfg = getattr(jconfigs, cls).from_dict(MODELS[upstream])
    key = jax.random.PRNGKey(3)
    if upstream == "hubert":
        n = len(JaxDictionary.load(f"{data}/dict.km.txt"))
        params = jhubert.init_hubert_params(key, cfg, (n,))
    else:
        params = jw2v.init_wav2vec2_params(key, cfg)
    params = jax.tree.map(np.asarray, params)
    params["encoder"]["layers"] = jax.tree.map(
        lambda x: (np.round(x / QUANTUM) * QUANTUM).astype(np.float32),
        params["encoder"]["layers"])
    path = str(tmp_path / "start.npz")
    jax_save_checkpoint(path, params, meta={"Config": cfg.to_dict()})
    return path


def _equal_trees(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _meta(path):
    with open(path + ".json") as f:
        meta = json.load(f)
    return {k: meta.get(k) for k in ("Step", "TotalStep", "Pruning",
                                     "Pruned_heads")}


def _npz(expdir):
    return sorted(f for f in os.listdir(expdir) if f.endswith(".npz"))


def _experts(upstream, path, data, jax_too=True):
    """The port's and (with ``jax_too``) JAX's expert on ``path``."""
    up = {upstream: MODELS[upstream]}
    kw, jax_expert = {}, None
    if upstream == "hubert":
        kw = dict(dicts=[Dictionary.load(f"{data}/dict.km.txt")])
        if jax_too:
            jax_expert = JaxHubertExpert(
                up, initial_weight=path,
                dicts=[JaxDictionary.load(f"{data}/dict.km.txt")])
    elif jax_too:
        jax_expert = JaxW2v2Expert(up, initial_weight=path)
    port = get_pretrain_expert(upstream)(up, initial_weight=path,
                                         device="cpu", **kw)
    return port, jax_expert


@pytest.mark.parametrize("upstream,mode", [
    ("hubert", "weight-pruning"), ("hubert", "head-pruning"),
    ("hubert", "row-pruning"), ("hubert", "by_whole"),
    ("wav2vec2", "weight-pruning"), ("wav2vec2", "head-pruning"),
    ("wav2vec2", "row-pruning")])
def test_runners_prune_alike_from_one_checkpoint(tmp_path, upstream, mode):
    data, task = _data(tmp_path, upstream)
    start = _start(tmp_path, upstream, data)
    run_mode = "head-pruning" if mode == "by_whole" else mode
    rc = _runner_config(task, PRUNE[mode])
    up = {upstream: MODELS[upstream]}
    runs = {}
    for name, cls in (("jax", JaxWaveRunner), ("port", WaveRunner)):
        runner = cls(_args(tmp_path / name, run_mode, upstream, start), rc,
                     up)
        runner.train()
        runs[name] = runner
    jr, tr = runs["jax"], runs["port"]

    # the choices
    assert tr.cfg.to_dict() == jr.cfg.to_dict()
    if run_mode == "weight-pruning":
        assert tr.wp_state.to_meta() == jr.wp_state.to_meta()
        assert tr.wp_state.pruning_times == 2
        _equal_trees(masks_tree(tr.masks), jr.masks)
    elif run_mode == "head-pruning":
        assert tr.pruned_heads == jr.pruned_heads
        assert sum(tr.cfg.encoder_attention_heads) == 8 - (
            6 if mode == "by_whole" else 4)
    else:
        assert tr.cfg.encoder_ffn_embed_dim == (48, 48)
        assert [[len(k) for k in e["kept"]] for e in tr.prune_event_log] == [
            [56, 56], [48, 48]]
    # the sliced tensors through the weight bridge (lr 0: as sliced)
    _equal_trees(wave_tree_from_named(tr.params, upstream),
                 jax.device_get(jr.params))

    # the artifacts: JAX's names and meta, read by JAX
    files = _npz(tmp_path / "port")
    assert files == _npz(tmp_path / "jax")
    want = {"weight-pruning": ["before-pruning-0.npz", "before-pruning-1.npz"],
            "head-pruning": ["states_prune_5.npz", "states_prune_8.npz"]
            if mode == "by_whole" else ["states_prune_6.npz",
                                        "states_prune_8.npz"],
            "row-pruning": ["states_prune_56.npz", "states_prune_64.npz"]}
    assert files == sorted(want[run_mode] + ["last-step.npz"])
    for f in files:
        got = str(tmp_path / "port" / f)
        ref = str(tmp_path / "jax" / f)
        assert _meta(got) == _meta(ref), f
        mine, theirs = jax_load_checkpoint(got), jax_load_checkpoint(ref)
        _equal_trees(mine["params"], theirs["params"])
        assert (mine["masks"] is None) == (theirs["masks"] is None)
        if mine["masks"] is not None:
            _equal_trees(mine["masks"], theirs["masks"])
    last = _meta(str(tmp_path / "port" / "last-step.npz"))
    assert last["Step"] == 2 and last["TotalStep"] is None
    assert ("Pruning" in last and last["Pruning"] is not None) == (
        run_mode == "weight-pruning")
    assert bool(last["Pruned_heads"]) == (run_mode == "head-pruning")

    # the port's expert reads every artifact at its widths, its masks kept
    for f in files:
        got = str(tmp_path / "port" / f)
        state = jax_load_checkpoint(got)
        expert, _ = _experts(upstream, got, data, jax_too=False)
        heads, ffns = jconvert.infer_pruned_dims(state["params"], 8)
        assert expert.cfg.encoder_attention_heads == tuple(heads), f
        assert expert.cfg.encoder_ffn_embed_dim == tuple(ffns), f
        assert (expert.masks is None) == (state["masks"] is None), f
    # both experts at the pruned widths, the masks kept
    port, jexp = _experts(upstream, str(tmp_path / "port" / "last-step.npz"),
                          data)
    for exp in (port, jexp):
        assert exp.cfg.encoder_attention_heads == tr.cfg.encoder_attention_heads
        assert exp.cfg.encoder_ffn_embed_dim == tr.cfg.encoder_ffn_embed_dim
    _equal_trees(wave_tree_from_named(dict(port.model.named_parameters()),
                                      upstream), jax.device_get(jr.params))
    if run_mode == "weight-pruning":
        _equal_trees(masks_tree(port.masks), jexp.masks)
    else:
        assert port.masks is None and jexp.masks is None
