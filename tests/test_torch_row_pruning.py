"""The port's row (FFN hidden-unit) pruning against the JAX package: the
row scores (bitwise, on the JAX-layout view of the port's weights, with a
control showing a torch-layout sum chooses otherwise), the slicing
through the weight bridge, the additivity identity, and the two
trainers' row-pruning runs from one checkpoint, whose artifacts serve in
both packages. Tiny widths, inputs from numpy seeds, on the CPU."""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.compress import row_pruning as jrp
from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.extract import (
    MelHuBERTExtractor as JaxExtractor,
)
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.train.runner import Runner as JaxRunner
from speech_ssl_compression_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu_torch.compress import row_pruning as trp
from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig as PortConfig,
)
from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
from speech_ssl_compression_tpu_torch.models.melhubert import melhubert_forward
from speech_ssl_compression_tpu_torch.train.runner import Runner
from speech_ssl_compression_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    tree_leaves,
)
from speech_ssl_compression_tpu_torch.utils.weights import (
    jax_tree_from_named,
    load_model,
    model_from_named,
    prunable_tree,
    state_dict_from_jax_params,
)
from test_torch_weight_pruning import (
    TINY,
    make_args,
    make_dataset,
    model_config,
)

SERVE_BAR = 1e-4  # max |d| / mean |ref| on valid frames


def _params(seed=0, quantum=None, ffns=None):
    cfg = MelHuBERTConfig.from_dict(TINY)
    if ffns is not None:
        cfg = cfg.with_ffn_dims(ffns)
    params = jax.tree.map(np.asarray,
                          init_melhubert_params(jax.random.PRNGKey(seed), cfg))
    if quantum:
        params = jax.tree.map(
            lambda a: (np.round(a / quantum) * quantum).astype(np.float32),
            params)
    return cfg, params


def _named(params):
    return {k: v.clone() for k, v in state_dict_from_jax_params(params).items()}


@pytest.mark.parametrize("quantum", [None, 0.01, 0.05])
@pytest.mark.parametrize("ffns", [(128, 128), (96, 40)])
def test_ffn_row_scores_match_jax_bitwise(quantum, ffns):
    _, params = _params(seed=1, quantum=quantum, ffns=ffns)
    tree = prunable_tree(_named(params))
    for mine, theirs in zip(tree["encoder"]["layers"],
                            params["encoder"]["layers"]):
        got, want = trp.ffn_row_scores(mine), jrp.ffn_row_scores(theirs)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    if quantum == 0.05:  # coarse levels: scores tie, the stable rule decides
        s = jrp.ffn_row_scores(params["encoder"]["layers"][0])
        assert len(np.unique(s)) < s.size


def test_torch_layout_row_sum_breaks_an_exact_tie_the_other_way():
    # unit 1 of layer 0 holds unit 0's fc1 entries in reverse order (the
    # same fc2 row and bias), so the two tie in exact arithmetic; float32
    # sums break the tie by the order they add in, which the layout sets.
    # The port ranks on the JAX-layout view and keeps JAX's rows; the same
    # sums on the torch-layout weights prune the other unit for some of
    # these weights.
    _, params = _params(seed=5)
    params = jax.tree.map(np.array, params)  # writable copies
    layer = params["encoder"]["layers"][0]
    flips = 0
    for seed in range(8):
        a = (0.02 * np.random.default_rng(seed).standard_normal(
            layer["fc1"]["kernel"].shape[0])).astype(np.float32)
        layer["fc1"]["kernel"][:] = 1.0  # the other units score far above
        layer["fc1"]["kernel"][:, 0] = a
        layer["fc1"]["kernel"][:, 1] = a[::-1]
        layer["fc1"]["bias"][:2] = 0.0
        layer["fc2"]["kernel"][1] = layer["fc2"]["kernel"][0]
        want = jrp.prune_rows(params, MelHuBERTConfig.from_dict(TINY), 1)[0]
        named = _named(params)
        keeps = trp.select_rows(named, 1)
        got = trp.prune_rows(named, PortConfig.from_dict(TINY), keeps)[0]
        assert all(np.array_equal(x, y) for x, y in zip(
            tree_leaves(jax_tree_from_named(got)),
            tree_leaves(jax.tree.map(np.asarray, want))))
        w1 = named["encoder.layers.0.fc1.weight"].numpy()
        b1 = named["encoder.layers.0.fc1.bias"].numpy()
        w2 = named["encoder.layers.0.fc2.weight"].numpy()
        torch_layout = (np.abs(w1).sum(axis=1) + np.abs(b1)
                        + np.abs(w2).sum(axis=0))
        pruned = np.setdiff1d(np.arange(w1.shape[0]), keeps[0])
        flips += int(np.argsort(torch_layout, kind="stable")[0] != pruned[0])
    assert flips > 0


@pytest.mark.parametrize("n_rows", [1, 32, 100])
@pytest.mark.parametrize("quantum", [None, 0.05])
def test_prune_rows_through_the_weight_bridge_bitwise(n_rows, quantum):
    cfg, params = _params(seed=2, quantum=quantum)
    want, want_cfg = jrp.prune_rows(params, cfg, n_rows)
    named = _named(params)
    before = {k: v.clone() for k, v in named.items()}
    keeps = trp.select_rows(named, n_rows)
    got, got_cfg = trp.prune_rows(named, PortConfig.from_dict(cfg.to_dict()),
                                  keeps)
    assert got_cfg.encoder_ffn_embed_dim == want_cfg.encoder_ffn_embed_dim
    assert all(torch.equal(before[k], named[k]) for k in named)
    a = tree_leaves(jax_tree_from_named(got))
    b = tree_leaves(jax.tree.map(np.asarray, want))
    assert len(a) == len(b)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    model = model_from_named(got, got_cfg)
    assert all(torch.equal(p, got[k]) for k, p in model.named_parameters())


def test_sliced_rows_equal_zeroed_units():
    # the additivity identity: the sliced model computes what the full one
    # does with the pruned units' fc1 rows and fc2 columns zeroed
    cfg, params = _params(seed=3)
    pcfg = PortConfig.from_dict(cfg.to_dict())
    full = load_model(params, pcfg)
    named = dict(full.named_parameters())
    keeps = trp.select_rows(named, 48)
    sliced_named, sliced_cfg = trp.prune_rows(named, pcfg, keeps)
    sliced = model_from_named(sliced_named, sliced_cfg)
    with torch.no_grad():
        for i, keep in enumerate(keeps):
            gone = np.setdiff1d(np.arange(cfg.encoder_ffn_embed_dim[i]), keep)
            layer = full.encoder.layers[i]
            layer.fc1.weight[gone] = 0.0
            layer.fc1.bias[gone] = 0.0
            layer.fc2.weight[:, gone] = 0.0
        rng = np.random.default_rng(0)
        feat = torch.from_numpy(rng.standard_normal((2, 30, 80)).astype(
            np.float32))
        pad = torch.ones(2, 30)
        pad[1, 20:] = 0
        ref = melhubert_forward(full, feat, pad, get_hidden=True)
        got = melhubert_forward(sliced, feat, pad, get_hidden=True)
    assert sliced_cfg.encoder_ffn_embed_dim == (80, 80)
    for a, b in zip(got["layer_hiddens"] + [got["logits"]],
                    ref["layer_hiddens"] + [ref["logits"]]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def _runner_config(csv, total_steps=2, lr=1.0e-4, **prune):
    return {
        "runner": {"n_epochs": 0, "total_steps": total_steps,
                   "gradient_clipping": 10.0, "gradient_accumulate_steps": 1,
                   "log_step": 1, "save_every_x_epochs": 100, "bf16": False},
        "optimizer": {"lr": lr, "betas": [0.9, 0.999], "eps": 1.0e-8,
                      "weight_decay": 0},
        "datarc": {"num_workers": 0, "train_batch_size": 2,
                   "max_timestep": 0, "sets": [csv]},
        "prune": dict(dict(num_rows_each_step=32, total_steps=1, interval=1,
                           warm_up=0), **prune),
    }


def _start(tmp_path):
    _, params = _params(seed=4, quantum=0.05)
    path = str(tmp_path / "start.npz")
    jax_save_checkpoint(path, params, meta={
        "Upstream_Config": model_config(), "Step": 0})
    return path


def test_runners_prune_the_same_rows_and_serve_alike(tmp_path):
    # warm_up 0 and lr 0: the event falls on the checkpoint's weights and
    # no update moves them, so both trainers' last artifacts hold the same
    # sliced weights; the port's serves in JAX and in the port alike
    csv = make_dataset(tmp_path)
    start = _start(tmp_path)
    rc = _runner_config(csv, lr=0.0)
    runs = {}
    for name, cls in (("jax", JaxRunner), ("port", Runner)):
        runner = cls(make_args(tmp_path / name, mode="row-pruning",
                               initial_weight=start), rc, model_config())
        runner.train()
        files = sorted(f for f in os.listdir(tmp_path / name)
                       if f.endswith(".npz"))
        meta = {f: {k: v for k, v in json.load(open(
            tmp_path / name / (f + ".json"))).items()
            if k in ("Step", "TotalStep", "Config")} for f in files}
        runs[name] = runner, files, meta
    (jr, jfiles, jmeta), (tr, tfiles, tmeta) = runs["jax"], runs["port"]
    assert tr.cfg.encoder_ffn_embed_dim == jr.cfg.encoder_ffn_embed_dim == (
        96, 96)
    assert tfiles == jfiles == ["states_prune_128.npz", "states_prune_96.npz"]
    assert tmeta == jmeta
    for f in tfiles:
        a = load_checkpoint(str(tmp_path / "port" / f), load_opt=False)
        b = load_checkpoint(str(tmp_path / "jax" / f), load_opt=False)
        assert all(np.array_equal(x, y) for x, y in zip(
            tree_leaves(a["params"]), tree_leaves(b["params"])))
        # stored C-ordered, as JAX stores them: a float32 sum over a slice
        # of a kernel rounds by the memory order it adds in
        with np.load(tmp_path / "port" / f) as data:
            assert all(data[k].flags.c_contiguous for k in data.files
                       if k.startswith("params/"))
    kept =tr.prune_event_log[0]["kept"]
    assert [len(k) for k in kept] == [96, 96]

    ckpt = str(tmp_path / "port" / "states_prune_96.npz")
    wavs = [np.random.default_rng(i).standard_normal(n).astype(np.float32)
            * 0.1 for i, n in enumerate((8000, 5000, 11000))]
    ref = JaxExtractor(ckpt, dtype=jnp.float32).forward_packed(wavs)
    out = MelHuBERTExtractor(ckpt, device="cpu").forward_packed(wavs)
    t = out["last_hidden_state"].shape[1]
    valid = np.arange(t)[None, :] < np.asarray(out["lengths"])[:, None]
    pairs = list(zip(out["hidden_states"], ref["hidden_states"]))
    pairs.append((out["last_hidden_state"], ref["last_hidden_state"]))
    for a, b in pairs:
        a, b = a.numpy()[valid], np.asarray(b)[valid]
        assert np.abs(a - b).max() / np.abs(b).mean() < SERVE_BAR


def test_two_row_events_reset_adam_and_shrink(tmp_path):
    csv = make_dataset(tmp_path)
    rc = _runner_config(csv, total_steps=3)
    rc["prune"] = dict(num_rows_each_step=16, total_steps=2, interval=1,
                       warm_up=1)
    runner = Runner(make_args(tmp_path / "port", mode="row-pruning",
                              initial_weight=_start(tmp_path)), rc,
                    model_config())
    runner.train()
    assert runner.cfg.encoder_ffn_embed_dim == (96, 96)
    assert int(runner.opt_state[0]) == 1  # the last event reset Adam
    log = runner.prune_event_log
    assert [e["step"] for e in log] == [1, 2]
    # 16 units of 64 + 64 + 1 weights (fc1 row, fc2 column, fc1 bias), per
    # layer, per event
    assert [e["params"][0] - e["params"][1] for e in log] == [
        2 * 16 * 129] * 2
    assert all(np.isfinite(h["loss"]) for h in runner.log_history)
    assert sorted(f for f in os.listdir(tmp_path / "port")
                  if f.endswith(".npz")) == [
        "states_prune_112.npz", "states_prune_128.npz", "states_prune_96.npz"]


def test_row_schedule_that_empties_the_ffn_raises_as_jax(tmp_path):
    csv = make_dataset(tmp_path)
    rc = _runner_config(csv, total_steps=4)
    rc["prune"] = dict(num_rows_each_step=32, total_steps=4, interval=1,
                       warm_up=0)  # 4 x 32 = 128 rows of 128
    for name, cls in (("jax", JaxRunner), ("port", Runner)):
        with pytest.raises(AssertionError):
            cls(make_args(tmp_path / name, mode="row-pruning"), rc,
                model_config())
