"""The port's head pruning against the JAX package: l1 scores (bitwise,
ties included, on the JAX-layout view of the port's weights, with a
control showing a torch-layout sum chooses otherwise), the selection, the
slicing through the weight bridge, the data-driven scores of the forward
with contexts and autograd to them, the stacked scoring batches, and the
two trainers' head-pruning runs from one checkpoint. Tiny widths, inputs
from numpy seeds, on the CPU."""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.compress import head_pruning as jhp
from speech_ssl_compression_tpu.compress import weight_pruning as jwp
from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.extract import (
    MelHuBERTExtractor as JaxExtractor,
)
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.models.melhubert import (
    melhubert_forward as jax_forward,
    melhubert_pretrain_loss as jax_loss,
)
from speech_ssl_compression_tpu.train.runner import Runner as JaxRunner
from speech_ssl_compression_tpu.train.runner import (
    _stack_buckets as jax_stack_buckets,
)
from speech_ssl_compression_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu_torch.compress import head_pruning as thp
from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig as PortConfig,
)
from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
from speech_ssl_compression_tpu_torch.models import encoder as tencoder
from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
from speech_ssl_compression_tpu_torch.ops.attention import (
    multi_head_self_attention,
)
from speech_ssl_compression_tpu_torch.train.runner import Runner
from speech_ssl_compression_tpu_torch.train.runner import _stack_buckets
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

SCORE_BAR = 1e-4  # data-driven scores, rel. L2 per layer
SERVE_BAR = 1e-4  # max |d| / mean |ref| on valid frames


def _params(seed=0, quantum=None, heads=None):
    """JAX-layout numpy params of the tiny model (``heads``: per-layer head
    counts); with ``quantum`` every weight is a multiple of it, so sums
    tie."""
    cfg = MelHuBERTConfig.from_dict(TINY)
    if heads is not None:
        cfg = cfg.with_heads(heads)
    params = jax.tree.map(np.asarray,
                          init_melhubert_params(jax.random.PRNGKey(seed), cfg))
    if quantum:
        params = jax.tree.map(
            lambda a: (np.round(a / quantum) * quantum).astype(np.float32),
            params)
    return cfg, params


def _port(cfg):
    return PortConfig.from_dict(cfg.to_dict())


def _named(params):
    return {k: v.clone() for k, v in state_dict_from_jax_params(params).items()}


# ----------------------------------------------------------------- l1 scores

@pytest.mark.parametrize("quantum", [None, 0.01])
@pytest.mark.parametrize("heads", [(4, 4), (1, 3)])
def test_l1_head_scores_match_jax_bitwise(quantum, heads):
    cfg, params = _params(seed=1, quantum=quantum, heads=heads)
    want = jhp.l1_head_scores(params, cfg)
    got = thp.l1_head_scores(prunable_tree(_named(params)), _port(cfg))
    assert got == want


def _torch_layout_l1(named, cfg, layer):
    """The l1 sums taken on the port's (out, in) weights directly."""
    hd = cfg.head_dim
    out = []
    for h in range(cfg.encoder_attention_heads[layer]):
        s = 0.0
        for mod in ("k_proj", "q_proj", "v_proj"):
            w = named[f"encoder.layers.{layer}.self_attn.{mod}.weight"]
            b = named[f"encoder.layers.{layer}.self_attn.{mod}.bias"]
            s += float(np.abs(w[h * hd:(h + 1) * hd].numpy()).sum())
            s += float(np.abs(b[h * hd:(h + 1) * hd].numpy()).sum())
        out.append(((layer, h), s))
    return out


def test_torch_layout_l1_sum_breaks_an_exact_tie_the_other_way():
    # head 1 of layer 0 holds head 0's q/k/v entries (q's in another
    # order), so the two tie in exact arithmetic; float32 sums break the
    # tie by the order they add in. The port scores the JAX-layout view and
    # chooses JAX's head; the same sums on the torch-layout weights choose
    # the other one for some of these weights.
    cfg, params = _params(seed=2)
    params = jax.tree.map(np.array, params)  # writable copies
    d, hd = cfg.encoder_embed_dim, cfg.head_dim
    pcfg = _port(cfg)
    flips = 0
    for seed in range(8):
        layer = params["encoder"]["layers"][0]
        rng = np.random.default_rng(seed)
        a = (0.02 * rng.standard_normal((d, hd))).astype(np.float32)
        for mod in ("q_proj", "k_proj", "v_proj"):
            k = layer[mod]["kernel"]
            k[:, 2 * hd:] = 1.0  # heads 2 and 3 score far above
            k[:, :hd] = a
            # head 1: a's entries in the order the torch layout reads them
            k[:, hd:2 * hd] = (np.ascontiguousarray(a.T).reshape(d, hd)
                               if mod == "q_proj" else a)
            layer[mod]["bias"][:] = 0.0
        want = jhp.select_heads_to_prune(jhp.l1_head_scores(params, cfg), 1,
                                         "by_layer", 2)
        named = _named(params)
        got = thp.select_heads_to_prune(
            thp.l1_head_scores(prunable_tree(named), pcfg), 1, "by_layer", 2)
        assert got == want
        torch_layout = thp.select_heads_to_prune(
            _torch_layout_l1(named, pcfg, 0), 1, "by_layer", 1)
        flips += torch_layout[0] != want[0]
    assert flips > 0


# ----------------------------------------------------------------- selection

@pytest.mark.parametrize("target,n", [("by_whole", 3), ("by_whole", 6),
                                      ("by_layer", 1), ("by_layer", 3)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_heads_to_prune_matches_jax(target, n, seed):
    rng = np.random.default_rng(seed)
    heads = (4, 2, 3)
    # integer scores: many ties, across and within layers
    scores = [((l, h), float(rng.integers(0, 4)))
              for l in range(3) for h in range(heads[l])]
    rng.shuffle(scores)
    want = jhp.select_heads_to_prune(scores, n, target, 3)
    got = thp.select_heads_to_prune(scores, n, target, 3)
    assert list(got.items()) == list(want.items())
    assert json.dumps(got) == json.dumps(want)


def test_select_heads_refuses_as_jax_does():
    scores = [((l, h), float(h)) for l in range(2) for h in range(2)]
    for select in (jhp.select_heads_to_prune, thp.select_heads_to_prune):
        with pytest.raises(AssertionError):
            select(scores, 3, "by_whole", 2)  # 2 prunable of 4
        with pytest.raises(AssertionError):
            select(scores, 3, "by_layer", 2)
        with pytest.raises(NotImplementedError):
            select(scores, 1, "by_row", 2)
    hist = [{0: [1, 2]}, {"0": [0], "1": [3]}]
    assert thp.summarize_pruned_heads(hist) == jhp.summarize_pruned_heads(
        hist) == {0: 3, 1: 1}


# ------------------------------------------------------------------- slicing

@pytest.mark.parametrize("group", [{0: [1, 3]}, {0: [0], 1: [3, 1, 2]}])
def test_prune_heads_through_the_weight_bridge_bitwise(group):
    cfg, params = _params(seed=3)
    want, want_cfg = jhp.prune_heads(params, cfg, group)
    named = _named(params)
    before = {k: v.clone() for k, v in named.items()}
    got, got_cfg = thp.prune_heads(named, _port(cfg), group)
    assert got_cfg.encoder_attention_heads == want_cfg.encoder_attention_heads
    assert all(torch.equal(before[k], named[k]) for k in named)  # untouched
    a = tree_leaves(jax_tree_from_named(got))
    b = tree_leaves(jax.tree.map(np.asarray, want))
    assert len(a) == len(b)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    model = model_from_named(got, got_cfg)  # strict load
    assert all(torch.equal(p, got[k]) for k, p in model.named_parameters())


def test_sliced_heads_equal_zeroed_out_proj_columns():
    # the additivity identity: a layer without heads 1 and 3 computes what
    # the full layer does with those heads' out_proj input columns zeroed
    cfg, params = _params(seed=4)
    pcfg = _port(cfg)
    full = load_model(params, pcfg)
    group = {0: [1, 3]}
    sliced = model_from_named(
        thp.prune_heads(dict(full.named_parameters()), pcfg, group)[0],
        pcfg.with_heads((2, 4)))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 12, cfg.encoder_embed_dim)).astype(np.float32))
    attn = full.encoder.layers[0].self_attn
    hd = cfg.head_dim
    with torch.no_grad():
        for h in group[0]:
            attn.out_proj.weight[:, h * hd:(h + 1) * hd] = 0.0
        for impl in ("auto", "dense"):
            ref, _ = multi_head_self_attention(x, attn, num_heads=4,
                                               head_dim=hd, impl=impl)
            got, ctx = multi_head_self_attention(
                x, sliced.encoder.layers[0].self_attn, num_heads=2,
                head_dim=hd, impl=impl)
            assert ctx.shape == (2, 2, 12, hd)
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


# ------------------------------------------------------- data-driven scores

def _batch(cfg, seed=0, b=3, t=40):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, t, 80)).astype(np.float32)
    lengths = np.array([t, 27, 12])[:b]
    pad = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    label = rng.integers(0, cfg.num_cluster, (b, t)).astype(np.int32)
    label[pad == 0] = -100
    mask = span_mask(_port(cfg), lengths, t, np.random.default_rng(seed + 1))
    return feat, pad, label, lengths, mask


def _jax_scores(cfg, params, feat, pad, label, mask, exponent=None):
    """JAX's scoring pass with the dropouts off and a fixed span mask:
    ``head_probes`` + jax.grad + ``data_driven_scores_from_grads`` (+
    ``normalize_scores_by_layer``)."""
    probes = jhp.make_head_probes(cfg, feat.shape[0], feat.shape[1])

    def loss_fn(probes):
        out = jax_forward(params, cfg, jnp.asarray(feat), jnp.asarray(pad),
                          mask=True, teacher_mask_indices=jnp.asarray(mask),
                          deterministic=True, head_probes=probes,
                          attn_impl="dense")
        loss, _ = jax_loss(out, jnp.asarray(label), jnp.asarray(pad), cfg)
        return loss, out["contexts"]

    (_, contexts), grads = jax.value_and_grad(loss_fn, has_aux=True)(probes)
    scores = [np.asarray(s, np.float64) for s in
              jhp.data_driven_scores_from_grads(contexts, grads)]
    if exponent is not None:
        scores = jhp.normalize_scores_by_layer(scores, exponent)
    return scores


@pytest.mark.parametrize("attn_impl", ["auto", "dense"])
@pytest.mark.parametrize("heads", [(4, 4), (1, 3)])
def test_data_driven_scores_match_jax(heads, attn_impl):
    cfg, params = _params(seed=5, heads=heads)
    feat, pad, label, lengths, mask = _batch(cfg)
    want = _jax_scores(cfg, params, feat, pad, label, mask)
    want_norm = _jax_scores(cfg, params, feat, pad, label, mask, exponent=2.0)
    model = load_model(params, _port(cfg))
    named = dict(model.named_parameters())
    batch = {"feat": torch.from_numpy(feat), "pad_mask": torch.from_numpy(pad),
             "label": torch.from_numpy(label).long()}
    _, got = thp.context_scores(model, named, batch, torch.from_numpy(mask),
                                torch.Generator(), deterministic=True,
                                attn_impl=attn_impl)
    got = [s.numpy().astype(np.float64) for s in got]
    assert [len(s) for s in got] == list(heads)
    for g, w in zip(got, want):
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < SCORE_BAR
    for g, w in zip(thp.normalize_scores_by_layer(got, 2.0), want_norm):
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < SCORE_BAR
    # the contexts' gradients reached no parameter
    assert all(p.grad is None for p in model.parameters())


def test_layerdrop_skipped_layer_scores_zero(monkeypatch):
    cfg, params = _params(seed=6)
    pcfg = PortConfig.from_dict(dict(cfg.to_dict(), encoder_layerdrop=0.5))
    model = load_model(params, pcfg)
    named = dict(model.named_parameters())
    feat, pad, label, lengths, mask = _batch(cfg)
    batch = {"feat": torch.from_numpy(feat), "pad_mask": torch.from_numpy(pad),
             "label": torch.from_numpy(label).long()}
    ran = []
    real = tencoder.encoder_layer_forward

    def spy(x, layer, **kw):
        ran.append(layer)
        return real(x, layer, **kw)

    monkeypatch.setattr(tencoder, "encoder_layer_forward", spy)
    seen = set()
    for seed in range(12):
        ran.clear()
        _, scores = thp.context_scores(
            model, named, batch, torch.from_numpy(mask),
            torch.Generator().manual_seed(seed))
        for layer, s in zip(model.encoder.layers, scores):
            kept = any(layer is r for r in ran)
            assert bool((s > 0).all()) if kept else bool((s == 0).all())
            seen.add(kept)
    assert seen == {True, False}


def test_every_layer_skipped_scores_zero():
    cfg, params = _params(seed=6)
    pcfg = PortConfig.from_dict(dict(cfg.to_dict(), encoder_layerdrop=1.0))
    model = load_model(params, pcfg)
    feat, pad, label, lengths, mask = _batch(cfg)
    batch = {"feat": torch.from_numpy(feat), "pad_mask": torch.from_numpy(pad),
             "label": torch.from_numpy(label).long()}
    loss, scores = thp.context_scores(
        model, dict(model.named_parameters()), batch,
        torch.from_numpy(mask), torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    assert [s.tolist() for s in scores] == [[0.0] * h for h in
                                            cfg.encoder_attention_heads]


# ------------------------------------------------------------ scoring batches

def test_stack_buckets_matches_jax_bitwise():
    rng = np.random.default_rng(0)

    def bucket(b, t):
        lens = rng.integers(t // 2, t + 1, b).astype(np.int32)
        return {"feat": rng.standard_normal((b, t, 80)).astype(np.float32),
                "label": rng.integers(0, 5, (b, t)).astype(np.int64),
                "pad_mask": (np.arange(t)[None] < lens[:, None]).astype(
                    np.float32),
                "length": lens}

    for shapes in (((4, 100), (4, 180)), ((2, 128),), ((3, 300), (3, 257),
                                                         (3, 12))):
        buckets = [bucket(b, t) for b, t in shapes]
        got, want = _stack_buckets(buckets), jax_stack_buckets(buckets)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k


# ------------------------------------------------------------- the trainers

def _runner_config(csv, prune, total_steps=2, lr=1.0e-4):
    return {
        "runner": {"n_epochs": 0, "total_steps": total_steps,
                   "gradient_clipping": 10.0, "gradient_accumulate_steps": 1,
                   "log_step": 1, "save_every_x_epochs": 100, "bf16": False},
        "optimizer": {"lr": lr, "betas": [0.9, 0.999], "eps": 1.0e-8,
                      "weight_decay": 0},
        "datarc": {"num_workers": 0, "train_batch_size": 2,
                   "max_timestep": 0, "sets": [csv]},
        "prune": dict(prune),
    }


def _start(tmp_path, masks=None):
    cfg, params = _params(seed=7, quantum=0.01)
    path = str(tmp_path / "start.npz")
    jax_save_checkpoint(path, params, masks=masks, meta={
        "Upstream_Config": model_config(), "Step": 0})
    return cfg, params, path


def _artifacts(expdir):
    files = sorted(f for f in os.listdir(expdir) if f.endswith((".npz",
                                                                  ".npy")))
    meta = {f: {k: v for k, v in json.load(open(os.path.join(
        expdir, f + ".json"))).items()
        if k in ("Step", "TotalStep", "Pruned_heads", "Config")}
        for f in files if f.endswith(".npz")}
    return files, meta


@pytest.mark.parametrize("target", ["by_layer", "by_whole"])
def test_runners_prune_the_same_heads_from_one_checkpoint(tmp_path, target):
    # warm_up 0: the event falls before any update, on the checkpoint's
    # weights; lr 0 keeps the weights, so both trainers' last artifacts
    # hold the same sliced weights
    csv = make_dataset(tmp_path)
    _, _, start = _start(tmp_path)
    rc = _runner_config(csv, dict(metric="l1", target=target, total_steps=1,
                                  interval=1, warm_up=0), lr=0.0)
    runs = {}
    for name, cls in (("jax", JaxRunner), ("port", Runner)):
        runner = cls(make_args(tmp_path / name, mode="head-pruning",
                               initial_weight=start), rc, model_config())
        runner.train()
        runs[name] = runner, _artifacts(tmp_path / name)
    (jr, (jfiles, jmeta)), (tr, (tfiles, tmeta)) = runs["jax"], runs["port"]
    assert tr.pruned_heads == jr.pruned_heads
    assert tr.cfg.encoder_attention_heads == jr.cfg.encoder_attention_heads
    assert sum(tr.cfg.encoder_attention_heads) == 6
    assert tfiles == jfiles == ["heads_and_score_8.npy", "states_prune_6.npz",
                                "states_prune_8.npz"]
    assert tmeta == jmeta
    for f in tfiles:
        if f.endswith(".npy"):
            assert np.array_equal(np.load(tmp_path / "port" / f),
                                  np.load(tmp_path / "jax" / f))
        else:
            a = load_checkpoint(str(tmp_path / "port" / f), load_opt=False)
            b = load_checkpoint(str(tmp_path / "jax" / f), load_opt=False)
            assert all(np.array_equal(x, y) for x, y in zip(
                tree_leaves(a["params"]), tree_leaves(b["params"])))


def test_two_events_reset_adam_and_shrink(tmp_path):
    # data-driven by_whole at steps 1 and 2 of 3: each event a fresh Adam
    # state, fewer params, the loss finite; scoring ran on the stacked
    # buckets with dropout on
    csv = make_dataset(tmp_path)
    _, _, start = _start(tmp_path)
    rc = _runner_config(csv, dict(
        metric="data-driven", target="by_whole", total_steps=2, interval=1,
        warm_up=1, num_heads_each_step=2, data_ratio=1.0,
        normalize_by_layer=2), total_steps=3)
    model = dict(model_config())
    model["melhubert"] = dict(TINY, dropout=0.1, attention_dropout=0.1,
                              activation_dropout=0.1)
    runner = Runner(make_args(tmp_path / "port", mode="head-pruning",
                              initial_weight=start), rc, model)
    counts = []
    apply = runner.apply

    def counting(grads, sample_size):
        counts.append(int(runner.opt_state[0]))
        return apply(grads, sample_size)

    runner.apply = counting
    runner.train()
    assert counts == [0, 0, 0]  # an event before the 2nd and 3rd update
    assert int(runner.opt_state[0]) == 1
    log = runner.prune_event_log
    assert [e["step"] for e in log] == [1, 2]
    assert log[0]["params"][0] > log[0]["params"][1] == log[1]["params"][0]
    assert log[1]["params"][0] > log[1]["params"][1]
    assert sum(runner.cfg.encoder_attention_heads) == 4
    assert [sum(map(len, e.values())) for e in runner.pruned_heads] == [2, 2]
    assert all(np.isfinite(h["loss"]) for h in runner.log_history)
    assert len(runner.log_history) == 3
    assert sum(p.numel() for p in runner.params.values()) == log[1]["params"][1]
    scores = np.load(tmp_path / "port" / "heads_and_score_6.npy")
    assert scores.shape == (6, 3)
    for layer in range(2):  # normalize_by_layer 2: unit L2 per layer
        s = scores[scores[:, 0] == layer, 2]
        assert abs(np.linalg.norm(s) - 1.0) < 1e-9


def test_weight_pruned_start_folds_its_masks(tmp_path):
    cfg, params = _params(seed=7, quantum=0.01)
    masks = jwp.global_magnitude_prune(params, 0.5)
    _, _, start = _start(tmp_path, masks=masks)
    csv = make_dataset(tmp_path)
    rc = _runner_config(csv, dict(metric="l1", target="by_layer",
                                  total_steps=1, interval=1, warm_up=0))
    runner = Runner(make_args(tmp_path / "port", mode="head-pruning",
                              initial_weight=start), rc, model_config())
    assert runner.masks is None
    want = tree_leaves(jwp.fold_masks(params, masks))
    got = tree_leaves(jax_tree_from_named(runner.params))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    # JAX folds the same way
    jr = JaxRunner(make_args(tmp_path / "jax", mode="head-pruning",
                             initial_weight=start), rc, model_config())
    assert jr.masks is None
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
        got, tree_leaves(jax.tree.map(np.asarray, jr.params))))


@pytest.mark.parametrize("prune", [
    dict(metric="l1", target="by_layer", total_steps=4, interval=1,
         warm_up=0),  # 4 events of 1 head a layer empty a 4-head layer
    dict(metric="data-driven", target="by_whole", total_steps=2, interval=1,
         warm_up=0, num_heads_each_step=4, data_ratio=1.0),  # 8 > 6
])
def test_schedules_that_empty_a_layer_raise_as_jax(tmp_path, prune):
    csv = make_dataset(tmp_path)
    rc = _runner_config(csv, prune, total_steps=4)
    for name, cls in (("jax", JaxRunner), ("port", Runner)):
        with pytest.raises(AssertionError):
            cls(make_args(tmp_path / name, mode="head-pruning"), rc,
                model_config())


def test_checkpoints_cross_the_packages(tmp_path):
    # a JAX-written head-pruned npz resumes in the port with its
    # Pruned_heads history; the port's next artifact serves in JAX and in
    # the port alike
    csv = make_dataset(tmp_path)
    _, _, start = _start(tmp_path)
    rc = _runner_config(csv, dict(metric="l1", target="by_whole",
                                  total_steps=1, interval=1, warm_up=0))
    jr = JaxRunner(make_args(tmp_path / "jax", mode="head-pruning",
                             initial_weight=start), rc, model_config())
    jr.train()
    jax_ckpt = str(tmp_path / "jax" / "states_prune_6.npz")
    runner = Runner(make_args(tmp_path / "port", mode="head-pruning",
                              initial_weight=jax_ckpt), rc, model_config())
    assert runner.cfg.encoder_attention_heads == jr.cfg.encoder_attention_heads
    assert runner.pruned_heads == json.loads(json.dumps(jr.pruned_heads))
    runner.train()
    port_ckpt = str(tmp_path / "port" / "states_prune_4.npz")
    meta = load_checkpoint(port_ckpt, load_opt=False)["meta"]
    assert len(meta["Pruned_heads"]) == 2
    assert meta["Pruned_heads"][0] == json.loads(json.dumps(
        jr.pruned_heads))[0]
    assert sum(thp.summarize_pruned_heads(meta["Pruned_heads"]).values()) == 4
    wavs = [np.random.default_rng(i).standard_normal(n).astype(np.float32)
            * 0.1 for i, n in enumerate((8000, 5000, 11000))]
    for ckpt in (port_ckpt, jax_ckpt):
        ref = JaxExtractor(ckpt, dtype=jnp.float32).forward_packed(wavs)
        out = MelHuBERTExtractor(ckpt, device="cpu").forward_packed(wavs)
        assert out["lengths"] == ref["lengths"]
        t = out["last_hidden_state"].shape[1]
        valid = np.arange(t)[None, :] < np.asarray(out["lengths"])[:, None]
        pairs = list(zip(out["hidden_states"], ref["hidden_states"]))
        pairs.append((out["last_hidden_state"], ref["last_hidden_state"]))
        for a, b in pairs:
            a, b = a.numpy()[valid], np.asarray(b)[valid]
            assert np.abs(a - b).max() / np.abs(b).mean() < SERVE_BAR
