"""Pipeline-parallel MelHuBERT pre-training of the port
(``parallel/pipeline.py``, ``--pipeline_parallel``) on CPU ranks, against
the JAX package's pipeline step and its 1-process grad step.

The ranks are gloo subprocesses that import nothing of JAX; the grad-step
cases of one world size run in one launch (``ranks``). The batch, weights
and span mask are JAX's own test's (``tests/test_pipeline_parallel.py``),
dropout off, the mask injected; bars as there: loss and ``loss_masked``
atol/rtol 1e-5, ``n_masked`` equal, the merged gradients atol/rtol 1e-5."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.configs import (
    MelHuBERTConfig as JaxMelHuBERTConfig,
)
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.models import melhubert as jmelhubert
from speech_ssl_compression_tpu.parallel import (
    make_melhubert_pipeline_grad_step as jax_pipeline_step,
    merge_pipeline_params as jax_merge,
    pipeline_mesh,
    shard_pipeline_params,
    split_pipeline_params as jax_split,
)
from speech_ssl_compression_tpu.train.steps import (
    make_melhubert_grad_step as jax_grad_step,
)
from speech_ssl_compression_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
from speech_ssl_compression_tpu_torch.ops.dropout import (
    attention_keep_mask,
)
from speech_ssl_compression_tpu_torch.parallel import mesh as tmesh
from speech_ssl_compression_tpu_torch.parallel import pipeline as tpipeline
from speech_ssl_compression_tpu_torch.train import parallel_mixin
from speech_ssl_compression_tpu_torch.train.__main__ import main as train_main
from speech_ssl_compression_tpu_torch.train.runner import Runner
from speech_ssl_compression_tpu_torch.utils.checkpoint import load_checkpoint
from speech_ssl_compression_tpu_torch.utils.torch_convert import (
    melhubert_state_dict_to_params,
    merge_pipeline_tree,
    split_pipeline_tree,
)
from speech_ssl_compression_tpu_torch.utils.weights import load_model
from tests.test_torch_parallel import (
    LOSS_RTOL,
    MODEL,
    REPO,
    _args,
    _assert_close_params,
    _env,
    _free_port,
    _launch,
    _losses,
    _make_dataset,
    _runner_config,
    _start,
    _write_configs,
)
from tests.test_torch_10ms import _paths

TOL = 1e-5
KEEP_SIGMAS = 5.0
CFG = dict(feat_emb_dim=12, encoder_layers=4, encoder_embed_dim=16,
           encoder_ffn_embed_dim=32, encoder_attention_heads=2, head_dim=8,
           num_cluster=11, mask_prob=0.65, mask_length=3,
           learnable_mask_emb=True, pred_nomask_weight=0.5,
           skip_nomask=False, dropout=0.0, attention_dropout=0.0,
           activation_dropout=0.0)
# (dp, pp, M) of each launch's world size
CASES = {2: [(1, 2, 2), (1, 2, 1)], 4: [(1, 4, 4), (2, 2, 1)]}

WORKER = r'''
import json, os, sys
repo, rank, world, port, spec = sys.argv[1:6]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank,
                  WORLD_SIZE=world, LOCAL_RANK=rank, LOCAL_WORLD_SIZE=world)
sys.path.insert(0, repo)
import numpy as np
import torch
torch.set_num_threads(1)
from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
from speech_ssl_compression_tpu_torch.parallel.mesh import make_mesh
from speech_ssl_compression_tpu_torch.parallel.multihost import initialize
from speech_ssl_compression_tpu_torch.parallel.pipeline import (
    make_melhubert_pipeline_grad_step, split_pipeline_params, stage_model)
from speech_ssl_compression_tpu_torch.utils.checkpoint import load_checkpoint
from speech_ssl_compression_tpu_torch.utils.weights import load_model

spec = json.load(open(spec))
initialize(backend="gloo", device_type="cpu")
cfg = MelHuBERTConfig.from_dict(spec["cfg"])
whole = load_model(load_checkpoint(spec["start"], load_opt=False)["params"],
                   cfg)
data = dict(np.load(spec["data"]))
for dp, pp, m in spec["cases"]:
    mesh = make_mesh(1, pp)
    parts = split_pipeline_params(dict(whole.named_parameters()), pp)
    model = stage_model({**parts["rep"], **parts["stages"][mesh.pipe_index]},
                        cfg, mesh.pipe_index, pp)
    b = len(data["label"]) // dp
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    batch = {k: torch.from_numpy(data[k][rows])
             for k in ("feat", "label", "pad_mask")}
    step = make_melhubert_pipeline_grad_step(
        model, mesh, n_microbatches=m, deterministic=True, attn_impl="dense")
    params = dict(model.named_parameters())
    loss, grads, logs = step(params, batch, None,
                             mask_indices=torch.from_numpy(data["mask"][rows]))
    out = {f"grad/{k}": g.numpy() for k, g in zip(params, grads)}
    out.update({f"log/{k}": np.float64(v) for k, v in logs.items()},
               loss=np.float64(loss))
    np.savez(f"{spec['out']}_{dp}_{pp}_{m}_{rank}.npz", **out)
'''


def _jax_cfg():
    return JaxMelHuBERTConfig.from_dict(CFG)


def _batch(b=4, t=16, seed=0):
    """tests/test_pipeline_parallel.py::_batch, as numpy."""
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, t, CFG["feat_emb_dim"])).astype(np.float32)
    label = rng.integers(0, CFG["num_cluster"], (b, t)).astype(np.int64)
    pad = np.ones((b, t), np.float32)
    pad[0, t - 5:] = 0.0
    label[1, 2] = -100
    mask = (rng.random((b, t)) < 0.4) & pad.astype(bool)
    return {"feat": feat, "label": label, "pad_mask": pad, "mask": mask}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{"params", "batch", (dp, pp, M): (loss, logs, merged grad tree)}."""
    root = tmp_path_factory.mktemp("pipeline")
    params = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(0), _jax_cfg()))
    jax_save_checkpoint(str(root / "start.npz"), params, meta={})
    batch = _batch()
    np.savez(root / "data.npz", **batch)
    got = {"params": params, "batch": batch}
    for world, cases in CASES.items():
        spec = root / f"spec{world}.json"
        spec.write_text(json.dumps(dict(
            cfg=CFG, start=str(root / "start.npz"),
            data=str(root / "data.npz"), cases=cases,
            out=str(root / "out"))))
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(REPO), str(r), str(world),
             port, str(spec)], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=_env())
            for r in range(world)]
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
        for dp, pp, m in cases:
            runs = [dict(np.load(root / f"out_{dp}_{pp}_{m}_{r}.npz"))
                    for r in range(world)]
            for run in runs[1:]:  # every rank returns the summed values
                assert float(run["loss"]) == float(runs[0]["loss"])
            named = {}
            for run in runs:
                for k, v in run.items():
                    if k.startswith("grad/"):
                        named.setdefault(k[5:], torch.from_numpy(v))
            got[(dp, pp, m)] = (
                float(runs[0]["loss"]),
                {k[4:]: float(v) for k, v in runs[0].items()
                 if k.startswith("log/")},
                melhubert_state_dict_to_params(named, keep_masks=False)[0])
    return got


def _assert_tree_close(got, want):
    got, want = dict(_paths(got)), dict(_paths(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=TOL, rtol=TOL, err_msg=k)


def _check(got, loss, logs, grads):
    g_loss, g_logs, g_grads = got
    np.testing.assert_allclose(g_loss, float(loss), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(g_logs["loss_masked"],
                               float(logs["loss_masked"]), atol=TOL, rtol=TOL)
    assert int(g_logs["n_masked"]) == int(logs["n_masked"])
    _assert_tree_close(g_grads, jax.tree.map(np.asarray, grads))


def _jax_batch(batch):
    return {"feat": jnp.asarray(batch["feat"]),
            "label": jnp.asarray(batch["label"], jnp.int32),
            "pad_mask": jnp.asarray(batch["pad_mask"]),
            "mask_indices": jnp.asarray(batch["mask"])}


def test_grad_step_matches_jax_pipeline(ranks):
    """(dp, pp, M) = (1, 2, 2) against JAX's
    ``make_melhubert_pipeline_grad_step`` on a (data 1, pipe 2) mesh."""
    cfg = _jax_cfg()
    mesh = pipeline_mesh(2, pipeline_parallel=2)
    step = jax_pipeline_step(cfg, mesh, n_microbatches=2, deterministic=True,
                             attn_impl="dense")
    loss, grads, logs = step(shard_pipeline_params(jax_split(
        ranks["params"], 2), mesh), _jax_batch(ranks["batch"]), None)
    _check(ranks[(1, 2, 2)], loss, logs, jax_merge(grads))


@pytest.mark.parametrize("case", [(1, 4, 4), (2, 2, 1), (1, 2, 1)])
def test_grad_step_matches_the_one_process_step(ranks, case, monkeypatch):
    """The other grids against JAX's 1-process ``make_melhubert_grad_step``
    on the whole batch (its span mask injected), which JAX's own pipeline
    test pins its pipeline to (tests/test_pipeline_parallel.py:86-118)."""
    batch = ranks["batch"]
    monkeypatch.setattr(jmelhubert, "compute_span_mask",
                        lambda rng, lengths, max_len=None, **kw:
                        jnp.asarray(batch["mask"]))
    step = jax_grad_step(_jax_cfg(), attn_impl="dense")
    jb = _jax_batch(batch)
    del jb["mask_indices"]
    loss, grads, logs = step(ranks["params"], None, jb,
                             jax.random.PRNGKey(0))
    _check(ranks[case], loss, logs, grads)


def test_split_and_merge_round_trip_bitwise():
    """The port's named split and merge, and its numpy tree split and
    merge against JAX's, bitwise."""
    cfg = MelHuBERTConfig.from_dict(CFG)
    params = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(1), _jax_cfg()))
    named = dict(load_model(params, cfg).named_parameters())
    for n_stages in (1, 2, 4):
        parts = tpipeline.split_pipeline_params(named, n_stages)
        assert len(parts["stages"]) == n_stages
        back = tpipeline.merge_pipeline_params(parts)
        assert list(back) == list(named)
        assert all(back[k] is named[k] for k in named)
        tree = split_pipeline_tree(params, n_stages)
        want = jax.tree.map(np.asarray, jax_split(params, n_stages))
        assert dict(_paths(tree)).keys() == dict(_paths(want)).keys()
        for (k, a), (_, b) in zip(_paths(tree), _paths(want)):
            np.testing.assert_array_equal(a, b, err_msg=k)
        for (k, a), (_, b) in zip(_paths(merge_pipeline_tree(tree)),
                                  _paths(params)):
            np.testing.assert_array_equal(a, b, err_msg=k)


def _model(**over):
    cfg = MelHuBERTConfig.from_dict(dict(CFG, **over))
    params = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(2), JaxMelHuBERTConfig.from_dict(dict(CFG,
                                                                 **over))))
    return load_model(params, cfg)


@pytest.mark.parametrize("what", ["ragged", "layerdrop", "stages",
                                  "seq_len_multiple", "batch", "masks"])
def test_grad_step_refuses_what_jax_refuses(what):
    """JAX's refusals (parallel/pipeline.py:168-196,
    tests/test_pipeline_parallel.py:168-180): a ragged stack, LayerDrop in
    training, layers that do not split into the stages, padding to a
    sequence multiple, a batch that is not a multiple of dp x M, and
    weight-pruning masks. JAX's step raises alike for the first and the
    batch."""
    mesh = tmesh.Mesh(world=8, pp=2, rank=0)  # (data 4, pipe 2)
    model = _model(**({"encoder_attention_heads": [2, 2, 1, 2]}
                      if what == "ragged" else {}))
    cfg = model.cfg
    kw = dict(n_microbatches=2, deterministic=what != "layerdrop")
    if what == "layerdrop":
        model.cfg = cfg = __import__("dataclasses").replace(
            cfg, encoder_layerdrop=0.1)
    if what == "stages":
        mesh = tmesh.Mesh(world=3, pp=3, rank=0)
    if what == "seq_len_multiple":
        model.cfg = types.SimpleNamespace(**{
            **vars(cfg), "required_seq_len_multiple": 2})
    if what in ("batch", "masks"):
        step = tpipeline.make_melhubert_pipeline_grad_step(model, mesh, **kw)
        b = _batch()
        batch = {k: torch.from_numpy(b[k]) for k in ("feat", "label",
                                                    "pad_mask")}
        params = dict(model.named_parameters())
        if what == "batch":  # 4 rows on one of 4 data ranks, M = 2
            with pytest.raises(ValueError, match="multiple of data_parallel"):
                step(params, {k: v[:1] for k, v in batch.items()}, None,
                     mask_indices=torch.from_numpy(b["mask"][:1]))
            jmesh = pipeline_mesh(8, pipeline_parallel=2)
            jstep = jax_pipeline_step(_jax_cfg(), jmesh, n_microbatches=2,
                                      deterministic=True)
            jparams = shard_pipeline_params(jax_split(jax.tree.map(
                np.asarray, init_melhubert_params(jax.random.PRNGKey(2),
                                                  _jax_cfg())), 2), jmesh)
            with pytest.raises(ValueError):
                jstep(jparams, _jax_batch(b), None)
        else:
            with pytest.raises(NotImplementedError, match="weight-pruned"):
                step(params, batch, None, masks={
                    "final_proj.weight": torch.ones(11, 16)})
        return
    exc = ValueError if what == "stages" else NotImplementedError
    with pytest.raises(exc):
        tpipeline.make_melhubert_pipeline_grad_step(model, mesh, **kw)
    if what == "ragged":
        with pytest.raises(NotImplementedError):
            jax_pipeline_step(JaxMelHuBERTConfig.from_dict(dict(
                CFG, encoder_attention_heads=(2, 2, 1, 2))),
                pipeline_mesh(4, pipeline_parallel=2), n_microbatches=2)


def test_dropout_seeds_per_microbatch_and_layer(monkeypatch):
    """Dropout on, one stage of 4 layers, M = 4 microbatches: each
    (microbatch, layer) keys the attention's keep bits on a seed of its
    own, each microbatch's residual dropout draws from a generator of its
    own, and every keep mask's rate lies within 5 sigma of the binomial."""
    p = 0.3
    model = _model(dropout=0.1, attention_dropout=p, activation_dropout=0.1)
    calls = []
    layer_forward = tpipeline.encoder_layer_forward

    def spy(x, layer, **kw):
        calls.append((kw["attention_seed"], kw["generator"].initial_seed(),
                      x.shape))
        return layer_forward(x, layer, **kw)

    monkeypatch.setattr(tpipeline, "encoder_layer_forward", spy)
    step = tpipeline.make_melhubert_pipeline_grad_step(
        model, tmesh.Mesh(), n_microbatches=4, attn_impl="dense")
    b = _batch()
    loss, grads, _ = step(dict(model.named_parameters()), {
        k: torch.from_numpy(b[k]) for k in ("feat", "label", "pad_mask")},
        torch.Generator().manual_seed(0),
        mask_indices=torch.from_numpy(b["mask"]))
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert len(calls) == 4 * CFG["encoder_layers"]
    seeds = [c[0] for c in calls]
    assert len(set(seeds)) == len(seeds)
    gens = [c[1] for c in calls]
    assert len(set(gens)) == 4  # one per microbatch, its layers in turn
    masks = []
    for seed, _, shape in calls:
        keep = attention_keep_mask(seed, shape[0], CFG[
            "encoder_attention_heads"], shape[1], shape[1], p)
        n = keep.numel()
        sigma = np.sqrt(n * p * (1 - p))
        assert abs(int(keep.sum()) - n * (1 - p)) < KEEP_SIGMAS * sigma
        masks.append(keep)
    for i in range(len(masks)):
        for j in range(i + 1, len(masks)):
            assert not torch.equal(masks[i], masks[j]), (i, j)


def test_trainer_refuses_what_jax_refuses(tmp_path, monkeypatch):
    """--pipeline_parallel with another mode than melhubert and with
    --model_parallel raises NotImplementedError (JAX runner.py:171-181);
    one process cannot hold 2 stages (ValueError); a weight-pruned
    checkpoint is refused once the grid has 2 ranks."""
    csv = _make_dataset(tmp_path)
    model = {"melhubert": MODEL, "task": {"sequence_length": 0}}
    m, r = _write_configs(tmp_path, model, _runner_config(csv))
    base = ["-g", m, "-c", r, "-n", str(tmp_path / "e"), "--device", "cpu"]
    for extra, exc, match in (
            (["-m", "head-pruning"], NotImplementedError, "melhubert"),
            (["-m", "melhubert", "--model_parallel", "2"],
             NotImplementedError, "model_parallel"),
            (["-m", "melhubert"], ValueError, "needs 2 ranks")):
        with pytest.raises(exc, match=match):
            train_main(base + extra + ["--pipeline_parallel", "2"])
    start = _start(tmp_path)
    state = jax_load_checkpoint(start)
    masks = {f"layer_{i}": {"fc1": {"kernel": np.ones_like(
        layer["fc1"]["kernel"])}}
        for i, layer in enumerate(state["params"]["encoder"]["layers"])}
    masked = str(tmp_path / "masked.npz")
    jax_save_checkpoint(masked, state["params"], masks=masks,
                        meta=state["meta"])
    monkeypatch.setattr(parallel_mixin, "make_mesh",
                        lambda tp, pp: tmesh.Mesh(world=2, pp=pp, rank=0))
    with pytest.raises(NotImplementedError, match="weight-pruned"):
        Runner(_args(tmp_path / "e2", start=masked, pipeline_parallel=2),
               _runner_config(csv), model)


def test_two_rank_pipeline_trainer(tmp_path):
    """3 f32 updates of MelHuBERT on 2 stage ranks through the CLI
    (--pipeline_parallel 2 --pp_microbatches 2, gloo) against the port's
    1-process run: the same losses and parameters; the checkpoint is the
    standard per-layer tree that JAX's load_checkpoint reads and the
    extractor serves; its Adam state is JAX's stage-split layout, which a
    1-process resume refuses."""
    csv = _make_dataset(tmp_path)
    start = _start(tmp_path)
    model = {"melhubert": MODEL, "task": {"sequence_length": 0}}
    rc = _runner_config(csv, steps=3)
    m, r = _write_configs(tmp_path, model, rc)
    outs, runs, cwds = _launch(tmp_path, "pp", [
        "-m", "melhubert", "-g", m, "-c", r, "-n", "exp", "-i", start,
        "--device", "cpu", "--seed", "0", "--pipeline_parallel", "2",
        "--pp_microbatches", "2"], patch=False)
    assert "Pipeline grid {'data': 1, 'pipe': 2}" in outs[0]
    assert _losses(runs[0]["log"]) == _losses(runs[1]["log"])
    assert sorted(os.listdir(cwds[1])) == []

    # the stages draw from the host generator as one process does, so the
    # span masks are the 1-process run's without any patch
    one = Runner(_args(tmp_path / "one", start=start), rc, model)
    one.train()
    np.testing.assert_allclose(_losses(runs[0]["log"]),
                               _losses(one.log_history), rtol=LOSS_RTOL)
    ckpt = cwds[0] / "exp" / "last-step.npz"
    _assert_close_params(load_checkpoint(str(ckpt))["params"],
                         load_checkpoint(str(tmp_path / "one" /
                                             "last-step.npz"))["params"])
    state = jax_load_checkpoint(str(ckpt))
    layers = state["params"]["encoder"]["layers"]
    assert isinstance(layers, list) and len(layers) == MODEL["encoder_layers"]
    leaves = load_checkpoint(str(ckpt))["opt_leaves"]
    split = jax_split(state["params"], 2)
    assert len(leaves) == 1 + 2 * len(jax.tree.leaves(split))
    assert leaves[1 + len(jax.tree.leaves(split["rep"]))].shape[:2] == (2, 1)

    ext = MelHuBERTExtractor(str(ckpt), device="cpu")
    out = ext.forward_packed([np.random.default_rng(0).standard_normal(
        8000).astype(np.float32) * 0.1])
    assert bool(out["last_hidden_state"].isfinite().all())

    args = _args(tmp_path / "resume", start=str(ckpt))
    args.init_optimizer_from_initial_weight = True
    with pytest.raises(ValueError, match="optimizer state"):
        Runner(args, rc, model)


def test_remat_recomputes_each_layer_to_the_same_gradients():
    """``remat=True`` (JAX's ``remat``, tests/test_pipeline_parallel.py:
    128-145) runs each layer through checkpoint_layer: dropout on, the
    same host generator state, the loss and every gradient bitwise the
    step's without it."""
    model = _model(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1)
    b = _batch()
    batch = {k: torch.from_numpy(b[k]) for k in ("feat", "label", "pad_mask")}
    params = dict(model.named_parameters())
    out = []
    for remat in (False, True):
        step = tpipeline.make_melhubert_pipeline_grad_step(
            model, tmesh.Mesh(), n_microbatches=2, attn_impl="dense",
            remat=remat)
        out.append(step(params, batch, torch.Generator().manual_seed(3),
                        mask_indices=torch.from_numpy(b["mask"])))
    (loss_a, grads_a, _), (loss_b, grads_b, _) = out
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(x, y) for x, y in zip(grads_a, grads_b))
    assert any(bool(g.abs().sum()) for g in grads_a)
