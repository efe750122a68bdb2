"""Data- and tensor-parallel training of the port (``parallel/``,
``train/parallel_mixin.py``) on the CPU, against the JAX package's mesh and
its single-process replay of a multi-process run.

Ranks run as subprocesses of the port's CLI (``--multi_host``, gloo,
torchrun's env), each from its own working directory with a relative
expdir; the workers import nothing of JAX. Span masks are drawn, where
JAX is compared, by one host function of a batch's T and lengths in both
packages (JAX's through a ``pure_callback``), as in
``tests/test_torch_10ms.py``. A run of 2 ranks is held to the 1-process
replay of its global batches (the datasets' ``process_index=None``) with
JAX's bars (``tests/test_multiprocess_train.py``): losses within rtol
2e-4, parameters within rtol 1e-4, atol 1e-6 (against JAX's replay: each
parameter within rel. L2 1e-4, the cross-package bar)."""

import json
import os
import pathlib
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from speech_ssl_compression_tpu.data import bucket_dataset as jbucket
from speech_ssl_compression_tpu.data import hubert_dataset as jhubert_data
from speech_ssl_compression_tpu.data import wav2vec2_dataset as jw2v_data
from speech_ssl_compression_tpu.models import melhubert as jmelhubert
from speech_ssl_compression_tpu.parallel.mesh import make_mesh as jax_make_mesh
from speech_ssl_compression_tpu.train.runner import Runner as JaxRunner
from speech_ssl_compression_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from speech_ssl_compression_tpu import configs as jconfigs
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu_torch.configs import (
    MelHuBERTConfig,
    read_yaml,
)
from speech_ssl_compression_tpu_torch.data import bucket_dataset as tbucket
from speech_ssl_compression_tpu_torch.data import hubert_dataset as thubert_data
from speech_ssl_compression_tpu_torch.data import wav2vec2_dataset as tw2v_data
from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
from speech_ssl_compression_tpu_torch.models.conv_frontend import (
    conv_output_length,
)
from speech_ssl_compression_tpu_torch.models.encoder import rank_coords
from speech_ssl_compression_tpu_torch.ops.dropout import (
    attention_keep_mask,
    dropout,
    fold_seed,
    seeded_generator,
)
from speech_ssl_compression_tpu_torch.parallel import mesh as tmesh
from speech_ssl_compression_tpu_torch.train import steps as tsteps
from speech_ssl_compression_tpu_torch.train.runner import Runner
from speech_ssl_compression_tpu_torch.train.wave_runner import WaveRunner
from speech_ssl_compression_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_10ms import _jax_span_mask, _paths
from tests.test_torch_hubert import make_wav_dataset
from tests.test_torch_wav2vec2 import make_w2v_dataset

REPO = pathlib.Path(__file__).resolve().parent.parent
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
GRAD_BAR = 1e-4  # rel. L2, each gradient (the f32 parity bar)

MODEL = dict(feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=64,
             encoder_ffn_embed_dim=128, encoder_attention_heads=4,
             head_dim=16, num_cluster=10, conv_pos=16, conv_pos_groups=4,
             mask_prob=0.65, mask_length=4, dropout=0.0,
             attention_dropout=0.0, activation_dropout=0.0)

# ---------------------------------------------------------------- helpers

WORKER = r'''
import json, os, sys
repo, rank, world, port, out, patch = sys.argv[1:7]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank,
                  WORLD_SIZE=world, LOCAL_RANK=rank, LOCAL_WORLD_SIZE=world)
sys.path.insert(0, repo)
import numpy as np
import torch
torch.set_num_threads(1)
from speech_ssl_compression_tpu_torch.data.bucket_dataset import MelFeatBuckets
from speech_ssl_compression_tpu_torch.data.hubert_dataset import (
    HubertWaveDataset)
from speech_ssl_compression_tpu_torch.train import steps
from speech_ssl_compression_tpu_torch.train.__main__ import main

loaded = []
for cls, meth, key in (
        (MelFeatBuckets, "_load_feat", lambda ds, a: os.path.basename(a)),
        (HubertWaveDataset, "_get_audio", lambda ds, a: ds.names[a])):
    def spy(ds, a, _orig=getattr(cls, meth), _key=key):
        loaded.append(_key(ds, a))
        return _orig(ds, a)
    setattr(cls, meth, spy)
if patch == "1":  # the span mask both packages draw (tests/test_torch_10ms)
    span = steps.span_mask
    steps.span_mask = lambda cfg, lens, t, rng: span(
        cfg, lens, t, np.random.default_rng([int(t)] + [int(n) for n in lens]))
runner = main(sys.argv[7:])
json.dump({"loaded": loaded, "pruned_heads": runner.pruned_heads,
           "log": runner.log_history,
           "heads": list(runner.cfg.encoder_attention_heads),
           "local_heads": list(runner.model.cfg.encoder_attention_heads)},
          open(out, "w"))
'''


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(tmp_path, tag: str, argv, world: int = 2, patch: bool = True,
            script: str = WORKER):
    """``world`` ranks of the port's CLI with ``argv`` (plus --multi_host),
    each in ``tmp_path/<tag>_rank<r>``; returns their stdout and the JSON
    each wrote outside its working directory."""
    port = _free_port()
    procs, cwds = [], []
    for r in range(world):
        cwd = tmp_path / f"{tag}_rank{r}"
        cwd.mkdir()
        cwds.append(cwd)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, str(REPO), str(r), str(world),
             port, str(tmp_path / f"{tag}_{r}.json"), "1" if patch else "0",
             *argv, "--multi_host"],
            cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=_env()))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{err[-4000:]}"
    runs = [json.load(open(tmp_path / f"{tag}_{r}.json"))
            for r in range(world)]
    return [o for o, _ in outs], runs, cwds


def _scalar(v) -> str:
    if isinstance(v, bool):
        return str(v).lower()
    text = repr(v) if isinstance(v, float) else str(v)
    if isinstance(v, float) and "e" in text and "." not in text:
        text = text.replace("e", ".0e")  # YAML 1.1 floats need the dot
    return text


def _yaml(tree: dict, indent: int = 0) -> str:
    """Block-style YAML of nested dicts, lists and scalars (the subset the
    port's reader takes)."""
    pad = " " * indent
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.append(f"{pad}{k}:\n" + _yaml(v, indent + 2))
        elif isinstance(v, (list, tuple)):
            out.append(f"{pad}{k}:\n"
                       + "".join(f"{pad}- {_scalar(x)}\n" for x in v))
        else:
            out.append(f"{pad}{k}: {_scalar(v)}\n")
    return "".join(out)


def _write_configs(tmp_path, model: dict, runner: dict):
    m, r = tmp_path / "model.yaml", tmp_path / "runner.yaml"
    m.write_text(_yaml(model))
    r.write_text(_yaml(runner))
    return str(m), str(r)


def _make_dataset(tmp_path, n_utts=8, seed=0):
    """tests/test_multiprocess_train.py's set: 40-d features of 30-60
    frames and labels < 10."""
    rng = np.random.default_rng(seed)
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    rows = ["file_path,label_path,length"]
    for i in range(n_utts):
        n = int(rng.integers(30, 60))
        np.save(data / f"feat_{i}.npy",
                rng.standard_normal((n, 40)).astype(np.float32))
        np.save(data / f"label_{i}.npy",
                rng.integers(0, 10, (n,)).astype(np.int64))
        rows.append(f"{data}/feat_{i}.npy,{data}/label_{i}.npy,{n}")
    csv = tmp_path / "train.csv"
    csv.write_text("\n".join(rows) + "\n")
    return str(csv)


def _runner_config(csv: str, steps: int = 4, **extra) -> dict:
    return dict({
        "runner": {"n_epochs": 0, "total_steps": steps,
                   "gradient_clipping": 10.0,
                   "gradient_accumulate_steps": 1, "log_step": 1,
                   "save_every_x_epochs": 100, "bf16": False},
        "optimizer": {"lr": 1.0e-4, "betas": [0.9, 0.999], "eps": 1.0e-8,
                      "weight_decay": 0},
        "datarc": {"num_workers": 0, "train_batch_size": 2,
                   "max_timestep": 0, "sets": [csv]},
    }, **extra)


def _start(tmp_path, model=MODEL) -> str:
    """A JAX-written checkpoint both packages start from."""
    cfg = jconfigs.MelHuBERTConfig.from_dict(model)
    params = jax.tree.map(np.asarray, init_melhubert_params(
        jax.random.PRNGKey(7), cfg))
    path = str(tmp_path / "start.npz")
    jax_save_checkpoint(path, params, meta={
        "Upstream_Config": {"melhubert": model,
                            "task": {"sequence_length": 0}}, "Step": 0})
    return path


def _args(expdir, mode="melhubert", start=None, upstream="melhubert",
          **kw):
    return types.SimpleNamespace(
        mode=mode, upstream=upstream, expdir=str(expdir),
        initial_weight=start, init_optimizer_from_initial_weight=False,
        frame_period=20, seed=0, device="cpu", **kw)


def _losses(runs) -> list:
    return [h["loss"] for h in runs]


def _assert_within_rel_l2(got: dict, ref: dict, bar: float = GRAD_BAR):
    """Each leaf of two JAX-layout trees within rel. L2 ``bar``; a leaf
    whose reference is ~0 by symmetry (the k_proj biases: softmax ignores a
    shift of a row's scores) or all zeros is taken against the norm of all
    leaves (tests/test_torch_10ms.py)."""
    got, ref = dict(_paths(got)), dict(_paths(ref))
    assert got.keys() == ref.keys()
    total = np.sqrt(sum(float(np.sum(np.square(r, dtype=np.float64)))
                        for r in ref.values()))
    for name, r in ref.items():
        assert got[name].shape == r.shape, name
        den = (total if name.endswith("k_proj/bias") or not r.any()
               else np.linalg.norm(r))
        err = np.linalg.norm(np.float64(got[name]) - r) / den
        assert err < bar, (name, err)


def _assert_close_params(got: dict, ref: dict):
    """Every leaf within rtol PARAM_RTOL, atol PARAM_ATOL."""
    got, ref = dict(_paths(got)), dict(_paths(ref))
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], r, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)


def _patched_port_span(monkeypatch):
    span = tsteps.span_mask
    monkeypatch.setattr(tsteps, "span_mask", lambda cfg, lens, t, rng: span(
        cfg, lens, t, np.random.default_rng([int(t)] + [int(n)
                                                         for n in lens])))


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("tp", [0, 2, 3])
def test_make_mesh_refuses_what_jax_refuses(tp):
    """One rank: JAX's message's first sentence, word for word."""
    with pytest.raises(ValueError) as got:
        tmesh.make_mesh(tp)
    with pytest.raises(ValueError) as want:
        jax_make_mesh(n_devices=1, model_parallel=tp)
    first = str(want.value).split(". ")[0]
    assert first.startswith("make_mesh: 1 device(s) available")
    assert str(got.value).split(". ")[0] == first


def test_explicit_launch_over_hosts_takes_nccl_and_a_card_a_rank(
        monkeypatch, capsys):
    """JAX's explicit entry (coordinator, process count, index) for 16
    processes over two hosts of 8 cards: NCCL, no host layout set for
    the process, rank 9 on cuda:1, nothing said of shared cards."""
    from speech_ssl_compression_tpu_torch.parallel import multihost

    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    joined = {}

    def init_process_group(**kwargs):
        joined.update(kwargs)

    fake = types.SimpleNamespace(
        is_initialized=lambda: bool(joined),
        init_process_group=init_process_group,
        new_group=lambda backend: f"{backend} group",
        get_rank=lambda: joined["rank"],
        get_world_size=lambda: joined["world_size"],
        group=types.SimpleNamespace(WORLD="world"))
    monkeypatch.setattr(multihost, "dist", fake)
    monkeypatch.setattr(multihost, "_STATE", dict(multihost._STATE))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cards = []
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    multihost.initialize("10.0.0.1:1234", 16, 9)
    assert joined == dict(backend="nccl", init_method="tcp://10.0.0.1:1234",
                          world_size=16, rank=9)
    assert "LOCAL_RANK" not in os.environ
    assert "LOCAL_WORLD_SIZE" not in os.environ
    assert multihost.cpu_group() == "gloo group"
    assert multihost.rank_device(torch.device("cuda")) == torch.device(
        "cuda", 1)
    assert cards == [1]
    out = capsys.readouterr().out
    assert "backend nccl" in out and "share" not in out


@pytest.mark.parametrize("heads,tp", [(12, 2), (11, 2), (1, 2), (7, 3)])
def test_split_and_shard_round_trip(heads, tp):
    """Uneven splits (the first n % tp ranks take one more) tile each
    leaf, and the slices put back in rank order are the whole tensor."""
    cfg = MelHuBERTConfig.from_dict(dict(MODEL, encoder_attention_heads=heads,
                                         encoder_ffn_embed_dim=130))
    parts = tmesh.split(heads, tp)
    assert sum(n for _, n in parts) == heads
    assert [n for _, n in parts] == sorted((n for _, n in parts),
                                           reverse=True)
    rng = np.random.default_rng(0)
    d, h = cfg.encoder_embed_dim, cfg.head_dim
    named = {
        "encoder.layers.0.self_attn.q_proj.weight": torch.tensor(
            rng.standard_normal((heads * h, d))),
        "encoder.layers.0.self_attn.out_proj.weight": torch.tensor(
            rng.standard_normal((d, heads * h))),
        "encoder.layers.0.self_attn.out_proj.bias": torch.zeros(d),
        "encoder.layers.0.fc1.bias": torch.tensor(rng.standard_normal(130)),
        "encoder.layers.0.fc2.weight": torch.tensor(
            rng.standard_normal((d, 130))),
        "final_proj.weight": torch.ones(3, d),
    }
    shards = [tmesh.shard_named(named, cfg, tmesh.Mesh(world=tp, tp=tp,
                                                        rank=r))
              for r in range(tp)]
    for name, whole in named.items():
        spec = tmesh.shard_spec(name, cfg, tp)
        if spec is None:
            assert all(s[name] is whole for s in shards), name
            continue
        back = torch.cat([s[name] for s in shards], dim=spec[0])
        assert torch.equal(back, whole), name


# -------------------------------------------------------------- datasets

def _same_batches(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "target_lists":
            for a, b in zip(got[k], want[k]):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def _datasets(kind, tmp_path):
    """(JAX class, port class, constructor keywords) of one dataset on a
    fresh set, crops on."""
    if kind == "melhubert":
        csv = _make_dataset(tmp_path, n_utts=13)
        kw = dict(frame_period=20, sequence_length=20, bucket_size=2,
                  sets=[csv], seed=3)
        return jbucket.MelFeatBuckets, tbucket.MelFeatBuckets, kw
    if kind == "hubert":
        data = make_wav_dataset(tmp_path, n_utts=13)
        kw = dict(manifest_path=f"{data}/train.tsv", sample_rate=16000,
                  label_paths=[f"{data}/train.km"], label_rates=100,
                  batch_size=2, min_keep_sample_size=1000,
                  max_sample_size=4000, seed=3)
        return jhubert_data.HubertWaveDataset, thubert_data.HubertWaveDataset, kw
    data = make_w2v_dataset(tmp_path, n_utts=13)
    conv = [(32, 10, 5), (32, 3, 2), (32, 2, 2)]
    kw = dict(manifest_path=f"{data}/train.tsv", batch_size=2,
              max_sample_size=4000, min_sample_size=0, num_buckets=3,
              seed=3, precompute_mask_config={"mask_prob": 0.5,
                                              "mask_length": 3},
              frames_fn=lambda n: conv_output_length(n, conv))
    return jw2v_data.Wav2Vec2AudioDataset, tw2v_data.Wav2Vec2AudioDataset, kw


@pytest.mark.parametrize("process_count", [2, 3])
@pytest.mark.parametrize("kind", ["melhubert", "hubert", "wav2vec2"])
def test_per_process_streams_match_jax_bitwise(tmp_path, kind,
                                               process_count):
    """Each rank's lockstep stream and the replay (process_index None),
    two epochs each, bitwise JAX's; the ranks' members of a group are
    disjoint and the replay concatenates them."""
    jcls, tcls, kw = _datasets(kind, tmp_path)
    members = {}
    for index in list(range(process_count)) + [None]:
        shard = dict(kw, process_index=index, process_count=process_count)
        want, got = jcls(**shard), tcls(**shard)
        assert len(got) == len(want) > 0
        batches = []
        for _ in range(2):
            for g, w in zip(got.epoch(shuffle=True), want.epoch(shuffle=True)):
                _same_batches(g, w)
                batches.append(g)
        assert len(batches) == 2 * len(want)
        members[index] = batches
    for step, whole in enumerate(members[None]):
        parts = [members[i][step] for i in range(process_count)]
        np.testing.assert_array_equal(
            whole["length"], np.concatenate([p["length"] for p in parts]))


# ---------------------------------------------------------------- dropout

def test_dropout_draws_across_ranks():
    """On a 2 x 2 grid, one seed drawn on every rank: the attention keep
    bits of a split layer differ between the model ranks (each holds
    other heads) and between the data ranks (other rows); the dropout of
    the replicated activations is the same on both model ranks of a data
    rank and differs across data ranks; rank 0 draws what one process
    draws."""
    seed = 12345
    encs = []
    for rank in range(4):
        enc = types.SimpleNamespace(
            mesh=tmesh.Mesh(world=4, tp=2, rank=rank), tp=object())
        encs.append(enc)
    coords = [rank_coords(e) for e in encs]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert rank_coords(types.SimpleNamespace()) == (0, 0)
    bits = [attention_keep_mask(fold_seed(seed, *c), 1, 2, 16, 16, 0.5)
            for c in coords]
    assert torch.equal(bits[0], attention_keep_mask(seed, 1, 2, 16, 16, 0.5))
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(bits[i], bits[j]), (i, j)
    x = torch.ones(64, 32)
    drops = [dropout(x, 0.3, seeded_generator(fold_seed(seed, c[0]),
                                              x.device)) for c in coords]
    assert torch.equal(drops[0], drops[1]) and torch.equal(drops[2], drops[3])
    assert not torch.equal(drops[0], drops[2])
    assert torch.equal(drops[0], dropout(x, 0.3, seeded_generator(
        seed, x.device)))
    # the activation dropout of a split layer: the model index and a tag
    act = [dropout(x, 0.3, seeded_generator(fold_seed(seed, *c, 1),
                                            x.device)) for c in coords]
    assert not torch.equal(act[0], act[1])
    assert not torch.equal(act[0], drops[0])


# ----------------------------------------------------- the trainer, 2 ranks

def test_two_rank_trainer_matches_the_replays(tmp_path, monkeypatch):
    """4 f32 updates of MelHuBERT on 2 data ranks through the CLI against
    the port's and JAX's 1-process replay of the same global batches:
    each step's ranks read disjoint files, rank 0 alone writes, and the
    losses and parameters agree."""
    csv = _make_dataset(tmp_path)
    start = _start(tmp_path)
    model = {"melhubert": MODEL, "task": {"sequence_length": 0}}
    rc = _runner_config(csv)
    m, r = _write_configs(tmp_path, model, rc)
    outs, runs, cwds = _launch(tmp_path, "dp", [
        "-m", "melhubert", "-g", m, "-c", r, "-n", "exp", "-i", start,
        "--device", "cpu", "--seed", "0"])

    for s in range(4):
        a = set(runs[0]["loaded"][2 * s:2 * s + 2])
        b = set(runs[1]["loaded"][2 * s:2 * s + 2])
        assert len(a) == len(b) == 2 and not (a & b), s
    assert "Saved checkpoint" in outs[0] and "Saved checkpoint" not in outs[1]
    assert sorted(os.listdir(cwds[1])) == []
    exp = cwds[0] / "exp"
    assert {"config_model.yaml", "config_runner.yaml",
            "last-step.npz"} <= set(os.listdir(exp))
    assert _losses(runs[0]["log"]) == _losses(runs[1]["log"])

    _patched_port_span(monkeypatch)

    class PortReplay(Runner):
        def _data_shard(self):
            return dict(process_index=None, process_count=2)

    replay = PortReplay(_args(tmp_path / "port_replay", start=start), rc,
                        model)
    replay.train()
    np.testing.assert_allclose(_losses(runs[0]["log"]),
                               _losses(replay.log_history), rtol=LOSS_RTOL)
    got = load_checkpoint(str(exp / "last-step.npz"))["params"]
    _assert_close_params(got, load_checkpoint(str(
        tmp_path / "port_replay" / "last-step.npz"))["params"])

    monkeypatch.setattr(jmelhubert, "compute_span_mask", _jax_span_mask)

    class JaxReplay(JaxRunner):
        def _get_dataloader(self):
            return jbucket.MelFeatBuckets(
                frame_period=20, sequence_length=0, bucket_size=2,
                sets=[csv], seed=0, process_index=None, process_count=2)

    jr = JaxReplay(_args(tmp_path / "jax_replay", start=start), rc, model)
    jlosses = []
    jr._log_scalar = (lambda tag, v, step: jlosses.append((step, float(v)))
                      if tag.endswith("-loss") else None)
    jr.train()
    np.testing.assert_allclose(_losses(runs[0]["log"]),
                               [v for _, v in jlosses], rtol=LOSS_RTOL)
    _assert_within_rel_l2(got, jax.tree.map(np.asarray, jr.params))


def test_data_driven_head_prune_is_one_choice_on_both_ranks(tmp_path):
    """Data-driven head pruning on 2 data ranks: the scoring batches stack
    buckets in lockstep and the scores are summed over the ranks before
    ranking, so both prune the same 2 heads."""
    csv = _make_dataset(tmp_path)
    model = {"melhubert": MODEL, "task": {"sequence_length": 0}}
    rc = _runner_config(csv, prune={
        "metric": "data-driven", "target": "by_whole", "total_steps": 1,
        "interval": 2, "warm_up": 1, "num_heads_each_step": 2,
        "data_ratio": 1.0, "normalize_by_layer": 2,
        "scoring_batch_buckets": 0})
    m, r = _write_configs(tmp_path, model, rc)
    outs, runs, _ = _launch(tmp_path, "hp", [
        "-m", "head-pruning", "-g", m, "-c", r, "-n", "exp", "--device",
        "cpu", "--seed", "0"], patch=False)
    assert runs[0]["pruned_heads"] == runs[1]["pruned_heads"]
    assert sum(len(v) for v in runs[0]["pruned_heads"][0].values()) == 2
    assert runs[0]["heads"] == runs[1]["heads"] and sum(runs[0]["heads"]) == 6
    for out in outs[:1]:
        assert "stacked" in out


def test_tensor_parallel_head_prune_to_ragged_heads(tmp_path):
    """l1 head pruning on a tp = 2 grid from 4 heads a layer to 3 (split
    2 + 1), then training on: the same choice, losses and parameters as
    the 1-process run, and the checkpoint serves in a 1-process
    extractor."""
    csv = _make_dataset(tmp_path)
    start = _start(tmp_path)
    model = {"melhubert": MODEL, "task": {"sequence_length": 0}}
    rc = _runner_config(csv, steps=3, prune={
        "metric": "l1", "target": "by_layer", "total_steps": 1,
        "interval": 1, "warm_up": 1})
    m, r = _write_configs(tmp_path, model, rc)
    _, runs, cwds = _launch(tmp_path, "tp", [
        "-m", "head-pruning", "-g", m, "-c", r, "-n", "exp", "-i", start,
        "--device", "cpu", "--seed", "0", "--model_parallel", "2"],
        patch=False)
    assert runs[0]["heads"] == runs[1]["heads"] == [3, 3]
    assert runs[0]["local_heads"] == [2, 2] and runs[1]["local_heads"] == [1, 1]

    one = Runner(_args(tmp_path / "one", "head-pruning", start), rc, model)
    one.train()
    assert runs[0]["pruned_heads"] == json.loads(json.dumps(one.pruned_heads))
    np.testing.assert_allclose(_losses(runs[0]["log"]),
                               _losses(one.log_history), rtol=LOSS_RTOL)
    ckpt = cwds[0] / "exp" / "states_prune_6.npz"
    _assert_close_params(load_checkpoint(str(ckpt))["params"],
                         load_checkpoint(str(tmp_path / "one" /
                                             "states_prune_6.npz"))["params"])
    ext = MelHuBERTExtractor(str(ckpt), device="cpu")
    out = ext.forward_packed([np.random.default_rng(0).standard_normal(
        8000).astype(np.float32) * 0.1])
    assert bool(out["last_hidden_state"].isfinite().all())


HUBERT = dict(label_rate=100, encoder_layers=1, encoder_embed_dim=32,
              encoder_ffn_embed_dim=64, encoder_attention_heads=2,
              head_dim=16, conv_feature_layers="'[(32,10,5),(32,3,2),(32,2,2)]'",
              final_dim=16, conv_pos=16, conv_pos_groups=4, mask_prob=0.65,
              mask_length=4, dropout=0.0, attention_dropout=0.0,
              activation_dropout=0.0, dropout_input=0.0,
              encoder_layerdrop=0.0, feature_grad_mult=0.1)


def test_hubert_two_rank_steps_match_the_replay(tmp_path):
    """2 f32 updates of HuBERT on 2 data ranks (the loss summed over the
    masked frames, the window's count summed over the ranks) against the
    port's 1-process replay."""
    data = make_wav_dataset(tmp_path / "wav", n_utts=8)
    task = {"data": data, "labels": ["km"], "label_rate": 100,
            "sample_rate": 16000, "max_sample_size": 4000,
            "min_sample_size": 1000}
    rc = {"runner": {"total_steps": 2, "gradient_clipping": 10.0,
                     "gradient_accumulate_steps": 1, "log_step": 1,
                     "bf16": False},
          "optimizer": {"lr": 0.0005}, "datarc": {"train_batch_size": 2},
          "task": task}
    m, r = _write_configs(tmp_path, {"hubert": HUBERT}, rc)
    outs, runs, cwds = _launch(tmp_path, "hubert", [
        "-m", "melhubert", "-u", "hubert", "-g", m, "-c", r, "-n", "exp",
        "--device", "cpu", "--seed", "0"], patch=False)
    for s in range(2):
        a = set(runs[0]["loaded"][2 * s:2 * s + 2])
        b = set(runs[1]["loaded"][2 * s:2 * s + 2])
        assert len(a) == 2 and not (a & b), s
    assert sorted(os.listdir(cwds[1])) == []

    class Replay(WaveRunner):
        def _data_shard(self):
            return dict(process_index=None, process_count=2)

    replay = Replay(_args(tmp_path / "replay", upstream="hubert"),
                    rc, read_yaml(m))
    replay.train()
    np.testing.assert_allclose(_losses(runs[0]["log"]),
                               _losses(replay.log_history), rtol=LOSS_RTOL)
    _assert_close_params(
        load_checkpoint(str(cwds[0] / "exp" / "last-step.npz"))["params"],
        load_checkpoint(str(tmp_path / "replay" / "last-step.npz"))["params"])


# ---------------------------------------- the tensor-parallel grad step

TP_WORKER = r'''
import os, sys, types
repo, rank, world, port, out, start, batch, model_yaml, runner_yaml = sys.argv[1:10]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank,
                  WORLD_SIZE=world, LOCAL_RANK=rank, LOCAL_WORLD_SIZE=world)
sys.path.insert(0, repo)
import numpy as np
import torch
torch.set_num_threads(1)
from speech_ssl_compression_tpu_torch.configs import read_yaml
from speech_ssl_compression_tpu_torch.parallel.mesh import gather_named
from speech_ssl_compression_tpu_torch.parallel.multihost import initialize
from speech_ssl_compression_tpu_torch.train.runner import Runner
from speech_ssl_compression_tpu_torch.utils.checkpoint import save_checkpoint
from speech_ssl_compression_tpu_torch.utils.weights import jax_tree_from_named

initialize(backend="gloo", device_type="cpu")
args = types.SimpleNamespace(
    mode="melhubert", upstream="melhubert", expdir=os.getcwd() + "/exp",
    initial_weight=start, init_optimizer_from_initial_weight=False,
    frame_period=20, seed=0, device="cpu", model_parallel=2)
runner = Runner(args, read_yaml(runner_yaml), read_yaml(model_yaml))
b = dict(np.load(batch))
mask = torch.from_numpy(b.pop("mask"))
loss, grads, _ = runner.grad_step(runner.params, runner._device_batch(b),
                                  runner.rng, mask_indices=mask)
whole = gather_named([dict(zip(runner.params, grads))], runner.cfg,
                     runner.mesh)[0]
if rank == "0":
    save_checkpoint(out, jax_tree_from_named(whole),
                    meta={"loss": float(loss)})
'''


def test_tensor_parallel_grad_step_matches_jax_mesh(tmp_path, monkeypatch):
    """The grad step on a tp = 2 grid of two gloo ranks (the heads and FFN
    units split, all-reduced after out_proj and fc2) against JAX's on
    ``make_mesh(8, model_parallel=2)``: one weights file, one batch, one
    injected span mask, dropout off; the loss and every gradient within
    the f32 parity bar."""
    csv = _make_dataset(tmp_path)
    start = _start(tmp_path)
    model = {"melhubert": MODEL, "task": {"sequence_length": 0}}
    rc = _runner_config(csv, steps=1)
    rc["datarc"]["train_batch_size"] = 4
    m, r = _write_configs(tmp_path, model, rc)
    ds = tbucket.MelFeatBuckets(frame_period=20, sequence_length=0,
                                bucket_size=4, sets=[csv], seed=0)
    batch = ds.get_batch(0)
    rng = np.random.default_rng(5)
    t = batch["feat"].shape[1]
    mask = np.zeros((4, t), bool)
    for i, n in enumerate(batch["length"]):
        mask[i, rng.choice(int(n), size=int(n) // 3, replace=False)] = True
    np.savez(tmp_path / "batch.npz", mask=mask, **batch)

    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", TP_WORKER, str(REPO), str(k), "2", port,
         str(tmp_path / "tp_grads.npz"), start, str(tmp_path / "batch.npz"),
         m, r], cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env()) for k in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    got = jax_load_checkpoint(str(tmp_path / "tp_grads.npz"))

    monkeypatch.setattr(
        jmelhubert, "compute_span_mask",
        lambda rng, lengths, max_len=None, **kw: jnp.asarray(mask))
    jr = JaxRunner(_args(tmp_path / "jax", start=start, model_parallel=2),
                   rc, model)
    assert dict(jr.mesh.shape) == {"data": 4, "model": 2}
    loss, grads, _ = jr.grad_step(jr.params, None, jr._device_batch(batch),
                                  jax.random.PRNGKey(0))
    assert abs(got["meta"]["loss"] - float(loss)) / float(loss) < GRAD_BAR
    _assert_within_rel_l2(got["params"], jax.tree.map(np.asarray, grads))


W2V_WORKER = r'''
import os, sys
repo, rank, world, port, spec, out = sys.argv[1:7]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank,
                  WORLD_SIZE=world, LOCAL_RANK=rank, LOCAL_WORLD_SIZE=world)
sys.path.insert(0, repo)
import numpy as np
import torch
torch.set_num_threads(1)
from speech_ssl_compression_tpu_torch.configs import Wav2Vec2Config
from speech_ssl_compression_tpu_torch.parallel.mesh import (
    all_reduce_tensors, attach, make_mesh)
from speech_ssl_compression_tpu_torch.parallel.multihost import initialize
from speech_ssl_compression_tpu_torch.train.steps import (
    make_wav2vec2_grad_step)
from speech_ssl_compression_tpu_torch.utils.checkpoint import load_checkpoint
from speech_ssl_compression_tpu_torch.utils.weights import load_wave_model

initialize(backend="gloo", device_type="cpu")
mesh = make_mesh()
state = load_checkpoint(spec, load_opt=False)
cfg = Wav2Vec2Config.from_dict(state["meta"]["cfg"])
model = attach(load_wave_model(state["params"], cfg, "wav2vec2"), mesh)
data = dict(np.load(spec.replace(".npz", "_data.npz")))
b = len(data["length"]) // mesh.dp
rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
per_row = len(data["uniform"]) // len(data["length"])
params = dict(model.named_parameters())
loss, n, grads, _ = make_wav2vec2_grad_step(model)(
    params, {"source": torch.from_numpy(data["source"][rows]),
             "length": data["length"][rows]},
    torch.Generator().manual_seed(5), 2.0,
    mask_indices=torch.from_numpy(data["mask"][rows]),
    gumbel_uniform=torch.from_numpy(data["uniform"][
        rows.start * per_row:rows.stop * per_row]))
summed = all_reduce_tensors(grads + [torch.stack([loss, n.float()])],
                            mesh.data_group)
if rank == "0":
    np.savez(out, loss=summed[-1][0].numpy(), n=summed[-1][1].numpy(),
             **{k: g.numpy() for k, g in zip(params, summed[:-1])})
'''


def test_wav2vec2_cross_sample_negatives_on_data_ranks(tmp_path):
    """wav2vec 2.0 with cross_sample_negatives = 3 on 2 data ranks: each
    rank draws the global batch's negatives and gathers the targets over
    the data group, so the ranks' summed loss and gradients equal the
    1-process grad step on the global batch (the span mask and the Gumbel
    uniforms injected, dropout off; JAX gets the same from GSPMD,
    tests/test_runner_mesh.py:116-165), the perplexity and feature
    penalty taken over the global batch: loss rel 1e-5, every gradient
    rel. L2 1e-4."""
    from speech_ssl_compression_tpu_torch.configs import Wav2Vec2Config
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import (
        init_wav2vec2_params_np,
        load_wave_model,
    )
    from tests.test_torch_wav2vec2 import TINY

    # the shipped 320 codewords a group: with TINY's 8 many frames share
    # their codes, and the exact-equality exclusion of a negative equal to
    # the positive then follows each batch size's matmul rounding
    up = dict(TINY, cross_sample_negatives=3, latent_vars=320,
              dropout_input=0.0, dropout_features=0.0, encoder_layerdrop=0.0)
    cfg = Wav2Vec2Config.from_dict(up)
    params = init_wav2vec2_params_np(cfg, 0)
    spec = str(tmp_path / "w2v.npz")
    save_checkpoint(spec, params, meta={"cfg": up})
    rng = np.random.default_rng(0)
    lengths = np.array([2400, 1930, 2400, 2100])
    source = rng.uniform(-0.3, 0.3, (4, 2400)).astype(np.float32)
    for i, n in enumerate(lengths):
        source[i, n:] = 0.0
    model = load_wave_model(params, cfg, "wav2vec2")
    t = 119  # frames of 2400 samples through the frontend
    mask = rng.random((4, t)) < 0.5
    uniform = rng.random((4 * t * cfg.latent_groups,
                          cfg.latent_vars)).astype(np.float32)
    np.savez(spec.replace(".npz", "_data.npz"), source=source,
             length=lengths, mask=mask, uniform=uniform)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", W2V_WORKER, str(REPO), str(r), "2", port,
         spec, str(tmp_path / "ranks.npz")], cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    got = dict(np.load(tmp_path / "ranks.npz"))

    tparams = dict(model.named_parameters())
    loss, n, grads, _ = tsteps.make_wav2vec2_grad_step(model)(
        tparams, {"source": torch.from_numpy(source), "length": lengths},
        torch.Generator().manual_seed(5), 2.0,
        mask_indices=torch.from_numpy(mask),
        gumbel_uniform=torch.from_numpy(uniform))
    assert int(got["n"]) == int(n) > 0
    assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    total = np.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads))
    for name, g in zip(tparams, grads):
        ref = g.double().numpy()
        den = (total if name.endswith("k_proj.bias") or not ref.any()
               else np.linalg.norm(ref))
        err = np.linalg.norm(got[name] - ref) / den
        assert err < GRAD_BAR, (name, err)


def test_tensor_parallel_resumes_a_one_process_checkpoint(tmp_path):
    """A 1-process run's checkpoint (its Adam state included) resumed on a
    tp = 2 grid and in one process: the whole state sharded after the
    restore, one more update each, the same loss, parameters and Adam
    state, gathered into the checkpoint a 1-process trainer reads."""
    csv = _make_dataset(tmp_path)
    model = {"melhubert": MODEL, "task": {"sequence_length": 0}}
    m, r = _write_configs(tmp_path, model, _runner_config(csv, steps=2))
    first = Runner(_args(tmp_path / "first"), read_yaml(r), read_yaml(m))
    first.train()
    ckpt = str(tmp_path / "first" / "last-step.npz")
    (tmp_path / "again").mkdir()
    m1, r1 = _write_configs(tmp_path / "again", model,
                            _runner_config(csv, steps=1))
    _, runs, cwds = _launch(tmp_path, "resume", [
        "-m", "melhubert", "-g", m1, "-c", r1, "-n", "exp", "-i", ckpt,
        "--init_optimizer_from_initial_weight", "--device", "cpu", "--seed",
        "0", "--model_parallel", "2"], patch=False)
    args = _args(tmp_path / "one", start=ckpt)
    args.init_optimizer_from_initial_weight = True
    one = Runner(args, read_yaml(r1), read_yaml(m1))
    one.train()
    np.testing.assert_allclose(_losses(runs[0]["log"]),
                               _losses(one.log_history), rtol=LOSS_RTOL)
    got = load_checkpoint(str(cwds[0] / "exp" / "last-step.npz"))
    want = load_checkpoint(str(tmp_path / "one" / "last-step.npz"))
    _assert_close_params(got["params"], want["params"])
    assert len(got["opt_leaves"]) == len(want["opt_leaves"])
    assert int(got["opt_leaves"][0]) == int(want["opt_leaves"][0]) == 3
    for a, b in zip(got["opt_leaves"][1:], want["opt_leaves"][1:]):
        np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL)
