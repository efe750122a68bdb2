"""The port's staged compression journey (``journey.py``,
``journey_curve.py``) against the JAX package on the CPU, at the TINY
settings (2 layers of 64, 4 heads, FFN 128, K = 16, 12 crops of T = 96):
the whole journey through the CLI with JAX's smoke assertions, each
stage's checkpoint read by JAX's loader and its held-out CE recomputed by
JAX's forward on the saved span mask; the three chained transitions no
other test crosses (head pruning from a weight-pruned checkpoint, row
pruning from ragged heads, distillation from the pre-trained teacher)
through both packages' trainers from the port's own stage checkpoints;
and stage 0's crops, CSV and held-out batch bitwise what JAX's
``tools/run_journey_tpu.py::build_dataset`` writes from the same features
and labels."""

import contextlib
import json
import pathlib
import shutil
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_ssl_compression_tpu import extract as jextract
from speech_ssl_compression_tpu.data import audio as jaudio
from speech_ssl_compression_tpu.models import init_melhubert_params
from speech_ssl_compression_tpu.models import melhubert as jmelhubert
from speech_ssl_compression_tpu.configs import MelHuBERTConfig
from speech_ssl_compression_tpu.ops import kmeans as jkmeans
from speech_ssl_compression_tpu.train.runner import Runner as JaxRunner
from speech_ssl_compression_tpu_torch import journey, journey_curve
from speech_ssl_compression_tpu_torch.compress import row_pruning as rp
from speech_ssl_compression_tpu_torch.train import runner as trunner
from speech_ssl_compression_tpu_torch.train import steps as tsteps
from speech_ssl_compression_tpu_torch.train.runner import Runner
from speech_ssl_compression_tpu_torch.utils.checkpoint import load_checkpoint
from speech_ssl_compression_tpu_torch.utils.weights import jax_tree_from_named
from test_torch_10ms import _jax_span_mask, _paths, _port_span_mask

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import run_journey_tpu as jjourney  # noqa: E402

CE_BAR = 1e-4     # held-out CE, port vs JAX, relative
PARAM_BAR = 1e-4  # each parameter after a chained stage, rel. L2
FBANK_ATOL = 1e-6  # the port's float32 fbank against JAX's (test_torch_extract)
STAGES = {"pretrain", "weight-prune", "head-prune", "row-prune",
          "distill-6L"}
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the tiny model's ops are small, and the suite's
    workers share the machine's cores (oversubscribed, torch's threads
    wait on each other far longer than they compute)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_ce(ckpt: str, batch: dict):
    """JAX's loader and forward (the dense attention) on a port checkpoint:
    (held-out CE on the saved span mask, config)."""
    params, cfg, _ = jextract.load_any_checkpoint(ckpt)
    out = jmelhubert.melhubert_forward(
        params, cfg, jnp.asarray(batch["feat"]), jnp.asarray(batch["pad_mask"]),
        mask=True, teacher_mask_indices=jnp.asarray(batch["mask"]),
        attn_impl="dense", deterministic=True)
    loss, _ = jmelhubert.melhubert_pretrain_loss(
        out, jnp.asarray(batch["label"]), jnp.asarray(batch["pad_mask"]), cfg)
    return float(loss), cfg


@pytest.mark.parametrize("fp", [20, 10])
def test_tiny_journey_chains_every_stage(tmp_path, fp):
    summary = journey.main(["--tiny", "--fp", str(fp), "--device", "cpu",
                            "--workdir", str(tmp_path)])
    assert summary == json.loads((tmp_path / "summary.json").read_text())
    # JAX's tests/test_journey_smoke.py assertions
    assert summary["frame_period_ms"] == fp and summary["t_crop"] == 96
    stages = {row["stage"]: row for row in summary["stages"]}
    assert set(stages) == STAGES
    for row in stages.values():
        assert 0.0 < row["heldout_masked_ce"] < 20.0, row
    assert (stages["weight-prune"]["params_m"]
            <= stages["pretrain"]["params_m"])
    assert stages["head-prune"]["params_m"] < stages["pretrain"]["params_m"]
    assert stages["row-prune"]["params_m"] < stages["head-prune"]["params_m"]
    assert stages["distill-6L"]["layers"] < stages["pretrain"]["layers"]
    assert abs(stages["weight-prune"]["sparsity"] - 0.4) < 0.01
    assert set(summary["serving_frames_per_sec"]) == set(journey.SERVED)
    assert all(v > 0 for v in summary["serving_frames_per_sec"].values())

    points = journey_curve.main(["--workdir", str(tmp_path), "--device",
                                 "cpu"])
    assert points == json.loads((tmp_path / "quality_curve.json")
                                .read_text())
    assert {p["stage"] for p in points} == {s for s, _ in journey.STAGE_DIRS}
    assert len(points) > len(stages)
    for p in points:
        assert 0.0 < p["heldout_masked_ce"] < 20.0, p
    # each stage's checkpoint read by JAX's loader: the same widths, and
    # the same held-out CE from JAX's forward on the saved mask
    batch = journey.load_eval_batch(tmp_path)
    assert batch["mask"].shape == (4, 96) and batch["mask"].any()
    for row in stages.values():
        ce, cfg = _jax_ce(row["ckpt"], batch)
        assert list(cfg.encoder_attention_heads) == row["heads"], row
        assert list(cfg.encoder_ffn_embed_dim) == row["ffn"], row
        assert cfg.encoder_layers == row["layers"], row
        got = row["heldout_masked_ce_unrounded"]
        assert abs(got - ce) / ce < CE_BAR, (row["stage"], got, ce)
    # the chained widths: ragged heads into row pruning, a halved student
    assert stages["row-prune"]["heads"] == stages["head-prune"]["heads"]
    assert sum(stages["head-prune"]["heads"]) == 6
    assert stages["row-prune"]["ffn"] == [96, 96]


# ------------------------------------------------ the chained transitions

@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The port's tiny journey at 20 ms with every dropout 0: the stage
    checkpoints the chained transitions start from."""
    workdir = tmp_path_factory.mktemp("chain")
    base = journey.model_cfg

    def no_dropout(settings):
        cfg = base(settings)
        cfg["melhubert"].update(NO_DROPOUT)
        return cfg

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(journey, "model_cfg", no_dropout)
        summary = journey.run_journey(workdir, journey.settings_for(tiny=True),
                                      journey.TINY, device="cpu")
    return workdir, {r["stage"]: r for r in summary["stages"]}, no_dropout


def _artifacts(expdir: pathlib.Path) -> dict:
    """Each npz artifact's meta entries both trainers write alike, and
    whether it holds masks; each npy artifact (head scores)."""
    out = {}
    for f in sorted(expdir.iterdir()):
        if f.suffix == ".npz":
            meta = json.loads(pathlib.Path(str(f) + ".json").read_text())
            state = load_checkpoint(str(f), load_opt=False)
            out[f.name] = dict(
                {k: v for k, v in meta.items() if k in (
                    "Step", "TotalStep", "Pruned_heads", "Pruning")},
                masks=state["masks"] is not None)
        elif f.suffix == ".npy":
            out[f.name] = np.load(f)
    return out


def _student_init_as_jax(cfg, seed):
    """The student JAX's Runner seeds (split(PRNGKey(seed))[1])."""
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    return jax.tree.map(np.asarray, init_melhubert_params(
        key, MelHuBERTConfig.from_dict(cfg.to_dict())))


@pytest.mark.parametrize("case", ["head-from-weight-pruned",
                                  "row-from-ragged-heads",
                                  "distill-from-pretrain"])
def test_chained_stage_matches_jax_runner(chain, tmp_path, monkeypatch, case):
    workdir, rows, model_cfg = chain
    settings, tiny = journey.settings_for(tiny=True), journey.TINY
    csv = str(workdir / "train.csv")
    mc = model_cfg(settings)
    if case == "head-from-weight-pruned":
        mode, start = "head-pruning", rows["weight-prune"]["ckpt"]
        rc = journey.runner_cfg(csv, tiny.hp_total, settings.batch)
        rc["prune"] = dict(tiny.hp_prune)
        up = mc
        assert load_checkpoint(start, load_opt=False)["masks"] is not None
    elif case == "row-from-ragged-heads":
        mode, start = "row-pruning", rows["head-prune"]["ckpt"]
        rc = journey.runner_cfg(csv, tiny.rp_total, settings.batch)
        rc["prune"] = dict(tiny.rp_prune)
        up = mc
        assert len(set(rows["head-prune"]["heads"])) > 1  # ragged
    else:
        mode, start = "distillation", rows["pretrain"]["ckpt"]
        rc = journey.runner_cfg(csv, tiny.distill_steps, settings.batch)
        up = {"teacher": dict(mc["melhubert"]),
              "student": dict(mc["melhubert"], encoder_layers=1,
                              initial_from_teacher=True),
              "task": {"sequence_length": 0},
              "loss_param": {"T": 4.0, "alpha": 0.5, "type": "masked"}}
        monkeypatch.setattr(trunner, "init_params_np", _student_init_as_jax)
    # both trainers' span masks from one host function of the batch
    monkeypatch.setattr(jmelhubert, "compute_span_mask", _jax_span_mask)
    monkeypatch.setattr(tsteps, "host_span_mask", _port_span_mask)
    monkeypatch.setattr(trunner, "host_span_mask", _port_span_mask)
    runs = {}
    for name, cls in (("jax", JaxRunner), ("port", Runner)):
        args = journey.make_args(tmp_path / name, mode, 20, "cpu",
                                 initial_weight=start)
        runner = cls(args, rc, up)
        runner.train()
        runs[name] = runner, _artifacts(pathlib.Path(args.expdir))
    (jr, jart), (tr, tart) = runs["jax"], runs["port"]
    # the same artifacts, meta and prune choices
    assert jart.keys() == tart.keys()
    for name, ref in jart.items():
        got = tart[name]
        if isinstance(ref, dict):
            assert got == ref, name
            assert not got["masks"] or mode == "distillation", name
        else:  # heads_and_score_*.npy: (layer, head) exact, scores close
            np.testing.assert_array_equal(got[:, :2], ref[:, :2])
            np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=PARAM_BAR)
    assert tr.masks is None and jr.masks is None
    assert tr.pruned_heads == jr.pruned_heads
    assert tuple(tr.cfg.encoder_attention_heads) == tuple(
        jr.cfg.encoder_attention_heads)
    assert tuple(tr.cfg.encoder_ffn_embed_dim) == tuple(
        jr.cfg.encoder_ffn_embed_dim)
    if mode == "head-pruning":
        assert len(tr.pruned_heads) == 1
        assert sum(tr.cfg.encoder_attention_heads) == 6
    elif mode == "row-pruning":
        assert tr.cfg.encoder_attention_heads == tuple(
            rows["head-prune"]["heads"])
        assert tr.cfg.encoder_ffn_embed_dim == (96, 96)
        # the rows each event kept: the port's, and those JAX's artifact
        # before the event scores to keep
        step = tiny.rp_prune["num_rows_each_step"]
        assert len(tr.prune_event_log) == tiny.rp_prune["total_steps"]
        for e in tr.prune_event_log:
            width = len(e["kept"][0]) + step
            layers = load_checkpoint(str(tmp_path / "jax" / "exp_row-pruning"
                                         / f"states_prune_{width}.npz"),
                                     load_opt=False)["params"]
            for layer, kept in zip(layers["encoder"]["layers"], e["kept"]):
                np.testing.assert_array_equal(
                    rp.rows_to_keep(rp.ffn_row_scores(layer), step), kept)
    else:
        assert tr.cfg.encoder_layers == 1
    # every parameter after the stage; a k_proj bias (zero gradient up to
    # rounding) and a leaf of zeros against the norm of all parameters
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
        assert err < PARAM_BAR, (name, err)


# ------------------------------------------------------------------ stage 0

def _assign(x, centers):
    """Both packages' k-means stand-in: nearest center in float64."""
    x, c = np.asarray(x, np.float64), np.asarray(centers, np.float64)
    return np.argmin(((x[:, None] - c[None]) ** 2).sum(-1), -1)


def _fit(rng, batches, k, **kw):
    rows = np.concatenate([np.asarray(b) for b in batches])
    return rows[:: rows.shape[0] // k][:k].astype(np.float32), 0.0


def test_stage0_data_matches_jax(tmp_path, monkeypatch):
    wavs = journey.synthetic_audio(0)
    assert [w.shape[0] for w in wavs] == [int(s * 16000)
                                          for s in journey.SYNTH_SECONDS]
    assert all(w.dtype == np.float32 and np.abs(w).max() <= 1 for w in wavs)
    mean, std = journey.load_mean_std(str(journey.MEAN_STD))
    for fp in (20, 10):
        for wav in wavs:
            np.testing.assert_allclose(
                journey.wav_to_mel(wav, mean, std, fp=fp),
                jextract.wav_to_mel(wav, mean, std, fp=fp),
                rtol=0, atol=FBANK_ATOL)

    # JAX's build_dataset on the same waveforms (its two flacs read as the
    # synthetic utterances), JAX's fbank for both packages, and one
    # k-means stand-in, so the features and labels are the same
    examples = tmp_path / "examples"
    examples.mkdir()
    shutil.copy(journey.MEAN_STD, examples / "libri-960-mean-std.npy")
    names = ("100-121669-0000.flac", "1001-134707-0000.flac")
    monkeypatch.setattr(jjourney, "EXAMPLES", examples)
    monkeypatch.setattr(jaudio, "read_audio", lambda path: (
        wavs[names.index(pathlib.Path(path).name)][None], 16000))
    monkeypatch.setattr(jkmeans, "kmeans_fit", _fit)
    monkeypatch.setattr(jkmeans, "kmeans_assign", lambda x, c: _assign(x, c))
    monkeypatch.setattr(journey, "wav_to_mel", jextract.wav_to_mel)
    monkeypatch.setattr(journey, "kmeans_fit",
                        lambda *a, device=None, **kw: _fit(*a, **kw))
    monkeypatch.setattr(journey, "kmeans_assign", lambda x, c: (
        torch.from_numpy(_assign(x.numpy(), c.numpy()))))
    for fp in (20, 10):
        settings = journey.settings_for(fp, tiny=True)
        with _jax_globals(settings):
            jax_csv, jax_batch, _ = jjourney.build_dataset(tmp_path / f"jax{fp}")
        csv, batch, _ = journey.build_dataset(tmp_path / f"port{fp}",
                                              settings, device="cpu")
        jrows = pathlib.Path(jax_csv).read_text().splitlines()
        trows = pathlib.Path(csv).read_text().splitlines()
        assert [r.replace(f"jax{fp}", f"port{fp}") for r in jrows] == trows
        for row in trows[1:]:
            feat, label, length = row.split(",")
            jfeat, jlabel = (p.replace(f"port{fp}", f"jax{fp}")
                             for p in (feat, label))
            for a, b in ((feat, jfeat), (label, jlabel)):
                x, y = np.load(a), np.load(b)
                assert x.dtype == y.dtype and np.array_equal(x, y), a
            assert np.load(feat).shape == (int(length), 40)
        with np.load(tmp_path / f"jax{fp}" / "eval_batch.npz") as z:
            assert set(z.files) == {"feat", "label", "pad_mask"}
            for k in z.files:
                assert batch[k].dtype == z[k].dtype, k
                assert np.array_equal(batch[k], z[k]), k
                assert np.array_equal(batch[k], jax_batch[k]), k
        saved = journey.load_eval_batch(tmp_path / f"port{fp}")
        assert np.array_equal(saved["mask"], journey.eval_mask(settings))
        assert saved["mask"].dtype == bool and saved["mask"].any()
        # a workdir of JAX's journey holds no mask: the same one is drawn
        drawn = journey.load_eval_batch(tmp_path / f"jax{fp}")["mask"]
        assert np.array_equal(drawn, saved["mask"])


@contextlib.contextmanager
def _jax_globals(settings):
    """run_journey_tpu's module settings for ``settings`` (its _set_fp10
    and _set_tiny write globals), restored after."""
    new = dict(FP=settings.frame_period, D_FEAT=settings.feat_dim,
               T_CROP=settings.t_crop, N_CLUSTER=settings.n_cluster,
               N_UTTS=settings.n_utts, BATCH=settings.batch)
    old = {k: getattr(jjourney, k) for k in new}
    for k, v in new.items():
        setattr(jjourney, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(jjourney, k, v)
