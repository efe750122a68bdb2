"""The staged compression journey at the paper's model scale on one GPU.

Port of ``tools/run_journey_tpu.py``: the reference README's staged
workflow run end to end, each stage reading the previous stage's
checkpoint from disk through the self-describing checkpoint contract:

  stage 0  fbank (20 ms stacked, 80-d; or 10 ms, 40-d) -> random T-frame
           crops -> k-means (K = 512) labels on the device -> the
           training CSV in the reference layout and one held-out batch
  stage 1  MelHuBERT pre-training (``train/runner.py::Runner``)
  stage 2  the weight-pruning ladder under the EMA convergence gate, from
           stage 1's checkpoint
  stage 3  data-driven head pruning from stage 2's checkpoint (its masks
           folded into the weights)
  stage 4  row pruning from stage 3's checkpoint (ragged heads a layer)
  stage 5  distillation into a 6-layer student, the teacher stage 1
  stage 6  serving of the dense, weight-pruned, head-and-row-pruned and
           6-layer models

After each stage the held-out batch's masked CE is evaluated with one
span mask, drawn once on the host and saved beside the batch, so every CE
of a workdir is comparable (``journey_curve.py`` evaluates the
intermediate checkpoints the same way).

    python -m speech_ssl_compression_tpu_torch.journey [--workdir DIR] \\
        [--pretrain-steps N] [--distill-steps N] [--fp 10|20] [--tiny] \\
        [--audio FILE ...] [--device cuda|cpu]

Without ``--audio`` the waveforms are seeded synthetic audio
(:func:`synthetic_audio`): its CEs show that every stage trains, prunes
and serves, and are no measure of speech quality. The trainers run f32
(``bf16: False``), as JAX's journey sets. ``run_journey(workdir,
settings, schedule, device=...)`` does the work; ``main`` parses flags.
Writes ``<workdir>/summary.json`` and prints a markdown table.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import re
import statistics
import time
import types
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .compress.weight_pruning import sparsity_of
from .configs import MelHuBERTConfig
from .extract import (
    MelHuBERTExtractor,
    load_any_checkpoint,
    load_mean_std,
    read_wavs,
    wav_to_mel,
)
from .models.melhubert import (
    melhubert_forward,
    melhubert_pretrain_loss,
    span_mask,
)
from .ops.kmeans import kmeans_assign, kmeans_fit
from .utils.checkpoint import tree_leaves
from .utils.device import (
    card_label,
    matmul_precision,
    resolve_device,
    upload,
)
from .utils.weights import load_model

MEAN_STD = (pathlib.Path(__file__).resolve().parent.parent / "example"
            / "libri-960-mean-std.npy")
EVAL_MASK_SEED = 1234  # the held-out span mask's host seed (JAX's PRNGKey)
SAMPLE_RATE = 16000


@dataclasses.dataclass(frozen=True)
class JourneySettings:
    """Frame period, features, data and model dims of a journey (JAX's
    ``FP``, ``D_FEAT``, ``T_CROP``, ``N_CLUSTER``, ``N_UTTS``, ``BATCH``
    and ``DIMS``)."""

    frame_period: int = 20
    feat_dim: int = 80
    t_crop: int = 768
    n_cluster: int = 512
    n_utts: int = 64
    batch: int = 4
    layers: int = 12
    embed_dim: int = 768
    ffn_dim: int = 3072
    heads: int = 12
    conv_pos: int = 128
    conv_pos_groups: int = 16

    def fp10(self) -> "JourneySettings":
        """The 10 ms recipe: raw 40-d fbank, 1500-frame crops (JAX's
        ``_set_fp10``)."""
        return dataclasses.replace(self, frame_period=10, feat_dim=40,
                                   t_crop=1500)

    def tiny(self) -> "JourneySettings":
        """CPU smoke scale (JAX's ``_set_tiny``): toy dims, K = 16, T =
        96, 12 utterances."""
        return dataclasses.replace(self, n_cluster=16, t_crop=96, n_utts=12,
                                   layers=2, embed_dim=64, ffn_dim=128,
                                   heads=4, conv_pos=16, conv_pos_groups=4)


@dataclasses.dataclass(frozen=True)
class JourneySchedule:
    """Each stage's length and prune section (JAX's main, :319-356)."""

    pretrain_steps: int
    distill_steps: int
    wp_prune: dict
    wp_total: int
    hp_prune: dict
    hp_total: int
    rp_prune: dict
    rp_total: int
    serve_reps: int


FULL = JourneySchedule(
    pretrain_steps=600, distill_steps=300,
    wp_prune={"pruning_condition": "converge", "strategy": "L1Unstructured",
              "n_iters": 3, "warnup": 150, "period": 100,
              "average_length": 10, "converge_loss_tolerance": 0.05,
              "sparsity": [0.3, 0.5, 0.7]},
    wp_total=450,
    hp_prune={"metric": "data-driven", "target": "by_whole",
              "total_steps": 2, "interval": 40, "warm_up": 30,
              "num_heads_each_step": 12, "data_ratio": 0.1,
              "normalize_by_layer": 2},
    hp_total=120,
    rp_prune={"num_rows_each_step": 512, "total_steps": 2, "interval": 40,
              "warm_up": 30},
    rp_total=120,
    serve_reps=20,
)

TINY = JourneySchedule(
    pretrain_steps=8, distill_steps=4,
    wp_prune={"pruning_condition": "always", "strategy": "L1Unstructured",
              "n_iters": 2, "warnup": 2, "period": 2, "average_length": 1,
              "converge_loss_tolerance": 0.1, "sparsity": [0.2, 0.4]},
    wp_total=6,
    hp_prune={"metric": "data-driven", "target": "by_whole",
              "total_steps": 1, "interval": 2, "warm_up": 1,
              "num_heads_each_step": 2, "data_ratio": 0.5,
              "normalize_by_layer": 2},
    hp_total=4,
    rp_prune={"num_rows_each_step": 32, "total_steps": 1, "interval": 2,
              "warm_up": 1},
    rp_total=4,
    serve_reps=2,
)

STAGE_DIRS = (("pretrain", "exp_melhubert"),
              ("weight-prune", "exp_weight-pruning"),
              ("head-prune", "exp_head-pruning"),
              ("row-prune", "exp_row-pruning"),
              ("distill", "exp_distillation"))
SERVED = ("dense_12L", "weight_pruned", "hp_rp_compressed", "student_6L")


def model_cfg(settings: JourneySettings) -> dict:
    """JAX's ``flagship_model_cfg``."""
    return {
        "melhubert": {
            "feat_emb_dim": settings.feat_dim,
            "encoder_layers": settings.layers,
            "encoder_embed_dim": settings.embed_dim,
            "encoder_ffn_embed_dim": settings.ffn_dim,
            "encoder_attention_heads": settings.heads,
            "head_dim": settings.embed_dim // settings.heads,
            "num_cluster": settings.n_cluster,
            "mask_prob": 0.65,
            "mask_length": 5,
            "learnable_mask_emb": False,
            "conv_pos": settings.conv_pos,
            "conv_pos_groups": settings.conv_pos_groups,
        },
        "task": {"sequence_length": 0},
    }


def runner_cfg(csv: str, total_steps: int, batch: int, lr: float = 1e-4,
               log_step: int = 100) -> dict:
    """JAX's ``runner_cfg``: f32, no accumulation, the CSV's buckets of
    ``batch``."""
    return {
        "runner": {
            "n_epochs": 0,
            "total_steps": total_steps,
            "gradient_clipping": 10.0,
            "gradient_accumulate_steps": 1,
            "log_step": log_step,
            "save_every_x_epochs": 10000,
            "bf16": False,
        },
        "optimizer": {"lr": lr, "betas": [0.9, 0.999], "eps": 1.0e-8,
                      "weight_decay": 0},
        "datarc": {
            "num_workers": 0,
            "train_batch_size": batch,
            "max_timestep": 0,
            "sets": [csv],
        },
    }


def make_args(workdir: pathlib.Path, mode: str, frame_period: int, device,
              **kw) -> types.SimpleNamespace:
    """JAX's ``make_args`` with the port's ``device``."""
    args = types.SimpleNamespace(
        mode=mode,
        upstream="melhubert",
        expdir=str(workdir / f"exp_{mode}"),
        initial_weight=None,
        init_optimizer_from_initial_weight=False,
        frame_period=frame_period,
        seed=0,
        device=str(device),
    )
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def ckpt_order(path: pathlib.Path):
    """Sort key of a stage's checkpoints, oldest first: the ``Step`` its
    meta records, then the fewest units left (``states_prune_N``: N heads
    or FFN rows, which only fall) last. Not the modification time, which
    can tie on a coarse clock."""
    meta = json.loads(pathlib.Path(str(path) + ".json").read_text())
    m = re.fullmatch(r"states_prune_(\d+)\.npz", path.name)
    return int(meta.get("Step", 0)), -int(m.group(1)) if m else 0


def stage_ckpts(expdir) -> list:
    """An expdir's checkpoints, oldest first (:func:`ckpt_order`)."""
    return sorted(pathlib.Path(expdir).glob("*.npz"), key=ckpt_order)


def newest_ckpt(expdir) -> pathlib.Path:
    """The newest checkpoint of an expdir (head and row pruning name their
    final artifact ``states_prune_N.npz``, not ``last-step.npz``)."""
    cks = stage_ckpts(expdir)
    assert cks, f"no checkpoint in {expdir}"
    return cks[-1]


# ---------------------------------------------------------------------------
# stage 0: data
# ---------------------------------------------------------------------------

SYNTH_SECONDS = (14.7, 16.0)  # two utterances, as long as JAX's two flacs


def synthetic_audio(seed: int = 0,
                    seconds: Sequence[float] = SYNTH_SECONDS) -> list:
    """Seeded speech-like waveforms at 16 kHz, float32 in [-1, 1]: one
    ``np.random.default_rng(seed)`` stream of segments 40-200 ms long,
    each voiced (3-6 harmonics of an f0 drawn from 80-300 Hz, rolled off
    by a random tilt, over quiet noise), unvoiced (white noise through a
    one-pole filter of a random pole, low- or high-passed) or near
    silence, with 5 ms ramps at the ends, so the fbank frames fall into
    classes k-means can separate and a model can learn."""
    rng = np.random.default_rng(seed)
    wavs = []
    for sec in seconds:
        n_total = int(sec * SAMPLE_RATE)
        pieces, n = [], 0
        while n < n_total:
            m = int(rng.integers(40, 201) * SAMPLE_RATE // 1000)
            t = np.arange(m) / SAMPLE_RATE
            kind = rng.choice(3, p=(0.6, 0.3, 0.1))
            if kind == 0:
                f0 = rng.uniform(80.0, 300.0)
                tilt = rng.uniform(0.5, 1.5)
                seg = sum(k ** -tilt * rng.uniform(0.3, 1.0)
                          * np.sin(2 * np.pi * k * f0 * t
                                   + rng.uniform(0, 2 * np.pi))
                          for k in range(1, int(rng.integers(3, 7)) + 1))
                seg = seg + 0.02 * rng.standard_normal(m)
            elif kind == 1:
                white = rng.standard_normal(m)
                pole = rng.uniform(-0.95, 0.95)
                seg = np.empty(m)
                acc = 0.0
                for i in range(m):
                    acc = white[i] + pole * acc
                    seg[i] = acc
                seg *= np.sqrt(1.0 - pole * pole)
            else:
                seg = 0.005 * rng.standard_normal(m)
            ramp = min(m // 2, SAMPLE_RATE // 200)
            env = np.ones(m)
            env[:ramp] = np.linspace(0.0, 1.0, ramp)
            env[m - ramp:] = np.linspace(1.0, 0.0, ramp)
            pieces.append(seg * env * rng.uniform(0.05, 0.3))
            n += m
        wav = np.concatenate(pieces)[:n_total]
        wavs.append(np.clip(wav, -1.0, 1.0).astype(np.float32))
    return wavs


def draw_crops(mels: list, settings: JourneySettings) -> list:
    """JAX's crops (:170-176): one tiled feature stream, N_UTTS + 1 crops
    of T_CROP frames at starts from ``default_rng(0)``."""
    stream = np.concatenate(mels, axis=0)
    reps = -(-(settings.t_crop * (settings.n_utts + 2)) // stream.shape[0])
    stream = np.tile(stream, (reps, 1))
    rng = np.random.default_rng(0)
    starts = rng.integers(0, stream.shape[0] - settings.t_crop,
                          settings.n_utts + 1)
    return [stream[s: s + settings.t_crop] for s in starts]


def eval_mask(settings: JourneySettings) -> np.ndarray:
    """The held-out span mask, (BATCH, T_CROP) bool: the host sampler with
    melhubert_forward's arguments, seeded by EVAL_MASK_SEED (JAX draws its
    own on the device from PRNGKey(1234), which no torch stream can
    reproduce)."""
    cfg = MelHuBERTConfig.from_dict(model_cfg(settings)["melhubert"])
    return span_mask(cfg, np.full(settings.batch, settings.t_crop),
                     settings.t_crop, np.random.default_rng(EVAL_MASK_SEED))


def write_dataset(workdir: pathlib.Path, crops: list, labels: list,
                  settings: JourneySettings):
    """The training CSV in the reference layout and the held-out batch
    (JAX :188-225). Training files hold raw 40-d 10 ms features: at 20 ms
    the stacked crops are unstacked and each label repeated twice (the
    dataset stacks pairs and takes every other label). The held-out batch
    is the last BATCH crops with their labels, a pad mask of ones and
    :func:`eval_mask`, saved as ``eval_batch.npz``. Returns (csv path,
    eval batch)."""
    data_dir = workdir / "data"
    data_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(settings.n_utts):
        fp = data_dir / f"feat_{i}.npy"
        lp = data_dir / f"label_{i}.npy"
        if settings.frame_period == 20:
            raw = crops[i].reshape(-1, 40)
            np.save(lp, np.repeat(labels[i], 2))
        else:
            raw = crops[i]
            np.save(lp, labels[i])
        np.save(fp, raw)
        rows.append((str(fp), str(lp), raw.shape[0]))
    csv = workdir / "train.csv"
    with open(csv, "w") as f:
        f.write("file_path,label_path,length\n")
        for r in rows:
            f.write(f"{r[0]},{r[1]},{r[2]}\n")
    n, b = settings.n_utts, settings.batch
    eval_batch = {
        "feat": np.stack(crops[n - b + 1: n + 1]).astype(np.float32),
        "label": np.stack(labels[n - b + 1: n + 1]).astype(np.int32),
        "pad_mask": np.ones((b, settings.t_crop), np.float32),
        "mask": eval_mask(settings),
    }
    np.savez(workdir / "eval_batch.npz", **eval_batch)
    return str(csv), eval_batch


def build_dataset(workdir: pathlib.Path, settings: JourneySettings, *,
                  device, audio: Optional[Sequence[str]] = None):
    """Stage 0 (JAX ``build_dataset``): the waveforms of ``audio`` (16 kHz
    files) or :func:`synthetic_audio`, fbank features by ``wav_to_mel``
    with the LibriSpeech 960 h mean and std, the crops, k-means labels
    (K = N_CLUSTER, 4 epochs on ``device``), then :func:`write_dataset`.
    Returns (csv path, eval batch, k-means info)."""
    device = resolve_device(device)
    mean, std = load_mean_std(str(MEAN_STD))
    wavs = read_wavs(audio) if audio else synthetic_audio(0)
    mels = [wav_to_mel(w, mean, std, fp=settings.frame_period)
            for w in wavs]
    crops = draw_crops(mels, settings)

    t0 = time.time()
    centers, inertia = kmeans_fit(0, [np.concatenate(crops, axis=0)],
                                  settings.n_cluster, epochs=4,
                                  device=device)
    c = upload(centers, device)
    labels = [kmeans_assign(upload(x, device), c).cpu().numpy().astype(
        np.int64) for x in crops]
    kmeans_sec = time.time() - t0
    csv, eval_batch = write_dataset(workdir, crops, labels, settings)
    return csv, eval_batch, {"kmeans_sec": round(kmeans_sec, 1),
                             "kmeans_inertia_per_row": float(inertia),
                             "audio": list(audio) if audio
                             else "synthetic (seed 0)"}


def load_eval_batch(workdir) -> dict:
    """``eval_batch.npz`` of a workdir. Without a saved ``mask`` (a
    workdir of JAX's journey) one is drawn as stage 0 draws it, for the
    batch's shape (the mask's settings are the same at every scale)."""
    with np.load(pathlib.Path(workdir) / "eval_batch.npz") as z:
        batch = {k: z[k] for k in z.files}
    if "mask" not in batch:
        b, t = batch["pad_mask"].shape
        batch["mask"] = eval_mask(dataclasses.replace(
            JourneySettings(), batch=b, t_crop=t))
        print("[journey] eval_batch.npz holds no mask: drew one on the host "
              f"(seed {EVAL_MASK_SEED})", flush=True)
    return batch


# ---------------------------------------------------------------------------
# held-out masked CE and serving
# ---------------------------------------------------------------------------

def eval_params(params: dict, cfg: MelHuBERTConfig, eval_batch: dict, *,
                device, attn_impl: str = "auto") -> float:
    """The held-out batch's pre-training loss (masked CE) with its saved
    span mask, dropout off, in f32 with TF32 off."""
    device = resolve_device(device)
    model = load_model(params, cfg).to(device).eval().requires_grad_(False)
    feat, pad, mask = (torch.from_numpy(np.asarray(eval_batch[k])).to(device)
                       for k in ("feat", "pad_mask", "mask"))
    label = torch.from_numpy(eval_batch["label"]).long().to(device)
    with matmul_precision("highest"), torch.no_grad():
        out = melhubert_forward(model, feat, pad, mask=True,
                                teacher_mask_indices=mask.bool(),
                                attn_impl=attn_impl)
        loss, _ = melhubert_pretrain_loss(out, label, pad, cfg)
    return float(loss)


def eval_ckpt(ckpt_path, eval_batch: dict, *, device,
              attn_impl: str = "auto"):
    """JAX's ``eval_ckpt``: a checkpoint through ``load_any_checkpoint``
    (masks folded, pruned widths inferred) -> (held-out masked CE, the
    parameter count, the config)."""
    params, cfg, _ = load_any_checkpoint(str(ckpt_path))
    loss = eval_params(params, cfg, eval_batch, device=device,
                       attn_impl=attn_impl)
    n_params = sum(int(np.prod(p.shape)) for p in tree_leaves(params))
    return loss, n_params, cfg


def serve_forward(extractor: MelHuBERTExtractor, feat: torch.Tensor,
                  pad: torch.Tensor) -> torch.Tensor:
    """The extractor's forward from features (no prediction head, every
    hidden state kept), as JAX's serving comparison calls it; returns the
    last hidden state."""
    with matmul_precision(extractor.matmul_precision), \
            torch.inference_mode():
        return melhubert_forward(extractor.model, feat, pad, no_pred=True,
                                 get_hidden=True,
                                 attn_impl=extractor.attn_impl)["hidden"]


def serve_fps(ckpt_path, eval_batch: dict, frame_period: int, *, device,
              n_rep: int = 20):
    """Extraction throughput of a checkpoint (B = BATCH, T = T_CROP, f32,
    TF32 off): the median of ``n_rep`` calls after one warm call, each
    timed by CUDA events on a GPU (wall time on the CPU). Returns
    (frames/s, the clock's name)."""
    device = resolve_device(device)
    ex = MelHuBERTExtractor(str(ckpt_path), fp=frame_period, device=device)
    feat, pad = (upload(np.asarray(eval_batch[k], np.float32), device)
                 for k in ("feat", "pad_mask"))
    serve_forward(ex, feat, pad)
    times = []
    for _ in range(n_rep):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            serve_forward(ex, feat, pad)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            serve_forward(ex, feat, pad)
            times.append(time.perf_counter() - t0)
    clock = ("CUDA events" if device.type == "cuda" else "wall") + (
        f", median of {n_rep}")
    return feat.shape[0] * feat.shape[1] / statistics.median(times), clock


def dir_bytes(path: pathlib.Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

Hook = Callable[..., None]


def run_journey(workdir, settings: JourneySettings,
                schedule: JourneySchedule, *, device="cuda",
                audio: Optional[Sequence[str]] = None,
                hook: Optional[Hook] = None) -> dict:
    """Stages 0-6 into ``workdir``; writes and returns the summary.

    ``hook(stage, when, runner, row)``, where given, is called with
    ``when="built"`` once a stage's trainer is built (before it trains;
    ``runner`` None for serving) and ``when="done"`` once the stage's
    held-out CE is recorded (``row`` its summary row; for serving the
    frames/s)."""
    from .train.runner import Runner

    device = resolve_device(device)
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    hook = hook or (lambda *a, **k: None)
    gpu = card_label(device)
    fp = settings.frame_period
    summary = {"frame_period_ms": fp, "t_crop": settings.t_crop,
               "gpu": gpu, "stages": []}

    def record(stage, ckpt, t_sec, extra=None):
        loss, n_params, cfg = eval_ckpt(ckpt, eval_batch, device=device)
        row = {
            "stage": stage,
            "ckpt": str(ckpt),
            "heldout_masked_ce": round(loss, 4),
            "heldout_masked_ce_unrounded": loss,
            "params_m": round(n_params / 1e6, 2),
            "wall_sec": round(t_sec, 1),
            "gpu": gpu,
            "heads": list(cfg.encoder_attention_heads),
            "ffn": list(cfg.encoder_ffn_embed_dim),
            "layers": cfg.encoder_layers,
        }
        if extra:
            row.update(extra)
        summary["stages"].append(row)
        print(f"[journey] {stage}: CE={loss:.4f} params={row['params_m']}M "
              f"({t_sec:.0f}s) [{gpu}]", flush=True)
        return row

    def train_stage(stage, mode, rc, up, ckpt_of, extra_of=None, **kw):
        t0 = time.time()
        args = make_args(workdir, mode, fp, device, **kw)
        runner = Runner(args, rc, up)
        hook(stage, "built", runner, None)
        runner.train()
        ckpt = ckpt_of(pathlib.Path(args.expdir))
        row = record(stage, ckpt, time.time() - t0,
                     extra_of(runner, ckpt) if extra_of else None)
        hook(stage, "done", runner, row)
        return ckpt

    def cfg_with_prune(total, prune):
        rc = runner_cfg(csv, total, settings.batch)
        rc["prune"] = dict(prune)
        return rc

    # ---- stage 0 ---------------------------------------------------------
    print("[journey] stage 0: data + k-means labels on the device",
          flush=True)
    t0 = time.time()
    csv, eval_batch, km_info = build_dataset(workdir, settings,
                                             device=device, audio=audio)
    summary["data"] = dict(km_info, n_utts=settings.n_utts,
                           t_crop=settings.t_crop,
                           wall_sec=round(time.time() - t0, 1), gpu=gpu)
    print(f"[journey] data ready: {km_info}", flush=True)
    mc = model_cfg(settings)

    print("[journey] stage 1: pre-train", flush=True)
    ck1 = train_stage("pretrain", "melhubert",
                      runner_cfg(csv, schedule.pretrain_steps,
                                 settings.batch),
                      mc, lambda d: d / "last-step.npz")

    print("[journey] stage 2: weight-pruning ladder", flush=True)

    def wp_extra(runner, ckpt):
        meta = json.loads(pathlib.Path(str(ckpt) + ".json").read_text())
        return {"sparsity": round(sparsity_of(runner.masks), 3),
                "prune_events_fired": runner.wp_state.pruning_times,
                "total_steps_after_extensions": meta.get("TotalStep")}

    ck2 = train_stage("weight-prune", "weight-pruning",
                      cfg_with_prune(schedule.wp_total, schedule.wp_prune),
                      mc, lambda d: d / "last-step.npz", wp_extra,
                      initial_weight=str(ck1))

    print("[journey] stage 3: data-driven head pruning", flush=True)
    ck3 = train_stage("head-prune", "head-pruning",
                      cfg_with_prune(schedule.hp_total, schedule.hp_prune),
                      mc, newest_ckpt,
                      lambda r, _: {"pruned_heads": len(r.pruned_heads)},
                      initial_weight=str(ck2))

    print("[journey] stage 4: row pruning", flush=True)
    ck4 = train_stage("row-prune", "row-pruning",
                      cfg_with_prune(schedule.rp_total, schedule.rp_prune),
                      mc, newest_ckpt, initial_weight=str(ck3))

    print("[journey] stage 5: distillation "
          f"({settings.layers}L teacher -> "
          f"{max(1, settings.layers // 2)}L student)", flush=True)
    up = {
        "teacher": dict(mc["melhubert"]),
        "student": dict(mc["melhubert"],
                        encoder_layers=max(1, settings.layers // 2),
                        initial_from_teacher=True),
        "task": {"sequence_length": 0},
        "loss_param": {"T": 4.0, "alpha": 0.5, "type": "masked"},
    }
    ck5 = train_stage("distill-6L", "distillation",
                      runner_cfg(csv, schedule.distill_steps,
                                 settings.batch),
                      up, lambda d: d / "last-step.npz",
                      initial_weight=str(ck1))

    # ---- stage 6: serving comparison ---------------------------------------
    print("[journey] stage 6: serving comparison", flush=True)
    hook("serve", "built", None, None)
    fps = {}
    clock = None
    for tag, ck in zip(SERVED, (ck1, ck2, ck4, ck5)):
        rate, clock = serve_fps(ck, eval_batch, fp, device=device,
                                n_rep=schedule.serve_reps)
        fps[tag] = round(rate, 1)
        print(f"[journey]   {tag}: {fps[tag]} frames/s ({clock}) [{gpu}]",
              flush=True)
    summary["serving_frames_per_sec"] = fps
    summary["serving_clock"] = clock
    summary["serving_gpu"] = gpu
    hook("serve", "done", None, fps)

    summary["workdir_bytes"] = dir_bytes(workdir)
    out = workdir / "summary.json"
    out.write_text(json.dumps(summary, indent=2, default=float))

    print("\n| stage | held-out masked CE | params (M) | wall (s) |")
    print("|---|---|---|---|")
    for row in summary["stages"]:
        print(f"| {row['stage']} | {row['heldout_masked_ce']} "
              f"| {row['params_m']} | {row['wall_sec']} |")
    print(f"\nserving: {fps} [{gpu}]")
    print(f"[journey] workdir {workdir}: {summary['workdir_bytes']} bytes")
    print(f"[journey] summary -> {out}")
    return summary


def settings_for(fp: int = 20, tiny: bool = False) -> JourneySettings:
    """JAX's module settings after ``_set_fp10`` and ``_set_tiny``."""
    settings = JourneySettings()
    if fp == 10:
        settings = settings.fp10()
    if tiny:
        settings = settings.tiny()
    return settings


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default="journey")
    ap.add_argument("--pretrain-steps", type=int, default=None)
    ap.add_argument("--distill-steps", type=int, default=None)
    ap.add_argument("--fp", type=int, default=20, choices=(10, 20),
                    help="frame period (ms); 10 = raw 40-d fbank with "
                    "T=1500 long-sequence crops (the 10 ms recipe)")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU smoke scale (toy dims, a few steps/stage)")
    ap.add_argument("--audio", nargs="+", default=None, metavar="FILE",
                    help="16 kHz audio files for stage 0 (default: seeded "
                    "synthetic audio)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu on the CPU)")
    args = ap.parse_args(argv)
    schedule = TINY if args.tiny else FULL
    steps = {}
    for name in ("pretrain_steps", "distill_steps"):
        given = getattr(args, name)
        if given is not None:
            # --tiny caps the steps at its own, as JAX's min() does
            steps[name] = (min(given, getattr(schedule, name)) if args.tiny
                           else given)
    schedule = dataclasses.replace(schedule, **steps)
    return run_journey(args.workdir, settings_for(args.fp, args.tiny),
                       schedule, device=args.device, audio=args.audio)


if __name__ == "__main__":
    main()
