"""The port imports and runs its CPU slices with ``jax`` and the JAX package
``speech_ssl_compression_tpu`` unimportable (and, for training, the
compression modes, HuBERT's l1 head pruning and a wav2vec 2.0 grad step,
``pandas`` and ``yaml`` too), as on a GPU machine that has none of them; no module of the port, and not
``chip_smoke.py``, imports either."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile
sys.modules["jax"] = None  # `import jax` now raises ImportError
sys.modules["speech_ssl_compression_tpu"] = None  # the JAX package
sys.modules["pandas"] = None
sys.modules["yaml"] = None
sys.path.insert(0, sys.argv[1])

import speech_ssl_compression_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)

import numpy as np
from speech_ssl_compression_tpu_torch.configs import MelHuBERTConfig
from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
from speech_ssl_compression_tpu_torch.utils.checkpoint import save_checkpoint
from speech_ssl_compression_tpu_torch.utils.weights import init_params_np

cfg = MelHuBERTConfig.from_dict(dict(
    feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=128,
    encoder_ffn_embed_dim=256, encoder_attention_heads=2, head_dim=64,
    conv_pos=16, conv_pos_groups=4, num_cluster=32))
with tempfile.TemporaryDirectory() as d:
    path = d + "/m.npz"
    save_checkpoint(path, init_params_np(cfg, seed=0),
                    meta={"Upstream_Config": {"melhubert": cfg.to_dict()}})
    ext = MelHuBERTExtractor(path, device="cpu")
rng = np.random.default_rng(0)
out = ext.forward_packed([rng.standard_normal(n).astype(np.float32) * 0.1
                          for n in (8000, 16000, 3000)])
h = out["last_hidden_state"]
assert h.shape == (3, 128, 128) and bool(h.isfinite().all())
dev = ext.forward_packed([rng.standard_normal(n).astype(np.float32) * 0.1
                          for n in (8000, 3000)], featurizer="device")
assert bool(dev["last_hidden_state"].isfinite().all())
for new in ("cluster", "ops.kmeans", "s3prl.expert", "s3prl.hubconf",
            "parallel.seqpar", "parallel.pipeline", "preprocess",
            "data.kaldi_io", "data.preprocess", "data.fairseq_dump",
            "data.text_compressor", "utils.flops", "utils.profiling",
            "train.wave_bench", "journey", "journey_curve",
            "ops.grouped_conv"):
    assert "speech_ssl_compression_tpu_torch." + new in names, new
from speech_ssl_compression_tpu_torch.ops.kmeans import kmeans_fit
centers, _ = kmeans_fit(0, [h[0].numpy()], 4, device="cpu")
assert centers.shape == (4, 128)
assert sys.modules["jax"] is None
assert sys.modules["speech_ssl_compression_tpu"] is None
print("modules", len(names), "rows", out["n_packed_rows"])
"""


def test_port_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(REPO)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("modules ")


TRAIN_SCRIPT = r"""
import pathlib, sys, tempfile
import numpy as np
for name in ("jax", "speech_ssl_compression_tpu", "pandas", "yaml"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
from speech_ssl_compression_tpu_torch.train.__main__ import main

d = pathlib.Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
rows = ["file_path,label_path,length"]
for i in range(4):
    n = 50 + 7 * i
    np.save(d / f"f{i}.npy", rng.standard_normal((n, 40)).astype(np.float32))
    np.save(d / f"l{i}.npy", rng.integers(0, 8, n))
    rows.append(f"{d}/f{i}.npy,{d}/l{i}.npy,{n}")
(d / "train.csv").write_text("\n".join(rows) + "\n")
(d / "model.yaml").write_text(
    "melhubert:\n  feat_emb_dim: 80\n  encoder_layers: 1\n"
    "  encoder_embed_dim: 64\n  encoder_ffn_embed_dim: 128\n"
    "  encoder_attention_heads: 4\n  head_dim: 16\n  num_cluster: 8\n"
    "  conv_pos: 8\n  conv_pos_groups: 4\n  mask_length: 3\n"
    "task:\n  sequence_length: 0\n")
(d / "runner.yaml").write_text(
    "runner:\n  total_steps: 2\n  gradient_accumulate_steps: 1\n"
    "  log_step: 1\noptimizer:\n  lr: 1.0e-03\n  betas:\n  - 0.9\n"
    "  - 0.999\ndatarc:\n  train_batch_size: 2\n  sets:\n"
    f"  - {d}/train.csv\n")
runner = main(["-m", "melhubert", "-g", str(d / "model.yaml"), "-c",
               str(d / "runner.yaml"), "-n", str(d / "exp"), "--device", "cpu"])
assert (d / "exp" / "last-step.npz").exists()
# weight pruning from that checkpoint, its Adam state restored: one event
# at step 1, before the second of two updates
(d / "wp.yaml").write_text(
    (d / "runner.yaml").read_text()
    + "prune:\n  sparsity:\n  - 0.5\n  warnup: 1\n  period: 1\n"
    "  n_iters: 1\n  pruning_condition: always\n")
pruned = main(["-m", "weight-pruning", "-g", str(d / "model.yaml"), "-c",
               str(d / "wp.yaml"), "-n", str(d / "wp"), "--device", "cpu",
               "-i", str(d / "exp" / "last-step.npz"),
               "--init_optimizer_from_initial_weight"])
assert pruned.wp_state.pruning_times == 1 and int(pruned.opt_state[0]) == 4
assert (d / "wp" / "before-pruning-states-1-sparsity-0.npz").exists()
assert (d / "wp" / "last-step.npz").exists()
assert all(sys.modules[n] is None
           for n in ("jax", "speech_ssl_compression_tpu", "pandas", "yaml"))
print("updates", len(runner.log_history) + len(pruned.log_history))
"""


def test_port_trains_without_jax_pandas_or_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", TRAIN_SCRIPT, str(REPO)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("updates 4")


# pre-training as in TRAIN_SCRIPT, then head pruning (data-driven,
# by_whole: one event of 3 heads, scored on the stacked buckets) and row
# pruning (one event of 32 rows) from its checkpoint
PRUNE_SCRIPT = TRAIN_SCRIPT[:TRAIN_SCRIPT.index("# weight pruning")] + r"""
for name, prune in (
        ("hp", "  metric: data-driven\n  target: by_whole\n"
               "  num_heads_each_step: 3\n  data_ratio: 1.0\n"
               "  normalize_by_layer: 2\n"),
        ("rp", "  num_rows_each_step: 32\n")):
    (d / f"{name}.yaml").write_text(
        (d / "runner.yaml").read_text() + "prune:\n" + prune
        + "  total_steps: 1\n  interval: 1\n  warm_up: 1\n")
heads = main(["-m", "head-pruning", "-g", str(d / "model.yaml"), "-c",
              str(d / "hp.yaml"), "-n", str(d / "hp"), "--device", "cpu",
              "-i", str(d / "exp" / "last-step.npz")])
rows = main(["-m", "row-pruning", "-g", str(d / "model.yaml"), "-c",
             str(d / "rp.yaml"), "-n", str(d / "rp"), "--device", "cpu",
             "-i", str(d / "exp" / "last-step.npz")])
assert heads.cfg.encoder_attention_heads == (1,)
assert (d / "hp" / "heads_and_score_4.npy").exists()
assert (d / "hp" / "states_prune_1.npz").exists()
assert rows.cfg.encoder_ffn_embed_dim == (96,)
assert (d / "rp" / "states_prune_96.npz").exists()
assert all(sys.modules[n] is None
           for n in ("jax", "speech_ssl_compression_tpu", "pandas", "yaml"))
print("updates", len(heads.log_history) + len(rows.log_history))
"""


def test_port_prunes_heads_and_rows_without_jax_pandas_or_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", PRUNE_SCRIPT, str(REPO)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("updates 4")


# pre-training as in TRAIN_SCRIPT, then -m distillation with its
# checkpoint as the teacher (masked, T = 2, alpha 0.5, the student's layer
# copied from the teacher), and the distiller expert on the same teacher
DISTILL_SCRIPT = TRAIN_SCRIPT[:TRAIN_SCRIPT.index("# weight pruning")] + r"""
model = (d / "model.yaml").read_text().split("task:")[0]
student = model.replace("melhubert:", "student:") + (
    "  initial_from_teacher: true\n")
(d / "distill.yaml").write_text(
    model.replace("melhubert:", "teacher:") + student
    + "loss_param:\n  T: 2\n  alpha: 0.5\n  type: masked\n"
    "task:\n  sequence_length: 0\n")
teacher = str(d / "exp" / "last-step.npz")
distilled = main(["-m", "distillation", "-g", str(d / "distill.yaml"), "-c",
                  str(d / "runner.yaml"), "-n", str(d / "kd"), "--device",
                  "cpu", "-i", teacher])
assert (d / "kd" / "last-step.npz").exists()
from speech_ssl_compression_tpu_torch.configs import read_yaml
from speech_ssl_compression_tpu_torch.upstream import get_pretrain_expert
expert = get_pretrain_expert("melhubert_distiller")(
    read_yaml(d / "distill.yaml"), teacher, device="cpu")
loss, n = expert.forward([rng.standard_normal((2, 30, 80)).astype(np.float32),
                          rng.integers(0, 8, (2, 30)), np.ones((2, 30))])
assert bool(loss.isfinite()) and n == 1
assert all(sys.modules[n] is None
           for n in ("jax", "speech_ssl_compression_tpu", "pandas", "yaml"))
print("updates", len(runner.log_history) + len(distilled.log_history))
"""


def test_port_distills_without_jax_pandas_or_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", DISTILL_SCRIPT, str(REPO)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("updates 4")


HUBERT_SCRIPT = r"""
import pathlib, sys, tempfile
import numpy as np
from scipy.io import wavfile
for name in ("jax", "speech_ssl_compression_tpu", "pandas", "yaml"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
from speech_ssl_compression_tpu_torch.train.__main__ import main

d = pathlib.Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
lines, labels = [], []
for i in range(4):
    n = 3000 + 500 * i
    wavfile.write(d / f"u{i}.wav", 16000,
                  (rng.uniform(-0.3, 0.3, n) * 32767).astype(np.int16))
    lines.append(f"u{i}.wav\t{n}")
    labels.append(" ".join(map(str, rng.integers(0, 6, n // 160))))
(d / "train.tsv").write_text(f"{d}\n" + "\n".join(lines) + "\n")
(d / "train.km").write_text("\n".join(labels) + "\n")
(d / "dict.km.txt").write_text("".join(f"{c} 1\n" for c in range(6)))
(d / "model.yaml").write_text(
    "hubert:\n  label_rate: 100\n  encoder_layers: 1\n"
    "  encoder_embed_dim: 128\n  encoder_ffn_embed_dim: 256\n"
    "  encoder_attention_heads: 2\n  head_dim: 64\n"
    "  conv_feature_layers: '[(128,10,5),(128,3,2),(128,2,2)]'\n"
    "  final_dim: 32\n  conv_pos: 16\n  conv_pos_groups: 4\n"
    "  mask_length: 4\n  feature_grad_mult: 0.1\n"
    "  conv_frontend_impl: tc_pallas\n")
(d / "runner.yaml").write_text(
    "runner:\n  total_steps: 2\n  gradient_accumulate_steps: 1\n"
    "  log_step: 1\noptimizer:\n  lr: 1.0e-03\ndatarc:\n"
    f"  train_batch_size: 2\ntask:\n  data: {d}\n  label_rate: 100\n"
    "  max_sample_size: 3200\n")
runner = main(["-m", "melhubert", "-u", "hubert", "-g", str(d / "model.yaml"),
               "-c", str(d / "runner.yaml"), "-n", str(d / "exp"),
               "--device", "cpu"])
assert (d / "exp" / "last-step.npz").exists()
# l1 head pruning of that checkpoint, one event of one head a layer
(d / "hp.yaml").write_text(
    (d / "runner.yaml").read_text() + "prune:\n  metric: l1\n"
    "  target: by_layer\n  total_steps: 1\n  interval: 1\n  warm_up: 0\n")
hp = main(["-m", "head-pruning", "-u", "hubert", "-g", str(d / "model.yaml"),
           "-c", str(d / "hp.yaml"), "-n", str(d / "hp"), "-i",
           str(d / "exp" / "last-step.npz"), "--device", "cpu"])
assert hp.cfg.encoder_attention_heads == (1,) and len(hp.pruned_heads) == 1
assert {"states_prune_2.npz", "last-step.npz"} <= {
    p.name for p in (d / "hp").iterdir()}
# a tiny wav2vec 2.0 and one grad step on two of those waveforms
import torch
from speech_ssl_compression_tpu_torch.configs import Wav2Vec2Config
from speech_ssl_compression_tpu_torch.train.steps import make_wav2vec2_grad_step
from speech_ssl_compression_tpu_torch.utils.weights import (
    init_wav2vec2_params_np, load_wave_model)
cfg = Wav2Vec2Config.from_dict(dict(
    encoder_layers=1, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
    encoder_attention_heads=2, head_dim=16,
    conv_feature_layers="[(32,10,5),(32,3,2),(32,2,2)]", final_dim=16,
    conv_pos=16, conv_pos_groups=4, quantize_targets=True, latent_vars=8,
    latent_groups=2, num_negatives=4, mask_length=4))
model = load_wave_model(init_wav2vec2_params_np(cfg, 0), cfg, "wav2vec2")
params = dict(model.named_parameters())
source = torch.from_numpy(rng.uniform(-0.3, 0.3, (2, 3000)).astype(np.float32))
loss, n, grads, logs = make_wav2vec2_grad_step(model)(
    params, {"source": source, "length": np.array([3000, 2500])},
    torch.Generator().manual_seed(0), gumbel_temp=2.0)
assert bool(torch.isfinite(loss)) and int(n) > 0 and logs["temp"] == 2.0
assert len(grads) == len(params) and all(bool(torch.isfinite(g).all())
                                         for g in grads)
assert all(sys.modules[n] is None
           for n in ("jax", "speech_ssl_compression_tpu", "pandas", "yaml"))
print("updates", len(runner.log_history))
"""


def test_port_trains_hubert_without_jax_pandas_or_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", HUBERT_SCRIPT, str(REPO)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("updates 2")


# the --multi_host CLI path on two gloo ranks (torchrun's variables), data
# parallel then tensor parallel in one process group, each rank in a
# directory of its own: only rank 0 writes
MULTI_HOST_SCRIPT = r"""
import os, pathlib, sys
for name in ("jax", "speech_ssl_compression_tpu", "pandas", "yaml"):
    sys.modules[name] = None
repo, rank, port = sys.argv[1:4]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank,
                  WORLD_SIZE="2", LOCAL_RANK=rank, LOCAL_WORLD_SIZE="2",
                  OMP_NUM_THREADS="1")
sys.path.insert(0, repo)
""" + TRAIN_SCRIPT[TRAIN_SCRIPT.index("import numpy as np"):
                   TRAIN_SCRIPT.index("runner = main(")].replace(
    "d = pathlib.Path(tempfile.mkdtemp())\n",
    "import tempfile\nfrom speech_ssl_compression_tpu_torch.train.__main__ "
    "import main\nd = pathlib.Path(tempfile.mkdtemp())\n") + r"""
for tp in ("1", "2"):
    runner = main(["-m", "melhubert", "-g", str(d / "model.yaml"), "-c",
                   str(d / "runner.yaml"), "-n", f"exp{tp}", "--device",
                   "cpu", "--multi_host", "--model_parallel", tp])
    assert runner.mesh.shape == {"data": 2 // int(tp), "model": int(tp)}
    assert pathlib.Path(f"exp{tp}/last-step.npz").exists() == (rank == "0")
assert sorted(os.listdir(".")) == (["exp1", "exp2"] if rank == "0" else [])
assert all(sys.modules[n] is None
           for n in ("jax", "speech_ssl_compression_tpu", "pandas", "yaml"))
print("rank", rank, "updates", len(runner.log_history))
"""


def test_port_trains_on_two_ranks_without_jax_pandas_or_yaml(tmp_path):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = []
    for rank in ("0", "1"):
        cwd = tmp_path / f"rank{rank}"
        cwd.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MULTI_HOST_SCRIPT, str(REPO), rank,
             port], cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    for rank, p in enumerate(procs):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
        assert out.strip().endswith(f"rank {rank} updates 2")


def _import_roots(path):
    """The top-level package of every absolute import in a Python file."""
    import ast

    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_chip_smoke_imports_nothing_of_jax_or_the_jax_package():
    roots = _import_roots(REPO / "chip_smoke.py")
    assert "jax" not in roots and "speech_ssl_compression_tpu" not in roots
    assert "speech_ssl_compression_tpu_torch" in roots


def test_port_modules_import_nothing_of_jax_or_the_jax_package():
    files = sorted((REPO / "speech_ssl_compression_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        roots = _import_roots(path)
        assert not roots & {"jax", "speech_ssl_compression_tpu"}, path


def test_chip_smoke_fails_without_cuda():
    # this CPU machine has no CUDA device: the script must refuse to run
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
