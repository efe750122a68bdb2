"""The port imports and runs its CPU slices with ``jax`` and the JAX package
``speech_ssl_compression_tpu`` unimportable (and, for training, ``pandas``
and ``yaml`` too), as on a GPU machine that has none of them; no module of
the port, and not ``chip_smoke.py``, imports either."""

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
assert all(sys.modules[n] is None
           for n in ("jax", "speech_ssl_compression_tpu", "pandas", "yaml"))
print("updates", len(runner.log_history))
"""


def test_port_trains_without_jax_pandas_or_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", TRAIN_SCRIPT, str(REPO)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("updates 2")


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
