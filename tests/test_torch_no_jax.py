"""The port imports and runs its CPU slice with ``jax`` unimportable, as on
a GPU machine that has no JAX."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile
sys.modules["jax"] = None  # `import jax` now raises ImportError
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
print("modules", len(names), "rows", out["n_packed_rows"])
"""


def test_port_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(REPO)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("modules ")


def test_chip_smoke_imports_nothing_of_jax_or_the_jax_package():
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "jax" not in roots and "speech_ssl_compression_tpu" not in roots
    assert "speech_ssl_compression_tpu_torch" in roots


def test_chip_smoke_fails_without_cuda():
    # this CPU machine has no CUDA device: the script must refuse to run
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
