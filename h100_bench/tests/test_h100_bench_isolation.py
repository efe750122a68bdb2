"""What the benchmark may load: never JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
in the reference nothing of the port. And a run without a card fails."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

from h100_bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_loaded(
        ["speech_ssl_compression_tpu_torch.extract", "jaxtyping", "flaxen",
         "numpy"]) == []
    assert harness.forbidden_loaded(
        ["speech_ssl_compression_tpu.ops.attention", "jax.numpy", "jaxlib",
         "flax.linen"]) == ["flax", "jax", "jaxlib",
                            "speech_ssl_compression_tpu"]


def _loaded_after(code: str) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=ROOT, env=env)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_and_its_entries_load_no_jax():
    code = ("from h100_bench import harness, controls, faults\n"
            "for e in ('melhubert_stream', 'hubert_forward', "
            "'runner_update'):\n"
            "    harness.load_entry(e)\n"
            "import speech_ssl_compression_tpu_torch.extract, "
            "speech_ssl_compression_tpu_torch.train.runner, "
            "speech_ssl_compression_tpu_torch.models.hubert")
    loaded = _loaded_after(code)
    assert harness.forbidden_loaded(loaded) == []
    assert "speech_ssl_compression_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(
        "import h100_bench.reference.train, h100_bench.reference.hubert, "
        "h100_bench.reference.numerics")
    assert "speech_ssl_compression_tpu_torch" not in loaded
    assert harness.forbidden_loaded(loaded) == []


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "melhubert20.serve.f32.libri", "--seed", "2147483653",
         "--seconds", "1"], capture_output=True, text=True, cwd=ROOT,
        env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_only_the_benchmarks_files_are_not_enough(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "melhubert20.serve.f32.libri", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
