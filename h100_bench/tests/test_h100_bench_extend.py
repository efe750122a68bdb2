"""A later change adds a configuration, a traffic mix, an entry and a
per-layer metric as new files and entries, and edits no file that exists:
shown on a copy of the benchmark with a throwaway entry that runs on the
CPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

ENTRY = '''
import time

import torch


class Cell:
    kind = "serve"

    def __init__(self, config, mix, seed, device, workdir):
        self.n = int(mix["batch"]) * config["width"]
        self.x = torch.randn(self.n, generator=torch.Generator().manual_seed(
            seed))

    def warm(self):
        self.y = self.x.cumsum(0)

    def window(self, seconds):
        units, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.y = self.x.cumsum(0)
            units.append({"done_s": time.perf_counter() - t0,
                          "latency_s": 1e-3, "valid_frames": self.n,
                          "computed_frames": self.n, "flops": self.n,
                          "segments": []})
        return {"units": units, "attempted": len(units), "failed": 0}

    def release(self):
        pass

    def check(self):
        return [("cumsum_gap", float((self.y[-1] - self.x.sum()).abs()),
                 1e-3)]
'''
METRIC = '''
def read(run):
    return float(len(run.done()))
'''
RUN = '''
import json, pathlib, sys, time
from h100_bench import harness
spec = harness.load_benchmark()
cell = harness.find_cell(spec, "toy.serve")
config = harness.load_config(spec, cell["config"])
mix = harness.mix_for(cell)
for trace in (False, True):
    run, checks = harness.run_cell(harness.load_entry(mix["entry"]), config,
                                   mix, 7, 0.2, False, "cpu",
                                   pathlib.Path("."), time.perf_counter(),
                                   "cpu")
    print(json.dumps(harness.result_line(spec, cell, run, checks, trace,
                                         "cpu")))
'''


def test_a_new_cell_needs_only_new_files(tmp_path):
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "h100_bench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "h100_bench"
    (b / "entries" / "toy_cumsum.py").write_text(ENTRY)
    (b / "metrics" / "batches.serve.py").write_text(METRIC)
    (b / "configs" / "toy.json").write_text(json.dumps({"width": 64}))
    mix = {"name": "toy-mix", "entry": "toy_cumsum", "batch": 4,
           "dtype": "float32", "why": "a throwaway"}
    (b / "traffic" / "toy-mix.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "toy", "source": "a test",
                             "file": "h100_bench/configs/toy.json",
                             "reduced": [], "why": "a throwaway"})
    bench["workloads"].append({"name": "toy.serve", "config": "toy",
                               "traffic": "toy-mix", "chips": 1,
                               "why": "a throwaway"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_frames_per_s":
            m["workloads"].append("toy.serve")
    bench["per_layer"].append({"name": "batches.serve", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves":
                               "serve_frames_per_s",
                               "workloads": ["toy.serve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", RUN], capture_output=True,
                         text=True, cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 0, out.stderr
    plain, traced = (json.loads(line) for line in
                     out.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"serve_frames_per_s", "peak_mem_gib",
                                     "setup_s"}
    assert set(traced["metrics"]) == {"batches.serve"}
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there was edited
