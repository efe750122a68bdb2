#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the card(s) of this machine.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Set-up (building the port's kernels on a
first run, making the weights and the traffic from the seed, warming
every shape the cell uses) is timed as ``setup_s``; then the window runs
for ``--seconds`` (with ``--trace 1``: the mix's ``trace_seconds``, under
the profiler); then the port's state is freed and what the window produced
is compared with the plain reference. Standard error ends with each number
compared beside its limit; the last line of standard output is the
result, a JSON object. Without a CUDA card, or with fewer than the cell
asks for, it exits 3 and prints no result.
"""

import time

T_START = time.perf_counter()  # set-up is timed from the process's start

import argparse
import json
import os
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"  # fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.load_benchmark(ROOT)
    cell = harness.find_cell(spec, args.workload)
    config = harness.load_config(spec, cell["config"])
    mix = harness.mix_for(cell)

    import torch

    if not torch.cuda.is_available():
        print("[bench] no CUDA device: this benchmark measures the card "
              "and does not run on the CPU", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"[bench] {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    from speech_ssl_compression_tpu_torch.utils.device import card_label

    kind = torch.cuda.get_device_name(0)
    print(f"[bench] {cell['name']} seed {args.seed}: {card_label('cuda')}, "
          f"torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)

    tmp = pathlib.Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    with tempfile.TemporaryDirectory(prefix="h100_bench_", dir=tmp) as work:
        run, checks = harness.run_cell(
            harness.load_entry(mix["entry"]), config, mix, args.seed,
            args.seconds, bool(args.trace), "cuda", pathlib.Path(work),
            T_START, kind)
    found = harness.forbidden_loaded()
    if found:
        print(f"[bench] loaded in this process: {', '.join(found)}; the "
              "benchmark imports neither JAX nor the JAX package",
              file=sys.stderr)
        return 4
    line = harness.result_line(spec, cell, run, checks, bool(args.trace),
                               kind)
    for name, value, limit in checks:
        print(f"[check] {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
