#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's
own size, all seeds in one process:

    python3 h100_bench/controls.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault half_batch --fault-seeds 1,2,3]

For each of ``--seeds`` the cell's set-up, a short window at its load
(``--seconds``) and its check's numbers: the program's readings, whose
largest over the seeds is a limit's lower reading. For each of
``--control-seeds`` the same numbers with the reference, computed one step
below the configuration's precision (the mix's ``check.control``), in the
program's place: the upper reading. For each of ``--fault-seeds`` the
program's readings with ``--fault`` planted (``faults.py``). One JSON line
per reading; the benchmark's own runs never run this.
"""

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
os.environ["CUDA_CACHE_PATH"] = str(ROOT / ".bench_cache" / "cuda")
sys.path.insert(0, str(ROOT))

from h100_bench import faults, harness  # noqa: E402


def readings(entry, config, mix, seed, seconds, device, control=None):
    """One seed's readings: the program's, or with ``control`` the
    reference in that arithmetic in the program's place."""
    import torch

    with tempfile.TemporaryDirectory(prefix="h100_bench_") as work:
        cell = entry.Cell(config, mix, seed, device, pathlib.Path(work))
        cell.warm()
        cell.window(seconds)
        cell.release()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        return cell.control(control) if control else cell.readings()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=faults.FAULTS)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    spec = harness.load_benchmark()
    cell = harness.find_cell(spec, args.workload)
    config = harness.load_config(spec, cell["config"])
    mix = harness.mix_for(cell)
    entry = harness.load_entry(mix["entry"])

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    plan = ([("program", s) for s in seeds(args.seeds)]
            + [("control", s) for s in seeds(args.control_seeds)]
            + [(args.fault, s) for s in seeds(args.fault_seeds)])
    for kind, seed in plan:
        t0 = time.perf_counter()
        if kind in faults.FAULTS:
            with faults.plant(kind):
                got = readings(entry, config, mix, seed, args.seconds,
                               "cuda")
        else:
            got = readings(entry, config, mix, seed, args.seconds,
                           "cuda", mix["check"]["control"]
                           if kind == "control" else None)
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "readings": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
