"""What every cell shares: finding a cell and its files by name, running
its entry through set-up, the window and the check, reading its metrics,
and the result line.

An entry (``entries/<entry>.py``) defines ``Cell(config, mix, seed,
device, workdir)``, whose construction and :meth:`warm` are the set-up,
:meth:`window` the measured work, :meth:`release` frees the port's state
and :meth:`check` compares what the window produced with the reference.
A metric (``metrics/<metric>.py``) defines ``read(run)``, which returns a
number, or None where the run has nothing for it to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import sys
import time

from . import traffic
from .trace import traced

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "speech_ssl_compression_tpu")


def forbidden_loaded(modules=None) -> list:
    """The top-level names of ``FORBIDDEN`` among the loaded modules, each
    compared whole: the port's name begins with the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    return json.loads(path.read_text())


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(spec: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == name:
            return json.loads((root / entry["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def _load_file(path: pathlib.Path, kind: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} {path.stem!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_{kind}_{path.stem}".replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_entry(name: str):
    return _load_file(HERE / "entries" / f"{name}.py", "entry")


def load_reader(name: str):
    return _load_file(HERE / "metrics" / f"{name}.py", "metric")


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The names of the metrics a run of ``cell`` reports: its end-to-end
    metrics (trace 0) or its per-layer ones (trace 1), each where its
    ``workloads`` name the cell or, without them, where the cell reports
    the end-to-end metric it moves."""
    def listed(metric):
        return "workloads" not in metric or cell in metric["workloads"]

    e2e = [m["name"] for m in spec["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    return [m["name"] for m in spec["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def torch_dtype(name: str):
    """The torch dtype a mix names ("float32", "bfloat16")."""
    import torch

    if name not in ("float32", "bfloat16"):
        raise ValueError(f"unknown dtype {name!r}")
    return getattr(torch, name)


def program_section(config: dict) -> dict:
    """The port's config section the configuration file points at: its
    YAML's section, or (in the tests) a section given inline."""
    prog = config["program"]
    if "inline" in prog:
        return dict(prog["inline"])
    from speech_ssl_compression_tpu_torch.configs import read_yaml

    return dict(read_yaml(ROOT / prog["yaml"])[prog["section"]])


def _plain(value):
    if isinstance(value, (tuple, list)):
        return [_plain(v) for v in value]
    return value


def check_program_config(config: dict, program_cfg) -> None:
    """Refuse to run where the port's config, read from its YAML, differs
    from what the configuration file states (a per-layer width against
    each layer's)."""
    for key, want in config.items():
        if not hasattr(program_cfg, key) or isinstance(want, dict):
            continue
        got = _plain(getattr(program_cfg, key))
        same = (got == want or (isinstance(got, list) and got
                                and not isinstance(want, list)
                                and all(v == want for v in got)))
        if not same:
            raise ValueError(f"the port's {key} is {got!r}, the "
                             f"configuration states {want!r}")


class Run:
    """What the metric readers read: the cell's kind and numerics, the
    window's units of work (one per batch or update, each with the
    seconds from the window's start at which it was done), set-up, peak
    memory and, in a traced run, the trace."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def done(self) -> list:
        """The units finished inside the window."""
        return [u for u in self.units if u["done_s"] <= self.window_s]


def run_cell(entry, config: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device, workdir, t_start: float, card: str,
             clock=time.perf_counter) -> tuple:
    """Set-up, window, release, check. Returns (Run, checks), where
    ``checks`` is a list of (name, value, limit)."""
    import torch

    cuda = torch.device(device).type == "cuda"
    cell = entry.Cell(config, mix, seed, device, workdir)
    cell.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = clock() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    window_s = min(seconds, float(mix.get("trace_seconds", seconds))
                   ) if trace else seconds
    with traced(trace, clock) as held:
        window = cell.window(window_s)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    t_check = clock()
    cell.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = cell.check()
    window_wall = t_check - t_start - setup_s
    print(f"[bench] set-up {setup_s:.2f} s, window {window_wall:.2f} s, "
          f"check {clock() - t_check:.2f} s", file=sys.stderr, flush=True)
    run = Run(kind=cell.kind, dtype=mix["dtype"], card=card,
              model=config, setup_s=setup_s, peak_bytes=peak,
              window_s=window_s if held.trace is None
              else held.trace.window_s,
              trace=held.trace, **window)
    return run, checks


def result_line(spec: dict, cell: dict, run: Run, checks: list,
                trace: bool, kind: str) -> dict:
    metrics = {}
    units = {m["name"]: m["unit"]
             for m in spec["end_to_end"] + spec["per_layer"]}
    for name in cell_metrics(spec, cell["name"], trace):
        value = load_reader(name).read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": run.peak_bytes}
    correct = (bool(checks) and all(v <= lim for _, v, lim in checks)
               and run.attempted > 0 and run.failed == 0)
    line = {"correct": correct,
            "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    return line


def mix_for(cell: dict) -> dict:
    return traffic.load_mix(cell["traffic"])
