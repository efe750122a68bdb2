"""Each cell's entry driven through a whole run on the CPU at tiny widths
(the harness's look for a card skipped): correct against the reference,
and not correct with the timed path broken underneath it."""

import pathlib
import time

import pytest

from h100_bench import faults, harness
from h100_bench.tests import tiny

SPEC = harness.load_benchmark()
CARD = "NVIDIA H100 80GB HBM3"
TRAIN = {"crop_frames": 100, "pad_multiple": 32}
CELLS = {
    "melhubert20.serve.f32.libri": ({}, ("half_batch", "altered_answer")),
    "hubert-base.serve.f32.wave": ({}, ("half_batch", "altered_answer")),
    "melhubert20.pretrain.bf16": (TRAIN, ("state_unchanged", "half_batch")),
}


def run(name: str, tmp_path: pathlib.Path, seed: int = 2147483659):
    cell = harness.find_cell(SPEC, name)
    changes, _ = CELLS[name]
    config = tiny.config(cell["config"])
    mix = tiny.mix(cell["traffic"], **changes)
    if mix["entry"] == "runner_update":
        mix["lengths"]["pool_batches"] = 32
    out, checks = harness.run_cell(
        harness.load_entry(mix["entry"]), config, mix, seed, 1.5, False,
        "cpu", tmp_path, time.perf_counter(), CARD)
    return harness.result_line(SPEC, cell, out, checks, False, CARD)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_is_correct(name, tmp_path):
    line = run(name, tmp_path)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == set(harness.cell_metrics(SPEC, name,
                                                            False))


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(CELLS)
                                        for f in CELLS[n][1]])
def test_a_broken_path_is_not_correct(name, fault, tmp_path):
    with faults.plant(fault):
        line = run(name, tmp_path)
    assert not line["correct"], line["checks"]
