"""The controls on the card: the reference computed one step below each
cell's precision (TF32 for the f32 cells, float8 operands for the bf16
one) in the port's place fails the cell's limits, and the port at the same
size passes them. At the cells' widths with a small pool of short
utterances; the cell-sized readings come from ``controls.py``.

    python -m pytest h100_bench/tests/test_h100_bench_controls.py
"""

import pytest

from h100_bench import controls, harness

SPEC = harness.load_benchmark()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the controls lower the card's "
                    "arithmetic (TF32), which the CPU does not have")
    return "cuda"


def small(cell):
    config = harness.load_config(SPEC, cell["config"])
    mix = harness.mix_for(cell)
    mix["lengths"].update(mean_s=4.0, max_s=8.0)
    if mix["entry"] != "runner_update":
        mix["lengths"]["pool_batches"] = 2
        mix["batch"] = 4
    return config, mix


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c["name"] for c in SPEC["workloads"]])
def test_the_control_fails_and_the_port_passes(name, card):
    cell = harness.find_cell(SPEC, name)
    config, mix = small(cell)
    entry = harness.load_entry(mix["entry"])
    limits = mix["check"]["limits"]
    seed = 2147483677
    port = controls.readings(entry, config, mix, seed, 1.0, card)
    control = controls.readings(entry, config, mix, seed, 1.0, card,
                                mix["check"]["control"])
    assert all(port[k] <= limits[k] for k in limits), port
    assert any(control[k] > limits[k] for k in limits), control
