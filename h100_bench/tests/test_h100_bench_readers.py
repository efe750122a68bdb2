"""The metric readers and the trace's arithmetic, on a trace recorded on
the card (``fixtures/trace_serve.json``: the first events of a traced
window of ``melhubert20.serve.f32.libri``) and on hand-made ones."""

import json
import pathlib

import pytest

from h100_bench import harness
from h100_bench.trace import Trace

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "trace_serve.json"
SPEC = harness.load_benchmark()
MEL = harness.load_config(SPEC, "melhubert-20ms-base")
CARD = "NVIDIA H100 80GB HBM3"


def read(name, run):
    return harness.load_reader(name).read(run)


def serve_run(trace=None, units=None, window_s=1.0):
    units = units if units is not None else [
        {"done_s": 0.4, "latency_s": 0.30, "valid_frames": 900,
         "computed_frames": 1000, "flops": 2.0e12, "segments": [500, 400]},
        {"done_s": 0.9, "latency_s": 0.50, "valid_frames": 700,
         "computed_frames": 1000, "flops": 1.3e12, "segments": [700]},
        {"done_s": 1.2, "latency_s": 0.40, "valid_frames": 800,
         "computed_frames": 1000, "flops": 1.0e12, "segments": [800]}]
    return harness.Run(kind="serve", dtype="float32", card=CARD, model=MEL,
                       setup_s=12.5, peak_bytes=3 * 2 ** 30,
                       window_s=window_s, trace=trace, units=units,
                       attempted=len(units), failed=0)


def test_busy_is_the_union_of_device_intervals():
    t = Trace([("gemm", 0.0, 0.3), ("conv", 0.15, 0.5), ("attn", 0.7, 0.8),
               ("copy", 0.95, 1.5)], [], 1.0)
    assert t.busy_s() == pytest.approx(0.5 + 0.1 + 0.05)  # clipped at 1.0
    assert t.kernel_seconds(("gemm", "attn")) == pytest.approx(0.4)
    assert t.top_device_ops(2) == [["copy", pytest.approx(0.55)],
                                   ["conv", pytest.approx(0.35)]]


def test_idle_gaps_go_to_the_innermost_host_op():
    device = [("k", 0.0, 0.2), ("k", 0.5, 0.6), ("k", 0.9, 1.0)]
    host = [("bench.next_batch", 0.0, 1.0), ("cudaMalloc", 0.3, 0.4),
            ("bench.fence", 0.6, 0.7)]
    gaps = dict(map(tuple, Trace(device, host, 1.0).idle_gaps()))
    # (0.2, 0.5): middle 0.35 inside cudaMalloc; (0.6, 0.9): middle 0.75,
    # bench.fence has ended, the batch's span still runs
    assert gaps == {"cudaMalloc": pytest.approx(0.3),
                    "bench.next_batch": pytest.approx(0.3)}


def test_recorded_trace():
    t = Trace.from_json(FIXTURE.read_text())
    assert 0 < t.busy_s() <= t.window_s
    assert t.kernel_seconds(("flash_attn_fwd",)) > 0
    total_idle = sum(v for _, v in t.idle_gaps(n=10 ** 6))
    assert total_idle == pytest.approx(t.window_s - t.busy_s(), abs=1e-9)
    assert Trace.from_json(t.to_json()).device == t.device


def test_serving_end_to_end_readers():
    run = serve_run()
    assert read("serve_frames_per_s", run) == 1600.0  # the third ends late
    assert read("serve_batch_p95_ms", run) == pytest.approx(500.0)
    assert read("peak_mem_gib", run) == 3.0
    assert read("setup_s", run) == 12.5
    assert read("train_frames_per_s", run) is None


def test_p95_is_the_nearest_rank():
    units = [{"done_s": 0.1, "latency_s": i / 1000.0} for i in range(1, 101)]
    assert read("serve_batch_p95_ms", serve_run(units=units)) == (
        pytest.approx(95.0))


def test_pack_fill_and_mfu_arithmetic():
    t = Trace([("flash_attn_fwd_f32_kernel", 0.0, 0.01)], [], 1.0)
    run = serve_run(trace=t)
    assert read("pack_fill.serve", run) == pytest.approx(80.0)
    assert read("mfu.serve", run) == pytest.approx(
        100 * 3.3e12 / 1.0 / (495e12 / 3))
    assert read("mfu.serve", serve_run()) is None  # untraced
    assert read("mfu.train", run) is None  # a serving cell


def test_attention_roofline_counts_the_segments():
    spent = 0.01
    t = Trace([("flash_attn_fwd_f32_kernel", 0.0, spent)], [], 1.0)
    need = 0.0
    for segs in ([500, 400], [700]):
        f = sum(4 * s * s * 768 for s in segs)
        b = sum(4 * s * 768 * 4 for s in segs)
        need += max(f / (495e12 / 3), b / 3.35e12)
    assert read("attn_roofline.serve", serve_run(trace=t)) == pytest.approx(
        100 * 12 * need / spent)
    assert read("attn_roofline.serve", serve_run(
        trace=Trace([], [], 1.0))) is None  # nothing to read: no share of 0


def test_idle_share():
    t = Trace([("k", 0.0, 0.75)], [], 1.0)
    assert read("idle_share.serve", serve_run(trace=t)) == pytest.approx(25.0)
    assert read("idle_share.train", serve_run(trace=t)) is None


def test_result_line_lists_the_cells_metrics_and_checks_last():
    cell = harness.find_cell(SPEC, "melhubert20.serve.f32.libri")
    line = harness.result_line(SPEC, cell, serve_run(),
                               [("hidden_rel_l2", 1e-6, 1e-5)], False, CARD)
    assert set(line["metrics"]) == {"serve_frames_per_s",
                                    "serve_batch_p95_ms", "peak_mem_gib",
                                    "setup_s"}
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    bad = harness.result_line(SPEC, cell, serve_run(),
                              [("hidden_rel_l2", 1e-4, 1e-5)], False, CARD)
    assert bad["correct"] is False
    json.dumps(line)


def test_every_metric_has_a_reader_and_every_cell_its_metrics():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        harness.load_reader(m["name"])
    for cell in SPEC["workloads"]:
        e2e = harness.cell_metrics(SPEC, cell["name"], False)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(SPEC, cell["name"], True)
