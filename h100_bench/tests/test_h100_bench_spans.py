"""The readers of the port's spans (``h100_bench/spans.py`` and the metrics
that read it) on hand-made traces, on the recorded fixture (a trace of a
program without spans: every such reader gives nothing, and the readers
that were there read the same with spans added) and on traced runs of the
cells on the CPU at tiny widths (host spans, no device)."""

import pathlib
import time

import pytest

from h100_bench import harness, spans
from h100_bench.tests import tiny
from h100_bench.trace import Trace

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "trace_serve.json"
SPEC = harness.load_benchmark()
MEL = harness.load_config(SPEC, "melhubert-20ms-base")
HUB = harness.load_config(SPEC, "hubert-base-ls960")
CARD = "NVIDIA H100 80GB HBM3"
PHASES = ("prep_idle_share.train", "dispatch_idle_share.train",
          "apply_idle_share.train")


def read(name, run):
    return harness.load_reader(name).read(run)


def make_run(kind, trace, units, model=MEL, dtype="float32"):
    return harness.Run(kind=kind, dtype=dtype, card=CARD, model=model,
                       setup_s=1.0, peak_bytes=0, window_s=trace.window_s,
                       trace=trace, units=units, attempted=len(units),
                       failed=0)


def test_idle_inside_host_phases_is_exact_and_parts_of_the_idle_share():
    device = [("k", 0.0, 0.2), ("k", 0.5, 0.6), ("k", 0.9, 1.0)]
    host = [("sslc.train.forward", 0.1, 0.4), ("sslc.train.backward",
                                               0.4, 0.55),
            ("sslc.train.apply", 0.6, 0.8), ("cudaLaunchKernel", 0.3, 0.31),
            ("sslc.train.upload", 0.85, 0.95)]
    t = Trace(device, host, 1.0)
    assert spans.idle_seconds_in(
        t, ("sslc.train.forward", "sslc.train.backward")) == (
        pytest.approx(0.2 + 0.1))
    assert spans.idle_seconds_in(t, ("sslc.train.apply",)) == (
        pytest.approx(0.2))
    assert spans.idle_seconds_in(t, ("sslc.train.upload",)) == (
        pytest.approx(0.05))
    run = make_run("train", t, [])
    shares = [read(m, run) for m in PHASES]
    assert shares == [pytest.approx(5.0), pytest.approx(30.0),
                      pytest.approx(20.0)]
    assert sum(shares) <= read("idle_share.train", run) + 1e-9


def test_port_spans_leave_the_readers_that_were_there_unchanged():
    fixture = Trace.from_json(FIXTURE.read_text())
    w = fixture.window_s
    spanned = Trace(fixture.device, fixture.host + [
        ("sslc.pos_conv.fwd", 0.1 * w, 0.2 * w),
        ("sslc.fbank", 0.3 * w, 0.9 * w)], w)
    assert spanned.busy_s() == fixture.busy_s()
    assert spanned.top_device_ops() == fixture.top_device_ops()
    units = [{"done_s": 0.1, "segments": [500], "flops": 1e12}]
    for name in ("idle_share.serve", "attn_roofline.serve"):
        assert read(name, make_run("serve", spanned, units)) == read(
            name, make_run("serve", fixture, units))


def test_without_the_port_spans_the_new_readers_give_nothing():
    fixture = Trace.from_json(FIXTURE.read_text())
    units = [{"done_s": 0.1, "segments": [500], "flops": 1e12}]
    for kind in ("serve", "train"):
        for trace in (fixture, Trace([("k", 0.0, 0.5)], [], 1.0)):
            for name in PHASES:
                assert read(name, make_run(kind, trace, units)) is None
    spanned = Trace([("k", 0.0, 0.5)], [("sslc.train.apply", 0.5, 0.9)],
                    1.0)
    assert read("apply_idle_share.train", make_run(
        "serve", spanned, units)) is None


@pytest.mark.parametrize("name", ["melhubert20.serve.f32.libri",
                                  "hubert-base.serve.f32.wave",
                                  "melhubert20.pretrain.bf16"])
def test_a_traced_cpu_run_reads_the_host_phases(name, tmp_path):
    cell = harness.find_cell(SPEC, name)
    config = tiny.config(cell["config"])
    changes = ({"crop_frames": 100, "pad_multiple": 32}
               if "pretrain" in name else {})
    mix = tiny.mix(cell["traffic"], trace_seconds=1.0, **changes)
    if mix["entry"] == "runner_update":
        mix["lengths"]["pool_batches"] = 32
    out, checks = harness.run_cell(
        harness.load_entry(mix["entry"]), config, mix, 2147483659, 1.0,
        True, "cpu", tmp_path, time.perf_counter(), CARD)
    got = harness.result_line(SPEC, cell, out, checks, True, CARD)["metrics"]
    if "pretrain" in name:
        assert set(PHASES) <= set(got)
        # no device on the CPU: every port phase's time is idle
        assert sum(got[m]["value"] for m in PHASES) <= (
            got["idle_share.train"]["value"] + 1e-9)
    names = {n for n, _, _ in out.trace.host}
    assert not any(n.startswith("sslc.") for n, _, _ in out.trace.device)
    want = {"melhubert20.serve.f32.libri": {"sslc.fbank",
                                            "sslc.pos_conv.fwd"},
            "hubert-base.serve.f32.wave": {"sslc.conv_frontend",
                                           "sslc.pos_conv.fwd"},
            "melhubert20.pretrain.bf16": {"sslc.train.upload",
                                          "sslc.train.span_mask",
                                          "sslc.train.forward",
                                          "sslc.train.backward",
                                          "sslc.train.apply",
                                          "sslc.pos_conv.fwd",
                                          "sslc.pos_conv.bwd"}}[name]
    assert want <= names
