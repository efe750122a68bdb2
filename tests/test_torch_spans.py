"""The port's trace spans (``utils/profiling.py::span``) on the CPU with tiny
models, under ``utils/profiling.trace(None)``: free and shared when no
profiler runs, recorded from any thread when one does, host ranges only;
the device fbank and the positional conv once per batch of
``forward_stream``, in input order; the trainer's upload, span mask,
forward, backward and apply once per micro-batch or update, with the
positional conv's forward and backward inside; HuBERT's conv frontend;
the same outputs, losses and parameters, bit for bit, with the profiler on
and off; and each span's device time by the launching thread and the
correlation ids, on hand-made records. On a card (``-m cuda``, skipped
elsewhere: ``python -m pytest --noconftest -m cuda
tests/test_torch_spans.py``), the positional conv's device time so read
against CUDA events."""

import threading
import tracemalloc
import types

import numpy as np
import pytest
import torch

from speech_ssl_compression_tpu_torch.configs import (
    HuBERTConfig,
    MelHuBERTConfig,
)
from speech_ssl_compression_tpu_torch.data.bucket_dataset import (
    PrefetchIterator,
)
from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
from speech_ssl_compression_tpu_torch.models.hubert import hubert_forward
from speech_ssl_compression_tpu_torch.ops.grouped_conv import grouped_conv1d
from speech_ssl_compression_tpu_torch.train.runner import Runner
from speech_ssl_compression_tpu_torch.train.steps import accumulate_grads
from speech_ssl_compression_tpu_torch.utils import profiling
from speech_ssl_compression_tpu_torch.utils.checkpoint import save_checkpoint
from speech_ssl_compression_tpu_torch.utils.device import matmul_precision
from speech_ssl_compression_tpu_torch.utils.profiling import (
    attribute_device_time,
    span,
    span_device_seconds,
    trace,
)
from speech_ssl_compression_tpu_torch.utils.weights import (
    init_hubert_params_np,
    init_params_np,
    load_wave_model,
)

MEL = dict(feat_emb_dim=80, encoder_layers=2, encoder_embed_dim=32,
           encoder_ffn_embed_dim=64, encoder_attention_heads=2, head_dim=16,
           conv_pos=8, conv_pos_groups=4, num_cluster=10, mask_prob=0.65,
           mask_length=4, dropout=0.1, attention_dropout=0.1,
           activation_dropout=0.1)
HUBERT = dict(encoder_layers=1, encoder_embed_dim=32,
              encoder_ffn_embed_dim=64, encoder_attention_heads=2,
              conv_feature_layers="[(32,10,5)] + [(32,3,2)] * 2",
              final_dim=16, conv_pos=8, conv_pos_groups=4)
TRAIN = ("sslc.train.upload", "sslc.train.span_mask", "sslc.train.forward",
         "sslc.train.backward", "sslc.train.apply")


def _spans(prof, prefix="sslc."):
    """The profile's host events named ``prefix``*, by start: (name,
    thread, start_us, end_us)."""
    return sorted(((e.name, e.thread, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith(prefix) and e.device_type.name
                   == "CPU"), key=lambda s: s[2])


def _names(spans):
    return [s[0] for s in spans]


def test_span_is_one_shared_no_op_without_a_profiler():
    assert span("sslc.a") is span("sslc.b")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with span("sslc.idle"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, profiling.__file__)]
    grown = after.filter_traces(only).compare_to(
        before.filter_traces(only), "lineno")
    assert sum(s.size_diff for s in grown) == 0


@pytest.mark.parametrize("worker", ["thread", "prefetch"])
def test_span_records_on_the_caller_and_on_a_worker_thread(worker):
    def work(tag):
        with span(f"sslc.test.{tag}"):
            return torch.ones(4).sum()

    with trace(None) as prof:
        work("main")
        if worker == "thread":
            t = threading.Thread(target=work, args=("worker",))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        else:  # forward_stream's prefetch worker
            assert len(list(PrefetchIterator(
                (work("worker") for _ in range(3)), depth=1))) == 3
    got = {s[0]: s[1] for s in _spans(prof)}
    assert set(got) == {"sslc.test.main", "sslc.test.worker"}
    assert got["sslc.test.main"] != got["sslc.test.worker"]
    # a plain op range, not a user annotation: no copy on the device
    scopes = {e.name: e.scope for e in prof.events()
              if e.name.startswith("sslc.")}
    assert set(scopes.values()) == {
        int(torch._C._profiler.RecordScope.FUNCTION)}
    assert span_device_seconds(prof) == {}  # no device on the CPU


def test_device_time_goes_to_the_span_open_on_the_launching_thread():
    """Host records (name, thread, start, end, id, linked id); device
    records (start, end, id, linked id): an operation's launch is the
    runtime call with both its ids."""
    host = [
        ("sslc.pos_conv.fwd", 1, 0, 100, 1, 0),
        ("aten::conv", 1, 10, 90, 2, 0),
        ("cudaLaunchKernel", 1, 20, 25, 50, 2),
        ("cudaLaunchKernel", 1, 30, 35, 51, 2),
        # a host op whose own id is a runtime call's (device op 54 below)
        ("aten::add", 1, 60, 70, 54, 0),
        ("aten::mul", 1, 120, 130, 3, 0),
        ("cudaLaunchKernel", 1, 121, 125, 52, 3),
        # autograd's thread, at once with the forward's span on thread 1
        ("sslc.pos_conv.bwd", 2, 40, 95, 4, 0),
        ("aten::bmm", 2, 45, 90, 5, 0),
        ("cudaLaunchKernel", 2, 50, 51, 53, 5),
        ("cudaDeviceSynchronize", 1, 300, 301, 60, 0)]
    device = [(200, 260, 50, 2), (210, 280, 51, 2),  # two streams at once
              (290, 300, 52, 3),                     # aten::mul's
              (280, 330, 53, 5),                     # the bwd's bmm
              (400, 410, 54, 0),                     # no enclosing op
              (420, 430, 99, 7)]                     # no launch recorded
    got = attribute_device_time(host, device)
    assert got == {"sslc.pos_conv.fwd": 80, "sslc.pos_conv.bwd": 50}
    host.append(("sslc.train.forward", 1, 0, 140, 6, 0))  # outer span
    assert attribute_device_time(host, device) == {
        "sslc.pos_conv.fwd": 80, "sslc.pos_conv.bwd": 50,
        "sslc.train.forward": 90}
    assert attribute_device_time(host, device, "sslc.pos_conv.b") == {
        "sslc.pos_conv.bwd": 50}


# ------------------------------------------------------- forward_stream

@pytest.fixture(scope="module")
def extractor(tmp_path_factory):
    cfg = MelHuBERTConfig.from_dict(MEL)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.npz"
    save_checkpoint(str(path), init_params_np(cfg, 0),
                    meta={"Upstream_Config": {"melhubert": cfg.to_dict()},
                          "Step": 0})
    return MelHuBERTExtractor(str(path), device="cpu", attn_impl="dense")


def _wav_batches():
    rng = np.random.default_rng(0)
    lengths = [(16000, 9000), (4000, 23000, 12000), (30000,), (7000, 7000)]
    return [[(0.1 * rng.standard_normal(n)).astype(np.float32) for n in b]
            for b in lengths]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("featurizer", ["device", "host"])
def test_forward_stream_spans_each_batch_in_order(extractor, depth,
                                                  featurizer):
    batches = _wav_batches()
    plain = list(extractor.forward_stream(iter(batches),
                                          featurizer=featurizer, depth=depth))
    with trace(None) as prof:
        with span("sslc.test.caller"):
            traced = list(extractor.forward_stream(
                iter(batches), featurizer=featurizer, depth=depth))
    convs = _spans(prof, "sslc.pos_conv.fwd")
    fbank = _spans(prof, "sslc.fbank")  # the device fbank's alone
    assert len(convs) == len(batches)
    assert len(fbank) == (len(batches) if featurizer == "device" else 0)
    caller = {s[1] for s in _spans(prof, "sslc.test.caller")}
    assert {s[1] for s in convs + fbank} == caller  # not the worker's
    for f, c in zip(fbank, convs):  # the n-th of each: one batch
        assert f[3] <= c[2]
    for a, b in zip(convs, convs[1:]):
        assert a[3] <= b[2]
    for a, b in zip(plain, traced):
        assert a["lengths"] == b["lengths"]
        for x, y in zip(a["hidden_states"], b["hidden_states"]):
            assert torch.equal(x, y)


# ------------------------------------------------------------- trainer

RUNNER_CFG = {
    "runner": {"n_epochs": 0, "total_steps": 1, "gradient_clipping": 10.0,
               "gradient_accumulate_steps": 2, "log_step": 1,
               "save_every_x_epochs": 100},
    "optimizer": {"lr": 1e-3, "betas": [0.9, 0.999], "eps": 1e-8,
                  "weight_decay": 0},
    "datarc": {"train_batch_size": 2, "max_timestep": 0, "sets": []},
}


def _runner(tmp_path):
    args = types.SimpleNamespace(mode="melhubert", expdir=str(tmp_path),
                                 seed=3, device="cpu", frame_period=20,
                                 initial_weight=None)
    return Runner(args, RUNNER_CFG, {"melhubert": dict(MEL),
                                     "task": {"sequence_length": 0}})


def _micro_batches(n=2, b=2, t=24):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        lengths = rng.integers(t // 2, t + 1, b)
        valid = np.arange(t)[None, :] < lengths[:, None]
        out.append({
            "feat": (rng.standard_normal((b, t, 80)) * valid[..., None]
                     ).astype(np.float32),
            "label": np.where(valid, rng.integers(0, 10, (b, t)), -100),
            "pad_mask": valid.astype(np.float32), "length": lengths})
    return out


def _update(r, batches):
    """One update as ``Runner.train``'s loop runs it."""
    acc, losses = None, []
    for batch in batches:
        loss, grads, _ = r.grad_step(r.params, r._device_batch(batch), r.rng,
                                     masks=r.masks)
        acc = accumulate_grads(acc, grads)
        losses.append(loss)
    acc, _ = r._reduce_window(acc, losses)
    r.apply(acc, float(len(batches)))
    return losses


def test_runner_update_spans_each_phase_once(tmp_path):
    batches = _micro_batches()
    plain_runner, traced_runner = _runner(tmp_path / "a"), _runner(
        tmp_path / "b")
    plain = _update(plain_runner, batches)
    with trace(None) as prof:
        traced = _update(traced_runner, batches)
    spans = _spans(prof)
    train = [s for s in spans if s[0] in TRAIN]
    n = len(batches)
    assert _names(train) == list(TRAIN[:4]) * n + ["sslc.train.apply"]
    for a, b in zip(train, train[1:]):  # one after another, none nested
        assert a[3] <= b[2]
    for name in ("sslc.pos_conv.fwd", "sslc.pos_conv.bwd"):
        assert len([s for s in spans if s[0] == name]) == n
    fwd = [s for s in train if s[0] == "sslc.train.forward"]
    for conv in (s for s in spans if s[0] == "sslc.pos_conv.fwd"):
        assert any(f[2] <= conv[2] and conv[3] <= f[3] for f in fwd)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    for k, p in plain_runner.params.items():
        assert torch.equal(p, traced_runner.params[k]), k


# -------------------------------------------------------------- HuBERT

def test_hubert_forward_spans_its_conv_frontend():
    cfg = HuBERTConfig.from_dict(HUBERT)
    model = load_wave_model(init_hubert_params_np(cfg, (12,), 0), cfg,
                            "hubert").eval()
    source = torch.randn(2, 4000, generator=torch.Generator().manual_seed(0))
    lengths = np.array([4000, 3100])
    with torch.no_grad():
        plain = hubert_forward(model, source, lengths, mask=False,
                               features_only=True, attn_impl="dense")
        with trace(None) as prof:
            traced = hubert_forward(model, source, lengths, mask=False,
                                    features_only=True, attn_impl="dense")
    assert _names(_spans(prof)) == ["sslc.conv_frontend",
                                    "sslc.pos_conv.fwd"]
    assert torch.equal(plain["x"], traced["x"])


# ---------------------------------------------------------- on the card

@pytest.mark.cuda
def test_pos_conv_span_covers_its_device_time_on_the_card():
    """At a serving batch's shape (16 utterances padded to 1280 frames,
    MelHuBERT's D = 768, K = 128, 16 groups, f32 with TF32 off), the
    device time ``sslc.pos_conv.fwd`` launched (by correlation; cuDNN
    spreads the groups over streams of its own) matches what CUDA events
    time the calls at, within 10%; the backward's span, on autograd's
    thread, is read too, and no span leaves a copy on the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.autograd import DeviceType

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(16, 1280, 768, device="cuda", generator=gen)
    w = 0.01 * torch.randn(128, 48, 768, device="cuda", generator=gen)
    n = 20
    with matmul_precision("highest"):
        for _ in range(3):
            grouped_conv1d(x, w, 16, (64, 64))
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(n):
            grouped_conv1d(x, w, 16, (64, 64))
        end.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(end) / n
        with trace(None) as prof:
            for _ in range(n):
                grouped_conv1d(x, w, 16, (64, 64))
            torch.cuda.synchronize()
        xg = x[:4].clone().requires_grad_(True)
        with trace(None) as grad_prof:
            grouped_conv1d(xg, w, 16, (64, 64)).sum().backward()
            torch.cuda.synchronize()
    span_ms = span_device_seconds(prof)["sslc.pos_conv.fwd"] * 1e3 / n
    bwd = span_device_seconds(grad_prof)
    streams = {e.device_resource_id()
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA}
    print(f"[pos-conv span] {torch.cuda.get_device_name(0)}: CUDA events "
          f"{event_ms:.4f} ms a call; launched in the span {span_ms:.4f} ms "
          f"(on {len(streams)} streams); backward at B = 4: "
          f"{1e3 * bwd.get('sslc.pos_conv.bwd', 0.0):.4f} ms")
    assert abs(span_ms / event_ms - 1.0) < 0.10
    assert bwd.get("sslc.pos_conv.bwd", 0.0) > 0
    for p in (prof, grad_prof):
        assert not any(e.name().startswith("sslc.")
                       for e in p.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA)
