"""Tracing and profiling over ``torch.profiler``.

Port of ``speech_ssl_compression_tpu/utils/profiling.py``: :func:`trace`
(JAX's over ``jax.profiler.start_trace``) records the CPU and, where there
is one, the CUDA activity of its block, every thread's, and writes a
Chrome trace into ``log_dir``; :func:`span` (in place of JAX's
``TraceAnnotation``) names a stretch of the port's work in it, and
:func:`span_device_seconds` reads the device time each span launched. JAX's
``start_server`` (a profiler server TensorBoard connects to) has no
PyTorch counterpart and is not ported.

The port's spans are named ``sslc.<layer>.<phase>`` and sit where the work
happens: the positional conv (``ops/grouped_conv.py``), the conv frontend,
the device fbank, and the trainer's upload, span mask, forward, backward
and apply. They are host ranges in kineto's trace, on the clock of the
device's events, with no copy on the device's timeline; with no profiler
running each costs one read of a flag.

Usage:
    from speech_ssl_compression_tpu_torch.utils.profiling import span, trace

    with trace("/tmp/torch-trace") as prof:   # prof: torch.profiler.profile
        with span("sslc.my.phase"):
            run_steps()
    span_device_seconds(prof)   # {"sslc.my.phase": device seconds, ...}
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import os
import time
from typing import Optional

import torch
from torch._C._profiler import _ExperimentalConfig, _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

_OFF = contextlib.nullcontext()  # stateless, so shared by every idle span


@contextlib.contextmanager
def trace(log_dir: Optional[str], host: bool = True):
    """Profile the block, on every thread (a prefetch worker's too);
    yields the ``torch.profiler.profile``. On exit a Chrome trace
    (``trace_<pid>_<ns>.json``) is written into ``log_dir`` (made if
    missing; None writes none, for a caller that reads the events alone).
    The CUDA device's activity is traced where there is one;
    ``host=False`` leaves the CPU's out (a trace of thousands of host ops
    takes seconds to read)."""
    activities = ([ProfilerActivity.CPU] if host else []) + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True))) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def span(name: str):
    """A span named ``name`` in the trace of a running profile, on the
    thread that enters it; with no profiler running, one shared no-op
    context (one read of a flag, nothing allocated). A plain operator
    range, not a user annotation: kineto lays no copy of it on the
    device's timeline, where it would stretch over the device's idle gaps
    inside it and read as busy. Its device time is read by correlation
    (:func:`span_device_seconds`)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)


def span_device_seconds(prof, prefix: str = "sslc.") -> dict:
    """The device seconds each span named ``prefix``* launched in the
    profile ``prof`` (host events recorded): per span name, the length of
    the union of the device operations whose launch (the runtime call
    with the operation's correlation ids) started inside a span of that
    name on its own thread. Operations launched at once on several
    streams count once; an outer span counts what its inner spans
    launched too."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        ids = (e.correlation_id(), e.linked_correlation_id())
        if e.device_type() == DeviceType.CPU:
            host.append((e.name(), e.start_thread_id(), e.start_ns(),
                         e.end_ns()) + ids)
        else:
            device.append((e.start_ns(), e.end_ns()) + ids)
    return {name: ns * 1e-9 for name, ns in
            attribute_device_time(host, device, prefix).items()}


def attribute_device_time(host, device, prefix: str = "sslc.") -> dict:
    """:func:`span_device_seconds` on plain records: ``host`` as (name,
    thread, start, end, correlation id, linked correlation id), ``device``
    as (start, end, correlation id, linked correlation id); returns {span
    name: the union's length}, in the records' unit.

    A device operation and the runtime call that launched it share both
    ids (kineto's own and the enclosing host operation's), so an
    operation launched outside every host operation (linked id 0) is
    outside every span and is not looked up: a host operation's own id
    may equal another's runtime id."""
    launched = {(corr, link): (thread, start)
                for _, thread, start, _, corr, link in host if link}
    spans = collections.defaultdict(list)  # (name, thread) -> [(s, e)]
    for name, thread, start, end, _, _ in host:
        if name.startswith(prefix):
            spans[name, thread].append((start, end))
    spans = {key: _merged(v) for key, v in spans.items()}
    names = {name for name, _ in spans}
    hits = collections.defaultdict(list)
    for start, end, corr, link in device:
        if not link or (corr, link) not in launched:
            continue
        thread, at = launched[corr, link]
        for name in names:
            runs = spans.get((name, thread))
            if runs is None:
                continue
            i = bisect.bisect_right(runs, (at, float("inf"))) - 1
            if i >= 0 and at <= runs[i][1]:
                hits[name].append((start, end))
    return {name: sum(e - s for s, e in _merged(v))
            for name, v in hits.items()}


def _merged(intervals) -> list:
    """Sorted disjoint (start, end) runs covering ``intervals``."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out
