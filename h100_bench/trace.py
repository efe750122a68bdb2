"""The traced window: ``torch.profiler`` over the device and the host, read
into plain records that the metric readers take.

A record is ``(name, start_s, end_s)``, seconds from the window's start.
``device`` holds every operation on the card (kernels, copies, sets),
``host`` every host operation and the benchmark's own spans
(``bench.*``, from :func:`span`). The readers work on these lists alone,
so they are tested on a recorded fixture without a card.
"""

from __future__ import annotations

import collections
import contextlib
import heapq
import json

from torch.profiler import ProfilerActivity, profile, record_function


def span(name: str):
    """A host span in the trace around a call into the port."""
    return record_function(name)


class Trace:
    def __init__(self, device: list, host: list, window_s: float):
        self.device = device
        self.host = host
        self.window_s = window_s

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        d = json.loads(text)
        return cls([tuple(e) for e in d["device"]],
                   [tuple(e) for e in d["host"]], d["window_s"])

    def to_json(self) -> str:
        return json.dumps({"device": self.device, "host": self.host,
                           "window_s": self.window_s})

    def busy_s(self) -> float:
        """The length of the union of the device's operation intervals."""
        return sum(end - start for start, end in self.busy_intervals())

    def busy_intervals(self) -> list:
        out = []
        for _, start, end in sorted(self.device, key=lambda e: e[1]):
            start, end = max(start, 0.0), min(end, self.window_s)
            if end <= start:
                continue
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return out

    def kernel_seconds(self, fragments) -> float:
        """Device seconds of the operations whose names hold any of
        ``fragments``."""
        return sum(end - start for name, start, end in self.device
                   if any(f in name for f in fragments))

    def top_device_ops(self, n: int = 10) -> list:
        total = collections.Counter()
        for name, start, end in self.device:
            total[name] += end - start
        return [[k, v] for k, v in total.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device seconds by what the host was doing: each gap between
        the device's busy intervals goes to the innermost host operation
        (the latest started) that spans its middle, ``idle`` where none
        does, summed by name. One sweep over both, in time order."""
        gaps, at = [], 0.0
        for start, end in self.busy_intervals() + [[self.window_s] * 2]:
            if start > at:
                gaps.append((at, start))
            at = max(at, end)
        host = sorted(self.host, key=lambda e: e[1])
        total, active, i = collections.Counter(), [], 0
        for g0, g1 in gaps:  # in time order, so their middles rise
            mid = (g0 + g1) / 2
            while i < len(host) and host[i][1] <= mid:
                name, start, end = host[i]
                heapq.heappush(active, (-start, end, name))
                i += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)  # ended: ends before every later middle
            label = "idle"
            if active:
                label = active[0][2]
            total[label] += g1 - g0
        return [[k, v] for k, v in total.most_common(n)]


@contextlib.contextmanager
def traced(enabled: bool, clock):
    """Profile the block when ``enabled`` (device and host); yields a
    holder whose ``trace`` is set on exit, with the window measured by
    ``clock`` (``time.perf_counter``) from entry to exit."""
    holder = type("Held", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            t0 = clock()
            yield holder
            t1 = clock()
    holder.trace = _read(prof, t1 - t0)


def _read(prof, window_s: float) -> Trace:
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    marks = [e for e in events if e.name() == "bench.window"]
    t0 = marks[0].start_ns() if marks else min(e.start_ns() for e in events)
    device, host = [], []
    for e in events:
        rec = (e.name(), (e.start_ns() - t0) * 1e-9, (e.end_ns() - t0) * 1e-9)
        if e.device_type() == DeviceType.CUDA:
            if not e.name().startswith("bench."):  # the spans' device copies
                device.append(rec)
        elif e.name() != "bench.window":
            host.append(rec)
    return Trace(device, host, window_s)
