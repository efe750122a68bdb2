"""The port's host spans in a traced window: what the readers of the
trainer's phases share.

The port names its work ``sslc.<layer>.<phase>``
(``speech_ssl_compression_tpu_torch/utils/profiling.py::span``): host
ranges, which stand in ``Trace.host`` and leave no copy among
``Trace.device``, so the device's busy time reads as it did before the
port had spans. A phase's idle seconds are the device's idle time
(the window less the busy union that ``idle_share.*`` reads) inside the
phase's host intervals, read from :class:`~h100_bench.trace.Trace` as
it is.
"""

from __future__ import annotations

from h100_bench.trace import Trace


def _overlap(a: list, b: list) -> float:
    """The length of the intersection of two sorted disjoint unions."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_seconds_in(trace: Trace, names) -> float:
    """The device's idle seconds inside the host intervals of the port's
    spans ``names``, in the window: their union less its busy part."""
    inside = Trace([r for r in trace.host if r[0] in names], [],
                   trace.window_s).busy_intervals()
    return (sum(end - start for start, end in inside)
            - _overlap(inside, trace.busy_intervals()))


def train_idle_share(run, names):
    """The share of a traced training window in which the card was idle
    inside the trainer's spans ``names``, in percent; None off a traced
    training run or where the port has none of these spans."""
    if (run.kind != "train" or run.trace is None
            or not any(n in names for n, _, _ in run.trace.host)):
        return None
    return 100.0 * idle_seconds_in(run.trace, names) / run.trace.window_s
