"""Tracing and profiling over ``torch.profiler``.

Port of ``speech_ssl_compression_tpu/utils/profiling.py``: :func:`trace`
(JAX's over ``jax.profiler.start_trace``) records the CPU and, where there
is one, the CUDA activity of its block and writes a Chrome trace into
``log_dir``; :func:`annotate` (JAX's ``TraceAnnotation`` decorator) names
a function's span in it through ``record_function``. JAX's
``start_server`` (a profiler server TensorBoard connects to) has no
PyTorch counterpart and is not ported.

Usage:
    from speech_ssl_compression_tpu_torch.utils.profiling import (
        annotate, trace)

    with trace("/tmp/torch-trace") as prof:   # prof: torch.profiler.profile
        run_steps()
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: Optional[str], host: bool = True):
    """Profile the block; yields the ``torch.profiler.profile``. On exit a
    Chrome trace (``trace_<pid>_<ns>.json``) is written into ``log_dir``
    (made if missing; None writes none, for a caller that reads the
    events alone). The CUDA device's activity is traced where there is
    one; ``host=False`` leaves the CPU's out (a trace of thousands of host
    ops takes seconds to read)."""
    activities = ([ProfilerActivity.CPU] if host else []) + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Decorator: the function's calls appear as spans named ``name`` in
    a trace."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
