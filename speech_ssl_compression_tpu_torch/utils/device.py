"""Device selection and matmul precision, shared by the extractors, the
trainers, the on-device featurizer and k-means.

``upload`` puts a host array on a device without a host fence: on a GPU it
goes through pinned memory with ``non_blocking=True``, and PyTorch's caching
host allocator records the copy's event on the pinned block, so the block
is not handed out again before the copy has completed.
"""

from __future__ import annotations

import contextlib
import subprocess

import numpy as np
import torch

PRECISIONS = ("default", "high", "highest")


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA where there is none: a run
    asked for the GPU never lands on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available "
            "(pass device='cpu' to run on the CPU)"
        )
    return dev


def card_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    power limit paces a loaded card, so it goes beside every time), or
    ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit unknown"


@contextlib.contextmanager
def matmul_precision(precision: str):
    """For the duration of a forward: "highest" turns TF32 off for both
    matmuls and cuDNN convolutions (true f32); "high" and "default" turn it
    on. The previous flags are restored on exit."""
    if precision not in PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {PRECISIONS}")
    tf32 = precision != "highest"
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``; on a GPU, pinned and
    non-blocking (the host does not wait for the stream to drain). On the
    CPU the tensor shares the array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
