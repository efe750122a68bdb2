"""Activation registry, mirroring
``speech_ssl_compression_tpu/ops/activations.py::ACTIVATIONS``.

``gelu`` is the exact erf form computed in float32 and cast back, the
reference's semantics. The JAX package evaluates erf through a tanh
polynomial (a workaround for slow erf on the TPU) that stays within
1.24e-7 of it. ``gelu_accurate``/``gelu_fast`` are the tanh approximation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float()).to(x.dtype)


def gelu_accurate(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (
        1 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x**3))
    )


ACTIVATIONS = {
    "relu": F.relu,
    "gelu": gelu,
    "gelu_exact": gelu,
    "gelu_fast": gelu_accurate,
    "gelu_accurate": gelu_accurate,
    "tanh": torch.tanh,
    "linear": lambda x: x,
}


def get_activation_fn(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise RuntimeError(f"--activation-fn {name} not supported") from None
