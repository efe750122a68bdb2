"""Activation registry, mirroring
``speech_ssl_compression_tpu/ops/activations.py::ACTIVATIONS``.

``gelu`` is the exact erf form computed in float32 (float64 stays float64)
and cast back, the reference's semantics. The JAX package evaluates erf through a tanh
polynomial (a workaround for slow erf on the TPU) that stays within
1.24e-7 of it. ``gelu_accurate``/``gelu_fast`` are the tanh approximation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or as it is if it is float64: the port's f32 islands
    (norms, GELU, softmax, losses) stay exact in a float64 reference run."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(at_least_f32(x)).to(x.dtype)


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
