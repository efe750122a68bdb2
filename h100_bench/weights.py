"""Seeded weights, made on the device in one draw.

A reference module lists its parameters as ``(name, shape, kind, scale)``
(the reference names, which the port's loaders take as they are);
:func:`make` draws one normal vector for all of them from the run's seed
on the device and cuts it into the leaves:

- ``normal``: ``scale`` times the draw;
- ``unit``: one plus ``scale`` times the draw (norm weights);
- ``wn_g``: the norm over its first two axes of the weight-normed kernel
  ``weight_v`` beside it (``scale`` unused), so that the kernel the conv
  sees is ``weight_v`` itself.
"""

from __future__ import annotations

import math

import torch

from .traffic import derive


def make(specs, seed: int, device) -> dict:
    sizes = [math.prod(shape) for _, shape, kind, _ in specs
             if kind != "wn_g"]
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind, scale in specs:
        if kind == "wn_g":
            continue
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape) * scale
        at += n
        if kind == "unit":
            leaf += 1.0
        elif kind != "normal":
            raise ValueError(f"unknown weight kind {kind!r} for {name}")
        out[name] = leaf
    for name, shape, kind, _ in specs:
        if kind == "wn_g":
            v = out[name[:-len("weight_g")] + "weight_v"]
            out[name] = torch.sqrt(torch.sum(v * v, dim=(0, 1),
                                             keepdim=True)).view(shape)
    return {k: out[k].contiguous() for k, _, _, _ in specs}
