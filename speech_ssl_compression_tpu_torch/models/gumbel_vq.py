"""Gumbel-softmax vector quantizer of wav2vec 2.0.

Port of ``speech_ssl_compression_tpu/models/gumbel_vq.py`` (reference
fairseq_code/gumbel_vector_quantizer.py): :class:`GumbelVectorQuantizer`
holds ``vars`` (1, G * V, var_dim) and ``weight_proj`` under the reference
names (a Linear for depth 1; for depth > 1 a Sequential of
[Linear, GELU] blocks and the logits Linear, keys ``weight_proj.{i}.0.*``
and ``weight_proj.{depth - 1}.*``). :func:`gumbel_vq_forward` is the
forward: the hard one-hot of the argmax and both perplexities in f32, the
Gumbel softmax in f32 with the straight-through estimator when training,
the code ids, and the codebook combine as a grouped matmul. The
temperature is an argument (the trainer anneals it on the host per step,
:func:`anneal_temp`); the Gumbel noise's uniforms come from an explicit
generator on the logits' device, or are passed in.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import at_least_f32, gelu
from ..parallel.mesh import sum_over_data


class GumbelVectorQuantizer(nn.Module):
    def __init__(self, dim: int, num_vars: int, groups: int, vq_dim: int,
                 weight_proj_depth: int = 1, weight_proj_factor: int = 1):
        super().__init__()
        assert vq_dim % groups == 0
        self.vars = nn.Parameter(
            torch.zeros(1, groups * num_vars, vq_dim // groups))
        if weight_proj_depth > 1:
            inner = dim * weight_proj_factor
            blocks = [nn.Sequential(nn.Linear(dim if i == 0 else inner, inner),
                                    nn.GELU())
                      for i in range(weight_proj_depth - 1)]
            self.weight_proj = nn.Sequential(
                *blocks, nn.Linear(inner, groups * num_vars))
        else:
            self.weight_proj = nn.Linear(dim, groups * num_vars)


def _weight_proj(proj: nn.Module, x2d: torch.Tensor) -> torch.Tensor:
    """The logits: one Linear, or the depth > 1 MLP with the exact GELU
    between its layers (JAX ``_weight_proj``)."""
    if isinstance(proj, nn.Linear):
        return proj(x2d)
    *blocks, final = proj
    for block in blocks:
        x2d = gelu(block[0](x2d))
    return final(x2d)


def anneal_temp(temp_cfg, num_updates: int) -> float:
    """max(max_t * decay^num_updates, min_t) (reference set_num_updates,
    gumbel_vector_quantizer.py:95-99)."""
    max_t, min_t, decay = temp_cfg
    return max(max_t * (decay ** num_updates), min_t)


def sample_from_codebook(vq: GumbelVectorQuantizer,
                         generator: Optional[torch.Generator], b: int, n: int,
                         *, num_vars: int, groups: int) -> torch.Tensor:
    """``n`` uniform random codewords per row (reference :124-135): one
    uniform index per group, the groups' codevectors concatenated.
    Returns (b, n, vq_dim)."""
    if n >= num_vars ** groups:
        raise ValueError(f"sample size {n} is greater than size of codebook "
                         f"{num_vars ** groups}")
    idx = torch.randint(0, num_vars, (b, n, groups), generator=generator,
                        device=vq.vars.device)
    cb = vq.vars.reshape(groups, num_vars, -1)  # (G, V, var_dim)
    z = cb[torch.arange(groups, device=cb.device), idx]  # (b, n, G, var_dim)
    return z.reshape(b, n, -1)


def gumbel_vq_forward(
    vq: GumbelVectorQuantizer,
    x: torch.Tensor,  # (B, T, C)
    *,
    num_vars: int,
    groups: int,
    temperature: float,
    training: bool = True,
    generator: Optional[torch.Generator] = None,  # on x's device
    uniform: Optional[torch.Tensor] = None,  # (B * T * G, V) in [0, 1)
    produce_targets: bool = False,
    mesh=None,
) -> dict:
    """Port of JAX ``gumbel_vq_forward``. Returns {"x" (B, T, vq_dim),
    "num_vars" (V * G), "code_perplexity", "prob_perplexity", "temp",
    "targets" ((B, T, G) code ids, or None)}. Training draws the Gumbel
    noise's uniforms from ``generator`` unless ``uniform`` is given. On a
    data-parallel grid (``mesh``) the perplexities average over the data
    group's global batch (``parallel/mesh.py::sum_over_data``)."""
    b, t, _ = x.shape
    logits = _weight_proj(vq.weight_proj, x.reshape(b * t, -1))
    logits = logits.reshape(b * t * groups, num_vars)

    lf = at_least_f32(logits)  # the f32 islands (float64 stays float64)
    hard_x = F.one_hot(logits.argmax(-1), num_vars).to(logits.dtype)
    hard = hard_x.reshape(b * t, groups, num_vars).to(lf.dtype)
    soft = torch.softmax(lf.reshape(b * t, groups, num_vars), -1)
    if mesh is None or mesh.dp == 1:
        hard_probs, avg_probs = hard.mean(0), soft.mean(0)
    else:  # data ranks: the global batch's averages, as JAX takes them
        sums = sum_over_data(torch.cat([
            hard.detach().sum(0).reshape(-1), soft.sum(0).reshape(-1),
            torch.tensor([float(b * t)], dtype=lf.dtype,
                         device=lf.device)]), mesh)
        n = groups * num_vars
        hard_probs = (sums[:n] / sums[-1]).view(groups, num_vars)
        avg_probs = (sums[n:2 * n] / sums[-1]).view(groups, num_vars)
    code_perplexity = torch.exp(
        -(hard_probs * torch.log(hard_probs + 1e-7)).sum(-1)).sum()
    prob_perplexity = torch.exp(
        -(avg_probs * torch.log(avg_probs + 1e-7)).sum(-1)).sum()

    if training:
        if uniform is None:
            if generator is None:
                raise ValueError("training draws Gumbel noise: pass a "
                                 "generator (or the uniforms)")
            uniform = torch.rand(logits.shape, generator=generator,
                                 device=logits.device)
        uniform = uniform.to(device=logits.device, dtype=lf.dtype)
        gumbels = -torch.log(-torch.log(uniform + 1e-10) + 1e-10)
        y_soft = torch.softmax((lf + gumbels) / temperature, -1)
        y_hard = F.one_hot(y_soft.argmax(-1), num_vars).to(y_soft.dtype)
        q = (y_hard + y_soft - y_soft.detach()).to(logits.dtype)
    else:
        q = hard_x

    targets = None
    if produce_targets:
        targets = q.detach().argmax(-1).reshape(b, t, groups)

    # the grouped matmul; the reference's broadcast multiply would hold a
    # (B * T, G * V, var_dim) intermediate
    q3 = q.reshape(b * t, groups, num_vars)
    cb = vq.vars.reshape(groups, num_vars, -1).to(q.dtype)
    out = torch.einsum("xgv,gvd->xgd", q3, cb).reshape(b, t, -1)
    return {"x": out, "num_vars": num_vars * groups,
            "code_perplexity": code_perplexity,
            "prob_perplexity": prob_perplexity, "temp": temperature,
            "targets": targets}
