"""Where a waveform pruning run's time goes besides its grad steps, on one
CUDA device: HuBERT-base's bf16 grad step at the pruning recipes' batch
(B = 12 x 250,000 samples, seeded random weights, the conv kernels,
LayerDrop 0, dropout on) with cuDNN's deterministic algorithms off, on and
off again, and a trainer checkpoint save (the params and two Adam moments
as the trainers write them) split into its parts.

    python -m speech_ssl_compression_tpu_torch.train.host_probe

Prints the wall time of each grad step (three after cuDNN's setting
changes, the first a warm-up), and for two saves: the three trees'
device-to-host conversion (``wave_tree_from_named``), ``save_checkpoint``,
and for the same bytes zlib's CRC-32 (which the npz's zip entries carry),
``tobytes`` and a raw write to the temporary directory; then a load of the
file and a garbage collection. Ends with the card's name and power limit.
Needs a CUDA device; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import gc
import os
import pathlib
import tempfile
import time
import zlib

import numpy as np
import torch

from ..configs import HuBERTConfig, read_yaml
from ..models.conv_frontend import conv_output_length
from ..ops import _kernels
from ..utils.checkpoint import save_checkpoint
from ..utils.device import card_label
from ..utils.weights import (
    init_hubert_params_np, load_wave_model, wave_tree_from_named)
from .steps import make_hubert_grad_step

ROOT = pathlib.Path(__file__).resolve().parents[2]


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in leaves(v)]
    if isinstance(tree, list):
        return [a for v in tree for a in leaves(v)]
    return [tree]


def main() -> None:
    _kernels.build()
    _kernels.load()
    dev = torch.device("cuda", 0)
    up = read_yaml(ROOT / "configs" / "hubert" / "config_model.yaml")["hubert"]
    up.update(encoder_layerdrop=0.0, conv_frontend_impl="tc_pallas")
    cfg = HuBERTConfig.from_dict(up)
    model = load_wave_model(init_hubert_params_np(cfg, (504,), 0), cfg,
                            "hubert").to(dev)
    b, n = 12, 250000
    frames = conv_output_length(n, cfg.conv_feature_layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"source": 0.3 * torch.randn((b, n), generator=gen, device=dev),
             "length": np.full(b, n),
             "target_list": [torch.randint(0, 504, (b, frames),
                                           generator=gen, device=dev)],
             "target_valid": torch.ones((b, frames), dtype=torch.bool,
                                        device=dev)}
    named = dict(model.named_parameters())
    torch.backends.cudnn.benchmark = False
    for deterministic in (False, True, False):
        torch.backends.cudnn.deterministic = deterministic
        step = make_hubert_grad_step(model, compute_dtype=torch.bfloat16)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(named, batch, torch.Generator().manual_seed(11))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"HuBERT bf16 grad step B={b} x {n} samples, cuDNN "
              f"deterministic {deterministic}: "
              + ", ".join(f"{w:.3f}" for w in walls) + " s", flush=True)
    torch.backends.cudnn.deterministic = False

    moments = [{k: torch.randn_like(v) for k, v in named.items()},
               {k: torch.rand_like(v) for k, v in named.items()}]
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(2):
            path = os.path.join(tmp, f"save{rep}.npz")
            t0 = time.perf_counter()
            trees = [wave_tree_from_named(d, "hubert")
                     for d in (named, *moments)]
            t1 = time.perf_counter()
            opt = [a for t in trees[1:] for a in leaves(t)]
            save_checkpoint(path, trees[0],
                            opt_state=[np.zeros((), np.int32)] + opt,
                            meta={"Step": 1})
            t2 = time.perf_counter()
            arrays = leaves(trees[0]) + opt
            for a in arrays:
                zlib.crc32(a)
            t3 = time.perf_counter()
            for a in arrays:
                a.tobytes()
            t4 = time.perf_counter()
            with open(os.path.join(tmp, "raw.bin"), "wb") as f:
                for a in arrays:
                    a.tofile(f)
            t5 = time.perf_counter()
            with np.load(path) as data:
                for k in data.files:
                    data[k]
            t6 = time.perf_counter()
            gc.collect()
            t7 = time.perf_counter()
            print(f"save {sum(a.nbytes for a in arrays) / 1e9:.3f} GB: trees "
                  f"to the host {t1 - t0:.3f} s, save_checkpoint "
                  f"{t2 - t1:.3f} s; on the same bytes crc32 {t3 - t2:.3f} "
                  f"s, tobytes {t4 - t3:.3f} s, a raw write {t5 - t4:.3f} s;"
                  f" the file's load {t6 - t5:.3f} s; gc.collect "
                  f"{t7 - t6:.3f} s", flush=True)
            os.remove(path)
            os.remove(os.path.join(tmp, "raw.bin"))
    print("gpu:", card_label(dev))


if __name__ == "__main__":
    main()
