"""Quality against compression from a finished journey workdir.

Port of ``tools/journey_quality_curve.py``. ``journey.py`` records the
held-out masked CE at each stage's final checkpoint only; the artifacts
it leaves behind (the weight-pruning ladder's before-pruning checkpoints
at each rung, the head- and row-pruning runs' ``states_prune_N`` before
each event) trace the whole tradeoff (arXiv:2211.09949, fig. 2). This
evaluates every checkpoint of the five stage expdirs, oldest first by
the step its meta records, against ``eval_batch.npz`` and its saved span
mask, and prints a markdown table.

    python -m speech_ssl_compression_tpu_torch.journey_curve \\
        [--workdir DIR] [--device cuda|cpu]

Writes ``<workdir>/quality_curve.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from .extract import load_any_checkpoint
from .journey import (
    STAGE_DIRS,
    eval_params,
    load_eval_batch,
    stage_ckpts,
)
from .utils.checkpoint import tree_leaves
from .utils.device import resolve_device


def curve(workdir, *, device="cuda") -> list:
    """One row per checkpoint: its stage, name, held-out masked CE,
    parameter count, sparsity (the share of zero entries: the loader folds
    the weight-pruning masks, so the nonzero count is the kept count),
    effective parameters, total heads, narrowest FFN and layers. Writes
    ``quality_curve.json`` and returns the rows."""
    device = resolve_device(device)
    workdir = pathlib.Path(workdir)
    eval_batch = load_eval_batch(workdir)
    rows = []
    for stage, name in STAGE_DIRS:
        expdir = workdir / name
        if not expdir.exists():
            continue
        for ck in stage_ckpts(expdir):
            params, cfg, _ = load_any_checkpoint(str(ck))
            loss = eval_params(params, cfg, eval_batch, device=device)
            leaves = tree_leaves(params)
            n_params = sum(int(np.prod(p.shape)) for p in leaves)
            nz = sum(int(np.count_nonzero(p)) for p in leaves)
            sp = round(1.0 - nz / n_params, 3)
            rows.append({
                "stage": stage,
                "ckpt": ck.name,
                "heldout_masked_ce": round(loss, 4),
                "params_m": round(n_params / 1e6, 2),
                "sparsity": sp,
                "effective_params_m": round(n_params * (1 - sp) / 1e6, 2),
                "heads": sum(cfg.encoder_attention_heads),
                "ffn": min(cfg.encoder_ffn_embed_dim),
                "layers": cfg.encoder_layers,
            })
            print(f"[curve] {stage}/{ck.name}: CE={loss:.4f} "
                  f"eff_params={rows[-1]['effective_params_m']}M",
                  flush=True)
    out = workdir / "quality_curve.json"
    out.write_text(json.dumps(rows, indent=2))

    print("\n| stage | checkpoint | held-out CE | eff. params (M) "
          "| sparsity | heads | ffn | layers |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['stage']} | {r['ckpt']} | {r['heldout_masked_ce']} "
              f"| {r['effective_params_m']} | {r['sparsity']} "
              f"| {r['heads']} | {r['ffn']} | {r['layers']} |")
    print(f"[curve] -> {out}")
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default="journey")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu on the CPU)")
    args = ap.parse_args(argv)
    return curve(args.workdir, device=args.device)


if __name__ == "__main__":
    main()
