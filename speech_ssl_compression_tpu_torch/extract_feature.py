"""Feature-extraction CLI of the PyTorch port, with the flags of the root
``extract_feature.py`` except ``--backend``, which becomes ``--device``:

    python -m speech_ssl_compression_tpu_torch.extract_feature -m MODE \\
        -c CKPT [-f {10,20}] [-d {360,960}] [--device cuda] [--wav ...]

MODE is accepted for interface parity; the checkpoint flavor is detected
from the checkpoint itself. The utterances go through
``MelHuBERTExtractor.forward_packed``; ``--featurizer device`` runs the
fbank on ``--device`` too. ``--device cuda`` (the default)
fails on a machine without CUDA; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import csv
import pathlib
import time

EXAMPLE_DIR = pathlib.Path(__file__).resolve().parent.parent / "example"


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-m", "--mode",
        choices=["melhubert", "weight-pruning", "head-pruning",
                 "row-pruning", "distillation"],
        default="melhubert",
        help="Inference mode (interface parity; flavor is auto-detected)",
    )
    parser.add_argument("-c", "--checkpoint", required=True,
                        help="Path to model checkpoint (.ckpt torch or .npz)")
    parser.add_argument("-f", "--fp", type=int, default=20,
                        choices=[10, 20], help="frame period (ms)")
    parser.add_argument("-d", "--hours", type=int, choices=[360, 960],
                        default=960)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "plain attention path on the CPU)")
    parser.add_argument("--matmul-precision", default="highest",
                        choices=["default", "high", "highest"],
                        help="'highest' = true f32 (TF32 off for matmuls and "
                             "cuDNN convs); 'default'/'high' = TF32 on")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="compute dtype")
    parser.add_argument("--featurizer", default="host",
                        choices=["host", "device"],
                        help="where fbank+normalize+stacking run: 'host' "
                             "(NumPy) or 'device' (torch on --device)")
    parser.add_argument("--fbank-precision", default="fast",
                        choices=["fast", "high"],
                        help="host featurizer numerics: 'fast' = f32 fbank, "
                             "'high' = the f64 oracle")
    parser.add_argument("--wav", nargs="*", default=None,
                        help="optional custom audio paths")
    parser.add_argument("--dump-dir", default=None,
                        help="write per-utterance features (.npy) + a "
                             "features.csv manifest here")
    parser.add_argument("--dump-layer", type=int, default=-1,
                        help="hidden_states index to dump (0 = pre-encoder "
                             "features, 1..L = transformer layers, "
                             "-1 = last layer)")
    return parser.parse_args(argv)


def dump_features(dump_dir, names, layer, lengths) -> int:
    """One ``.npy`` (T, D) f32 per utterance, its valid frames of ``layer``
    (B, T_pad, D), and a ``features.csv`` manifest (file_path, length), the
    input of the cluster CLI. Returns the number of utterances."""
    import numpy as np

    dump = pathlib.Path(dump_dir)
    dump.mkdir(parents=True, exist_ok=True)
    rows = []
    for i, (p, n) in enumerate(zip(names, lengths)):
        path = dump / f"{i:06d}_{pathlib.Path(p).stem}.npy"
        np.save(path, layer[i, :n].astype(np.float32))
        rows.append((str(path), int(n)))
    with open(dump / "features.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file_path", "length"])
        w.writerows(rows)
    return len(rows)


def main(argv=None):
    args = get_args(argv)
    import torch

    from .extract import MelHuBERTExtractor, read_wavs

    print(f"[Extractor] - Extracting feature with {args.mode} mode")
    wav_path = args.wav or [
        str(EXAMPLE_DIR / "100-121669-0000.flac"),
        str(EXAMPLE_DIR / "1001-134707-0000.flac"),
    ]
    print(f"[Extractor] - Extracting feature from these files: {wav_path}")

    extractor = MelHuBERTExtractor(
        args.checkpoint, fp=args.fp,
        mean_std_npy_path=str(EXAMPLE_DIR / f"libri-{args.hours}-mean-std.npy"),
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        matmul_precision=args.matmul_precision,
        fbank_precision=args.fbank_precision,
        device=args.device,
    )
    print(
        f"[Extractor] - Successfully load model with "
        f"{extractor.num_params()} parameters on {extractor.device}"
    )

    t0 = time.perf_counter()
    out = extractor.forward_packed(read_wavs(wav_path),
                                   featurizer=args.featurizer)
    last = out["last_hidden_state"].float().cpu()
    dt = time.perf_counter() - t0
    n_frames = sum(out["lengths"])
    print(f"[Extractor] - Feature with shape of {tuple(last.shape)} is extracted")
    print(f"[Extractor] - {n_frames} frames in {dt:.3f}s "
          f"({n_frames / dt:.0f} frames/s incl. featurization, first call)")

    if args.dump_dir:
        layer = out["hidden_states"][args.dump_layer].float().cpu().numpy()
        n = dump_features(args.dump_dir, wav_path, layer, out["lengths"])
        print(f"[Extractor] - Dumped layer {args.dump_layer} features for "
              f"{n} utterances to {args.dump_dir} (features.csv manifest)")


if __name__ == "__main__":
    main()
