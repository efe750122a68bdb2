"""k-means cluster labels for HuBERT-style pre-training, on the GPU.

Port of the root ``cluster.py``, with ``--device`` (cuda by default; cpu on
request, never as a fallback) in place of ``--backend``. Mini-batch k-means
(``ops/kmeans.py``) over per-utterance .npy feature files, then a second
pass writes fairseq-format labels:

  <out>/centers.npy            (K, D) float32
  <out>/labels.km              one line per utterance: space-separated ids
  <out>/labels.len             frame count per utterance (dump format)

Usage:
  python -m speech_ssl_compression_tpu_torch.cluster -f features.csv \\
      -k 500 -o outdir [--epochs 2] [--device cuda]
  # features.csv: header `file_path[,length]`, one .npy (T, D) per row
  # (extract_feature --dump-dir writes one)
  python -m speech_ssl_compression_tpu_torch.cluster -f 'dir/*.npy' -k 100 -o outdir
  # straight from audio (iteration-1 HuBERT labels on MFCC-39):
  python -m speech_ssl_compression_tpu_torch.cluster -f manifest.tsv \\
      --audio mfcc -k 100 -o outdir
  # manifest.tsv: fairseq style (first line = root dir; then
  # relpath<TAB>nsamples), or a glob of audio files
"""

from __future__ import annotations

import argparse
import glob
import pathlib

import numpy as np

from .ops.kmeans import kmeans_assign, kmeans_fit
from .utils.device import resolve_device, upload

ASSIGN_BUCKET = 1024  # the assign pass pads T to a multiple, as JAX's does


def _feature_paths(spec: str):
    if spec.endswith(".csv"):
        import csv

        with open(spec) as f:
            rows = list(csv.DictReader(f))
        return [r["file_path"] for r in rows]
    if spec.endswith(".tsv"):
        lines = pathlib.Path(spec).read_text().splitlines()
        root = pathlib.Path(lines[0].strip())
        return [str(root / ln.split("\t")[0]) for ln in lines[1:] if ln]
    paths = sorted(glob.glob(spec))
    if not paths:
        raise FileNotFoundError(f"no feature files match {spec!r}")
    return paths


def _make_loader(audio: str):
    """Returns load(path) -> (T, D) float32 features."""
    if audio == "none":
        return lambda p: np.asarray(np.load(p), np.float32)
    if audio == "mfcc":
        from .extract import read_wavs
        from .ops.fbank import mfcc39_np

        def load(p):
            wav = read_wavs([p])[0]
            return mfcc39_np(wav.astype(np.float64) * (2 ** 15),
                             dtype=np.float32)

        return load
    raise ValueError(f"unknown --audio mode {audio!r}")


class _Chunks:
    """Re-iterable training chunks of exactly (rows_per_chunk, D): rows
    carried over flow into the next chunk and the last partial chunk is
    zero-padded with its valid count, so every step has one shape; the
    features stream from disk once per epoch."""

    def __init__(self, paths, rows_per_chunk, load):
        self.paths = paths
        self.rows = rows_per_chunk
        self.load = load

    def __iter__(self):
        buf = []
        n = 0
        for p in self.paths:
            x = self.load(p)
            buf.append(x)
            n += x.shape[0]
            if n < self.rows:
                continue
            # one concatenation per flush, walked with slices
            flat = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
            off = 0
            while n - off >= self.rows:
                yield flat[off: off + self.rows], self.rows
                off += self.rows
            rest = flat[off:]
            buf, n = ([rest] if len(rest) else []), len(rest)
        if n:
            flat = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
            pad = np.zeros((self.rows - n, flat.shape[1]), np.float32)
            yield np.concatenate([flat, pad], axis=0), n


def write_labels(paths, load, centers: np.ndarray, out: pathlib.Path,
                 device) -> None:
    """The assign pass: ``labels.km`` and ``labels.len`` under ``out``, each
    utterance padded to a multiple of ASSIGN_BUCKET frames."""
    c = upload(centers, device)
    with open(out / "labels.km", "w") as fkm, \
            open(out / "labels.len", "w") as flen:
        for p in paths:
            x = load(p)
            t = x.shape[0]
            t_pad = max(ASSIGN_BUCKET, -(-t // ASSIGN_BUCKET) * ASSIGN_BUCKET)
            if t_pad != t:
                x = np.pad(x, ((0, t_pad - t), (0, 0)))
            ids = kmeans_assign(upload(x, device), c)[:t]
            fkm.write(" ".join(map(str, ids.tolist())) + "\n")
            flen.write(f"{t}\n")


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--features", required=True,
                    help=".csv with file_path column, or a .npy glob")
    ap.add_argument("-k", "--clusters", type=int, required=True)
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--chunk-rows", type=int, default=65536)
    ap.add_argument("--audio", default="none", choices=["none", "mfcc"],
                    help="treat -f entries as AUDIO files and featurize "
                         "on the fly (mfcc = 39-dim Kaldi-style MFCC, the "
                         "conventional iteration-1 HuBERT label features)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    paths = _feature_paths(args.features)
    load = _make_loader(args.audio)
    print(f"[cluster] {len(paths)} "
          f"{'audio' if args.audio != 'none' else 'feature'} files, "
          f"k={args.clusters}, on {device}", flush=True)

    centers, inertia = kmeans_fit(
        args.seed,
        _Chunks(paths, args.chunk_rows, load),
        args.clusters,
        epochs=args.epochs,
        verbose=True,
        device=device,
    )
    print(f"[cluster] final inertia/row {inertia:.4f}", flush=True)

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "centers.npy", centers)
    write_labels(paths, load, centers, out, device)
    print(f"[cluster] wrote {out}/centers.npy, labels.km, labels.len",
          flush=True)


if __name__ == "__main__":
    main()
