"""Offline preprocessing: a Kaldi release -> per-utterance .npy features,
cluster labels and the training CSV.

The port's copy of ``speech_ssl_compression_tpu/data/preprocess.py``
(``tidy_kaldi_data``; reference preprocess/tidy_libri960_kaldi_data.py and
tidy_libri360_kaldi_data.py): read the fbank .scp and the mean-var
accumulator, decode the ark feature matrices, normalize them in float64,
decode the cluster-label text lines (labels in [0, num_cluster)) and write
the .npy pairs and the 'file_path,label_path,length' CSV the bucket
dataset reads. The files are JAX's: float64 features, ``mean-std.npy``,
``cluster_{fp}/`` and the CSV rows in scp order. The CLI is
``python -m speech_ssl_compression_tpu_torch.preprocess``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .kaldi_io import parse_feat_matrix, read_mean_var, read_scp, read_text_labels


def tidy_kaldi_data(
    data_dir: str,
    out_dir: str,
    feat_scp: str = "fbank/train-960.scp",
    mean_var: str = "fbank/train-960.mean-var",
    cluster_dirs: Optional[Dict[str, str]] = None,
    label_scp_name: str = "train_960.hubert8.bas.scp",
    num_cluster: int = 512,
    csv_prefix: str = "libri960-stg2",
):
    """cluster_dirs: {"10ms": "stage2-cluster-10ms", "20ms": ...} relative to
    data_dir. Features are normalized with the accumulator stats and written
    once; labels + CSV are written per frame period."""
    if cluster_dirs is None:
        cluster_dirs = {
            "10ms": "stage2-cluster-10ms",
            "20ms": "stage2-cluster-20ms",
        }
    fbank_dir = os.path.dirname(os.path.join(data_dir, feat_scp))
    mean, std = read_mean_var(os.path.join(data_dir, mean_var))
    os.makedirs(out_dir, exist_ok=True)
    np.save(
        os.path.join(out_dir, "mean-std.npy"),
        np.stack([mean, std], axis=0),
    )

    feat_index = read_scp(os.path.join(data_dir, feat_scp), fbank_dir)
    feat_dir = os.path.join(out_dir, "feature")
    os.makedirs(feat_dir, exist_ok=True)

    feat_paths: Dict[str, str] = {}
    feat_lengths: Dict[str, int] = {}
    for key, (path, offset) in feat_index.items():
        with open(path, "rb") as fp:
            fp.seek(offset)
            feat = parse_feat_matrix(fp)
        feat = (feat - mean) / std
        save_path = os.path.join(feat_dir, key + ".npy")
        np.save(save_path, feat)
        feat_paths[key] = save_path
        feat_lengths[key] = feat.shape[0]

    for fp_name, rel in cluster_dirs.items():
        kmeans_dir = os.path.join(data_dir, rel)
        scp_path = os.path.join(kmeans_dir, label_scp_name)
        if not os.path.exists(scp_path):
            print(f"[Preprocess] WARNING: no {fp_name} label scp at "
                  f"{scp_path}; skipping that frame period's labels/CSV "
                  "(if this release nests them under split200/, flatten "
                  "first — preprocess.py --tar does it automatically)")
            continue
        label_dir = os.path.join(out_dir, f"cluster_{fp_name}")
        os.makedirs(label_dir, exist_ok=True)
        label_index = read_scp(scp_path, kmeans_dir)

        rows = []
        for key, (path, offset) in label_index.items():
            label = read_text_labels(path, offset)
            assert not ((label >= num_cluster).any() or (label < 0).any()), (
                f"label out of range for {key}"
            )
            save_path = os.path.join(label_dir, key + ".npy")
            np.save(save_path, label)
            if key in feat_paths:
                rows.append((feat_paths[key], save_path, feat_lengths[key]))

        csv_path = os.path.join(out_dir, f"{csv_prefix}-{fp_name}.csv")
        with open(csv_path, "w") as f:
            f.write("file_path,label_path,length\n")
            for feat_path, label_path, length in rows:
                f.write(f"{feat_path},{label_path},{length}\n")
    return out_dir
