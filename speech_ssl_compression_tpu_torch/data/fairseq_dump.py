"""The fairseq-dump variant of the MelHuBERT dataset.

The port's copy of ``speech_ssl_compression_tpu/data/fairseq_dump.py``
(reference datasets/melhubert_dataset.py:122-286: FairseqFeatLabelDataset,
LoadFairseqDataset, get_feat_iterator): one mmap'd .npy feature matrix,
.len offsets and .km text labels, mean/std normalization on the fly and
optional multitask dual labels (odd and even frames at 20 ms). The
buckets (``np.argsort(...)[::-1]``, unstable, and the trailing
single-utterance drop), the crops (``np.random.default_rng(seed)``) and
the batches are JAX's, bit for bit. Like JAX's, it is a set class with
``MelFeatBuckets``' API that no trainer flag selects.
"""

from __future__ import annotations

import logging
from typing import Iterator, List

import numpy as np

from ..ops.fbank import stack_frame_pairs_np
from .bucket_dataset import _round_up


def get_feat_iterator(feat_dir: str, split: str, nshard: int, rank: int):
    """Sharded iterator over an mmap'd feature dump (reference :122-135)."""
    feat_path = f"{feat_dir}/{split}_{rank}_{nshard}.npy"
    leng_path = f"{feat_dir}/{split}_{rank}_{nshard}.len"
    with open(leng_path) as f:
        lengs = [int(line.rstrip()) for line in f]
    offsets = [0] + np.cumsum(lengs[:-1]).tolist()

    def iterate():
        feat = np.load(feat_path, mmap_mode="r")
        assert feat.shape[0] == offsets[-1] + lengs[-1]
        for offset, leng in zip(offsets, lengs):
            yield feat[offset : offset + leng]

    return iterate, len(lengs)


class FairseqDumpBuckets:
    """Bucketed batches over the single-matrix dump format. Mirrors the
    MelFeatBuckets API so the Runner can consume either."""

    def __init__(
        self,
        frame_period: int,
        sequence_length: int,
        bucket_size: int,
        feat_dir: str,
        label_dir: str,
        split: str,
        mean_std_pth: str,
        multitask: bool = False,
        pad_multiple: int = 128,
        seed: int = 0,
    ):
        self.frame_period = frame_period
        self.sample_length = sequence_length
        self.multitask = multitask
        self.pad_multiple = pad_multiple
        self.rng = np.random.default_rng(seed)

        with open(f"{feat_dir}/{split}.len") as f:
            lengs = [int(line.rstrip()) for line in f]
        offsets = [0] + np.cumsum(lengs[:-1]).tolist()
        self.feat = np.load(f"{feat_dir}/{split}.npy", mmap_mode="r")
        assert self.feat.shape[0] == offsets[-1] + lengs[-1]

        labels: List[List[int]] = []
        with open(f"{label_dir}/{split}.km") as fp:
            for line in fp:
                labels.append(list(map(int, line.strip().split(" "))))
        assert len(labels) == len(lengs)

        ms = np.load(mean_std_pth)
        self.mean = ms[0].reshape(-1)
        self.std = ms[1].reshape(-1)

        order = np.argsort(np.array(lengs))[::-1]
        entries = [(lengs[i], offsets[i], labels[i]) for i in order]

        self.buckets: List[list] = []
        cur: list = []
        for e in entries:
            cur.append(e)
            if len(cur) == bucket_size:
                self.buckets.append(cur)
                cur = []
        if len(cur) > 1:
            self.buckets.append(cur)
        elif cur:
            logging.getLogger(__name__).info(
                "dropping a trailing single-utterance bucket"
            )

    def __len__(self):
        return len(self.buckets)

    def _load_feat(self, leng, offset):
        feat = np.asarray(self.feat[offset : offset + leng], np.float64)
        feat = (feat - self.mean) / self.std
        if self.frame_period == 20:
            feat = stack_frame_pairs_np(feat)
        return feat.astype(np.float32)

    def _load_label(self, y, feat_len):
        label = np.asarray(y)
        if self.frame_period == 20 and feat_len != label.shape[0]:
            l1 = label[::2]
            if not self.multitask:
                return l1.astype(np.int32)
            l2 = label[1::2]
            if len(l2) != len(l1):
                l2 = np.append(l2, l1[-1])
            return l1.astype(np.int32), l2.astype(np.int32)
        if self.multitask:
            # labels already at the feature rate: both tasks see them
            return label.astype(np.int32), label.astype(np.int32)
        return label.astype(np.int32)

    def get_batch(self, index: int) -> dict:
        feats, labels1, labels2 = [], [], []
        for leng, offset, y in self.buckets[index]:
            f = self._load_feat(leng, offset)
            lab = self._load_label(y, f.shape[0])
            if self.multitask:
                l1, l2 = lab
            else:
                l1, l2 = lab, None
            if self.sample_length > 0 and len(f) > self.sample_length:
                idx = int(
                    self.rng.integers(0, len(f) - self.sample_length + 1)
                )
                f = f[idx : idx + self.sample_length]
                l1 = l1[idx : idx + self.sample_length]
                if l2 is not None:
                    l2 = l2[idx : idx + self.sample_length]
            feats.append(f)
            labels1.append(l1)
            if l2 is not None:
                labels2.append(l2)

        lengths = np.array([len(f) for f in feats], np.int32)
        t = _round_up(int(lengths.max()), self.pad_multiple)
        b, d = len(feats), feats[0].shape[1]
        feat_pad = np.zeros((b, t, d), np.float32)
        lab_pad = np.full((b, t), -100, np.int32)
        lab2_pad = np.full((b, t), -100, np.int32) if labels2 else None
        for i, f in enumerate(feats):
            feat_pad[i, : len(f)] = f
            n = min(len(labels1[i]), len(f))
            lab_pad[i, :n] = labels1[i][:n]
            if lab2_pad is not None:
                lab2_pad[i, :n] = labels2[i][:n]
        pad_mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
        batch = {
            "feat": feat_pad,
            "label": lab_pad,
            "pad_mask": pad_mask,
            "length": lengths,
        }
        if lab2_pad is not None:
            batch["label2"] = lab2_pad
        return batch

    def epoch(self, shuffle: bool = True) -> Iterator[dict]:
        order = np.arange(len(self.buckets))
        if shuffle:
            self.rng.shuffle(order)
        for i in order:
            yield self.get_batch(int(i))
