"""HuBERT waveform batches: raw audio and frame labels, bucketed by size.

The port's copy of ``speech_ssl_compression_tpu/data/hubert_dataset.py``
(reference datasets/hubert_dataset.py:111-352): a TSV
manifest (first line the root, then "rel_path\\tnum_samples"), per-frame
label files read lazily at byte offsets, the audio/label duration check,
buckets of ``batch_size`` utterances sorted by size, a random crop of every
utterance to the bucket's shortest (or ``max_sample_size``) with the labels
cropped alike, and sources padded to a multiple of ``pad_multiple``. The
numpy generator calls are JAX's, so the same seed gives the same batches.
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .audio import read_audio
from .bucket_dataset import _round_up

logger = logging.getLogger(__name__)


def load_manifest(manifest_path: str, max_keep: Optional[int],
                  min_keep: Optional[int]):
    """(root, names, line indices, sizes, total lines) of the kept
    utterances."""
    names, inds, sizes = [], [], []
    n_long = n_short = tot = 0
    with open(manifest_path) as f:
        root = f.readline().strip()
        for ind, line in enumerate(f):
            tot = ind + 1
            items = line.strip().split("\t")
            assert len(items) == 2, line
            sz = int(items[1])
            if min_keep is not None and sz < min_keep:
                n_short += 1
            elif max_keep is not None and sz > max_keep:
                n_long += 1
            else:
                names.append(items[0])
                inds.append(ind)
                sizes.append(sz)
    logger.info(f"manifest {manifest_path}: kept {len(names)}, skipped "
                f"{n_short} short / {n_long} long")
    return root, names, inds, sizes, tot


def load_label_offsets(label_path: str, inds: Sequence[int], tot: int):
    """Byte offsets of the kept utterances' label lines."""
    with open(label_path) as f:
        code_lengths = [len(line.encode("utf-8")) for line in f]
    assert len(code_lengths) == tot, (
        f"label count {len(code_lengths)} != manifest count {tot}")
    offsets = list(itertools.accumulate([0] + code_lengths))
    return [(offsets[i], offsets[i + 1]) for i in inds]


def verify_label_lengths(sizes, label_path, inds, tot, label_rate,
                         sample_rate=16000, tol=0.1):
    """Warn where audio and label durations differ by more than ``tol`` s."""
    if label_rate < 0:
        logger.info(f"{label_path} is sequence label. skipped")
        return
    with open(label_path) as f:
        lengths = [len(line.rstrip().split()) for line in f]
    assert len(lengths) == tot
    n_bad = sum(abs(sizes[i] / sample_rate - lengths[ind] / label_rate) > tol
                for i, ind in enumerate(inds))
    if n_bad:
        logger.warning(f"total {n_bad} (audio, label) pairs with mismatch")


class HubertWaveDataset:
    """Bucketed (by size) batches of raw audio and frame labels."""

    def __init__(
        self,
        manifest_path: str,
        sample_rate: int,
        label_paths: List[str],
        label_rates,
        batch_size: int = 4,
        max_keep_sample_size: Optional[int] = None,
        min_keep_sample_size: Optional[int] = None,
        max_sample_size: Optional[int] = None,
        pad_audio: bool = False,
        normalize: bool = False,
        random_crop: bool = True,
        single_target: bool = False,
        pad_multiple: int = 2000,
        seed: int = 0,
        process_index: Optional[int] = 0,
        process_count: int = 1,
    ):
        """``process_index`` of ``process_count`` data ranks, or None for
        the replay: lockstep groups as ``bucket_dataset.MelFeatBuckets``
        serves them (equal-size buckets only, each group padded to its
        length from the manifest)."""
        self.root, self.names, inds, self.sizes, tot = load_manifest(
            manifest_path, max_keep_sample_size, min_keep_sample_size)
        self.sample_rate = sample_rate
        self.label_paths = label_paths
        if isinstance(label_rates, (int, float)):
            label_rates = [float(label_rates)] * len(label_paths)
        self.label_rates = [float(r) for r in label_rates]
        self.max_sample_size = max_sample_size or np.inf
        self.pad_audio = pad_audio
        self.normalize = normalize
        self.random_crop = random_crop
        self.single_target = single_target
        self.pad_multiple = pad_multiple
        self.process_index = process_index
        self.process_count = max(1, int(process_count))
        self._multi = self.process_count > 1 or process_index is None
        self._order_rng = None
        if self._multi:
            self._order_rng = np.random.default_rng(seed)
            self.rng = np.random.default_rng(
                seed + 1000003 * ((process_index or 0) + 1))
            if process_index is None:
                self._member_rngs = [
                    np.random.default_rng(seed + 1000003 * (m + 1))
                    for m in range(self.process_count)]
        else:
            self.rng = np.random.default_rng(seed)
        self.label_offsets = [load_label_offsets(p, inds, tot)
                              for p in label_paths]
        for p, r in zip(label_paths, self.label_rates):
            verify_label_lengths(self.sizes, p, inds, tot, r, sample_rate)
        order = np.argsort(np.array(self.sizes))[::-1]
        self.buckets = [order[i: i + batch_size].tolist()
                        for i in range(0, len(order), batch_size)]
        if batch_size > 1 and self.buckets and len(self.buckets[-1]) < 2:
            logger.info("dropping a trailing single-utterance bucket")
            self.buckets.pop()
        if self._multi:  # lockstep groups need equal batch sizes
            self.buckets = [b for b in self.buckets if len(b) == batch_size]

    def __len__(self):
        return len(self.buckets) // self.process_count

    def _bucket_tpad(self, bucket_idx: int) -> int:
        """A bucket's padded source length from the manifest alone."""
        szs = [self.sizes[j] for j in self.buckets[bucket_idx]]
        target = max(szs) if self.pad_audio else min(szs)
        if np.isfinite(self.max_sample_size):
            target = min(target, int(self.max_sample_size))
        return _round_up(int(target), self.pad_multiple)

    def _get_audio(self, index: int) -> np.ndarray:
        path = os.path.join(self.root, self.names[index])
        wav, sr = read_audio(path)
        assert sr == self.sample_rate, path
        wav = wav[0]
        if self.normalize:
            wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-5)
        return wav.astype(np.float32)

    def _get_labels(self, index: int) -> List[np.ndarray]:
        out = []
        for p, offsets in zip(self.label_paths, self.label_offsets):
            s, e = offsets[index]
            # byte offsets: read in binary mode, then decode
            with open(p, "rb") as f:
                f.seek(s)
                line = f.read(e - s).decode("utf-8")
            out.append(np.array(list(map(int, line.split()))))
        return out

    def get_batch(self, bucket_idx: int, pad_to: Optional[int] = None) -> dict:
        """{"source" (B, T_pad) f32, "length" (B,) int32, "target_lists":
        per label set, per utterance, the cropped frame labels, "starts",
        "crop_size"}; T_pad is ``pad_to`` where given (a lockstep
        group's)."""
        idxs = self.buckets[bucket_idx]
        wavs = [self._get_audio(i) for i in idxs]
        labels = [self._get_labels(i) for i in idxs]
        target = (max(len(w) for w in wavs) if self.pad_audio
                  else min(len(w) for w in wavs))
        if np.isfinite(self.max_sample_size):
            target = min(target, int(self.max_sample_size))
        starts, cropped = [], []
        for w in wavs:
            diff = len(w) - target
            start = (int(self.rng.integers(0, diff + 1))
                     if diff > 0 and self.random_crop else 0)
            starts.append(start)
            cropped.append(w[start: start + target])
        t_pad = _round_up(target, self.pad_multiple)
        if pad_to is not None:
            assert pad_to >= t_pad, (
                f"lockstep pad target {pad_to} < bucket length {t_pad}")
            t_pad = pad_to
        source = np.zeros((len(idxs), t_pad), np.float32)
        lengths = np.zeros((len(idxs),), np.int32)
        for i, w in enumerate(cropped):
            source[i, : len(w)] = w
            lengths[i] = len(w)
        target_lists = []
        for li, rate in enumerate(self.label_rates):
            if rate < 0:  # sequence labels pass whole
                target_lists.append([labs[li] for labs in labels])
                continue
            s2f = rate / self.sample_rate
            frm_size = int(round(target * s2f))
            target_lists.append([
                labs[li][int(round(starts[bi] * s2f)):][:frm_size]
                for bi, labs in enumerate(labels)])
        return {"source": source, "length": lengths,
                "target_lists": target_lists, "starts": starts,
                "crop_size": target}

    def epoch(self, shuffle: bool = True) -> Iterator[dict]:
        order = np.arange(len(self.buckets))
        if not self._multi:
            if shuffle:
                self.rng.shuffle(order)
            for i in order:
                yield self.get_batch(int(i))
            return
        if shuffle:
            self._order_rng.shuffle(order)
        pc = self.process_count
        for s in range(len(self.buckets) // pc):
            group = [int(i) for i in order[s * pc:(s + 1) * pc]]
            tpad = max(self._bucket_tpad(g) for g in group)
            if self.process_index is not None:
                yield self.get_batch(group[self.process_index], pad_to=tpad)
                continue
            parts = []
            for m, g in enumerate(group):
                self.rng = self._member_rngs[m]
                parts.append(self.get_batch(g, pad_to=tpad))
            yield {
                "source": np.concatenate([p["source"] for p in parts]),
                "length": np.concatenate([p["length"] for p in parts]),
                "target_lists": [
                    sum((p["target_lists"][li] for p in parts), [])
                    for li in range(len(parts[0]["target_lists"]))],
                "starts": sum((list(p["starts"]) for p in parts), []),
                "crop_size": max(p["crop_size"] for p in parts),
            }
