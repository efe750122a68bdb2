"""Length-bucketed feature/label batches for MelHuBERT pre-training.

Port of ``speech_ssl_compression_tpu/data/bucket_dataset.py``
(``MelFeatBuckets`` and ``PrefetchIterator``): CSV manifests
(file_path,label_path,length), sorted by length descending, greedy buckets
of ``bucket_size`` utterances (a trailing singleton is dropped, as the
reference does), random fixed-length crops, -100 label padding, 20 ms
frame-pair stacking, and batches padded to a multiple of ``pad_multiple``
frames. The CSV is read with the standard library; the numpy generator
calls are JAX's, so the same seed gives the same batches.

Data parallel (``process_index`` of ``process_count`` data ranks): every
rank builds the same buckets; an epoch serves them in lockstep groups of
``process_count`` in one shuffled order (a stream of its own, seeded
``seed``), rank k loading member k with its crops drawn from seed
``seed + 1000003 (k + 1)``, every member padded to the group's length
taken from the manifest alone; the trailing partial bucket and the
trailing partial group are dropped. ``process_index=None`` serves each
group concatenated on one process, every member under its rank's crop
stream: the global batches of the parallel run (its replay).
"""

from __future__ import annotations

import csv
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..ops.fbank import stack_frame_pairs_np


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def read_manifest(path: str) -> List[tuple]:
    """(file_path, label_path, length) rows of one CSV manifest."""
    with open(path, newline="") as f:
        return [(r["file_path"], r["label_path"], int(r["length"]))
                for r in csv.DictReader(f)]


class MelFeatBuckets:
    """CSV-driven bucketed dataset of (feat.npy, label.npy) pairs."""

    def __init__(
        self,
        frame_period: int,
        sequence_length: int,
        bucket_size: int,
        sets: Sequence[str],
        max_timestep: int = 0,
        pad_multiple: int = 128,
        seed: int = 0,
        process_index: Optional[int] = 0,
        process_count: int = 1,
    ):
        self.frame_period = frame_period
        self.sample_length = sequence_length
        self.bucket_size = bucket_size
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

        rows = [r for s in sets for r in read_manifest(s)]
        # descending by length in the order pandas' sort_values gives
        # (its nargsort: numpy's quicksort, which is not stable, on the
        # reversed lengths, then reversed back), so tied lengths land as
        # they do in JAX's buckets
        lens = np.array([r[2] for r in rows], np.int64)
        order = np.arange(len(rows))[::-1][
            lens[::-1].argsort(kind="quicksort")][::-1]
        rows = [rows[i] for i in order]
        # signed max_timestep: > 0 drops longer, < 0 drops shorter
        # (melhubert_dataset.py:30-34)
        if max_timestep > 0:
            rows = [r for r in rows if r[2] < max_timestep]
        elif max_timestep < 0:
            rows = [r for r in rows if r[2] > -max_timestep]

        self.buckets: List[tuple] = []
        bucket_lens: List[List[int]] = []
        bx, by, bl = [], [], []
        for xi, yi, li in rows:
            bx.append(xi)
            by.append(yi)
            bl.append(li)
            if len(bx) == bucket_size:
                self.buckets.append((bx, by))
                bucket_lens.append(bl)
                bx, by, bl = [], [], []
        # the reference drops a trailing singleton (:59); lockstep groups
        # drop the trailing partial bucket whole
        if len(bx) > 1 and not self._multi:
            self.buckets.append((bx, by))
            bucket_lens.append(bl)
        self.num_samples = sum(len(b[0]) for b in self.buckets)
        # each bucket's padded length from the manifest alone: every rank
        # knows a group's batch shape without asking the others
        self._bucket_tpad = []
        for ls in bucket_lens:
            eff = max(-(-n // 2) if frame_period == 20 else n for n in ls)
            if self.sample_length > 0:
                eff = min(eff, self.sample_length)
            self._bucket_tpad.append(_round_up(eff, pad_multiple))

    def __len__(self):
        # an epoch of lockstep groups of process_count buckets
        return len(self.buckets) // self.process_count

    def _load_feat(self, path: str) -> np.ndarray:
        feat = np.load(path)
        if self.frame_period == 20:
            feat = stack_frame_pairs_np(feat)
        return np.asarray(feat, np.float32)

    def _load_label(self, path: str, feat_len: int) -> np.ndarray:
        label = np.load(path)
        if self.frame_period == 20 and feat_len != label.shape[0]:
            label = label[::2]
        return np.asarray(label, np.int32)

    def _crop(self, feat, label):
        if self.sample_length <= 0 or len(feat) < self.sample_length:
            return feat, label
        idx = int(self.rng.integers(0, len(feat) - self.sample_length + 1))
        return (
            feat[idx: idx + self.sample_length],
            label[idx: idx + self.sample_length],
        )

    def get_batch(self, index: int, pad_to: Optional[int] = None) -> dict:
        """Bucket ``index`` as numpy arrays: feat (B, T, F) f32, label
        (B, T) int32 (-100 past each length), pad_mask (B, T) f32 and
        length (B,) int32, T rounded up to ``pad_multiple`` (or
        ``pad_to``, a lockstep group's length)."""
        bx, by = self.buckets[index]
        feats, labels = [], []
        for xp, yp in zip(bx, by):
            f = self._load_feat(xp)
            lab = self._load_label(yp, f.shape[0])
            f, lab = self._crop(f, lab)
            feats.append(f)
            labels.append(lab)

        lengths = np.array([len(f) for f in feats], np.int32)
        t = _round_up(int(lengths.max()), self.pad_multiple)
        if pad_to is not None:
            assert pad_to >= t, (
                f"lockstep pad target {pad_to} < actual bucket length {t} "
                "(manifest lengths disagree with the stored features)")
            t = pad_to
        b, d = len(feats), feats[0].shape[1]
        feat_pad = np.zeros((b, t, d), np.float32)
        label_pad = np.full((b, t), -100, np.int32)
        for i, (f, lab) in enumerate(zip(feats, labels)):
            feat_pad[i, : len(f)] = f
            n = min(len(lab), len(f))
            label_pad[i, :n] = lab[:n]
        pad_mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
        return {
            "feat": feat_pad,
            "label": label_pad,
            "pad_mask": pad_mask,
            "length": lengths,
        }

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
            tpad = max(self._bucket_tpad[g] for g in group)
            if self.process_index is not None:
                yield self.get_batch(group[self.process_index], pad_to=tpad)
                continue
            parts = []
            for m, g in enumerate(group):
                self.rng = self._member_rngs[m]
                parts.append(self.get_batch(g, pad_to=tpad))
            yield {k: np.concatenate([p[k] for p in parts], axis=0)
                   for k in parts[0]}


class PrefetchIterator:
    """Background-thread prefetch (double buffering) around any iterator.
    An early exit of the consumer must not leave the worker blocked on a
    full queue: puts poll a stop event, and :meth:`close` sets it."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._exhausted = False

        def _put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in it:
                    if not _put(item):
                        return
            except BaseException as e:  # raised again in the consumer
                self._err = e
            finally:
                _put(self._done)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def close(self):
        self._stop.set()

    def __del__(self):
        self._stop.set()

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        while True:
            if self._stop.is_set():
                # closed: the worker may stop without the done sentinel, so
                # drain what is buffered and stop
                try:
                    item = self.q.get_nowait()
                except queue.Empty:
                    self._exhausted = True
                    raise StopIteration from None
            else:
                try:
                    item = self.q.get(timeout=0.1)
                except queue.Empty:
                    continue
            if item is self._done:
                self._exhausted = True
                self._stop.set()
                if self._err is not None:
                    raise self._err
                raise StopIteration
            return item
