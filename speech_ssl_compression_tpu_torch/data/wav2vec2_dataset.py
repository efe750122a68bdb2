"""wav2vec 2.0 raw-audio batches, bucketed by percentile of size.

The port's copy of ``speech_ssl_compression_tpu/data/wav2vec2_dataset.py``
(reference datasets/wav2vec2_dataset.py, RawAudioDataset /
FileAudioDataset): a TSV manifest (first line the root,
then "rel_path\\tnum_samples"), percentile length buckets
(:func:`get_percentile_buckets`, reference fairseq_code/data_utils.py:
313-331), batches of ``batch_size`` utterances sorted by bucketed size,
every utterance randomly cropped to the batch's target (the batch minimum
snapped down to a bucket bound, or with ``pad`` the batch maximum padded
up) and cut to a multiple of ``crop_seq_to_multiple``, and, with
``precompute_mask_config``, a block mask per batch at the batch's frame
count. The numpy generator calls are JAX's, so the same seed gives the
same batches. ``process_index`` of ``process_count`` data ranks (or None,
the replay) serves lockstep groups as ``bucket_dataset.MelFeatBuckets``
does: equal-size batches only, each group padded to its length from the
manifest, the block mask drawn at the padded frame count and cleared past
the batch's own.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, Optional

import numpy as np

from .audio import read_audio

logger = logging.getLogger(__name__)

_MASK_KEYS = {"mask_prob", "mask_length", "mask_prob_adjust", "inverse_mask",
              "mask_dropout", "non_overlapping", "require_same_masks"}


def get_percentile_buckets(sizes: np.ndarray, num_buckets: int) -> np.ndarray:
    """Bucket bounds at uniform percentiles of the sizes (JAX
    ``get_percentile_buckets``)."""
    return np.unique(np.percentile(
        sizes, np.linspace(0, 100, num_buckets + 1), method="lower")[1:])


def crop_to_multiple(n_samples: int, multiple: int) -> int:
    """Copy of JAX ``models/wav2vec2.py::crop_to_multiple`` (reference
    crop_seq_to_multiple, model.py:757-762): ``n_samples`` cut down to a
    multiple of ``multiple``."""
    if multiple <= 1:
        return n_samples
    return n_samples - (n_samples % multiple)


class Wav2Vec2AudioDataset:
    """``epoch(shuffle)`` yields {"source" (B, T) float32, "length" (B,)
    int32} and, with a mask config, "precomputed_mask" (B, T') bool, where
    ``frames_fn`` maps samples to conv frames."""

    def __init__(
        self,
        manifest_path: str,
        sample_rate: int = 16000,
        batch_size: int = 4,
        max_sample_size: Optional[int] = None,
        min_sample_size: int = 0,
        pad: bool = False,
        normalize: bool = False,
        num_buckets: int = 8,
        crop_seq_to_multiple: int = 1,
        seed: int = 0,
        precompute_mask_config: Optional[dict] = None,
        frames_fn=None,
        process_index: Optional[int] = 0,
        process_count: int = 1,
    ):
        self.process_index = process_index
        self.process_count = max(1, int(process_count))
        self._multi = self.process_count > 1 or process_index is None
        self._order_rng = None
        if self._multi:
            self._order_rng = np.random.default_rng(seed)
            if process_index is None:
                self._member_rngs = [
                    np.random.default_rng(seed + 1000003 * (m + 1))
                    for m in range(self.process_count)]
            seed = seed + 1000003 * ((process_index or 0) + 1)
        self.sample_rate = sample_rate
        self.max_sample_size = (int(max_sample_size)
                                if max_sample_size is not None
                                else np.iinfo(np.int64).max)
        self.pad = pad
        self.normalize = normalize
        self.crop_seq_to_multiple = max(int(crop_seq_to_multiple), 1)
        self.rng = np.random.default_rng(seed)

        self.precompute_mask_config = None
        if precompute_mask_config is not None:
            unknown = sorted(k for k, v in precompute_mask_config.items()
                             if k not in _MASK_KEYS and v)
            if unknown:
                raise NotImplementedError(
                    f"precompute_mask_config keys {unknown} are not "
                    "supported (expand_adjacent/clone_batch are data2vec-"
                    "only paths the reference never exercises)")
            assert frames_fn is not None, (
                "precompute_mask_config needs frames_fn to map samples to "
                "conv frames")
            self.precompute_mask_config = {
                k: v for k, v in precompute_mask_config.items()
                if k in _MASK_KEYS}
            self.frames_fn = frames_fn

        self.names, sizes = [], []
        skipped = 0
        with open(manifest_path) as f:
            self.root = f.readline().strip()
            for line in f:
                items = line.strip().split("\t")
                assert len(items) == 2, line
                sz = int(items[1])
                if sz < min_sample_size:
                    skipped += 1
                    continue
                self.names.append(items[0])
                sizes.append(sz)
        self.sizes = np.array(sizes, np.int64)
        logger.info(f"loaded {len(self.names)}, skipped {skipped} short "
                    "samples")

        capped = np.minimum(self.sizes, int(self.max_sample_size))
        if num_buckets > 0 and len(capped) > 1:
            bounds = get_percentile_buckets(capped, num_buckets)
            self.bucket_bounds = np.asarray(bounds, np.int64)
            self.padded_sizes = bounds[np.searchsorted(bounds, capped,
                                                       side="left")]
        else:
            self.bucket_bounds = np.zeros((0,), np.int64)
            self.padded_sizes = capped
        order = np.argsort(self.padded_sizes)[::-1]
        self.batches = [order[i:i + batch_size].tolist()
                        for i in range(0, len(order), batch_size)]
        if batch_size > 1 and self.batches and len(self.batches[-1]) < 2:
            self.batches.pop()  # a trailing singleton, as JAX drops it
        if self._multi:  # lockstep groups need equal batch sizes
            self.batches = [b for b in self.batches if len(b) == batch_size]

    def __len__(self):
        return len(self.batches) // self.process_count

    def _batch_target(self, batch_idx: int) -> int:
        """The batch's source length, from the manifest alone."""
        idxs = self.batches[batch_idx]
        szs = self.sizes[idxs]
        if self.pad:
            target = min(int(szs.max()), int(self.max_sample_size))
            target = int(max(self.padded_sizes[idxs].max(), target))
        else:
            target = min(int(szs.min()), int(self.max_sample_size))
            if len(self.bucket_bounds):
                bi = int(np.searchsorted(self.bucket_bounds, target,
                                         side="right")) - 1
                if bi >= 0:
                    target = int(self.bucket_bounds[bi])
        return max(crop_to_multiple(target, self.crop_seq_to_multiple), 1)

    def _get_audio(self, index: int) -> np.ndarray:
        path = os.path.join(self.root, self.names[index])
        wav, sr = read_audio(path)
        assert sr == self.sample_rate, path
        wav = wav[0]
        if self.normalize:
            wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-5)
        return wav.astype(np.float32)

    def get_batch(self, batch_idx: int, pad_to: Optional[int] = None) -> dict:
        idxs = self.batches[batch_idx]
        wavs = [self._get_audio(i) for i in idxs]
        target = self._batch_target(batch_idx)
        t_total = target
        if pad_to is not None:
            assert pad_to >= target, (
                f"lockstep pad target {pad_to} < batch target {target}")
            t_total = pad_to
        b = len(idxs)
        source = np.zeros((b, t_total), np.float32)
        lengths = np.zeros((b,), np.int32)
        for i, w in enumerate(wavs):
            if len(w) > target:
                start = int(self.rng.integers(0, len(w) - target + 1))
                w = w[start:start + target]
            source[i, :len(w)] = w
            lengths[i] = len(w)
        batch = {"source": source, "length": lengths}
        if self.precompute_mask_config is not None:
            from ..ops.block_masking import compute_block_mask_1d

            mask = compute_block_mask_1d(
                (b, int(self.frames_fn(t_total))), rng=self.rng,
                **self.precompute_mask_config)
            if t_total > target:  # frames past the batch's own: padding
                mask[:, int(self.frames_fn(target)):] = False
            batch["precomputed_mask"] = mask
        return batch

    def epoch(self, shuffle: bool = True) -> Iterator[dict]:
        order = np.arange(len(self.batches))
        if not self._multi:
            if shuffle:
                self.rng.shuffle(order)
            for i in order:
                yield self.get_batch(int(i))
            return
        if shuffle:
            self._order_rng.shuffle(order)
        pc = self.process_count
        for s in range(len(self.batches) // pc):
            group = [int(i) for i in order[s * pc:(s + 1) * pc]]
            tpad = max(self._batch_target(g) for g in group)
            if self.process_index is not None:
                yield self.get_batch(group[self.process_index], pad_to=tpad)
                continue
            parts = []
            for m, g in enumerate(group):
                self.rng = self._member_rngs[m]
                parts.append(self.get_batch(g, pad_to=tpad))
            yield {k: np.concatenate([p[k] for p in parts], axis=0)
                   for k in parts[0]}
