"""Feature extraction API: MelHuBERT packed extraction in PyTorch.

Port of ``speech_ssl_compression_tpu/extract.py``: load a checkpoint (the
JAX package's npz or a reference ``.ckpt``), featurize waveforms on the host
(the Kaldi-compatible fbank in NumPy) or on the device
(:meth:`MelHuBERTExtractor.featurize_device`), and run the encoder with
``no_pred`` and ``get_hidden``. The bulk paths are
:meth:`MelHuBERTExtractor.forward_packed`, which packs utterances into
fixed-capacity rows with segment-masked attention, and
:meth:`MelHuBERTExtractor.forward_stream`, which pipelines it over batches.
:meth:`MelHuBERTExtractor.forward_seqpar` serves one long utterance with
its time axis sharded over the ranks of a process group
(``parallel/seqpar.py``).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .configs import MelHuBERTConfig
from .data.audio import read_audio
from .models.encoder import encoder_layers_forward, encoder_prologue
from .models.melhubert import melhubert_forward, pre_project
from .ops.fbank import (
    featurize_batch,
    kaldi_fbank_np,
    normalize_fbank,
    num_frames,
    stack_frame_pairs_np,
)
from .ops.packing import build_pack_arrays, plan_packing
from .utils.device import PRECISIONS, matmul_precision, resolve_device, upload
from .utils.weights import apply_masks, infer_pruned_dims, load_model


def load_mean_std(mean_std_npy_path: str) -> Tuple[np.ndarray, np.ndarray]:
    mean_std = np.load(mean_std_npy_path)
    return mean_std[0].reshape(-1), mean_std[1].reshape(-1)


def wav_to_mel(
    waveform: np.ndarray,  # (n,) float in [-1, 1]
    mean: np.ndarray,
    std: np.ndarray,
    fp: int = 20,
    precision: str = "fast",
) -> np.ndarray:
    """Mirror of ``extract.py::wav_to_mel``: x 2**15, 40-bin Kaldi fbank,
    per-dim normalization, 20 ms frame stacking. ``precision="fast"`` runs
    the fbank in float32, "high" in float64."""
    dtype = np.float64 if precision == "high" else np.float32
    y = kaldi_fbank_np(np.asarray(waveform, dtype) * (2**15), dtype=dtype)
    y = normalize_fbank(y, mean, std)
    if fp == 20:
        y = stack_frame_pairs_np(y)
    return y.astype(np.float32)


def load_any_checkpoint(path: str):
    """Port of ``extract.py::load_any_checkpoint``: the JAX package's .npz
    or a reference torch .ckpt -> (params (JAX-layout numpy tree, masks
    folded), cfg with per-layer heads and FFN widths, extras)."""
    if path.endswith(".npz"):
        from .utils.checkpoint import load_checkpoint

        state = load_checkpoint(path, load_opt=False)
        meta = state["meta"]
        up = meta.get("Upstream_Config", {})
        # "student" first: a distillation checkpoint stores the student's
        # params beside a possible "melhubert" teacher section
        cfg_dict = dict(up.get("student") or up.get("melhubert")
                        or up.get("hubert") or {})
        cfg = MelHuBERTConfig.from_dict(cfg_dict)
        params = apply_masks(state["params"], state["masks"])
        heads, ffns = infer_pruned_dims(params, cfg.head_dim)
        cfg = cfg.with_heads(heads).with_ffn_dims(ffns)
        return params, cfg, meta
    from .utils.torch_convert import load_reference_checkpoint

    params, _, cfg, extras = load_reference_checkpoint(path)
    return params, cfg, extras  # masks already folded by the converter


def _check_featurizer(featurizer: str):
    if featurizer not in ("host", "device"):
        raise ValueError(
            f"featurizer must be 'host' or 'device', got {featurizer!r}"
        )


def read_wavs(paths: Sequence[str]):
    """Decode 16 kHz audio files to mono float waveforms."""
    wavs = []
    for p in paths:
        wav, sr = read_audio(p)
        if sr != 16000:
            raise ValueError(f"{p}: expected 16 kHz, got {sr}")
        wavs.append(wav[0])
    return wavs


class MelHuBERTExtractor:
    """S3PRL-style inference wrapper, port of ``extract.py::MelHuBERTExtractor``.

    forward(wavs) -> {"hidden_states": [pre_feat] + layer_hiddens,
                      "last_hidden_state": hidden, "lengths": lengths}
    with tensors on ``device``. ``attn_impl`` is passed to every attention
    call ("auto": the CUDA kernel on a GPU; "dense": the plain path).
    """

    def __init__(
        self,
        ckpt: str,
        fp: int = 20,
        mean_std_npy_path: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        pad_multiple: int = 128,
        matmul_precision: str = "highest",
        fbank_precision: str = "fast",
        device="cuda",
        attn_impl: str = "auto",
    ):
        if matmul_precision not in PRECISIONS:
            raise ValueError(f"matmul_precision must be one of {PRECISIONS}")
        self.device = resolve_device(device)
        self.fp = fp
        self.pad_multiple = pad_multiple
        self.fbank_precision = fbank_precision
        self.dtype = dtype
        self.matmul_precision = matmul_precision
        self.attn_impl = attn_impl
        params, cfg, extras = load_any_checkpoint(ckpt)
        self.cfg = cfg
        self.extras = extras
        self.model = load_model(params, cfg).to(self.device, dtype)
        self.model.eval().requires_grad_(False)
        if mean_std_npy_path is not None:
            self.mean, self.std = load_mean_std(mean_std_npy_path)
        else:
            self.mean = np.zeros(40)
            self.std = np.ones(40)
        # the device featurizer's copies, uploaded once
        self._mean, self._std = (
            torch.as_tensor(np.asarray(a, np.float32), device=self.device)
            for a in (self.mean, self.std))

    def get_downsample_rates(self, key: str = "") -> int:
        return 320 if self.fp == 20 else 160

    def num_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    def featurize(self, wavs: Sequence[np.ndarray]):
        """Host featurizer: (feat (B, T_pad, D) f32, pad_mask (B, T_pad) f32,
        lengths), T_pad rounded up to ``pad_multiple``."""
        mels = [wav_to_mel(w, self.mean, self.std, self.fp,
                           precision=self.fbank_precision) for w in wavs]
        lengths = [m.shape[0] for m in mels]
        t = max(lengths)
        t_pad = -(-t // self.pad_multiple) * self.pad_multiple
        feat = np.zeros((len(mels), t_pad, mels[0].shape[1]), np.float32)
        for i, m in enumerate(mels):
            feat[i, : m.shape[0]] = m
        pad_mask = (
            np.arange(t_pad)[None, :] < np.asarray(lengths)[:, None]
        ).astype(np.float32)
        return feat, pad_mask, lengths

    def featurize_device(self, wavs: Sequence[np.ndarray]):
        """Port of ``MelHuBERTExtractor.featurize_device``: fbank, normalize
        and stacking on the extractor's device (``ops/fbank.py::
        featurize_batch``). Returns (feat (B, T_pad, D) f32 tensor on the
        device, pad_mask (B, T_pad) f32 array, lengths), shaped as
        :meth:`featurize` shapes them."""
        return self._featurize_batch_device(*self._assemble_wave_batch(wavs))

    def _assemble_wave_batch(self, wavs):
        """Host half of :meth:`featurize_device`: scale, pad and size the
        batch. Pure NumPy, so it may run in a prefetch worker thread."""
        n_samp = [int(w.shape[-1]) for w in wavs]
        frames10 = [num_frames(n) for n in n_samp]
        stack = self.fp == 20  # 20 ms: pairs of 10 ms frames
        lengths = [-(-f // 2) for f in frames10] if stack else frames10
        t_pad = -(-max(lengths) // self.pad_multiple) * self.pad_multiple
        max_frames = 2 * t_pad if stack else t_pad
        # snip-edges leftovers: the longest wav may carry up to 159 samples
        # past its last frame's reach (and a frame count can land exactly
        # on the pad boundary), so the buffer takes whichever is larger
        max_samples = max((max_frames - 1) * 160 + 400, max(n_samp))
        batch = np.zeros((len(wavs), max_samples), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : n_samp[i]] = np.asarray(w, np.float32) * (2**15)
        # 16-bit-sourced audio scales back to exact int16: upload half the
        # bytes, bit for bit (featurize_batch casts to f32 on the device);
        # other audio stays f32
        if (np.abs(batch).max(initial=0.0) <= 32767.0
                and np.array_equal(batch, np.round(batch))):
            batch = batch.astype(np.int16)
        return batch, n_samp, max_frames, stack, lengths, t_pad

    def _featurize_batch_device(self, batch, n_samp, max_frames, stack,
                                lengths, t_pad):
        """Device half of :meth:`featurize_device`: the uploads and
        ``featurize_batch`` (the calling thread's, never a worker's)."""
        feat, _ = featurize_batch(
            upload(batch, self.device),
            upload(np.asarray(n_samp, np.int64), self.device),
            self._mean, self._std, max_frames, stack=stack,
        )
        pad_mask = (
            np.arange(t_pad)[None, :] < np.asarray(lengths)[:, None]
        ).astype(np.float32)
        return feat, pad_mask, lengths

    def _featurize(self, wavs, featurizer: str):
        _check_featurizer(featurizer)
        if featurizer == "device":
            return self.featurize_device(wavs)
        return self.featurize(wavs)

    def _to_device(self, feat, pad_mask):
        """Features (an array, or a tensor from the device featurizer) and
        the pad mask on the device, the features in the compute dtype."""
        if not torch.is_tensor(feat):
            feat = upload(feat, self.device)
        return feat.to(self.dtype), upload(pad_mask, self.device)

    def forward(self, wavs: Sequence[np.ndarray],
                featurizer: str = "host") -> dict:
        feat, pad_mask, lengths = self._featurize(wavs, featurizer)
        feat, pad_mask = self._to_device(feat, pad_mask)
        with matmul_precision(self.matmul_precision), torch.inference_mode():
            out = melhubert_forward(
                self.model, feat, pad_mask, no_pred=True, get_hidden=True,
                attn_impl=self.attn_impl,
            )
        return {
            "hidden_states": [out["pre_feat"]] + list(out["layer_hiddens"]),
            "last_hidden_state": out["hidden"],
            "lengths": lengths,
        }

    def forward_seqpar(self, wav: np.ndarray, mesh=None,
                       featurizer: str = "host") -> dict:
        """Port of ``MelHuBERTExtractor.forward_seqpar``: sequence-parallel
        extraction of ONE utterance, its time axis sharded over the data
        group of ``mesh`` (``parallel/mesh.py::make_mesh()`` over the
        process group when None: every rank of it calls this with the same
        ``wav``). Each rank featurizes the whole utterance and runs its
        shard; ``last_hidden_state`` (1, T, D) and ``lengths`` come back on
        every rank and match :meth:`forward`'s."""
        from .parallel.mesh import make_mesh
        from .parallel.seqpar import melhubert_extract_seqpar

        if mesh is None:
            if getattr(self, "_seqpar_mesh", None) is None:
                self._seqpar_mesh = make_mesh()
            mesh = self._seqpar_mesh
        feat, pad_mask, lengths = self._featurize([wav], featurizer)
        feat, pad_mask = self._to_device(feat, pad_mask)
        with matmul_precision(self.matmul_precision), torch.inference_mode():
            hidden = melhubert_extract_seqpar(
                self.model, feat, pad_mask, mesh, attn_impl=self.attn_impl)
        return {"last_hidden_state": hidden, "lengths": lengths}

    def forward_files(self, paths: Sequence[str],
                      featurizer: str = "host") -> dict:
        return self.forward(read_wavs(paths), featurizer=featurizer)

    # ------------------------------------------------------------------
    # sequence-packed extraction: identical outputs, less padding waste
    # ------------------------------------------------------------------
    def _packed_impl(self, feat, pad_mask, gather_idx, seg_ids, unpack_idx):
        cfg = self.cfg
        enc = self.model.encoder
        valid = pad_mask.to(torch.bool)
        pre_feat = pre_project(self.model, feat)
        # the prologue runs per utterance: the conv positional embedding
        # must not cross utterance boundaries
        x = encoder_prologue(pre_feat, enc, cfg, padding_mask=~valid)

        b, t, d = x.shape
        r, s = gather_idx.shape
        xp = x.reshape(b * t, d).index_select(0, gather_idx.reshape(-1))
        hidden_p, layer_hiddens_p = encoder_layers_forward(
            xp.view(r, s, d), enc, cfg,
            padding_mask=seg_ids == 0,
            segment_ids=seg_ids,
            get_hidden=True,
            # packing keeps each utterance contiguous and in order, so
            # causal-within-segment equals the unpacked causal mask
            causal=cfg.attention_type == "causal",
            attn_impl=self.attn_impl,
        )

        def unpack(h):
            flat = h.reshape(r * s, d).index_select(0, unpack_idx.reshape(-1))
            return flat.view(b, t, d).masked_fill(~valid[:, :, None], 0.0)

        return {
            "hidden": unpack(hidden_p),
            "layer_hiddens": [unpack(h) for h in layer_hiddens_p],
            "pre_feat": pre_feat,
        }

    def forward_packed(self, wavs: Sequence[np.ndarray],
                       capacity: Optional[int] = None,
                       featurizer: str = "host") -> dict:
        """Like :meth:`forward` but packs utterances into fixed-capacity
        rows with segment-masked attention. Outputs match the unpacked path
        on valid frames and are zero elsewhere (``pre_feat`` excepted)."""
        _check_featurizer(featurizer)
        if int(self.cfg.encoder_layers) == 0:
            # no encoder to pack over: the plain path's gelu(pre_feat)
            return self.forward(wavs, featurizer=featurizer)
        feat, pad_mask, lengths = self._featurize(wavs, featurizer)
        return self._pack_and_dispatch(feat, pad_mask, lengths, capacity)

    def _pack_and_dispatch(self, feat, pad_mask, lengths,
                           capacity: Optional[int] = None) -> dict:
        """Plan packing on the host, run the packed encoder, assemble the
        outputs."""
        t = feat.shape[1]
        cap = max(capacity or t, max(lengths))
        cap = -(-cap // self.pad_multiple) * self.pad_multiple
        rows = plan_packing(lengths, cap)
        gather_idx, seg_ids, unpack_idx = build_pack_arrays(
            lengths, rows, cap, t
        )
        feat, pad_mask = self._to_device(feat, pad_mask)
        idx = [upload(a, self.device)
               for a in (gather_idx, seg_ids, unpack_idx)]
        with matmul_precision(self.matmul_precision), torch.inference_mode():
            out = self._packed_impl(feat, pad_mask, *idx)
        return {
            "hidden_states": [out["pre_feat"]] + list(out["layer_hiddens"]),
            "last_hidden_state": out["hidden"],
            "lengths": lengths,
            "n_packed_rows": len(rows),
        }

    def forward_stream(self, batch_iter, capacity: Optional[int] = None,
                       featurizer: str = "host", depth: int = 2):
        """Port of ``MelHuBERTExtractor.forward_stream``: yields
        :meth:`forward_packed`'s outputs for an iterator of wav batches, in
        input order. A prefetch thread does the host work (the NumPy fbank,
        or the batch assembly for the device featurizer) and makes no CUDA
        call; this thread uploads without a host fence and dispatches, so up
        to ``depth`` batches are in flight on the device before the first
        is yielded. Sustained throughput then approaches max(featurize,
        encode) instead of their sum. A consumer fences an item by reading
        it (for example ``.cpu()`` of one tensor).

        On a GPU the batches run on a stream of their own, and each item is
        handed to the caller's current stream through its own event, so
        reading item i waits for batch i alone (JAX's per-array readiness),
        not for batch i + 1 queued behind it, which keeps computing."""
        from collections import deque

        from .data.bucket_dataset import PrefetchIterator

        _check_featurizer(featurizer)
        if int(self.cfg.encoder_layers) == 0:
            # no encoder to pack over: forward per batch, as forward_packed
            # routes it
            for b in batch_iter:
                yield self.forward(b, featurizer=featurizer)
            return
        host_work = (self._assemble_wave_batch if featurizer == "device"
                     else self.featurize)
        items = PrefetchIterator((host_work(b) for b in batch_iter),
                                 depth=depth)
        lane = _Lane(self.device)
        try:
            pending = deque()
            for item in items:
                with lane.dispatch():
                    if featurizer == "device":
                        item = self._featurize_batch_device(*item)
                    out = self._pack_and_dispatch(*item, capacity)
                pending.append((out, lane.mark()))
                if len(pending) >= depth:
                    yield lane.hand_over(*pending.popleft())
            while pending:
                yield lane.hand_over(*pending.popleft())
        finally:
            items.close()


class _Lane:
    """``forward_stream``'s stream on a GPU (a no-op on the CPU): work is
    dispatched on it, an event marks each batch's end, and a batch's
    outputs are handed to the caller's current stream by that event, with
    ``record_stream`` so the caching allocator does not reuse their memory
    before the caller's stream is done with them."""

    def __init__(self, device: torch.device):
        self.stream = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            # the weights and anything else the caller queued come first
            self.stream.wait_stream(torch.cuda.current_stream(device))

    def dispatch(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def mark(self):
        if self.stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        return event

    def hand_over(self, out: dict, event) -> dict:
        if event is not None:
            current = torch.cuda.current_stream(self.stream.device)
            current.wait_event(event)
            for t in out["hidden_states"] + [out["last_hidden_state"]]:
                t.record_stream(current)
        return out
