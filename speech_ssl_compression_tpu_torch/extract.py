"""Feature extraction API: MelHuBERT packed extraction in PyTorch.

Port of ``speech_ssl_compression_tpu/extract.py``: load a checkpoint (the
JAX package's npz or a reference ``.ckpt``), featurize waveforms on the host
with the Kaldi-compatible fbank, and run the encoder with ``no_pred`` and
``get_hidden``. The bulk path is :meth:`MelHuBERTExtractor.forward_packed`,
which packs utterances into fixed-capacity rows with segment-masked
attention.

Not ported yet: ``featurize_device``, ``forward_seqpar`` and
``forward_stream``.
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
from .ops.fbank import kaldi_fbank_np, normalize_fbank, stack_frame_pairs_np
from .ops.packing import build_pack_arrays, plan_packing
from .utils.weights import apply_masks, infer_pruned_dims, load_model

PRECISIONS = ("default", "high", "highest")


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

        state = load_checkpoint(path)
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


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA where there is none: a run
    asked for the GPU never lands on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available "
            "(pass device='cpu' to run on the CPU)"
        )
    return dev


@contextlib.contextmanager
def matmul_precision(precision: str):
    """For the duration of a forward: "highest" turns TF32 off for both
    matmuls and cuDNN convolutions (true f32); "high" and "default" turn it
    on. The previous flags are restored on exit."""
    if precision not in PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {PRECISIONS}")
    tf32 = precision != "highest"
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _check_featurizer(featurizer: str):
    if featurizer == "device":
        raise NotImplementedError(
            "featurizer='device' (featurize_device) is not ported yet"
        )
    if featurizer != "host":
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

    def _to_device(self, feat, pad_mask):
        return (torch.from_numpy(feat).to(self.device, self.dtype),
                torch.from_numpy(pad_mask).to(self.device))

    def forward(self, wavs: Sequence[np.ndarray],
                featurizer: str = "host") -> dict:
        _check_featurizer(featurizer)
        feat, pad_mask, lengths = self.featurize(wavs)
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
        feat, pad_mask, lengths = self.featurize(wavs)
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
        idx = [torch.from_numpy(a).to(self.device)
               for a in (gather_idx, seg_ids, unpack_idx)]
        with matmul_precision(self.matmul_precision), torch.inference_mode():
            out = self._packed_impl(feat, pad_mask, *idx)
        return {
            "hidden_states": [out["pre_feat"]] + list(out["layer_hiddens"]),
            "last_hidden_state": out["hidden"],
            "lengths": lengths,
            "n_packed_rows": len(rows),
        }
