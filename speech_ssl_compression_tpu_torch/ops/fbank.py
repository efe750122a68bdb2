"""Kaldi-compatible log-Mel filterbank: the host side in NumPy and the
batched featurizer on the tensor's device in PyTorch.

Port of ``speech_ssl_compression_tpu/ops/fbank.py``. Semantics
(torchaudio's ``compliance.kaldi.fbank`` defaults): snip_edges framing,
per-frame DC removal, preemphasis 0.97, symmetric Hamming window,
zero-padding to 512, power spectrum, Kaldi triangular Mel bank with a zero
Nyquist column, log floored at float32 eps. :func:`featurize_batch` runs
that on a (B, samples) batch with ``torch.fft`` and one matmul, TF32 off;
JAX computes it with XLA, not in Pallas, so no kernel of the port stands
behind it. ``mfcc39_np`` gives the cluster CLI its MFCC-39 features.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import matmul_precision
from ..utils.profiling import span

MEL_LOW_HZ = 20.0
EPSILON_F32 = 1.1920928955078125e-07  # float32 machine eps, Kaldi's log floor


def _mel(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks(
    num_bins: int = 40,
    window_length_padded: int = 512,
    sample_freq: float = 16000.0,
    low_freq: float = MEL_LOW_HZ,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Mirror of ``ops/fbank.py::mel_banks``: Kaldi triangular Mel bank,
    shape (num_bins, n_fft//2 + 1), zero Nyquist column. ``high_freq <= 0``
    means Nyquist + high_freq."""
    if window_length_padded % 2:
        raise ValueError("window_length_padded must be even")
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    if not 0.0 <= low_freq < high_freq <= nyquist:
        raise ValueError(f"bad Mel range [{low_freq}, {high_freq}]")

    fft_bin_width = sample_freq / window_length_padded
    mel_low = _mel(low_freq)
    mel_high = _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64).reshape(-1, 1)
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1.0) * mel_delta
    right_mel = mel_low + (bin_idx + 2.0) * mel_delta

    freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float64)
    mel = _mel(freqs).reshape(1, -1)

    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    bank = np.maximum(0.0, np.minimum(up_slope, down_slope))
    return np.concatenate(
        [bank, np.zeros((num_bins, 1), dtype=np.float64)], axis=1
    )


def _hamming(window_size: int) -> np.ndarray:
    """Mirror of ``ops/fbank.py::_hamming`` (symmetric)."""
    n = np.arange(window_size, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (window_size - 1))


def num_frames(num_samples: int, window_size: int = 400,
               window_shift: int = 160) -> int:
    """Mirror of ``ops/fbank.py::num_frames``: snip_edges frame count."""
    if num_samples < window_size:
        return 0
    return 1 + (num_samples - window_size) // window_shift


def kaldi_fbank_np(
    waveform: np.ndarray,
    num_mel_bins: int = 40,
    sample_freq: float = 16000.0,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
    dtype=np.float64,
) -> np.ndarray:
    """Mirror of ``ops/fbank.py::kaldi_fbank_np``. waveform: 1-D, already
    scaled (e.g. by 2**15). ``dtype=np.float32`` is the faster serving
    path; float64 is the oracle."""
    waveform = np.asarray(waveform, dtype=dtype).reshape(-1)
    window_size = int(sample_freq * frame_length_ms * 1e-3)
    window_shift = int(sample_freq * frame_shift_ms * 1e-3)
    padded = 1 << (window_size - 1).bit_length()  # next power of two

    m = num_frames(len(waveform), window_size, window_shift)
    idx = np.arange(m)[:, None] * window_shift + np.arange(window_size)[None, :]
    frames = waveform[idx]

    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True).astype(dtype)
    if preemphasis != 0.0:
        offset = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - dtype(preemphasis) * offset
    frames = frames * _hamming(window_size).astype(dtype)[None, :]

    spec = np.fft.rfft(frames, n=padded, axis=1)
    power = (spec.real**2 + spec.imag**2).astype(dtype)

    bank = mel_banks(num_mel_bins, padded, sample_freq).astype(dtype)
    mel_energies = power @ bank.T
    return np.log(np.maximum(mel_energies, dtype(EPSILON_F32)))


def normalize_fbank(feats, mean, std):
    """Mirror of ``ops/fbank.py::normalize_fbank``: per-dim (x - mean) / std."""
    return (feats - mean) / std


def stack_frame_pairs_np(feats: np.ndarray) -> np.ndarray:
    """Mirror of ``ops/fbank.py::stack_frame_pairs_np``: 20 ms input stacks
    even and odd 10 ms frames channel-wise, zero-padding an odd count.
    (T, D) -> (ceil(T/2), 2D)."""
    a = feats[::2, :]
    b = feats[1::2, :]
    if a.shape[0] != b.shape[0]:
        b = np.concatenate(
            [b, np.zeros((1, b.shape[1]), dtype=feats.dtype)], axis=0
        )
    return np.concatenate([a, b], axis=1)


@functools.lru_cache(maxsize=None)
def _device_constants(device: torch.device, num_mel_bins: int):
    """The Hamming window (400,) and the Mel bank (257, num_mel_bins), f32
    on ``device``, uploaded once per device (a blocking copy per batch
    would fence the host)."""
    window = torch.from_numpy(_hamming(400).astype(np.float32))
    bank = torch.from_numpy(
        np.ascontiguousarray(mel_banks(num_mel_bins, 512, 16000.0).T,
                             dtype=np.float32))
    return window.to(device), bank.to(device)


def featurize_batch(
    waveforms: torch.Tensor,    # (B, max_samples) f32 or int16, x 2**15
    num_samples: torch.Tensor,  # (B,) int true sample counts
    mean: torch.Tensor,         # (num_mel_bins,) f32
    std: torch.Tensor,          # (num_mel_bins,) f32
    max_frames: int,            # 10 ms frame capacity per row
    stack: bool = True,         # 20 ms frame period: stack even/odd pairs
    num_mel_bins: int = 40,
):
    """Port of ``ops/fbank.py::featurize_batch`` (with ``kaldi_fbank`` and
    ``stack_frame_pairs``): wav -> normalized, optionally stacked features
    on the batch's device, 16 kHz / 25 ms / 10 ms.

    Returns (feats (B, T_out, D) f32, n_valid (B,) int32) with rows past
    n_valid zero; T_out = ceil(max_frames / 2) and D = 2 * num_mel_bins
    when ``stack``, else max_frames and num_mel_bins. The Mel product runs
    with TF32 off whatever the caller's matmul precision. A profile's
    trace names the call ``sslc.fbank``."""
    with span("sslc.fbank"):
        window_size, window_shift, padded = 400, 160, 512
        dev = waveforms.device
        window, bank = _device_constants(dev, num_mel_bins)
        w = waveforms.to(torch.float32)
        need = (max_frames - 1) * window_shift + window_size
        if w.shape[1] < need:
            # rows reaching past the buffer are past n_valid and zeroed below
            w = F.pad(w, (0, need - w.shape[1]))
        frames = w.unfold(1, window_size, window_shift)[:, :max_frames]
        frames = frames - frames.mean(dim=2, keepdim=True)
        offset = torch.cat([frames[..., :1], frames[..., :-1]], dim=2)
        frames = (frames - 0.97 * offset) * window
        spec = torch.fft.rfft(frames, n=padded, dim=2)
        power = spec.real ** 2 + spec.imag ** 2
        with matmul_precision("highest"):
            mel = power @ bank
        feats = torch.log(torch.clamp_min(mel, EPSILON_F32))

        n = num_samples.to(dev, torch.int64)
        n_valid = torch.clamp(
            torch.div(n - window_size, window_shift,
                      rounding_mode="floor") + 1,
            0, max_frames)
        valid = (torch.arange(max_frames, device=dev)[None, :]
                 < n_valid[:, None])
        feats = torch.where(valid[..., None],
                            normalize_fbank(feats, mean, std), 0.0)
        if stack:
            if max_frames % 2:
                feats = F.pad(feats, (0, 0, 0, 1))
            feats = torch.cat([feats[:, 0::2], feats[:, 1::2]], dim=2)
            n_valid = (n_valid + 1) // 2
            valid = (torch.arange(feats.shape[1], device=dev)[None, :]
                     < n_valid[:, None])
            feats = torch.where(valid[..., None], feats, 0.0)
        return feats, n_valid.to(torch.int32)


def _dct_matrix(n_ceps: int, n_mels: int) -> np.ndarray:
    """Mirror of ``ops/fbank.py::_dct_matrix``: orthonormal DCT-II rows
    (Kaldi/HTK convention), (n_ceps, n_mels)."""
    j = np.arange(n_mels, dtype=np.float64)
    m = np.cos(np.pi / n_mels * (j + 0.5)[None, :]
               * np.arange(n_ceps, dtype=np.float64)[:, None])
    m *= np.sqrt(2.0 / n_mels)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m


def _deltas(x: np.ndarray, window: int = 2) -> np.ndarray:
    """Mirror of ``ops/fbank.py::_deltas``: regression deltas over
    +-window frames with edge replication."""
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    pad = np.concatenate(
        [np.repeat(x[:1], window, axis=0), x,
         np.repeat(x[-1:], window, axis=0)], axis=0
    )
    out = np.zeros_like(x)
    for i in range(1, window + 1):
        out += i * (pad[window + i: window + i + len(x)]
                    - pad[window - i: window - i + len(x)])
    return out / denom


def mfcc39_np(
    waveform: np.ndarray,
    num_ceps: int = 13,
    num_mel_bins: int = 23,
    cepstral_lifter: float = 22.0,
    dtype=np.float32,
) -> np.ndarray:
    """Mirror of ``ops/fbank.py::mfcc39_np``: 39-dim MFCC (13 cepstra +
    deltas + delta-deltas), the features of first-iteration HuBERT cluster
    labels. 23-bin log-Mel fbank, orthonormal DCT-II, lifter 22, regression
    deltas over +-2 frames."""
    logmel = kaldi_fbank_np(waveform, num_mel_bins=num_mel_bins,
                            dtype=dtype)
    ceps = logmel @ _dct_matrix(num_ceps, num_mel_bins).T.astype(dtype)
    if cepstral_lifter > 0:
        q = np.arange(num_ceps, dtype=np.float64)
        lift = 1.0 + 0.5 * cepstral_lifter * np.sin(
            np.pi * q / cepstral_lifter
        )
        ceps = ceps * lift.astype(dtype)[None, :]
    d1 = _deltas(ceps)
    d2 = _deltas(d1)
    return np.concatenate([ceps, d1, d2], axis=1).astype(dtype)
