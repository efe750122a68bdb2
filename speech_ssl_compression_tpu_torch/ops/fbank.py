"""Kaldi-compatible log-Mel filterbank, host side (NumPy).

Mirror of the NumPy half of ``speech_ssl_compression_tpu/ops/fbank.py``,
which cannot be imported here because that module also holds the JAX
featurizer. Semantics (torchaudio's ``compliance.kaldi.fbank`` defaults):
snip_edges framing, per-frame DC removal, preemphasis 0.97, symmetric
Hamming window, zero-padding to 512, power spectrum, Kaldi triangular Mel
bank with a zero Nyquist column, log floored at float32 eps. The
on-device featurizer (``featurize_batch``) is not ported yet.
"""

from __future__ import annotations

import numpy as np

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
