"""Kaldi's log-Mel filterbank as torchaudio's ``compliance.kaldi.fbank``
computes it with its defaults, in float64: 25 ms frames every 10 ms with
snip edges, per-frame DC removal, preemphasis 0.97, a symmetric Hamming
window, a 512-point power spectrum, Kaldi's triangular Mel bank from 20 Hz
to Nyquist, and the log floored at float32's epsilon. Then MelHuBERT's
input: per-bin normalisation and, at 20 ms, the even and odd 10 ms frames
side by side (an odd count padded with a zero frame).
"""

from __future__ import annotations

import math

import torch

EPS_F32 = 1.1920928955078125e-07
WINDOW, SHIFT, N_FFT = 400, 160, 512


def mel_bank(num_bins: int = 40, rate: float = 16000.0, low: float = 20.0):
    """(N_FFT // 2 + 1, num_bins) float64: Kaldi's triangles on the mel
    scale 1127 ln(1 + f / 700), the Nyquist bin 0."""
    def mel(f):
        return 1127.0 * torch.log1p(f / 700.0)

    high = rate / 2
    lo, hi = mel(torch.tensor(low, dtype=torch.float64)), mel(
        torch.tensor(high, dtype=torch.float64))
    delta = (hi - lo) / (num_bins + 1)
    i = torch.arange(num_bins, dtype=torch.float64)[:, None]
    left, center, right = (lo + i * delta, lo + (i + 1) * delta,
                           lo + (i + 2) * delta)
    m = mel(rate / N_FFT * torch.arange(N_FFT // 2, dtype=torch.float64))[None]
    bank = torch.clamp(torch.minimum((m - left) / (center - left),
                                     (right - m) / (right - center)), min=0.0)
    return torch.cat([bank, torch.zeros(num_bins, 1, dtype=torch.float64)],
                     dim=1).T


def log_mel(wave: torch.Tensor, num_bins: int = 40) -> torch.Tensor:
    """(n,) samples at 16 kHz, scaled to 16-bit levels -> (frames, bins)."""
    w = wave.to(torch.float64)
    n_frames = 1 + (w.numel() - WINDOW) // SHIFT if w.numel() >= WINDOW else 0
    frames = w.unfold(0, WINDOW, SHIFT)[:n_frames]
    frames = frames - frames.mean(dim=1, keepdim=True)
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    n = torch.arange(WINDOW, dtype=torch.float64, device=w.device)
    hamming = 0.54 - 0.46 * torch.cos(2 * math.pi * n / (WINDOW - 1))
    frames = (frames - 0.97 * prev) * hamming
    spec = torch.fft.rfft(frames, n=N_FFT, dim=1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ mel_bank(num_bins).to(w.device)
    return torch.log(torch.clamp(mel, min=EPS_F32))


def melhubert_input(wave: torch.Tensor, mean: torch.Tensor,
                    std: torch.Tensor, stack: bool = True) -> torch.Tensor:
    """A [-1, 1) waveform -> MelHuBERT's normalised (and, at 20 ms,
    stacked) features, float64, (T, 80) at 20 ms."""
    y = (log_mel(wave * 32768.0, mean.numel()) - mean) / std
    if not stack:
        return y
    if y.shape[0] % 2:
        y = torch.cat([y, torch.zeros_like(y[:1])])
    return torch.cat([y[0::2], y[1::2]], dim=1)
