"""Audio DSP on tensors for the clone path (counterpart of
``rtvc_tpu/ops/audio.py`` and ``ops/stft.py``): the speaker encoder's
40-mel power spectrogram, volume normalisation, and the vocoder's label /
mu-law codecs and de-emphasis."""
from __future__ import annotations

import functools
import math

import numpy as np
import scipy.signal
import torch

from rtvc_tpu_torch.ops import mel as mel_ops

Tensor = torch.Tensor


@functools.lru_cache(maxsize=16)
def hann_window(win_size: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window of ``win_size``, centred in an ``n_fft`` buffer
    (librosa's ``get_window('hann', fftbins=True)`` + ``pad_center``)."""
    n = np.arange(win_size, dtype=np.float64)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)
    lpad = (n_fft - win_size) // 2
    padded = np.zeros(n_fft, dtype=np.float64)
    padded[lpad: lpad + win_size] = win
    return padded.astype(np.float32)


def stft_magnitude(y: Tensor, n_fft: int, hop_size: int, win_size: int
                   ) -> Tensor:
    """|STFT| with centred, reflect-padded frames, shape (1 + n_fft//2, T)."""
    window = torch.from_numpy(hann_window(win_size, n_fft)).to(y.device)
    spec = torch.stft(y, n_fft, hop_length=hop_size, win_length=n_fft,
                      window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    return spec.abs()


def encoder_mel_spectrogram(wav: Tensor, sample_rate: int, n_fft: int,
                            hop_size: int, n_mels: int) -> Tensor:
    """Power (|S|²) mel spectrogram, shape (T, n_mels): the speaker-encoder
    frontend (librosa ``melspectrogram`` defaults: power 2, fmin 0,
    fmax sr/2)."""
    mag = stft_magnitude(wav, n_fft, hop_size, n_fft)
    basis = torch.from_numpy(mel_ops.mel_filterbank(
        sample_rate, n_fft, n_mels, 0.0, sample_rate / 2.0)).to(wav.device)
    return (basis @ (mag ** 2)).t()


def normalize_volume(wav: Tensor, target_dBFS: float,
                     increase_only: bool = False,
                     decrease_only: bool = False) -> Tensor:
    """Scale to a target dBFS."""
    if increase_only and decrease_only:
        raise ValueError("Both increase only and decrease only are set")
    dBFS_change = target_dBFS - 10.0 * torch.log10(torch.mean(wav ** 2))
    gain = 10.0 ** (dBFS_change / 20.0)
    if increase_only:
        gain = torch.clamp(gain, min=1.0)
    if decrease_only:
        gain = torch.clamp(gain, max=1.0)
    return wav * gain


def label_2_float(x: Tensor, bits: int) -> Tensor:
    """Integer label [0, 2^bits) → float [-1, 1]."""
    return 2.0 * x / (2.0 ** bits - 1.0) - 1.0


def decode_mu_law(y: Tensor, mu: int, from_labels: bool = True) -> Tensor:
    """Inverse mu-law."""
    if from_labels:
        y = label_2_float(y, int(math.log2(mu)))
    m = mu - 1
    return torch.sign(y) / m * ((1.0 + m) ** torch.abs(y) - 1.0)


def de_emphasis(x: Tensor, k: float) -> Tensor:
    """IIR y[n] = x[n] + k·y[n-1]. A first-order recurrence over a whole
    waveform; it runs on the host in float64 (the waveform leaves the card
    right after it) and returns a float32 tensor on ``x``'s device."""
    y = scipy.signal.lfilter([1.0], [1.0, -k],
                             x.detach().cpu().double().numpy())
    return torch.from_numpy(y.astype(np.float32)).to(x.device)
