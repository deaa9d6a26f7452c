"""STFT / ISTFT on tensors with librosa's semantics (counterpart of
``rtvc_tpu/ops/stft.py``): centred frames, reflect padding, a periodic Hann
window of ``win_size`` zero-padded symmetrically to ``n_fft``. The
transforms themselves are ``torch.fft.rfft`` / ``irfft``; framing is one
gather and the overlap-add one ``index_add_``.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

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


def num_frames(n_samples: int, n_fft: int, hop_size: int) -> int:
    """Frame count of a centred STFT (librosa: 1 + n_samples // hop)."""
    return 1 + n_samples // hop_size


def _frame_index(n_frames: int, n_fft: int, hop_size: int, device) -> Tensor:
    return (torch.arange(n_frames, device=device)[:, None] * hop_size
            + torch.arange(n_fft, device=device)[None, :])


def frame_signal(y: Tensor, n_fft: int, hop_size: int) -> Tensor:
    """Centred, reflect-padded framing → (n_frames, n_fft)."""
    pad = n_fft // 2
    y = F.pad(y[None, None], (pad, pad), mode="reflect")[0, 0]
    n_frames = 1 + (y.shape[0] - n_fft) // hop_size
    return y[_frame_index(n_frames, n_fft, hop_size, y.device)]


def stft(y: Tensor, n_fft: int, hop_size: int, win_size: int) -> Tensor:
    """Complex STFT, shape (1 + n_fft // 2, n_frames) (librosa's orientation)."""
    frames = frame_signal(y, n_fft, hop_size)
    window = torch.from_numpy(hann_window(win_size, n_fft)).to(y.device)
    return torch.fft.rfft(frames * window[None, :], n=n_fft, dim=-1).t()


def stft_magnitude(y: Tensor, n_fft: int, hop_size: int, win_size: int) -> Tensor:
    """|STFT|, shape (1 + n_fft // 2, n_frames)."""
    return stft(y, n_fft, hop_size, win_size).abs()


def istft(spec: Tensor, n_fft: int, hop_size: int, win_size: int,
          length: Optional[int] = None) -> Tensor:
    """Inverse STFT by windowed overlap-add, normalised by the overlap-added
    squared window (``librosa.istft``, centred): the output is trimmed by
    ``n_fft // 2`` at both ends, then to ``length``."""
    spec = spec.t()  # (n_frames, bins)
    n_frames = spec.shape[0]
    window = torch.from_numpy(hann_window(win_size, n_fft)).to(spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window[None, :]
    total = n_fft + hop_size * (n_frames - 1)
    idx = _frame_index(n_frames, n_fft, hop_size, spec.device).reshape(-1)
    y = torch.zeros(total, dtype=frames.dtype, device=spec.device)
    y.index_add_(0, idx, frames.reshape(-1))
    wsq = torch.zeros(total, dtype=frames.dtype, device=spec.device)
    wsq.index_add_(0, idx, (window ** 2).expand(n_frames, n_fft).reshape(-1))
    y = y / wsq.clamp(min=1e-10)
    pad = n_fft // 2
    y = y[pad: total - pad]
    return y if length is None else y[:length]
