"""Mel filterbank construction (Slaney-style, librosa-compatible numerics).

The reference gets its mel basis from ``librosa.filters.mel`` (ref:
synthesizer/audio.py:169-172, vocoder/audio.py:52-53, and implicitly
``librosa.feature.melspectrogram`` at encoder/audio.py:63-75). librosa is not a
dependency here, so the filterbank is built from the underlying math: the
Slaney mel scale (linear below 1 kHz, log above) with triangular filters and
Slaney area normalization. Filterbanks are tiny (n_mels × n_fft//2+1) and are
built once on the host in float64, then cached.
"""
from __future__ import annotations

import functools

import numpy as np

# Slaney mel scale constants: mel = hz / (200/3) below 1 kHz;
# above, logarithmic with step log(6.4)/27 per mel.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOG_STEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies: np.ndarray | float) -> np.ndarray:
    """Convert Hz to Slaney mels."""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    mels = frequencies / _F_SP
    log_region = frequencies >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(frequencies, 1e-10) / _MIN_LOG_HZ) / _LOG_STEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray | float) -> np.ndarray:
    """Convert Slaney mels to Hz."""
    mels = np.asarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOG_STEP * (mels - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Center frequencies of ``n_mels`` bands uniformly spaced on the mel scale."""
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def fft_frequencies(sample_rate: int, n_fft: int) -> np.ndarray:
    return np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)


@functools.lru_cache(maxsize=16)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: float,
) -> np.ndarray:
    """Triangular mel filterbank of shape ``(n_mels, 1 + n_fft // 2)``.

    Slaney-normalized (each filter scaled by 2 / bandwidth), matching
    ``librosa.filters.mel(..., htk=False, norm='slaney')`` which is what the
    reference relies on for all three pipeline stages.
    """
    assert fmax <= sample_rate / 2, "fmax must not exceed Nyquist"
    fftfreqs = fft_frequencies(sample_rate, n_fft)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=16)
def inv_mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: float,
) -> np.ndarray:
    """Moore-Penrose pseudo-inverse of the mel basis, shape
    ``(1 + n_fft // 2, n_mels)`` (computed in float64)."""
    basis = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    return np.linalg.pinv(basis.astype(np.float64)).astype(np.float32)
