"""Log-MMSE speech enhancement (noise-profile estimation + denoising).

An implementation of the Ephraim–Malah log-MMSE STSA estimator [IEEE TASSP
1985] with decision-directed a-priori SNR estimation and exponential
noise-spectrum tracking on low-energy frames, used by the synthesizer's
silence-based utterance splitting. Host-side numpy.

This package's own copy of ``rtvc_tpu/ops/logmmse.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.special import exp1


@dataclass
class NoiseProfile:
    sample_rate: int
    frame_len: int
    hop: int
    noise_power: np.ndarray  # (n_bins,) average noise power spectrum


def _frames(wav: np.ndarray, frame_len: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(wav) - frame_len)) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame_len)[None, :]
    return wav[idx]


def profile_noise(
    noise: np.ndarray, sample_rate: int, window_ms: int = 20
) -> NoiseProfile:
    """Estimate the average noise power spectrum from a noise-only clip
    (ref surface: utils/logmmse.py:36)."""
    frame_len = int(window_ms * sample_rate / 1000)
    frame_len += frame_len % 2  # even for clean halves
    hop = frame_len // 2
    noise = np.asarray(noise, dtype=np.float64)
    if len(noise) < frame_len:
        noise = np.pad(noise, (0, frame_len - len(noise)))
    window = np.hanning(frame_len)
    frames = _frames(noise, frame_len, hop) * window
    spec = np.fft.rfft(frames, axis=1)
    noise_power = np.mean(np.abs(spec) ** 2, axis=0)
    return NoiseProfile(sample_rate, frame_len, hop, noise_power)


def denoise(wav: np.ndarray, profile: NoiseProfile, eta: float = 0.15) -> np.ndarray:
    """Log-MMSE denoising with the given noise profile (ref surface:
    utils/logmmse.py:72).

    ``eta`` controls noise-estimate adaptation on detected noise frames
    (0 freezes the profile, like the reference's usage at
    synthesizer/preprocess.py:187).
    """
    wav = np.asarray(wav, dtype=np.float64)
    frame_len, hop = profile.frame_len, profile.hop
    if len(wav) < frame_len:
        return wav.astype(np.float32)

    window = np.hanning(frame_len)
    win_norm = window.sum() ** 2 / frame_len

    noise_power = profile.noise_power.copy()
    aa = 0.98        # decision-directed smoothing
    ksi_min = 10 ** (-25 / 10)
    vad_thresh = 0.15

    out = np.zeros(len(wav) + frame_len)
    norm = np.zeros_like(out)
    prev_gain2_power = None

    n_frames = 1 + (len(wav) - frame_len) // hop
    for t in range(n_frames):
        seg = wav[t * hop : t * hop + frame_len] * window
        spec = np.fft.rfft(seg)
        power = np.abs(spec) ** 2

        gamma = np.minimum(power / np.maximum(noise_power, 1e-12), 40.0)
        if prev_gain2_power is None:
            ksi = aa + (1 - aa) * np.maximum(gamma - 1, 0)
        else:
            ksi = (
                aa * prev_gain2_power / np.maximum(noise_power, 1e-12)
                + (1 - aa) * np.maximum(gamma - 1, 0)
            )
            ksi = np.maximum(ksi_min, ksi)

        # simple likelihood-ratio VAD for noise tracking
        log_sigma_k = gamma * ksi / (1 + ksi) - np.log(1 + ksi)
        if eta > 0 and np.mean(log_sigma_k) < vad_thresh:
            noise_power = eta * noise_power + (1 - eta) * power

        A = ksi / (1 + ksi)
        v = A * gamma
        gain = A * np.exp(0.5 * exp1(np.maximum(v, 1e-12)))
        gain = np.minimum(gain, 1.0)

        prev_gain2_power = (gain**2) * power
        clean = np.fft.irfft(spec * gain, n=frame_len) * window
        out[t * hop : t * hop + frame_len] += clean
        norm[t * hop : t * hop + frame_len] += window**2

    # Overlap-add normalization. Samples at the very edges (and any tail the
    # frame grid does not cover) have a vanishing window sum — dividing by
    # an absolute epsilon there turns float dust into large spikes (found by
    # the genuine-reference cross-check, tests/ref_oracle/test_ref_dsp.py).
    # Use a relative floor and pass the raw input through where coverage is
    # effectively zero.
    floor = 1e-3 * float(norm.max())
    covered = norm[: len(wav)] > floor
    result = np.where(
        covered,
        out[: len(wav)] / np.maximum(norm[: len(wav)], floor),
        wav,
    ).astype(np.float32)
    return result
