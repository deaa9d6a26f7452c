"""F0 (pitch) estimation for alignment features.

The reference uses pyworld's DIO (ref: synthesizer/preprocess.py:372-374),
which is not available here. This is an independent normalized-autocorrelation
tracker (NCCF, the RAPT/YIN family): per hop-aligned frame, the lag of the
autocorrelation peak in the 60–600 Hz band gives F0; frames with weak
periodicity or low energy are marked unvoiced (0.0), matching DIO's contract
of one F0 value per mel frame with 0 for unvoiced.

Octave-error handling (round 3): (a) candidate selection prefers the
SHORTEST lag whose autocorrelation is within 87% of the best peak — the
classic fix for octave-down slips where the 2·lag peak edges out the true
one; (b) a post-pass snaps outliers that sit a factor ~2 off the local
voiced median back into the contour, then lightly median-smooths voiced
runs. This brings gross pitch error under the <10% production gate
(tests/test_pitch_crossval.py).

This package's own copy of ``rtvc_tpu/ops/pitch.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import numpy as np


def _local_voiced_median(f0: np.ndarray, half: int = 3) -> np.ndarray:
    """Per-frame median of the voiced neighbors within ±half frames
    (the frame itself excluded); 0 where no voiced neighbor exists."""
    n = len(f0)
    out = np.zeros(n, dtype=np.float64)
    for t in range(n):
        lo, hi = max(0, t - half), min(n, t + half + 1)
        neigh = np.concatenate([f0[lo:t], f0[t + 1 : hi]])
        neigh = neigh[neigh > 0]
        if len(neigh):
            out[t] = np.median(neigh)
    return out


def _smooth_octaves(f0: np.ndarray, fmin: float, fmax: float) -> np.ndarray:
    """Snap ×2 / ×0.5 (and ×3 / ×⅓) slips onto the local voiced contour,
    then 3-point median over voiced runs.

    The snap runs over widening neighbor windows (±3 then ±8 frames, two
    rounds each): a narrow window fixes isolated slips, the wide window
    pulls in RUNS of consecutive slips (measured on the reference samples:
    5–6-frame octave-up runs on high female F0) once enough neighbors have
    been corrected."""
    f0 = f0.astype(np.float64).copy()
    for half in (3, 3, 8, 8):
        ref = _local_voiced_median(f0, half=half)
        voiced = (f0 > 0) & (ref > 0)
        for factor in (2.0, 0.5, 3.0, 1.0 / 3.0):
            cand = f0 * factor
            off = np.abs(f0 - ref) > 0.3 * ref
            fixes = voiced & off & (np.abs(cand - ref) < 0.15 * ref)
            fixes &= (cand >= fmin) & (cand <= fmax)
            f0[fixes] = cand[fixes]

    # Utterance-level octave prior: a speaker's F0 stays within roughly one
    # octave of their voiced median over an utterance; runs of slips longer
    # than the local window (measured: 9-frame ×2 runs) survive the local
    # passes but not this one. Snap an outlier only when halving/doubling
    # lands it back inside the plausible band — expressive-but-genuine
    # excursions that have no in-band octave image are left alone.
    voiced_vals = f0[f0 > 0]
    if len(voiced_vals) >= 10:
        m = float(np.median(voiced_vals))
        for factor in (0.5, 2.0):
            cand = f0 * factor
            outlier = (f0 > 1.75 * m) if factor < 1 else (
                (f0 > 0) & (f0 < 0.55 * m)
            )
            fixes = outlier & (cand > 0.65 * m) & (cand < 1.55 * m)
            fixes &= (cand >= fmin) & (cand <= fmax)
            f0[fixes] = cand[fixes]

    # light median smoothing: voiced frames with two voiced neighbors take
    # the 3-point median (kills single-frame spikes without smearing
    # voicing boundaries)
    out = f0.copy()
    for t in range(1, len(f0) - 1):
        if f0[t - 1] > 0 and f0[t] > 0 and f0[t + 1] > 0:
            out[t] = np.median(f0[t - 1 : t + 2])
    return out.astype(np.float32)


def estimate_f0(
    wav: np.ndarray,
    sample_rate: int,
    hop: int,
    fmin: float = 60.0,
    fmax: float = 600.0,
    frame_ms: float = 40.0,
    voicing_threshold: float = 0.3,
    smooth: bool = True,
) -> np.ndarray:
    """Waveform → per-frame F0 in Hz (0 where unvoiced), one value per hop.

    Matches pyworld.dio's framing convention (frame_period = hop/sr·1000 →
    ~len(wav)//hop + 1 frames). ``smooth=False`` disables the octave
    post-pass (raw per-frame picks, for diagnostics).
    """
    wav = np.asarray(wav, dtype=np.float64)
    frame_len = int(sample_rate * frame_ms / 1000)
    lag_min = max(int(sample_rate / fmax), 2)
    lag_max = min(int(sample_rate / fmin), frame_len - 1)
    n_frames = len(wav) // hop + 1
    f0 = np.zeros(n_frames, dtype=np.float32)

    # global energy floor: quiet frames are unvoiced
    rms_floor = 0.01 * np.sqrt(np.mean(wav**2) + 1e-12)

    padded = np.pad(wav, (frame_len // 2, frame_len))
    for t in range(n_frames):
        frame = padded[t * hop : t * hop + frame_len]
        frame = frame - frame.mean()
        rms = np.sqrt(np.mean(frame**2))
        if rms < rms_floor:
            continue
        # normalized autocorrelation via FFT
        n_fft = 1 << int(np.ceil(np.log2(2 * frame_len)))
        spec = np.fft.rfft(frame, n_fft)
        ac = np.fft.irfft(spec * np.conj(spec))[: lag_max + 1]
        if ac[0] <= 0:
            continue
        ac = ac / ac[0]
        seg = ac[lag_min : lag_max + 1]
        best = int(np.argmax(seg))
        if seg[best] < voicing_threshold:
            continue
        # Octave guard: among local maxima nearly as strong as the best
        # (≥87%), take the SHORTEST lag — an octave-down slip picks 2·lag
        # whose peak is often within a hair of the true one.
        strong = np.where(seg >= 0.87 * seg[best])[0]
        peak = best
        for c in strong:
            is_local_max = (
                0 < c < len(seg) - 1 and seg[c] >= seg[c - 1] and seg[c] >= seg[c + 1]
            )
            if is_local_max:
                peak = int(c)
                break
        lag = peak + lag_min
        # parabolic interpolation around the peak for sub-sample precision
        if 0 < peak < len(seg) - 1:
            y0, y1, y2 = seg[peak - 1], seg[peak], seg[peak + 1]
            denom = y0 - 2 * y1 + y2
            if abs(denom) > 1e-12:
                lag = lag + 0.5 * (y0 - y2) / denom
        f0[t] = sample_rate / lag
    if smooth:
        f0 = _smooth_octaves(f0, fmin, fmax)
    return f0
