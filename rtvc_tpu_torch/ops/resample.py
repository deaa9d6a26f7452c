"""Sample-rate conversion (host-side preprocessing).

The reference resamples with ``librosa.resample`` (ref: encoder/audio.py:47-53).
Here we use polyphase filtering via ``scipy.signal.resample_poly``, which is
high quality, exact for rational ratios, and dependency-free.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import signal as sps


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wav
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return sps.resample_poly(wav.astype(np.float64), up, down).astype(np.float32)
