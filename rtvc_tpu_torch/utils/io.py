"""Audio file loading on the host (numpy copy of ``rtvc_tpu/utils/io.py``).

WAV files are read with scipy. The compressed formats that
``rtvc_tpu`` decodes through libmpg123 / FFmpeg are not ported yet: they
raise :class:`UnsupportedAudioFormat`; pass a numpy waveform instead.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
from scipy.io import wavfile

from rtvc_tpu_torch.ops.resample import resample

PathLike = Union[str, Path]


class UnsupportedAudioFormat(RuntimeError):
    pass


def _to_float32(data: np.ndarray) -> np.ndarray:
    """Convert integer PCM to float32 in [-1, 1)."""
    if data.dtype == np.float32:
        return data
    if data.dtype == np.float64:
        return data.astype(np.float32)
    if data.dtype == np.int16:
        return (data / 32768.0).astype(np.float32)
    if data.dtype == np.int32:
        return (data / 2147483648.0).astype(np.float32)
    if data.dtype == np.uint8:
        return ((data.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
    raise UnsupportedAudioFormat(f"Unsupported WAV sample dtype: {data.dtype}")


def load_wav(path: PathLike, target_sr: Optional[int] = None
             ) -> Tuple[np.ndarray, int]:
    """Load a WAV file → (float32 mono waveform, sample_rate), resampled to
    ``target_sr`` when given."""
    path = Path(path)
    if path.suffix.lower() not in ("", ".wav"):
        raise UnsupportedAudioFormat(
            f"{path.suffix} decoding is not ported to rtvc_tpu_torch yet; "
            f"convert {path.name} to WAV or pass a numpy waveform.")
    sr, data = wavfile.read(str(path))
    wav = _to_float32(np.asarray(data))
    if wav.ndim == 2:  # downmix channels
        wav = wav.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        wav = resample(wav, sr, target_sr)
        sr = target_sr
    return wav.astype(np.float32), int(sr)

