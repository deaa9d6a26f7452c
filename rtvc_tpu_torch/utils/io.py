"""Audio file I/O on the host (the port's copy of ``rtvc_tpu/utils/io.py``).

WAV through scipy (every integer and float PCM subtype), mp3 / mp2 through
the system libmpg123 (``utils.mpeg``) and then the codec shim, and the other
compressed formats (flac for LibriSpeech, m4a for VoxCeleb2, ogg / opus,
NIST .sph for TED-LIUM, ...) through the port's codec shim over the system
FFmpeg libraries (``utils.libav``), resampled on load. Where no decoder is
available a compressed file raises :class:`UnsupportedAudioFormat`, naming
why.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
from scipy.io import wavfile

from rtvc_tpu_torch.ops.resample import resample

PathLike = Union[str, Path]

_MPEG = {".mp3", ".mp2"}
_COMPRESSED = {".flac", ".ogg", ".m4a", ".aac", ".opus", ".wma", ".sph",
               ".webm", ".mp4", ".mka"}
SAMPLES_DIR = Path(__file__).resolve().parents[2] / "samples"


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
    """Load an audio file → (float32 mono waveform, sample_rate), resampled
    to ``target_sr`` when given. The suffix picks the decoder."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in _MPEG:
        from rtvc_tpu_torch.utils import libav, mpeg

        if mpeg.mpeg_supported():
            wav, sr = mpeg.decode_mpeg(path)
        elif libav.libav_supported():
            wav, sr = libav.decode_audio(path)
        else:
            raise UnsupportedAudioFormat(
                f"{suffix} needs libmpg123 or the FFmpeg codec shim, and neither is "
                f"available ({libav.load_error()}). Convert {path.name} to WAV first.")
    elif suffix in _COMPRESSED:
        from rtvc_tpu_torch.utils import libav

        if not libav.libav_supported():
            raise UnsupportedAudioFormat(
                f"No decoder for {suffix}: the FFmpeg codec shim is not available "
                f"({libav.load_error()}). Convert {path.name} to WAV first, or pass a "
                f"numpy waveform.")
        wav, sr = libav.decode_audio(path)
    else:
        sr, data = wavfile.read(str(path))
        wav = _to_float32(np.asarray(data))
    if wav.ndim == 2:  # downmix channels
        wav = wav.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        wav = resample(wav, sr, target_sr)
        sr = target_sr
    return wav.astype(np.float32), int(sr)


def save_wav(wav: np.ndarray, path: PathLike, sample_rate: int) -> None:
    """Peak-normalise to int16 and write a WAV file."""
    wav = np.asarray(wav, dtype=np.float32)
    scaled = wav * (32767.0 / max(0.01, float(np.max(np.abs(wav)))))
    wavfile.write(str(path), sample_rate, scaled.astype(np.int16))


def save_wav_float(wav: np.ndarray, path: PathLike, sample_rate: int) -> None:
    """Write float32 PCM without rescaling."""
    wavfile.write(str(path), sample_rate, np.asarray(wav, dtype=np.float32))


def save_audio(wav: np.ndarray, path: PathLike, sample_rate: int) -> None:
    """Write in the format the extension names: WAV in process, the other
    formats (.flac / .mp3 / .ogg) through the FFmpeg codec shim."""
    path = Path(path)
    if path.suffix.lower() in ("", ".wav"):
        save_wav_float(wav, path, sample_rate)
        return
    from rtvc_tpu_torch.utils import libav

    if not libav.libav_supported():
        raise UnsupportedAudioFormat(
            f"No encoder for {path.suffix}: the FFmpeg codec shim is not available "
            f"({libav.load_error()}). Write .wav instead.")
    libav.encode_audio(path, wav, sample_rate)


def sample_path(name: str) -> Path:
    """An audio fixture of the repo's ``samples/`` directory by file name
    (the reference's sample utterances, CC BY 4.0: samples/README.md).
    Raises FileNotFoundError naming the directory where it is missing."""
    path = SAMPLES_DIR / name
    if not path.is_file():
        raise FileNotFoundError(f"audio fixture {name!r} not found in {SAMPLES_DIR}")
    return path
