"""ctypes wrapper over the audio codec shim (``native/src/audio_codec.c``).

Decodes every container and codec the system FFmpeg knows (flac for
LibriSpeech, m4a / aac for VoxCeleb2, ogg / vorbis / opus, NIST .sph for
TED-LIUM, mp3, wav) to mono float32, and encodes mono float32 to flac, mp3,
ogg or wav. The port's counterpart of ``rtvc_tpu/utils/libav.py``, over the
port's own copy of the shim: ``_build.build_audio_codec`` compiles it with
``gcc`` into ``rtvc_tpu_torch/build/`` on first use, never at import.

Where the FFmpeg headers or libraries are missing, ``libav_supported()`` is
False and ``load_error()`` keeps the build's output for the error messages.
This is host audio decoding: no kernel runs here.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from rtvc_tpu_torch import _build

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the shim could not be built or loaded
_lock = threading.Lock()


def _configure(lib: ctypes.CDLL) -> None:
    lib.rtvc_decode_audio.restype = ctypes.c_int
    lib.rtvc_decode_audio.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.rtvc_encode_audio.restype = ctypes.c_int
    lib.rtvc_encode_audio.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.rtvc_free_buf.restype = None
    lib.rtvc_free_buf.argtypes = [ctypes.c_void_p]


def _load() -> Optional[ctypes.CDLL]:
    """The shim, built and loaded once per process (threads that ask at once
    wait for one build); None when that failed."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(_build.build_audio_codec()))
                _configure(lib)
                _lib = lib
            except (OSError, RuntimeError, AttributeError) as e:
                _error = str(e) or repr(e)
    return _lib


def libav_supported() -> bool:
    return _load() is not None


def load_error() -> str:
    """Why the shim is unavailable (the build's output), or ''."""
    _load()
    return _error or ""


def _require(what: str) -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the audio codec shim is not available for {what}: {_error}")
    return lib


def decode_audio(path, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Decode any FFmpeg-supported audio file → (float32 mono wav, sr),
    resampled by libswresample to ``target_sr`` when given."""
    lib = _require("decoding")
    data = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    rc = lib.rtvc_decode_audio(str(path).encode(), int(target_sr or 0), ctypes.byref(data),
                               ctypes.byref(n), ctypes.byref(sr), err, len(err))
    if rc != 0:
        raise RuntimeError(f"decode failed: {err.value.decode(errors='replace')}")
    try:
        wav = np.ctypeslib.as_array(data, shape=(n.value,)).copy()
    finally:
        lib.rtvc_free_buf(data)
    return wav, sr.value


def encode_audio(path, wav: np.ndarray, sample_rate: int) -> None:
    """Encode mono float32 PCM; codec and container from the extension
    (.flac / .mp3 / .ogg / .wav)."""
    lib = _require("encoding")
    wav = np.ascontiguousarray(np.asarray(wav, dtype=np.float32))
    err = ctypes.create_string_buffer(256)
    rc = lib.rtvc_encode_audio(str(path).encode(),
                               wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(wav),
                               int(sample_rate), err, len(err))
    if rc != 0:
        raise RuntimeError(f"encode failed: {err.value.decode(errors='replace')}")
