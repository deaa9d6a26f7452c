"""MPEG audio (mp3) decode via the system ``libmpg123`` C library (ctypes).

``decode_mpeg`` reads mp3 / mp2 files (the repo's ``samples/*.mp3``,
CommonVoice) without a Python-level decoder. An optional ``libmp3lame``
encoder binding exists for round-trip tests (encode a known signal, decode
it back). A plain C-API binding.

This package's own copy of ``rtvc_tpu/utils/mpeg.py``.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

# --- mpg123 constants (from the public mpg123.h API) ---
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_MONO = 1
_MPG123_STEREO = 2
_MPG123_RATES = (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000)

_mpg123: Optional[ctypes.CDLL] = None
_mpg123_checked = False

_LIB_CANDIDATES = (
    "libmpg123.so.0",
    "libmpg123.so",
    "/usr/lib/x86_64-linux-gnu/libmpg123.so.0",
)


def _load_mpg123() -> Optional[ctypes.CDLL]:
    global _mpg123, _mpg123_checked
    if _mpg123_checked:
        return _mpg123
    _mpg123_checked = True
    names = list(_LIB_CANDIDATES)
    found = ctypes.util.find_library("mpg123")
    if found:
        names.insert(0, found)
    for name in names:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        try:
            _configure_mpg123(lib)
        except AttributeError:
            continue
        _mpg123 = lib
        break
    return _mpg123


def _configure_mpg123(lib: ctypes.CDLL) -> None:
    lib.mpg123_init.restype = ctypes.c_int
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.restype = ctypes.c_int
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_close.restype = ctypes.c_int
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.restype = None
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_format_none.restype = ctypes.c_int
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.restype = ctypes.c_int
    lib.mpg123_format.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
    ]
    lib.mpg123_getformat.restype = ctypes.c_int
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_read.restype = ctypes.c_int
    lib.mpg123_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_strerror.restype = ctypes.c_char_p
    lib.mpg123_strerror.argtypes = [ctypes.c_void_p]


def mpeg_supported() -> bool:
    """True when a usable libmpg123 is present."""
    return _load_mpg123() is not None


def _err(lib, handle, what: str) -> RuntimeError:
    msg = lib.mpg123_strerror(handle) if handle else b"?"
    return RuntimeError(f"mpg123 {what} failed: {msg.decode(errors='replace')}")


def decode_mpeg(path) -> Tuple[np.ndarray, int]:
    """Decode an mp3/mp2 file → (float32 mono waveform in [-1, 1], rate)."""
    lib = _load_mpg123()
    if lib is None:
        raise RuntimeError("libmpg123 is not available on this system")
    lib.mpg123_init()
    err = ctypes.c_int(0)
    handle = lib.mpg123_new(None, ctypes.byref(err))
    if not handle:
        raise RuntimeError(f"mpg123_new failed (code {err.value})")
    try:
        # Accept every MPEG rate but force float32 output.
        lib.mpg123_format_none(handle)
        for rate in _MPG123_RATES:
            lib.mpg123_format(
                handle, rate, _MPG123_MONO | _MPG123_STEREO, _MPG123_ENC_FLOAT_32
            )
        if lib.mpg123_open(handle, str(Path(path)).encode()) != _MPG123_OK:
            raise _err(lib, handle, "open")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        if (
            lib.mpg123_getformat(
                handle, ctypes.byref(rate), ctypes.byref(channels),
                ctypes.byref(encoding),
            )
            != _MPG123_OK
        ):
            raise _err(lib, handle, "getformat")
        if encoding.value != _MPG123_ENC_FLOAT_32:
            raise RuntimeError(
                f"mpg123 negotiated encoding {encoding.value:#x}, "
                f"expected float32"
            )

        chunks = []
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(handle, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(buf.raw[: done.value], np.float32))
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(
                    handle, ctypes.byref(rate), ctypes.byref(channels),
                    ctypes.byref(encoding),
                )
                continue
            if rc != _MPG123_OK:
                raise _err(lib, handle, "read")
        wav = (
            np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        )
        if channels.value > 1:
            wav = wav.reshape(-1, channels.value).mean(axis=1)
        return np.ascontiguousarray(wav, dtype=np.float32), int(rate.value)
    finally:
        lib.mpg123_close(handle)
        lib.mpg123_delete(handle)


# --- optional LAME encoder (test/round-trip support only) ---

_lame: Optional[ctypes.CDLL] = None
_lame_checked = False


def _load_lame() -> Optional[ctypes.CDLL]:
    global _lame, _lame_checked
    if _lame_checked:
        return _lame
    _lame_checked = True
    names = ["libmp3lame.so.0", "libmp3lame.so"]
    found = ctypes.util.find_library("mp3lame")
    if found:
        names.insert(0, found)
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            lib.lame_init.restype = ctypes.c_void_p
            lib.lame_set_in_samplerate.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.lame_set_num_channels.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.lame_set_out_samplerate.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.lame_init_params.argtypes = [ctypes.c_void_p]
            lib.lame_init_params.restype = ctypes.c_int
            lib.lame_encode_buffer.restype = ctypes.c_int
            lib.lame_encode_buffer.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_short),
                ctypes.POINTER(ctypes.c_short),
                ctypes.c_int,
                ctypes.c_char_p,
                ctypes.c_int,
            ]
            lib.lame_encode_flush.restype = ctypes.c_int
            lib.lame_encode_flush.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ]
            lib.lame_close.argtypes = [ctypes.c_void_p]
        except (OSError, AttributeError):
            continue
        _lame = lib
        break
    return _lame


def lame_supported() -> bool:
    return _load_lame() is not None


def encode_mpeg(wav: np.ndarray, sample_rate: int, path) -> None:
    """Encode a float32 mono waveform to an mp3 file via libmp3lame.

    Test utility (round-trip fixtures for the decoder); not part of the
    reference API surface.
    """
    lib = _load_lame()
    if lib is None:
        raise RuntimeError("libmp3lame is not available on this system")
    wav = np.asarray(wav, dtype=np.float32)
    pcm = np.clip(wav * 32767.0, -32768, 32767).astype(np.int16)
    gf = lib.lame_init()
    if not gf:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gf, int(sample_rate))
        lib.lame_set_out_samplerate(gf, int(sample_rate))
        lib.lame_set_num_channels(gf, 1)
        if lib.lame_init_params(gf) < 0:
            raise RuntimeError("lame_init_params failed")
        out = ctypes.create_string_buffer(int(1.25 * len(pcm)) + 7200)
        ptr = pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
        # Mono: lame duplicates the left channel when num_channels == 1.
        n = lib.lame_encode_buffer(gf, ptr, ptr, len(pcm), out, len(out))
        if n < 0:
            raise RuntimeError(f"lame_encode_buffer failed ({n})")
        data = out.raw[:n]
        n = lib.lame_encode_flush(gf, out, len(out))
        if n < 0:
            raise RuntimeError(f"lame_encode_flush failed ({n})")
        data += out.raw[:n]
        Path(path).write_bytes(data)
    finally:
        lib.lame_close(gf)
