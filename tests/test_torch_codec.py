"""The port's audio I/O and its builds on the CPU.

- Compressed audio: the port's codec shim (``utils/libav.py`` over its own
  ``native/src/audio_codec.c``, built by ``_build.build_audio_codec`` into
  ``rtvc_tpu_torch/build/``), ``utils/mpeg.py`` and ``utils/io.load_wav``
  give the same bits as the JAX package's on the same flac, ogg, mp3 and
  stereo files and on the repo's ``samples/*.mp3``; ``encode_audio`` /
  ``save_audio`` round trips (flac within one int16 step, the lossy formats
  within 10 % of the RMS); ``UnsupportedAudioFormat`` naming the cause where
  a decoder is missing. The shim is built once for the module, in a fixture
  under the build's file lock; its cases skip only where the FFmpeg headers
  are missing (the preprocessor probe of ``rtvc_tpu/native/build.sh``).
- The kernel library's build under threads: four first callers of
  ``_build.library()`` with a fake ``nvcc`` compile each source once and all
  load one library; ``count_launch`` from eight threads loses no count.
"""
import collections
import ctypes
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

from rtvc_tpu.utils import io as jio
from rtvc_tpu.utils import libav as jlibav
from rtvc_tpu.utils import mpeg as jmpeg
from rtvc_tpu_torch import _build
from rtvc_tpu_torch.utils import io as tio
from rtvc_tpu_torch.utils import libav as tlibav
from rtvc_tpu_torch.utils import mpeg as tmpeg

SR = 16000
SAMPLES = ("1320_00000.mp3", "3575_00000.mp3", "p240_00000.mp3")


def _tone(sr=SR, seconds=1.0, f=440.0):
    t = np.arange(int(seconds * sr)) / sr
    return (0.5 * np.sin(2 * np.pi * f * t) * np.sin(2 * np.pi * 1.5 * t)).astype(np.float32)


@pytest.fixture(scope="module")
def shim():
    """The port's codec shim, built (once, under the build's locks) where
    the FFmpeg headers are found."""
    found, log = _build.ffmpeg_headers()
    if not found:
        pytest.skip(f"the FFmpeg headers are missing: {log[-300:]}")
    assert tlibav.libav_supported(), tlibav.load_error()
    return tlibav


@pytest.fixture(scope="module")
def files(shim, tmp_path_factory):
    """A flac, an ogg and an mp3 of one tone (encoded by the port's shim), a
    stereo wav and a 22 050 Hz flac."""
    d = tmp_path_factory.mktemp("codec")
    out = {}
    for ext in ("flac", "ogg", "mp3"):
        out[ext] = d / f"tone.{ext}"
        shim.encode_audio(out[ext], _tone(), SR)
    stereo = np.stack([_tone(), _tone(f=220.0)], axis=1)
    out["stereo.wav"] = d / "stereo.wav"
    wavfile.write(str(out["stereo.wav"]), SR, (stereo * 32767).astype(np.int16))
    out["22k.flac"] = d / "tone22k.flac"
    shim.encode_audio(out["22k.flac"], _tone(22050), 22050)
    return out


@pytest.mark.parametrize("kind", ["flac", "ogg", "mp3", "stereo.wav", "22k.flac"])
def test_decode_and_load_equal_jax(files, kind):
    path = files[kind]
    got, sr = tlibav.decode_audio(path)
    want, want_sr = jlibav.decode_audio(path)
    assert sr == want_sr and got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert len(got) > 0.9 * sr
    got, sr = tlibav.decode_audio(path, target_sr=8000)
    want, _ = jlibav.decode_audio(path, target_sr=8000)
    assert sr == 8000 and got.tobytes() == want.tobytes()
    got, sr = tio.load_wav(path, target_sr=SR)
    want, want_sr = jio.load_wav(path, target_sr=SR)
    assert sr == want_sr == SR and got.ndim == 1 and got.tobytes() == want.tobytes()
    if kind == "mp3":
        got, sr = tmpeg.decode_mpeg(path)
        want, want_sr = jmpeg.decode_mpeg(path)
        assert sr == want_sr and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", SAMPLES)
def test_repo_samples_load_as_in_jax(name):
    """The repo's mp3 prompts through ``load_wav`` (libmpg123 first, then the
    shim), as the JAX package loads them."""
    path = tio.sample_path(name)
    assert path == jio.sample_path(name)
    got, sr = tio.load_wav(path, target_sr=SR)
    want, _ = jio.load_wav(path, target_sr=SR)
    assert sr == SR and got.tobytes() == want.tobytes() and len(got) > SR
    if tmpeg.mpeg_supported():
        raw, raw_sr = tmpeg.decode_mpeg(path)
        jraw, _ = jmpeg.decode_mpeg(path)
        assert raw.tobytes() == jraw.tobytes() and raw_sr in (16000, 22050, 24000, 44100, 48000)


def test_sample_path_names_the_directory():
    with pytest.raises(FileNotFoundError, match="samples"):
        tio.sample_path("missing.mp3")


def test_save_audio_round_trips(shim, tmp_path):
    wav = _tone()
    tio.save_audio(wav, tmp_path / "x.flac", SR)
    back, sr = tio.load_wav(tmp_path / "x.flac")
    assert sr == SR and len(back) == len(wav)
    np.testing.assert_allclose(back, wav, atol=1.0 / 32767)
    tio.save_audio(wav, tmp_path / "x.wav", SR)  # float PCM, no rescaling
    back, _ = tio.load_wav(tmp_path / "x.wav")
    assert back.tobytes() == wav.tobytes()
    for ext in (".ogg", ".mp3"):
        tio.save_audio(wav, tmp_path / f"x{ext}", SR)
        back, sr = tio.load_wav(tmp_path / f"x{ext}", target_sr=SR)
        assert sr == SR and abs(len(back) - len(wav)) < SR // 10
        mid = slice(len(wav) // 4, len(wav) // 2)
        rms = float(np.sqrt(np.mean(wav[mid] ** 2)))
        assert abs(float(np.sqrt(np.mean(back[mid] ** 2))) - rms) / rms < 0.1, ext
    with pytest.raises(RuntimeError, match="decode failed"):
        tlibav.decode_audio(tmp_path / "missing.flac")


def test_compressed_audio_raises_without_a_decoder(tmp_path, monkeypatch):
    """The shim's loader pointed at a missing source, and no libmpg123."""
    monkeypatch.setattr(_build, "CODEC_SRC", tmp_path / "missing" / "audio_codec.c")
    monkeypatch.setattr(tlibav, "_lib", None)
    monkeypatch.setattr(tlibav, "_error", None)
    monkeypatch.setattr(tmpeg, "_mpg123", None)
    monkeypatch.setattr(tmpeg, "_mpg123_checked", True)
    assert not tlibav.libav_supported()
    assert "audio_codec.c" in tlibav.load_error()
    (tmp_path / "x.flac").write_bytes(b"")
    (tmp_path / "x.mp3").write_bytes(b"")
    with pytest.raises(tio.UnsupportedAudioFormat, match="No decoder for .flac.*audio_codec.c"):
        tio.load_wav(tmp_path / "x.flac")
    with pytest.raises(tio.UnsupportedAudioFormat, match="libmpg123"):
        tio.load_wav(tmp_path / "x.mp3")
    with pytest.raises(tio.UnsupportedAudioFormat, match="No encoder for .ogg"):
        tio.save_audio(_tone(), tmp_path / "y.ogg", SR)
    with pytest.raises(RuntimeError, match="not available for decoding"):
        tlibav.decode_audio(tmp_path / "x.flac")
    tio.save_audio(_tone(), tmp_path / "y.wav", SR)  # wav needs no shim
    assert tio.load_wav(tmp_path / "y.wav")[1] == SR


def test_codec_build_names_missing_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "FFMPEG_PROBE", "#include <libavformat/no_such_header.h>\n")
    with pytest.raises(RuntimeError, match="FFmpeg headers.*not found"):
        _build.build_audio_codec()
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def test_codec_builds_once_under_threads(shim, tmp_path, monkeypatch):
    """Four threads ask for the shim in a cold build directory: one gcc
    build, one library for all of them, no temporary file left."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    calls, real_run = [], _build.subprocess.run

    def run(cmd, **kw):
        calls.append(cmd[:2])
        return real_run(cmd, **kw)

    monkeypatch.setattr(_build.subprocess, "run", run)
    paths = _run_threads(4, _build.build_audio_codec)
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path and paths[0].is_file()
    assert calls.count(["gcc", "-E"]) == 1 and len(calls) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["audio_codec.lock", paths[0].name]
    lib = ctypes.CDLL(str(paths[0]))
    assert lib.rtvc_decode_audio and lib.rtvc_encode_audio


# ---------------------------------------------------------------------------
# The kernel library's build and the launch counts under threads
# ---------------------------------------------------------------------------


def _run_threads(n, fn):
    """``fn()`` on ``n`` threads released together; their results in order."""
    barrier, out, errors = threading.Barrier(n), [None] * n, []

    def work(i):
        try:
            barrier.wait(timeout=30)
            out[i] = fn()
        except BaseException as e:  # reported below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    assert not errors, errors
    return out


FAKE_NVCC = """#!/bin/sh
# logs its arguments, sleeps so that callers overlap, writes its -o file
echo "$@" >> "{log}"
sleep 0.2
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo fake > "$2"; fi
  shift
done
"""


def test_kernel_library_builds_once_under_threads(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    loaded = []

    def fake_cdll(path):
        loaded.append(path)
        return types.SimpleNamespace(**{name: types.SimpleNamespace()
                                        for name in _build.SIGNATURES})

    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    libs = _run_threads(4, _build.library)
    assert all(lib is libs[0] for lib in libs) and _build._lib is libs[0]
    assert loaded == [str(_build.library_path())]
    calls = log.read_text().splitlines()
    cu, _ = _build._sources()
    compiled = sorted(Path(c.split()[-1]).name for c in calls if " -c " in c)
    assert compiled == sorted(f.name for f in cu) and len(cu) >= 6
    assert sum(c.startswith("-shared ") for c in calls) == 1 and len(calls) == len(cu) + 1
    assert sorted(p.name for p in build_dir.iterdir()) == [_build.library_path().name]
    # a later build finds the library and compiles nothing
    assert _build.build() == _build.library_path() and len(log.read_text().splitlines()) == \
        len(calls)


class _SlowCounter(collections.Counter):
    """A Counter whose item access runs Python code, so that the interpreter
    may switch threads between the read and the write of a ``+=`` (a plain
    Counter's C-level access gives it no point to switch at in CPython
    3.12, so a lost count would not show)."""

    def __getitem__(self, key):
        return super().__getitem__(key)

    def __setitem__(self, key, value):
        super().__setitem__(key, value)


def test_count_launch_loses_no_count_under_threads(monkeypatch):
    monkeypatch.setattr(_build, "launch_counts", _SlowCounter())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads(8, lambda: [_build.count_launch("probe") for _ in range(10_000)])
    finally:
        sys.setswitchinterval(old)
    assert _build.launch_counts == {"probe": 80_000}
