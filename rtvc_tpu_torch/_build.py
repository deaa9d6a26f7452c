"""Build and load the package's CUDA kernels.

The kernels are plain CUDA C++ with a C interface (``csrc/*.cu``). On first
use each source is compiled by its own ``nvcc`` for Hopper (``sm_90a``), all
started together, and the objects are linked into one shared library under
``rtvc_tpu_torch/build/`` that is loaded with ``ctypes``; a source hash in
the library's file name triggers a rebuild when any source changes. A file
with a C interface builds in seconds, where an extension that includes
PyTorch's headers takes minutes.

The same module builds two host libraries into the same directory, each
under a source hash: the audio codec shim (``native/src/audio_codec.c``,
over the system FFmpeg libraries) with ``gcc``
(:func:`build_audio_codec`), and the native WaveRNN engine
(``native/src/wavernn_engine.cpp``, the vocoder's CPU backend) and its
command line tool with ``g++`` (:func:`build_wavernn_engine`).

Nothing here runs at import time: the CPU path of every wrapper never
touches this module's build. Both builds and the launch counts are safe to
use from many threads: the passes of ``data/`` call the kernels from thread
pools.
"""
from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)
_U64 = ctypes.c_ulonglong
_F = ctypes.c_float

# C entry points and their argument types. Every entry returns the
# cudaError_t of its launch (0 on success).
SIGNATURES = {
    # xg, w_hh, h0, c0, ys, hT, cT, cs (or null), gates (or null), B, T, H,
    # plan (ops/lstm_seq.py:Plan), sync (32 zeroed words a group), stream
    "rtvc_lstm_seq_fwd": [_P] * 9 + [_I] * 3 + [_IP, _P, _P],
    # dys, dhT, dcT, gates, cs, c0, w_hh, dxg, dh0, dc0, B, T, H, plan, sync,
    # stream
    "rtvc_lstm_seq_bwd": [_P] * 10 + [_I] * 3 + [_IP, _P, _P],
    # the bf16 instantiations: as above, the forward with its f32 exchange
    # buffer hx after the outputs
    "rtvc_lstm_seq_fwd_bf16": [_P] * 10 + [_I] * 3 + [_IP, _P, _P],
    "rtvc_lstm_seq_bwd_bf16": [_P] * 10 + [_I] * 3 + [_IP, _P, _P],
    # K3's tensor-core mode for bf16 streams (csrc/lstm_seq_mma.cu; plan
    # ops/lstm_seq.py:MmaPlan): the forward's arguments with the exchange of
    # h's hi/lo fragments after the outputs; the backward's with the
    # exchange of dxg's fragments and the f32 partial dh after the outputs
    "rtvc_lstm_mma_fwd_bf16": [_P] * 10 + [_I] * 3 + [_IP, _P, _P],
    "rtvc_lstm_mma_bwd_bf16": [_P] * 12 + [_I] * 3 + [_IP, _P, _P],
    # sync (one zeroed word), CTAs, barriers, stream
    "rtvc_grid_barrier_steps": [_P, _I, _I, _P],
    # out: SMs of the current device, shared-memory bytes a block may opt in to
    "rtvc_device_limits": [_IP],
    # xg, w_hh, b_hh, ys, gates, B, T, H, plan (ops/gru_seq.py:Plan), sync,
    # stream
    "rtvc_gru_seq_fwd": [_P] * 5 + [_I] * 3 + [_IP, _P, _P],
    # dys, gates, ys, w_hh, dxg, dhg, carry, B, T, H, plan, sync, stream
    "rtvc_gru_seq_bwd": [_P] * 7 + [_I] * 3 + [_IP, _P, _P],
    # the bf16 instantiations: as above, the forward with its f32 exchange
    # buffer hx after the outputs
    "rtvc_gru_seq_fwd_bf16": [_P] * 6 + [_I] * 3 + [_IP, _P, _P],
    "rtvc_gru_seq_bwd_bf16": [_P] * 7 + [_I] * 3 + [_IP, _P, _P],
    # K4's row-resident mode (H <= 128): xg, w_hh, b_hh, ys, gates, B, T, H,
    # plan (ops/gru_seq.py:RowPlan), stream; and dys, gates, ys, w_hh, dxg,
    # dhg, B, T, H, plan, stream; each also in bf16
    "rtvc_gru_rows_fwd": [_P] * 5 + [_I] * 3 + [_IP, _P],
    "rtvc_gru_rows_fwd_bf16": [_P] * 5 + [_I] * 3 + [_IP, _P],
    "rtvc_gru_rows_bwd": [_P] * 6 + [_I] * 3 + [_IP, _P],
    "rtvc_gru_rows_bwd_bf16": [_P] * 6 + [_I] * 3 + [_IP, _P],
    # weights, dims, their count, plan (ops/tacotron_decode.py:Plan.ints), its
    # length, seed, enc_seq, enc_proj, char_mask, mel, attn, stops, work,
    # carry in and out (8 pointers each, or null), done in, flags out, pad,
    # stream
    "rtvc_tacotron_decode": [_PP, _IP, _I, _IP, _I, _U64] + [_P] * 7 + [_PP, _PP, _P, _P, _F,
                                                                        _P],
    # weights, streams, dims (with the plan, ops/wavernn_generate.py:Plan),
    # argmax, seed, scratch, sync, out, logits_out (or null), stream
    "rtvc_wavernn_generate": [_PP, _PP, _IP, _I, _U64, _P, _P, _P, _P, _P],
    # mag, band weights, bands (ops/mel_project.py:mel_bands), out, n_bins, T,
    # num_mels, mels a CTA, shared-memory bytes, min_level, ref_level_db,
    # min_level_db, max_abs_value, symmetric, clip, stream
    "rtvc_mel_project": [_P] * 4 + [_I] * 5 + [_F] * 4 + [_I] * 2 + [_P],
    # weights, their strides, inputs, outputs, dims (n, B, T, D, L, E, KS),
    # plan (ops/tacotron_train.py:FwdPlan.ints), its length, work, stream
    "rtvc_tacotron_train_fwd": [_PP, _IP, _PP, _PP, _IP, _IP, _I, _P, _P],
    # the same for the backward (BwdPlan.ints)
    "rtvc_tacotron_train_bwd": [_PP, _IP, _PP, _PP, _IP, _IP, _I, _P, _P],
}

# Launches per kernel since the last reset; each wrapper adds one where it
# launches its kernel and nowhere else, through count_launch.
launch_counts: collections.Counter = collections.Counter()
_count_lock = threading.Lock()

_lib = None
_lib_lock = threading.Lock()  # held by library() and build()
build_log = ""


def count_launch(name: str) -> None:
    """Add one to ``launch_counts[name]``; atomic under threads (a bare
    ``+=`` on a Counter is a read and a write that two threads can
    interleave, losing a count)."""
    with _count_lock:
        launch_counts[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librtvc_kernels_{h.hexdigest()[:16]}.so"


def _tmp_name(out: Path) -> Path:
    """A temporary name beside ``out`` that no other process or thread uses."""
    return out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library for these exact sources
    exists; returns its path. Raises RuntimeError if nvcc fails. A thread
    that calls it while another builds waits for that build and returns its
    library; processes each build under names of their own and the last
    ``os.replace`` wins."""
    with _lib_lock:
        return _build_locked()


def _build_locked() -> Path:
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    tmp = _tmp_name(out)
    objs = [tmp.with_name(f"{tmp.name}.{f.stem}.o") for f in cu]
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c",
                                   "-o", str(o), str(f)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for f, o in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        for f, p, log in zip(cu, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {f.name} ({p.returncode}):\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; the first callers of
    many threads wait for one build and one load)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build_locked()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# The audio codec shim: decode and encode through the system FFmpeg
# libraries, built on first use (utils/libav.py).
CODEC_SRC = _PKG / "native" / "src" / "audio_codec.c"
CODEC_FLAGS = ["-O2", "-fPIC", "-Wall", "-shared"]
CODEC_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswresample"]
FFMPEG_PROBE = "#include <libavformat/avformat.h>\n"
_codec_lock = threading.Lock()


def codec_library_path() -> Path:
    h = hashlib.sha256(" ".join(CODEC_FLAGS + CODEC_LIBS).encode())
    h.update(CODEC_SRC.read_bytes())
    return BUILD_DIR / f"librtvc_audio_{h.hexdigest()[:16]}.so"


def ffmpeg_headers() -> tuple:
    """(found, the preprocessor's output): whether ``gcc`` finds FFmpeg's
    headers, the probe ``rtvc_tpu/native/build.sh`` makes."""
    try:
        probe = subprocess.run(["gcc", "-E", "-"], input=FFMPEG_PROBE, capture_output=True,
                               text=True, timeout=60)
    except OSError as e:  # no gcc
        return False, str(e)
    return probe.returncode == 0, probe.stderr[-2000:]


def build_audio_codec() -> Path:
    """Compile ``native/src/audio_codec.c`` with ``gcc`` into
    ``build/librtvc_audio_<hash>.so`` unless it exists; returns its path.
    Runs under a thread lock and an ``fcntl`` lock on a file in the build
    directory, so that threads and processes (test workers) asking at once
    build it once. Raises RuntimeError with the compiler's output when the
    FFmpeg headers are missing or the build fails; OSError when the source
    cannot be read."""
    out = codec_library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _codec_lock, open(BUILD_DIR / "audio_codec.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        found, log = ffmpeg_headers()
        if not found:
            raise RuntimeError(f"the FFmpeg headers (libavformat/avformat.h) were not found, "
                               f"so the audio codec shim was not built:\n{log}")
        tmp = _tmp_name(out)
        try:
            proc = subprocess.run(["gcc", *CODEC_FLAGS, str(CODEC_SRC), *CODEC_LIBS, "-o",
                                   str(tmp)], capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"building the audio codec shim failed ({proc.returncode}):"
                                   f"\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


# The native WaveRNN engine (native/libwavernn.py): a host CPU engine in C++,
# the vocoder's second backend, with the flags of rtvc_tpu/native/build.sh.
ENGINE_SRC_DIR = _PKG / "native" / "src"
ENGINE_SOURCES = ("wavernn_engine.cpp", "wavernn_engine.h", "vocoder_cli.cpp")
ENGINE_FLAGS = ["-O3", "-march=native", "-ffast-math", "-std=c++17", "-fPIC", "-Wall"]
# The library is compiled with ENGINE_FLAGS and linked without -ffast-math:
# linked with it, g++ adds crtfastmath.o, whose constructor turns on
# flush-to-zero and denormals-are-zero for the whole process that loads the
# library, so every later float operation of that process would change.
ENGINE_LINK_FLAGS = ["-shared", "-fPIC"]


class WavernnEngine(NamedTuple):
    library: Path  # librtvc_wavernn_<hash>.so, the ctypes surface
    cli: Path  # rtvc_vocoder_<hash>, the standalone command line tool


def wavernn_engine_paths() -> WavernnEngine:
    h = hashlib.sha256(" ".join(ENGINE_FLAGS + ENGINE_LINK_FLAGS).encode())
    for name in ENGINE_SOURCES:
        h.update(name.encode())
        h.update((ENGINE_SRC_DIR / name).read_bytes())
    tag = h.hexdigest()[:16]
    return WavernnEngine(BUILD_DIR / f"librtvc_wavernn_{tag}.so", BUILD_DIR / f"rtvc_vocoder_{tag}")


def build_wavernn_engine() -> WavernnEngine:
    """Compile ``native/src/wavernn_engine.cpp`` into a shared library (linked
    without ``-ffast-math``: ``ENGINE_LINK_FLAGS``) and, with
    ``vocoder_cli.cpp``, the ``rtvc_vocoder`` command, with ``g++`` into
    ``build/`` under the sources' and flags' hash, unless both exist; returns
    their paths. Runs under the kernels' build lock (``library`` and
    ``build``) and an ``fcntl`` lock on a file in the build directory, so
    that threads and processes asking at once build it once. Raises
    RuntimeError with the compiler's output when a build fails. The
    binaries are for the host that built them (``-march=native``)."""
    out = wavernn_engine_paths()
    if out.library.exists() and out.cli.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lib_lock, open(BUILD_DIR / "wavernn_engine.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        cxx = os.environ.get("CXX", "g++")
        engine = str(ENGINE_SRC_DIR / "wavernn_engine.cpp")
        # the library's object and the command, compiled side by side; a
        # file another process built while this one waited is not built again
        jobs = [(path, _tmp_name(path), args) for path, args in (
            (out.library, ["-c", engine]),
            (out.cli, [engine, str(ENGINE_SRC_DIR / "vocoder_cli.cpp")]))
            if not path.exists()]
        linked = _tmp_name(out.library).with_suffix(".so.tmp")
        try:
            procs = [subprocess.Popen([cxx, *ENGINE_FLAGS, *args, "-o", str(tmp)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for _, tmp, args in jobs]
            logs = [p.communicate(timeout=600)[0] for p in procs]
            for (path, tmp, _), p, log in zip(jobs, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"building {path.name} failed ({p.returncode}):\n{log}")
                if path == out.library:
                    link = subprocess.run([cxx, *ENGINE_LINK_FLAGS, str(tmp), "-o", str(linked)],
                                          capture_output=True, text=True, timeout=600)
                    if link.returncode != 0:
                        raise RuntimeError(f"linking {path.name} failed ({link.returncode}):\n"
                                           f"{link.stdout}{link.stderr}")
                    tmp = linked
                os.replace(tmp, path)
        finally:
            for f in (*(tmp for _, tmp, _ in jobs), linked):
                f.unlink(missing_ok=True)
    return out


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


def check_tensors(fn: str, device, **specs) -> None:
    """Raise ValueError unless every ``name=(tensor, shape)`` is a
    contiguous f32 tensor of that shape on ``device``; ``name=(tensor,
    shape, dtype)`` asks for that dtype instead (the streams of the bf16
    instantiations), which must be f32 or bf16."""
    import torch

    for name, (t, shape, *dtype) in specs.items():
        want = dtype[0] if dtype else torch.float32
        elem_bytes(want)
        if t.device != device or t.dtype != want:
            label = "f32" if want == torch.float32 else "bf16"
            raise ValueError(f"{fn}: {name} must be {label} on {device}, got {t.dtype} on "
                             f"{t.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous {tuple(shape)}, "
                             f"got {tuple(t.shape)}")


def elem_bytes(dtype) -> int:
    """Bytes an element of a kernel stream's dtype takes: f32 or bf16."""
    import torch

    sizes = {torch.float32: 4, torch.bfloat16: 2}
    if dtype not in sizes:
        raise ValueError(f"the kernels take f32 or bf16 streams, not {dtype}")
    return sizes[dtype]


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def pointer_array(tensors) -> ctypes.Array:
    """Device pointers of ``tensors`` as a C array; ``None`` gives a null."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


_limits: dict = {}


def device_limits(device) -> tuple:
    """(SM count, bytes of shared memory a block may opt in to) of a CUDA
    device, asked of the CUDA runtime once: what every kernel's plan is cut
    from."""
    import torch

    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _limits:
        out = int_array([0, 0])
        with torch.cuda.device(index):
            check(library().rtvc_device_limits(out), "rtvc_device_limits")
        _limits[index] = (int(out[0]), int(out[1]))
    return _limits[index]
