"""Build and load the package's CUDA kernels.

The kernels are plain CUDA C++ with a C interface (``csrc/*.cu``). On first
use each source is compiled by its own ``nvcc`` for Hopper (``sm_90a``), all
started together, and the objects are linked into one shared library under
``rtvc_tpu_torch/build/`` that is loaded with ``ctypes``; a source hash in
the library's file name triggers a rebuild when any source changes. A file
with a C interface builds in seconds, where an extension that includes
PyTorch's headers takes minutes.

Nothing here runs at import time: the CPU path of every wrapper never
touches this module's build.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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

# C entry points and their argument types. Every entry returns the
# cudaError_t of its launch (0 on success).
SIGNATURES = {
    # xg, w_hh, h0, c0, ys, hT, cT, cs (or null), gates (or null), B, T, H,
    # stream
    "rtvc_lstm_seq_fwd": [_P] * 9 + [_I] * 3 + [_P],
    # dys, dhT, dcT, gates, cs, c0, w_hh_t, dxg, dh0, dc0, B, T, H, stream
    "rtvc_lstm_seq_bwd": [_P] * 10 + [_I] * 3 + [_P],
    # xg, w_hh, b_hh, ys, gates, B, T, H, stream
    "rtvc_gru_seq_fwd": [_P] * 5 + [_I] * 3 + [_P],
    # dys, gates, ys, w_hh_t, dxg, B, T, H, stream
    "rtvc_gru_seq_bwd": [_P] * 5 + [_I] * 3 + [_P],
    # weights, dims, seed, enc_seq, enc_proj, char_mask, mel, attn, stops,
    # work, stream
    "rtvc_tacotron_decode": [_PP, _IP, _U64] + [_P] * 7 + [_P],
    # dims (as for rtvc_tacotron_decode) → floats of workspace needed
    "rtvc_tacotron_workspace": [_IP],
    # weights, streams, dims, argmax, seed, out, logits_out (or null), stream
    "rtvc_wavernn_generate": [_PP, _PP, _IP, _I, _U64, _P, _P, _P],
    # weights, inputs, outputs, dims (n, B, T, D, L, E, KS), stream
    "rtvc_tacotron_train_fwd": [_PP, _PP, _PP, _IP, _P],
    "rtvc_tacotron_train_bwd": [_PP, _PP, _PP, _IP, _P],
    # dims, backward (0 or 1) → bytes of shared memory a CTA takes
    "rtvc_tacotron_train_smem": [_IP, _I],
}

# Launches per kernel since the last reset; each wrapper adds one where it
# launches its kernel and nowhere else.
launch_counts: collections.Counter = collections.Counter()

_lib = None
build_log = ""


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


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library for these exact sources
    exists; returns its path. Raises RuntimeError if nvcc fails."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
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
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


def check_tensors(fn: str, device, **specs) -> None:
    """Raise ValueError unless every ``name=(tensor, shape)`` is a
    contiguous f32 tensor of that shape on ``device``."""
    import torch

    for name, (t, shape) in specs.items():
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be f32 on {device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous {tuple(shape)}, "
                             f"got {tuple(t.shape)}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def pointer_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*[int(v) for v in values])
