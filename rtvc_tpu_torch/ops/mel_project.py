"""K6: mel-filterbank projection of |STFT| magnitudes fused with the dB
conversion, the reference-level shift and the normalisation.

``mel_project_normalize`` launches the CUDA kernel in
``csrc/mel_project.cu`` for CUDA tensors and runs
``mel_project_normalize_plain`` for CPU tensors. It replaces
``rtvc_tpu/ops/pallas/mel_kernel.py:mel_project_normalize``. Like that
kernel it always normalises; ``ops.audio.melspectrogram`` calls it when
``pp.signal_normalization`` is set.
"""
from __future__ import annotations

import functools
import math

import torch

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.config.signal import PreprocessingParams, SignalParams
from rtvc_tpu_torch.ops import mel as mel_ops

Tensor = torch.Tensor

# the kernel keeps at most this many mel rows per thread group
# (csrc/mel_project.cu: kMelGroups · kMaxMelsPerThread)
MAX_MELS = 128


@functools.lru_cache(maxsize=8)
def _basis_on(key: tuple, device: torch.device) -> Tensor:
    return torch.from_numpy(mel_ops.mel_filterbank(*key)).to(device)


def mel_basis(sp: SignalParams, device) -> Tensor:
    """The (num_mels, 1 + n_fft // 2) mel filterbank of ``sp`` on ``device``
    (uploaded once per device and kept: treat it as read-only)."""
    key = (sp.sample_rate, sp.n_fft, sp.num_mels, sp.fmin, sp.fmax)
    return _basis_on(key, torch.device(device))


def _min_level(sp: SignalParams) -> float:
    return math.exp(sp.min_level_db / 20.0 * math.log(10.0))


def mel_project_normalize_plain(mag: Tensor, sp: SignalParams, pp: PreprocessingParams
                                ) -> Tensor:
    """|STFT| magnitudes (n_bins, T) → normalised mel (num_mels, T):
    ``basis @ mag``, 20·log10 with the floor of ``min_level_db``, minus
    ``ref_level_db``, scaled by ``-min_level_db`` to [-max_abs, max_abs]
    (symmetric) or [0, max_abs], clipped if the config says so."""
    mel = mel_basis(sp, mag.device) @ mag
    db = 20.0 * torch.log10(mel.clamp(min=_min_level(sp))) - sp.ref_level_db
    scaled = (db - sp.min_level_db) / (-sp.min_level_db)
    if pp.symmetric_mels:
        out = (2.0 * sp.max_abs_value) * scaled - sp.max_abs_value
        lo, hi = -sp.max_abs_value, sp.max_abs_value
    else:
        out = sp.max_abs_value * scaled
        lo, hi = 0.0, sp.max_abs_value
    if pp.allow_clipping_in_normalization:
        out = out.clamp(lo, hi)
    return out


def mel_project_normalize(mag: Tensor, sp: SignalParams, pp: PreprocessingParams) -> Tensor:
    """Same contract as :func:`mel_project_normalize_plain`; a CUDA tensor
    (f32, contiguous, (n_bins, T)) goes through the kernel."""
    if not mag.is_cuda:
        return mel_project_normalize_plain(mag, sp, pp)
    n_bins, T = mag.shape
    basis = mel_basis(sp, mag.device)
    if sp.num_mels > MAX_MELS:
        raise ValueError(f"mel_project: at most {MAX_MELS} mel bins, got {sp.num_mels}")
    _build.check_tensors("mel_project", mag.device, mag=(mag, (n_bins, T)),
                         basis=(basis, (sp.num_mels, n_bins)))
    lib = _build.library()
    out = torch.empty((sp.num_mels, T), device=mag.device, dtype=torch.float32)
    if T > 0:
        err = lib.rtvc_mel_project(
            mag.data_ptr(), basis.data_ptr(), out.data_ptr(), n_bins, T, sp.num_mels,
            _min_level(sp), float(sp.ref_level_db), float(sp.min_level_db),
            float(sp.max_abs_value), int(bool(pp.symmetric_mels)),
            int(bool(pp.allow_clipping_in_normalization)), _build.stream_handle(mag.device))
        _build.check(err, "rtvc_mel_project")
        _build.launch_counts["mel_project"] += 1
    return out
