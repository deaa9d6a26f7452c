"""K6: mel-filterbank projection of |STFT| magnitudes fused with the dB
conversion, the reference-level shift and the normalisation.

``mel_project_normalize`` launches the CUDA kernel in
``csrc/mel_project.cu`` for CUDA tensors and runs
``mel_project_normalize_plain`` (the dense ``basis @ mag``) for CPU
tensors. The kernel sums each mel row over its band only: ``mel_bands``
derives the runs of non-zero bins from the basis, once per basis. It
replaces ``rtvc_tpu/ops/pallas/mel_kernel.py:mel_project_normalize``. Like
that kernel it always normalises; ``ops.audio.melspectrogram`` calls it when
``pp.signal_normalization`` is set.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.config.signal import PreprocessingParams, SignalParams
from rtvc_tpu_torch.ops import mel as mel_ops

Tensor = torch.Tensor

FRAMES = 32  # frames a CTA, one a lane (csrc/mel_project.cu:kFrames)
MELS_PER_CTA = (8, 4, 2, 1)  # mel rows a CTA, one a warp, the most first


class MelBands(NamedTuple):
    """The runs of non-zero bins of a filterbank's rows: row m's run is bins
    ``first[m]`` to ``first[m] + width[m] - 1`` (the first to the last
    non-zero; width 0 for a row of zeros), its weights
    ``weights[offset[m]:offset[m] + width[m]]``."""
    first: np.ndarray   # (num_mels,) int32
    width: np.ndarray   # (num_mels,) int32
    offset: np.ndarray  # (num_mels,) int32, the running sum of width
    weights: np.ndarray  # (sum(width),) float32


def mel_bands(basis: np.ndarray) -> MelBands:
    """The :class:`MelBands` of a (num_mels, n_bins) filterbank. A banded
    sum in bin order equals the dense one in bin order bit for bit: what it
    skips are exact zeros."""
    basis = np.asarray(basis, np.float32)
    nz = basis != 0
    rows = nz.any(axis=1)
    first = np.where(rows, nz.argmax(axis=1), 0)
    last = np.where(rows, basis.shape[1] - 1 - nz[:, ::-1].argmax(axis=1), -1)
    width = last - first + 1
    offset = np.cumsum(width) - width
    runs = [basis[m, f:f + w] for m, (f, w) in enumerate(zip(first, width))]
    return MelBands(first.astype(np.int32), width.astype(np.int32), offset.astype(np.int32),
                    np.concatenate([np.zeros(0, np.float32), *runs]))


def mels_per_cta(T: int, num_mels: int, sm_count: int) -> int:
    """Mel rows a CTA: the most of ``MELS_PER_CTA`` that still gives at
    least two CTAs an SM (8 at 4801 frames, 2 at 302 on 132 SMs), else one."""
    tiles = -(-T // FRAMES)
    for mpc in MELS_PER_CTA:
        if tiles * -(-num_mels // mpc) >= 2 * sm_count:
            return mpc
    return MELS_PER_CTA[-1]


def shared_bytes(bands: MelBands, mpc: int) -> int:
    """Shared memory of the largest CTA with ``mpc`` rows a group: its band
    weights, rounded up to 4, and its joint band of magnitudes x 32 frames."""
    most = 0
    for m0 in range(0, len(bands.first), mpc):
        w = bands.width[m0:m0 + mpc]
        f = bands.first[m0:m0 + mpc][w > 0]
        rows = int((f + w[w > 0]).max() - f.min()) if len(f) else 0
        most = max(most, -(-int(w.sum()) // 4) * 4 + rows * FRAMES)
    return 4 * most


@functools.lru_cache(maxsize=8)
def _basis_on(key: tuple, device: torch.device) -> Tensor:
    return torch.from_numpy(mel_ops.mel_filterbank(*key)).to(device)


def mel_basis(sp: SignalParams, device) -> Tensor:
    """The (num_mels, 1 + n_fft // 2) mel filterbank of ``sp`` on ``device``
    (uploaded once per device and kept: treat it as read-only)."""
    key = (sp.sample_rate, sp.n_fft, sp.num_mels, sp.fmin, sp.fmax)
    return _basis_on(key, torch.device(device))


class _Prepared(NamedTuple):
    """What a launch needs that depends only on the config and the device,
    worked out once: the bands on the card, the shared memory of each group
    size and the card's limits."""
    table: Tensor    # (num_mels, 4) int32: first, width, offset, 0
    weights: Tensor  # the packed runs (one zero where there are none)
    smem: dict       # mels a CTA → shared-memory bytes
    sm_count: int
    smem_limit: int
    min_level: float


@functools.lru_cache(maxsize=8)
def _prepared(sp: SignalParams, device: torch.device) -> _Prepared:
    b = mel_bands(mel_basis(sp, device).cpu().numpy())
    table = np.stack([b.first, b.width, b.offset, np.zeros_like(b.first)], axis=1)
    weights = b.weights if len(b.weights) else np.zeros(1, np.float32)
    return _Prepared(torch.from_numpy(table).to(device), torch.from_numpy(weights).to(device),
                     {mpc: shared_bytes(b, mpc) for mpc in MELS_PER_CTA},
                     *_build.device_limits(device), _min_level(sp))


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
    _build.check_tensors("mel_project", mag.device, mag=(mag, (n_bins, T)),
                         basis=(basis, (sp.num_mels, n_bins)))
    out = torch.empty((sp.num_mels, T), device=mag.device, dtype=torch.float32)
    if T == 0:
        return out
    k = _prepared(sp, mag.device)
    mpc = mels_per_cta(T, sp.num_mels, k.sm_count)
    if k.smem[mpc] > k.smem_limit:
        raise ValueError(f"mel_project: a group of {mpc} mel rows needs {k.smem[mpc]} bytes "
                         f"of shared memory for its bands, past the card's {k.smem_limit}")
    err = _build.library().rtvc_mel_project(
        mag.data_ptr(), k.weights.data_ptr(), k.table.data_ptr(), out.data_ptr(), n_bins, T,
        sp.num_mels, mpc, k.smem[mpc], k.min_level, sp.ref_level_db, sp.min_level_db,
        sp.max_abs_value, pp.symmetric_mels, pp.allow_clipping_in_normalization,
        _build.stream_handle(mag.device))
    _build.check(err, "rtvc_mel_project")
    _build.count_launch("mel_project")
    return out
