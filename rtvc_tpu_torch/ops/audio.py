"""Audio DSP on tensors (counterpart of ``rtvc_tpu/ops/audio.py``):

* synthesizer path: pre-emphasis → STFT → mel → dB → [-4, 4] normalisation
  (``melspectrogram``; its projection and normalisation run through the K6
  kernel, ``ops.mel_project``) and the way back by Griffin-Lim
  (``inv_mel_spectrogram``);
* vocoder path: label / mu-law codecs, pre- and de-emphasis, and the
  16-bit signal as two bytes (``split_signal`` / ``combine_signal``);
* encoder path: the 40-mel power spectrogram and volume normalisation.

``sp`` and ``pp`` are ``config.signal``'s ``SignalParams`` and
``PreprocessingParams``. The random initial phase of Griffin-Lim comes from
a ``torch.Generator``, or from ``angles`` where the caller injects it.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import scipy.signal
import torch

from rtvc_tpu_torch.config.signal import PreprocessingParams, SignalParams
from rtvc_tpu_torch.ops import mel as mel_ops
from rtvc_tpu_torch.ops import stft as stft_ops
from rtvc_tpu_torch.ops.mel_project import mel_project_normalize
from rtvc_tpu_torch.ops.stft import hann_window, stft_magnitude  # noqa: F401  (re-exported)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Pre-emphasis filters
# ---------------------------------------------------------------------------


def preemphasis(wav: Tensor, k: float) -> Tensor:
    """FIR y[n] = x[n] - k·x[n-1]."""
    return torch.cat([wav[:1], wav[1:] - k * wav[:-1]])


def inv_preemphasis(wav: Tensor, k: float) -> Tensor:
    """IIR y[n] = x[n] + k·y[n-1] over a whole waveform, in float64, as a
    float32 tensor on ``wav``'s device: a CPU tensor through scipy's
    ``lfilter``, a CUDA tensor on the card by :func:`iir_blocks` (a host
    filter would wait for the card there, and a streamed vocode would wait
    for each chunk's sample loop before it could queue the next)."""
    if wav.is_cuda:
        return iir_blocks(wav.detach().double(), k).float()
    y = scipy.signal.lfilter([1.0], [1.0, -k], wav.detach().cpu().double().numpy())
    return torch.from_numpy(y.astype(np.float32))


IIR_BLOCK = 256


def iir_blocks(x: Tensor, k: float) -> Tensor:
    """y[n] = x[n] + k·y[n-1] from a zero state, in x's dtype, without a
    sequential loop: each block of ``IIR_BLOCK`` samples from a zero state
    is one product with the matrix of k^(i-j) (i ≥ j); the state entering a
    block is Σ_m k^(m·L) · e[b-1-m], e the blocks' zero-state last values,
    cut where k^(m·L) falls below 1e-18 (the whole sum when |k| ≥ 1)."""
    L = IIR_BLOCK
    n = x.shape[0]
    nb = max(-(-n // L), 1)
    xb = torch.nn.functional.pad(x, (0, nb * L - n)).view(nb, L)
    i = torch.arange(L, device=x.device, dtype=x.dtype)
    lag = i[:, None] - i[None, :]
    P = torch.where(lag >= 0, torch.full_like(lag, k) ** lag.clamp(min=0), torch.zeros_like(lag))
    y = xb @ P.t()
    e = y[:, -1]
    kL = abs(k) ** L
    if k == 0:
        terms = 0
    elif kL >= 1:
        terms = nb - 1
    else:
        terms = min(nb - 1, math.ceil(math.log(1e-18) / math.log(kL)))
    state = e.clone()
    for m in range(1, terms + 1):
        state[m:] += (k ** L) ** m * e[:nb - m]
    carry = torch.nn.functional.pad(state, (1, 0))[:nb]  # the state entering each block
    y = y + carry[:, None] * (torch.full_like(i, k) ** (i + 1))[None, :]
    return y.reshape(-1)[:n]


# the vocoder side's names for the same filters
pre_emphasis = preemphasis
de_emphasis = inv_preemphasis


# ---------------------------------------------------------------------------
# dB scaling and normalisation
# ---------------------------------------------------------------------------


def amp_to_db(x: Tensor, min_level_db: float) -> Tensor:
    """20·log10(max(min_level, x))."""
    min_level = math.exp(min_level_db / 20.0 * math.log(10.0))
    return 20.0 * torch.log10(x.clamp(min=min_level))


def db_to_amp(x: Tensor) -> Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_spectrogram(S: Tensor, sp: SignalParams, pp: PreprocessingParams) -> Tensor:
    """dB → [-max_abs, max_abs] (symmetric) or [0, max_abs]."""
    scaled = (S - sp.min_level_db) / (-sp.min_level_db)
    if pp.symmetric_mels:
        out = (2.0 * sp.max_abs_value) * scaled - sp.max_abs_value
        lo, hi = -sp.max_abs_value, sp.max_abs_value
    else:
        out = sp.max_abs_value * scaled
        lo, hi = 0.0, sp.max_abs_value
    if pp.allow_clipping_in_normalization:
        out = out.clamp(lo, hi)
    return out


def denormalize_spectrogram(D: Tensor, sp: SignalParams, pp: PreprocessingParams) -> Tensor:
    """Inverse of :func:`normalize_spectrogram`."""
    if pp.symmetric_mels:
        if pp.allow_clipping_in_normalization:
            D = D.clamp(-sp.max_abs_value, sp.max_abs_value)
        return ((D + sp.max_abs_value) * (-sp.min_level_db) / (2.0 * sp.max_abs_value)
                + sp.min_level_db)
    if pp.allow_clipping_in_normalization:
        D = D.clamp(0.0, sp.max_abs_value)
    return D * (-sp.min_level_db) / sp.max_abs_value + sp.min_level_db


# ---------------------------------------------------------------------------
# Spectrograms (synthesizer path)
# ---------------------------------------------------------------------------


def _stft_mag(wav: Tensor, sp: SignalParams) -> Tensor:
    if sp.preemphasize:
        wav = preemphasis(wav, sp.preemphasis)
    return stft_magnitude(wav, sp.n_fft, sp.hop_size, sp.win_size)


def melspectrogram(wav: Tensor, sp: SignalParams, pp: PreprocessingParams) -> Tensor:
    """Waveform → mel spectrogram in dB, shape (num_mels, T), normalised
    through K6 when ``pp.signal_normalization`` is set."""
    mag = _stft_mag(wav, sp)
    if pp.signal_normalization:
        return mel_project_normalize(mag.contiguous(), sp, pp)
    basis = torch.from_numpy(mel_ops.mel_filterbank(
        sp.sample_rate, sp.n_fft, sp.num_mels, sp.fmin, sp.fmax)).to(wav.device)
    return amp_to_db(basis @ mag, sp.min_level_db) - sp.ref_level_db


def linearspectrogram(wav: Tensor, sp: SignalParams, pp: PreprocessingParams) -> Tensor:
    """Waveform → linear spectrogram in dB, normalised when
    ``pp.signal_normalization`` is set."""
    S = amp_to_db(_stft_mag(wav, sp), sp.min_level_db) - sp.ref_level_db
    if pp.signal_normalization:
        return normalize_spectrogram(S, sp, pp)
    return S


# ---------------------------------------------------------------------------
# Griffin-Lim inversion
# ---------------------------------------------------------------------------


def _initial_phase(S: Tensor, generator: Optional[torch.Generator],
                   angles: Optional[Tensor]) -> Tensor:
    """exp(2πi·u) with u uniform in [0, 1) of S's shape: drawn from
    ``generator``, or the injected ``angles``."""
    if angles is None:
        angles = torch.rand(S.shape, generator=generator, device=S.device)
    return torch.polar(torch.ones_like(angles), 2.0 * math.pi * angles)


def griffin_lim(S: Tensor, sp: SignalParams, n_iters: int,
                generator: Optional[torch.Generator] = None, length: Optional[int] = None,
                angles: Optional[Tensor] = None) -> Tensor:
    """Phase recovery by iterated STFT projection: magnitudes S
    (1 + n_fft // 2, T) → waveform. The inner istft never trims, so every
    round trip keeps exactly T frames; ``length`` trims once at the end."""
    phase = _initial_phase(S, generator, angles)
    S = S.abs().to(torch.complex64)

    def _istft(spec):
        return stft_ops.istft(spec, sp.n_fft, sp.hop_size, sp.win_size)

    y = _istft(S * phase)
    for _ in range(n_iters):
        spec = stft_ops.stft(y, sp.n_fft, sp.hop_size, sp.win_size)
        y = _istft(S * (spec / spec.abs().clamp(min=1e-16)))
    return y if length is None else y[:length]


def fast_griffin_lim(S: Tensor, sp: SignalParams, n_iters: int,
                     generator: Optional[torch.Generator] = None,
                     length: Optional[int] = None, momentum: float = 0.99,
                     angles: Optional[Tensor] = None) -> Tensor:
    """Momentum-accelerated Griffin-Lim (Perraudin et al. 2013), the
    ``pp.use_lws`` path of :func:`inv_mel_spectrogram`."""
    phase = _initial_phase(S, generator, angles)
    S = S.abs().to(torch.complex64)

    def _istft(spec):
        return stft_ops.istft(spec, sp.n_fft, sp.hop_size, sp.win_size)

    c = t = S * phase
    for _ in range(n_iters):
        spec = stft_ops.stft(_istft(c), sp.n_fft, sp.hop_size, sp.win_size)
        t_prev, t = t, S * (spec / spec.abs().clamp(min=1e-16))
        c = t + momentum * (t - t_prev)
    y = _istft(t)
    return y if length is None else y[:length]


def _invert(S: Tensor, sp: SignalParams, pp: PreprocessingParams, generator, length,
            angles) -> Tensor:
    recon = fast_griffin_lim if pp.use_lws else griffin_lim
    wav = recon(S ** pp.power, sp, pp.griffin_lim_iters, generator, length=length,
                angles=angles)
    if sp.preemphasize:
        wav = inv_preemphasis(wav, sp.preemphasis)
    return wav


def inv_mel_spectrogram(mel: Tensor, sp: SignalParams, pp: PreprocessingParams,
                        generator: Optional[torch.Generator] = None,
                        length: Optional[int] = None,
                        angles: Optional[Tensor] = None) -> Tensor:
    """Normalised mel → waveform: pinv(mel basis), then Griffin-Lim."""
    D = denormalize_spectrogram(mel, sp, pp) if pp.signal_normalization else mel
    amp = db_to_amp(D + sp.ref_level_db)
    inv_basis = torch.from_numpy(mel_ops.inv_mel_filterbank(
        sp.sample_rate, sp.n_fft, sp.num_mels, sp.fmin, sp.fmax)).to(mel.device)
    S = (inv_basis @ amp).clamp(min=1e-10)
    return _invert(S, sp, pp, generator, length, angles)


def inv_linear_spectrogram(linear: Tensor, sp: SignalParams, pp: PreprocessingParams,
                           generator: Optional[torch.Generator] = None,
                           length: Optional[int] = None,
                           angles: Optional[Tensor] = None) -> Tensor:
    """Normalised linear spectrogram → waveform by Griffin-Lim."""
    D = denormalize_spectrogram(linear, sp, pp) if pp.signal_normalization else linear
    return _invert(db_to_amp(D + sp.ref_level_db), sp, pp, generator, length, angles)


# ---------------------------------------------------------------------------
# Encoder-path mel, volume, and the vocoder's codecs
# ---------------------------------------------------------------------------


def encoder_mel_spectrogram(wav: Tensor, sample_rate: int, n_fft: int,
                            hop_size: int, n_mels: int) -> Tensor:
    """Power (|S|²) mel spectrogram, shape (T, n_mels): the speaker-encoder
    frontend (librosa ``melspectrogram`` defaults: power 2, fmin 0,
    fmax sr/2)."""
    mag = stft_magnitude(wav, n_fft, hop_size, n_fft)
    basis = torch.from_numpy(mel_ops.mel_filterbank(
        sample_rate, n_fft, n_mels, 0.0, sample_rate / 2.0)).to(wav.device)
    return (basis @ (mag ** 2)).t()


def normalize_volume(wav: Tensor, target_dBFS: float,
                     increase_only: bool = False,
                     decrease_only: bool = False) -> Tensor:
    """Scale to a target dBFS."""
    if increase_only and decrease_only:
        raise ValueError("Both increase only and decrease only are set")
    dBFS_change = target_dBFS - 10.0 * torch.log10(torch.mean(wav ** 2))
    gain = 10.0 ** (dBFS_change / 20.0)
    if increase_only:
        gain = torch.clamp(gain, min=1.0)
    if decrease_only:
        gain = torch.clamp(gain, max=1.0)
    return wav * gain


def label_2_float(x: Tensor, bits: int) -> Tensor:
    """Integer label [0, 2^bits) → float [-1, 1]."""
    return 2.0 * x / (2.0 ** bits - 1.0) - 1.0


def float_2_label(x: Tensor, bits: int) -> Tensor:
    """Float [-1, 1] → label [0, 2^bits - 1] (a float tensor)."""
    x = (x + 1.0) * (2.0 ** bits - 1.0) / 2.0
    return torch.clamp(x, 0.0, 2.0 ** bits - 1.0)


def encode_mu_law(x: Tensor, mu: int) -> Tensor:
    """Mu-law companding → integer labels (a float tensor); log1p(mu - 1)
    taken in float32, as the JAX package takes it."""
    m = mu - 1
    fx = torch.sign(x) * torch.log1p(m * torch.abs(x)) / float(np.log1p(np.float32(m)))
    return torch.floor((fx + 1.0) / 2.0 * m + 0.5)


def decode_mu_law(y: Tensor, mu: int, from_labels: bool = True) -> Tensor:
    """Inverse mu-law."""
    if from_labels:
        y = label_2_float(y, int(math.log2(mu)))
    m = mu - 1
    return torch.sign(y) / m * ((1.0 + m) ** torch.abs(y) - 1.0)


# ---------------------------------------------------------------------------
# 16-bit signals as two bytes (the DeepMind WaveRNN's coarse and fine labels)
# ---------------------------------------------------------------------------


def split_signal(x: Tensor):
    """16-bit integer signal → (coarse, fine): the high and low byte of
    x + 2^15. A signal narrower than 32 bits is widened to int32 first, so
    that the offset cannot overflow its dtype."""
    if x.dtype in (torch.int8, torch.uint8, torch.int16):
        x = x.to(torch.int32)
    unsigned = x + 2 ** 15
    return torch.div(unsigned, 256, rounding_mode="floor"), torch.remainder(unsigned, 256)


def combine_signal(coarse: Tensor, fine: Tensor) -> Tensor:
    """The inverse of :func:`split_signal`."""
    return coarse * 256 + fine - 2 ** 15


def encode_16bits(x: Tensor) -> Tensor:
    """Float [-1, 1] → int16, clipped to [-2^15, 2^15 - 1]."""
    return torch.clamp(x * 2 ** 15, -(2 ** 15), 2 ** 15 - 1).to(torch.int16)
