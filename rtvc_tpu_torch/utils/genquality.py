"""Fold-with-overlap audio-quality instrumentation (counterpart of
``rtvc_tpu/utils/genquality.py``).

The batched WaveRNN generation splits a long utterance into overlapping fold
windows, decodes them as a batch, and equal-power-crossfades them back (ref:
fatchord_version.py:290-404). This module measures the cost of those joins:
greedy (argmax) decoding is deterministic, so the difference between a
batched decode and the single-fold decode of the same conditioning isolates
the fold warm-up and crossfade error. Both decodes run the port's
``models.wavernn.generate_core`` with ``argmax=True``, so through K1 on the
card; they also take the sample loop's ``compute_dtype`` and
``stream_dtype`` (f32 by default), so that the same functions measure a
bf16 decode.

The mel distances take the port's ``ops.audio.melspectrogram`` on
``device`` (the card unless the caller names another): the normalised mel
of ``mel_l2_distance`` runs through K6 there; the dB mel of
``mel_cepstral_distortion`` is the plain filterbank product. The numpy
arithmetic after the decodes and the mels is the JAX module's, line for
line.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def _argmax_decode_unbatched(model, d, mels_up, aux, compute_dtype=None,
                             stream_dtype=None) -> np.ndarray:
    from rtvc_tpu_torch.models.wavernn import generate_core

    with torch.no_grad():
        samples = generate_core(model, d, mels_up, aux, 0, argmax=True,
                                compute_dtype=compute_dtype, stream_dtype=stream_dtype)
    return samples[0].cpu().numpy()


def _argmax_decode_batched(model, d, mels_up, aux, target, overlap, compute_dtype=None,
                           stream_dtype=None):
    from rtvc_tpu_torch.models.wavernn import fold_with_overlap, generate_core, xfade_and_unfold

    mf, num_folds = fold_with_overlap(mels_up, target, overlap)
    af, _ = fold_with_overlap(aux, target, overlap)
    with torch.no_grad():
        samples = generate_core(model, d, mf, af, 0, argmax=True,
                                compute_dtype=compute_dtype, stream_dtype=stream_dtype)
    wav = xfade_and_unfold(samples, target, overlap).cpu().numpy()
    return wav, num_folds


def fold_fidelity(model, d, mel: np.ndarray, configs: Sequence[Tuple[int, int]],
                  compute_dtype=None, stream_dtype=None) -> List[Dict]:
    """Measure join artifacts of batched generation for each
    (target, overlap) config, on the vocoder ``model`` (``d`` its dims) and
    its device.

    mel: (feat_dims, n_frames) normalized conditioning. Returns one dict per
    config: ``target``, ``overlap``, ``num_folds``, ``aligned_rms`` (the
    batched decode's deviation from the unbatched decode, modulo each fold's
    phase, relative to the unbatched decode's RMS) and ``join_click_ratio``
    (the first difference inside the crossfades over that between them).
    """
    import torch.nn.functional as F

    from rtvc_tpu_torch.models.wavernn import upsample_forward

    dev = model.I.weight.device
    mels = torch.as_tensor(np.asarray(mel, np.float32)[None], device=dev)
    mels = F.pad(mels, (d.pad, d.pad))
    with torch.no_grad():
        mels_up, aux, _ = upsample_forward(model, d, mels)
    ref = _argmax_decode_unbatched(model, d, mels_up, aux, compute_dtype, stream_dtype)
    ref_rms = float(np.sqrt(np.mean(ref**2))) + 1e-12

    results = []
    for target, overlap in configs:
        wav, num_folds = _argmax_decode_batched(model, d, mels_up, aux, target, overlap,
                                                compute_dtype, stream_dtype)
        n = min(len(wav), len(ref))
        results.append({
            "target": target,
            "overlap": overlap,
            "num_folds": int(num_folds),
            "aligned_rms": _aligned_rms(wav[:n], ref[:n], num_folds, target,
                                        overlap, ref_rms),
            "join_click_ratio": _join_click_ratio(wav[:n], num_folds, target,
                                                  overlap),
        })
    return results


def _aligned_rms(wav, ref, num_folds, target, overlap, ref_rms,
                 max_lag: int = 8) -> float:
    """Waveform fidelity modulo per-fold phase: an AR fold warming up from a
    zero state can lock onto the conditioned signal a couple of samples out
    of phase — inaudible after the crossfade, but fatal to a raw sample-wise
    comparison. Per inter-join segment, find the best alignment within
    ±max_lag samples and report the mean residual RMS relative to the
    reference signal RMS."""
    seg_rms = []
    for i in range(num_folds):
        s = i * (target + overlap) + overlap
        e = min(s + target - overlap, len(wav), len(ref))
        if e - s < 4 * max_lag:
            continue
        w = wav[s:e]
        best = np.inf
        for lag in range(-max_lag, max_lag + 1):
            rs, re = s + lag, e + lag
            if rs < 0 or re > len(ref):
                continue
            best = min(best, float(np.sqrt(np.mean((w - ref[rs:re]) ** 2))))
        if np.isfinite(best):
            seg_rms.append(best)
    return float(np.mean(seg_rms)) / ref_rms if seg_rms else 0.0


def _join_click_ratio(wav, num_folds, target, overlap) -> float:
    """Click detector on the batched output alone: mean absolute first
    difference inside the crossfade windows vs in the fold interiors. A
    clean join ≈ 1.0; a discontinuity (click) pushes it up."""
    n = len(wav)
    join_mask = np.zeros(n, bool)
    for i in range(1, num_folds):
        start = i * (target + overlap)
        join_mask[max(0, start - overlap): min(n, start + overlap)] = True
    d1 = np.abs(np.diff(wav))
    jm = join_mask[:-1]
    if not jm.any() or jm.all():
        return 1.0
    join = float(np.mean(d1[jm]))
    interior = float(np.mean(d1[~jm])) + 1e-12
    return join / interior


def _mel(wav: np.ndarray, sp, pp, device) -> np.ndarray:
    """The port's mel spectrogram of a numpy waveform, computed on
    ``device``, back on the host."""
    from rtvc_tpu_torch.ops.audio import melspectrogram

    x = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    return melspectrogram(x, sp, pp).cpu().numpy()


def mel_cepstral_distortion(wav_ref: np.ndarray, wav_gen: np.ndarray, sp, pp,
                            n_coeffs: int = 13, device="cuda") -> float:
    """Mel-cepstral distortion in dB between two waveforms (frame-aligned,
    no DTW — callers compare a vocoded reconstruction against the exact
    audio whose mel conditioned it, so the frames line up by construction).

    Standard MCD: cepstra = DCT-II(ortho) of the NATURAL-LOG mel spectrum
    (our mels are dB = (20/ln 10)·ln amp, so divide by 8.686 first),
    c1..c13 (c0 = loudness excluded), MCD = (10/ln 10)·√2·mean‖Δc‖ over
    frames whose REFERENCE frame carries speech energy. Silent frames are
    excluded (mean dB more than 35 dB below the utterance's loudest frame),
    and within active frames both spectra are clipped to a 40 dB dynamic
    range below the reference peak, as in the JAX module."""
    from scipy.fft import dct

    n = min(len(wav_ref), len(wav_gen))
    raw_pp = pp.replace(signal_normalization=False)  # dB mels, unnormalized
    m_ref = _mel(wav_ref[:n], sp, raw_pp, device)
    m_gen = _mel(wav_gen[:n], sp, raw_pp, device)
    # voiced/active-frame gate: mean dB within 35 dB of the utterance peak
    frame_db = m_ref.mean(axis=0)
    active = frame_db > frame_db.max() - 35.0
    if not active.any():
        active = np.ones_like(active, dtype=bool)
    floor = float(m_ref.max()) - 40.0
    m_ref = np.maximum(m_ref, floor)
    m_gen = np.maximum(m_gen, floor)
    db_to_ln = np.log(10.0) / 20.0  # dB mel → ln-amplitude mel
    c_ref = dct(m_ref.T[active] * db_to_ln, type=2, norm="ortho",
                axis=1)[:, 1 : n_coeffs + 1]
    c_gen = dct(m_gen.T[active] * db_to_ln, type=2, norm="ortho",
                axis=1)[:, 1 : n_coeffs + 1]
    dist = np.sqrt(np.sum((c_ref - c_gen) ** 2, axis=1))
    return float((10.0 / np.log(10.0)) * np.sqrt(2.0) * np.mean(dist))


def mel_l2_distance(wav_a: np.ndarray, wav_b: np.ndarray, sp, pp, device="cuda") -> float:
    """Mean per-frame L2 distance between normalized mels of two waveforms
    (the sampled-decode divergence metric — raw AR waveforms decorrelate
    after a single label flip, mels capture perceptual closeness)."""
    n = min(len(wav_a), len(wav_b))
    m_a = _mel(wav_a[:n], sp, pp, device)
    m_b = _mel(wav_b[:n], sp, pp, device)
    return float(np.mean(np.linalg.norm(m_a - m_b, axis=0)))
