"""Vocoder inference (counterpart of ``rtvc_tpu/inference/vocoder.py``)
with any of the three WaveRNN variants and heads.

``infer_waveform`` vocodes one mel and ``infer_waveforms`` several in one
launch of the sample loop. Both fold the mel with the model's own window
(``gen_target`` / ``gen_overlap`` of its config: 3000 / 1500 for fatchord
and geneing, 6000 / 1000 for runtimeracer) unless the caller passes
another or sets one with :func:`set_generation_options`; a window tuned for
the card is not derived yet. The sample loop runs through the K1 kernel on
a card, and a launch that fails raises: there is no second path to retry
on, so the JAX package's ``use_pallas`` knob and its fallback to an XLA
scan have no counterpart here.

``load_model`` reads a checkpoint in any of the formats of
``train/checkpoints.py:read_model`` and rebuilds the variant at the widths
its config names; ``warmup`` builds the kernels and takes the model's first
pass through K1 before the first request.

The second backend is the native WaveRNN engine, a host CPU engine in C++
(``native/libwavernn.py``): ``load_model(path, voc_type="libwavernn")``
loads an RTVCNAT1 file (``native/convert.py``) into it, and
``infer_waveform`` and ``set_seed`` then go to it, as in the JAX package.
It runs only where a caller names it: it is never a substitute for K1 when
there is no card or a launch fails. One backend is installed at a time.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

import torch

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.config import signal as _sig
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models.wavernn import wavernn_generate, wavernn_generate_batch
from rtvc_tpu_torch.ops import precision
from rtvc_tpu_torch.train.checkpoints import read_model
from rtvc_tpu_torch.utils.profiler import count, span

VOC_TYPE_PYTORCH = "pytorch"  # the reference's name for this path: the port's WaveRNN and K1
VOC_TYPE_CPP = "libwavernn"  # the native engine

_bundle: Optional[factories.VocModel] = None
_native = None  # a native.libwavernn.Vocoder while the engine is the vocoder
_seed: int = 0
_gen_counter: int = 0

# The generation options (set_generation_options). The JAX package's module
# default window, 400 / 160, is tuned for a TPU and applies only there; the
# port keeps the checkpoint's window unless a caller sets one, per knob
# (None: the checkpoint's).
_default_target: Optional[int] = None
_default_overlap: Optional[int] = None
_compute_dtype: torch.dtype = torch.float32
_stream_dtype: torch.dtype = torch.float32

_UNSET = object()


def set_generation_options(compute_dtype=None, target=_UNSET, overlap=_UNSET,
                           stream_dtype=_UNSET) -> None:
    """Override the generation defaults, as the JAX package's
    ``set_generation_options`` does (without its ``use_pallas``: K1 is the
    one path on the card). ``compute_dtype``: the sample loop's resident
    weights and carried state, ``"f32"`` or ``"bf16"`` (or a torch dtype,
    through ``ops.precision.resolve``); every call sets it, None and
    ``"auto"`` giving f32. ``target`` / ``overlap``: the fold window, each
    kept once set until set again; None restores the checkpoint's
    ``gen_target`` / ``gen_overlap``. ``stream_dtype``: the per-step
    conditioning streams, kept once set; None gives f32.

    The defaults are f32 weights and f32 streams. The JAX package defaults
    its streams to bf16, but that default reaches only its Pallas kernel,
    which runs only on a TPU: off a TPU its scan ignores ``stream_dtype``.
    Whether bf16 should be the default on the card is for a measured change
    to decide. Raises ValueError for a dtype name ``precision.resolve``
    does not know."""
    global _compute_dtype, _stream_dtype, _default_target, _default_overlap
    _compute_dtype = precision.resolve(compute_dtype)
    if target is not _UNSET:
        _default_target = target
    if overlap is not _UNSET:
        _default_overlap = overlap
    if stream_dtype is not _UNSET:
        _stream_dtype = precision.resolve(stream_dtype)


def _gen_backend():
    """(compute dtype, stream dtype) of the next generation call."""
    return _compute_dtype, _stream_dtype


def _default_window(cfg):
    """The fold window per knob: a value the caller set wins; otherwise the
    checkpoint's own (the JAX package's rule off a TPU)."""
    return (cfg.gen_target if _default_target is None else _default_target,
            cfg.gen_overlap if _default_overlap is None else _default_overlap)


def load_model(weights_fpath, voc_type: str = VOC_TYPE_PYTORCH, verbose: bool = True,
               device=None, native_batch: int = 1) -> None:
    """Install the vocoder of a checkpoint, on the card unless ``device``
    names another; the variant comes from the file (fatchord when it names
    none, as the reference does). ``voc_type="libwavernn"`` loads an
    RTVCNAT1 file into the native engine instead (``device`` does not
    apply; ``native_batch`` > 1 decodes its fold chunks in lockstep, as the
    JAX package's ``native_batch`` does)."""
    global _native
    if voc_type == VOC_TYPE_PYTORCH:
        ckpt = read_model(weights_fpath, "vocoder")
        load_bundle(factories.from_checkpoint(ckpt, "vocoder", device))
        if verbose:
            print("Loaded vocoder of model '%s' at path '%s'." % (_bundle.model_type,
                                                                   weights_fpath))
            print("Model has been trained to step %d." % ckpt.step)
    elif voc_type == VOC_TYPE_CPP:
        from rtvc_tpu_torch.native import libwavernn

        engine = libwavernn.Vocoder(weights_fpath, "runtimeracer-wavernn", verbose,
                                    batch=native_batch)
        engine.load()
        load_bundle(None)
        _native = engine
        if verbose:
            print("Loaded vocoder of model '%s' at path '%s'." % (voc_type, weights_fpath))
    else:
        raise NotImplementedError(
            "Invalid vocoder of type '%s' provided. Aborting..." % voc_type)


def load_bundle(bundle: Optional[factories.VocModel]) -> None:
    """Install an in-memory vocoder (self-tests, benchmarks); it replaces
    the native engine where that was loaded."""
    global _bundle, _native
    _bundle, _native = bundle, None


def is_loaded() -> bool:
    return _bundle is not None or _native is not None


def warmup(frame_buckets=(64,)) -> int:
    """Vocode a silent mel of each frame count in ``frame_buckets`` before
    the first request, after building the kernels when the model is on the
    card; returns how many were vocoded. Each call takes a seed of the
    counter, as a request does, and the dtypes :func:`set_generation_options`
    set. One bucket is enough here: a kernel is built once for every shape,
    and the first launch pays for loading it. The native engine has nothing
    to warm: it raises there."""
    if _native is not None:
        raise RuntimeError("warmup warms K1 and the port's WaveRNN; the native engine "
                           "needs none")
    if _bundle is None:
        raise Exception("Please load Wave-RNN in memory before using it")
    if _bundle.model.I.weight.is_cuda:
        _build.library()
    for frames in frame_buckets:
        infer_waveform(np.zeros((_bundle.dims.feat_dims, int(frames)), np.float32),
                       normalize=False)
    return len(frame_buckets)


def set_seed(seed: int) -> None:
    """Deterministic generation: same seed → same audio (the native
    engine's workers are seeded too, ``seed + i`` each)."""
    global _seed, _gen_counter
    _seed = int(seed)
    _gen_counter = 0
    if _native is not None:
        _native.setRandomSeed(seed)


def next_seed() -> int:
    """The seed of the next generation call: each call (a vocode, or a whole
    stream) gets one of its own, from ``set_seed``'s seed and a counter."""
    global _gen_counter
    _gen_counter += 1
    return ((_seed & 0xFFFFFFFF) << 32) | (_gen_counter & 0xFFFFFFFF)


def _next_call(target: Optional[int], overlap: Optional[int]):
    """(config, target, overlap, seed, dtypes) of the next generation call:
    the window defaults to :func:`_default_window`'s, each call gets a seed
    of its own, and the dtypes are the options'."""
    if _bundle is None:
        raise Exception("Please load Wave-RNN in memory before using it")
    cfg = _bundle.config
    default_t, default_o = _default_window(cfg)
    target = default_t if target is None else target
    overlap = default_o if overlap is None else overlap
    compute_dtype, stream_dtype = _gen_backend()
    return cfg, target, overlap, next_seed(), dict(compute_dtype=compute_dtype,
                                                   stream_dtype=stream_dtype)


def infer_waveform(mel: np.ndarray, normalize: bool = True, batched: bool = True,
                   target: Optional[int] = None, overlap: Optional[int] = None,
                   progress_callback=None, argmax: bool = False) -> np.ndarray:
    """Mel (synthesizer format, (80, T)) → float64 waveform of (T-1)·200
    samples. ``argmax=True`` is the deterministic (greedy) test hook. With
    the native engine loaded it vocodes there, folded by the engine's worker
    pool (``batched``, ``target`` and ``overlap`` do not apply). On K1's
    path it counts the mel's frames (``rtvc.vocoder.mel_frames``)."""
    with span("rtvc.vocoder.vocode"):
        if _native is not None:
            return _native.vocode_mel(mel=mel, normalize=normalize,
                                      progress_callback=progress_callback, argmax=argmax)
        cfg, target, overlap, seed, dtypes = _next_call(target, overlap)
        count("rtvc.vocoder.mel_frames", int(np.shape(mel)[-1]))
        sp = _sig.sp
        if normalize:
            mel = mel / sp.max_abs_value
        wav = wavernn_generate(_bundle.model, _bundle.dims, np.asarray(mel, np.float32),
                               seed, batched=batched, target=target, overlap=overlap,
                               mu_law=cfg.mu_law, apply_preemphasis=sp.preemphasize,
                               argmax=argmax, **dtypes)
        if progress_callback is not None:
            progress_callback(len(wav), len(wav), 1, 0.0)
        return wav


def infer_waveforms(mels: Sequence[np.ndarray], normalize: bool = True,
                    target: Optional[int] = None, overlap: Optional[int] = None,
                    argmax: bool = False) -> List[np.ndarray]:
    """Vocode several mels in one batch: every utterance's fold windows share
    the batch axis of one launch of the sample loop. Returns one waveform
    per mel, each of its own (T_i - 1)·200 samples. Counts the mels' frames
    (``rtvc.vocoder.mel_frames``)."""
    with span("rtvc.vocoder.vocode"):
        cfg, target, overlap, seed, dtypes = _next_call(target, overlap)
        count("rtvc.vocoder.mel_frames", sum(int(np.shape(m)[-1]) for m in mels))
        sp = _sig.sp
        if normalize:
            mels = [m / sp.max_abs_value for m in mels]
        return wavernn_generate_batch(_bundle.model, _bundle.dims,
                                      [np.asarray(m, np.float32) for m in mels], seed,
                                      target=target, overlap=overlap, mu_law=cfg.mu_law,
                                      apply_preemphasis=sp.preemphasize, argmax=argmax,
                                      **dtypes)
