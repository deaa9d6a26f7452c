"""Vocoder inference (counterpart of ``rtvc_tpu/inference/vocoder.py``),
runtimeracer WaveRNN.

``infer_waveform`` folds the mel with the checkpoint's own window
(``gen_target`` / ``gen_overlap``: 6000 / 1000 for runtimeracer). The JAX
package's 400 / 160 default was tuned on a TPU and is re-derived on the card
in a later change. The sample loop runs through the K1 kernel on a card.
Loading ``.ckpt`` files and the native C++ engine are later slices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from rtvc_tpu_torch.config import signal as _sig
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models.wavernn import wavernn_generate

_bundle: Optional[factories.VocModel] = None
_seed: int = 0
_gen_counter: int = 0


def load_model(weights_fpath, *args, **kwargs):
    raise NotImplementedError("loading vocoder checkpoints is not ported to "
                              "rtvc_tpu_torch yet; install a model with load_bundle()")


def load_bundle(bundle: factories.VocModel) -> None:
    """Install an in-memory vocoder (self-tests, benchmarks)."""
    global _bundle
    _bundle = bundle


def is_loaded() -> bool:
    return _bundle is not None


def set_seed(seed: int) -> None:
    """Deterministic generation: same seed → same audio."""
    global _seed, _gen_counter
    _seed = int(seed)
    _gen_counter = 0


def infer_waveform(mel: np.ndarray, normalize: bool = True, batched: bool = True,
                   target: Optional[int] = None, overlap: Optional[int] = None,
                   progress_callback=None, argmax: bool = False) -> np.ndarray:
    """Mel (synthesizer format, (80, T)) → float64 waveform of (T-1)·200
    samples. ``argmax=True`` is the deterministic (greedy) test hook."""
    global _gen_counter
    if _bundle is None:
        raise Exception("Please load Wave-RNN in memory before using it")
    cfg = _bundle.config
    target = cfg.gen_target if target is None else target
    overlap = cfg.gen_overlap if overlap is None else overlap
    sp = _sig.sp
    if normalize:
        mel = mel / sp.max_abs_value
    _gen_counter += 1
    seed = ((_seed & 0xFFFFFFFF) << 32) | (_gen_counter & 0xFFFFFFFF)
    wav = wavernn_generate(_bundle.model, _bundle.dims, np.asarray(mel, np.float32),
                           seed, batched=batched, target=target, overlap=overlap,
                           mu_law=cfg.mu_law, apply_preemphasis=sp.preemphasize,
                           argmax=argmax)
    if progress_callback is not None:
        progress_callback(len(wav), len(wav), 1, 0.0)
    return wav
