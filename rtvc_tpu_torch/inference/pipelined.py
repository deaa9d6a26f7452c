"""Vocoding a stream of mels with several launches in flight (counterpart of
``rtvc_tpu/inference/pipelined.py``).

:func:`vocode_pipelined` queues up to ``depth`` utterances' generate paths
(one K1 launch each on a card) on the card's stream before it waits for the
first one's samples, and yields the waveforms in input order as they are
drained: the host's trim and fade of one utterance overlap the card's work
on the next ones. Each frame count is padded to the 64-frame bucket of
``wavernn_generate``, so an utterance gives what ``wavernn_generate`` gives
it (with ``argmax=True``, the same samples).
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from rtvc_tpu_torch.config import sp
from rtvc_tpu_torch.inference.streaming import _HostCopy, _vocoder, derive_seed
from rtvc_tpu_torch.models.wavernn import bucket_pad, generate_pipeline


@torch.no_grad()
def vocode_pipelined(voc, mels: Iterable[np.ndarray], seed: int = 0, depth: int = 8,
                     target: int = 400, overlap: int = 160, argmax: bool = False,
                     compute_dtype=torch.float32, stream_dtype=torch.float32
                     ) -> Iterator[np.ndarray]:
    """Vocode a stream of normalised mels (n_mels, T_i) with the vocoder
    bundle ``voc`` (None: the one installed in ``inference.vocoder``);
    yields float64 waveforms of (T_i − 1)·hop samples with the end fade, in
    input order. ``mels`` may be a generator: an utterance is launched when
    the window reaches it, and at most ``depth`` are in flight. Utterance i
    draws from ``streaming.derive_seed(seed, i)`` (the JAX package folds i
    into its key). mu-law decoding and de-emphasis follow the vocoder's
    config and the signal config, as in ``vocoder.infer_waveform``.
    ``argmax=True`` is the deterministic (greedy) test hook. Each K1 launch
    takes ``compute_dtype`` and ``stream_dtype`` (f32 by default; the JAX
    function takes ``compute_dtype`` and streams its kernel's default)."""
    voc = _vocoder(voc)
    d = voc.dims
    dev = voc.model.I.weight.device

    def dispatch(i, mel):
        mel = np.asarray(mel, np.float32)
        if mel.ndim != 2 or mel.shape[0] != d.feat_dims:
            raise ValueError(f"mel {i}: expected ({d.feat_dims}, T), got {mel.shape}")
        if mel.shape[-1] < 2:
            raise ValueError(f"mel {i}: need at least 2 frames")
        wav = generate_pipeline(voc.model, d, bucket_pad(torch.as_tensor(mel, device=dev)[None]),
                                derive_seed(seed, i), True, target, overlap, voc.config.mu_law,
                                sp.preemphasize, argmax, compute_dtype, stream_dtype)
        return _HostCopy(wav, (mel.shape[-1] - 1) * d.hop_length)

    def finish(copy):
        wav = np.array(copy.numpy(), dtype=np.float64)
        fade_len = min(20 * d.hop_length, len(wav))
        if fade_len:
            wav[-fade_len:] *= np.linspace(1.0, 0.0, fade_len)
        return wav

    window: deque = deque()
    for i, mel in enumerate(mels):
        window.append(dispatch(i, mel))
        if len(window) >= depth:
            yield finish(window.popleft())
    while window:
        yield finish(window.popleft())
