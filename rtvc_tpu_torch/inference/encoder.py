"""Speaker-encoder inference (counterpart of ``rtvc_tpu/inference/encoder.py``).

Same module-level surface as the JAX package (and the reference it mirrors):
install a model with ``load_state`` or ``init_random_model``, then
``preprocess_wav`` → ``embed_utterance``. The partial-utterance batch runs
through the speaker encoder whose LSTMs go through the K3 kernel on a card.
The JAX package pads that batch to a power of two to bound XLA recompiles;
padded rows never touch real ones, so this port runs the batch as it is.

Loading ``.ckpt`` files (flax msgpack) is a later slice.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from rtvc_tpu_torch.config.encoder import EncoderDataParams, EncoderModelParams
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models.speaker_encoder import SpeakerEncoder
from rtvc_tpu_torch.ops.audio import encoder_mel_spectrogram, normalize_volume
from rtvc_tpu_torch.ops.resample import resample
from rtvc_tpu_torch.ops.vad import trim_long_silences
from rtvc_tpu_torch.utils.io import load_wav

_data = EncoderDataParams()
_model_cfg = EncoderModelParams()
_model: Optional[SpeakerEncoder] = None


def load_state(state_dict: dict, device=None,
               model_cfg: EncoderModelParams = EncoderModelParams(),
               data_cfg: EncoderDataParams = EncoderDataParams()) -> SpeakerEncoder:
    """Install an encoder from a state_dict under the reference's names
    (for example ``bridge.speaker_encoder_state``), on the card unless
    ``device`` names another (RuntimeError without a card)."""
    global _model, _model_cfg, _data
    model = factories.empty_on_device(lambda: SpeakerEncoder(model_cfg, data_cfg), device)
    model.load_state_dict(state_dict, strict=True)
    _model, _model_cfg, _data = model.eval(), model_cfg, data_cfg
    return _model


def init_random_model(seed: int = 0, device=None) -> SpeakerEncoder:
    """Install an encoder with random weights (self-tests, benchmarks), on
    the card unless ``device`` names another."""
    global _model
    _model = factories.init_encoder_model(seed, device, _model_cfg, _data)
    return _model


def is_loaded() -> bool:
    return _model is not None


def _device() -> torch.device:
    return _model.linear.weight.device


@torch.no_grad()
def embed_frames_batch(frames_batch: np.ndarray) -> np.ndarray:
    """(B, n_frames, n_channels) mel frames → (B, E) embeddings."""
    if _model is None:
        raise Exception("Model was not loaded. Call load_state() or "
                        "init_random_model() before inference.")
    frames = torch.as_tensor(np.asarray(frames_batch, np.float32), device=_device())
    return _model(frames).cpu().numpy()


def compute_partial_slices(n_samples: int,
                           partial_utterance_n_frames: Optional[int] = None,
                           min_pad_coverage: float = 0.75, overlap: float = 0.5
                           ) -> Tuple[List[slice], List[slice]]:
    """Overlapping partial-utterance windows: 160 frames, 50% overlap, the
    trailing window kept only if it covers ≥ 75% after padding."""
    if partial_utterance_n_frames is None:
        partial_utterance_n_frames = _data.partials_n_frames
    if not (0 <= overlap < 1 and 0 < min_pad_coverage <= 1):
        raise ValueError("need 0 <= overlap < 1 and 0 < min_pad_coverage <= 1")
    samples_per_frame = int(_data.sampling_rate * _data.mel_window_step / 1000)
    n_frames = int(np.ceil((n_samples + 1) / samples_per_frame))
    frame_step = max(int(np.round(partial_utterance_n_frames * (1 - overlap))), 1)

    wav_slices, mel_slices = [], []
    steps = max(1, n_frames - partial_utterance_n_frames + frame_step + 1)
    for i in range(0, steps, frame_step):
        mel_range = np.array([i, i + partial_utterance_n_frames])
        wav_range = mel_range * samples_per_frame
        mel_slices.append(slice(*mel_range))
        wav_slices.append(slice(*wav_range))

    last_wav_range = wav_slices[-1]
    coverage = (n_samples - last_wav_range.start) / (
        last_wav_range.stop - last_wav_range.start)
    if coverage < min_pad_coverage and len(mel_slices) > 1:
        mel_slices = mel_slices[:-1]
        wav_slices = wav_slices[:-1]
    return wav_slices, mel_slices


def wav_to_mel_spectrogram(wav: np.ndarray) -> np.ndarray:
    """Encoder-frontend mel frames (T, 40)."""
    n_fft = int(_data.sampling_rate * _data.mel_window_length / 1000)
    hop = int(_data.sampling_rate * _data.mel_window_step / 1000)
    mel = encoder_mel_spectrogram(torch.as_tensor(np.asarray(wav, np.float32)),
                                  _data.sampling_rate, n_fft, hop, _data.mel_n_channels)
    return mel.numpy().astype(np.float32)


def preprocess_wav(fpath_or_wav: Union[str, Path, np.ndarray],
                   source_sr: Optional[int] = None, normalize: bool = True,
                   trim_silence: bool = True) -> np.ndarray:
    """Load/resample → volume-normalise → VAD silence trim (host side)."""
    if isinstance(fpath_or_wav, (str, Path)):
        wav, source_sr = load_wav(fpath_or_wav)
    else:
        wav = np.asarray(fpath_or_wav, dtype=np.float32)
    if source_sr is not None and source_sr != _data.sampling_rate:
        wav = resample(wav, source_sr, _data.sampling_rate)
    if normalize:
        wav = normalize_volume(torch.as_tensor(wav), _data.audio_norm_target_dBFS,
                               increase_only=True).numpy()
    if trim_silence:
        wav = trim_long_silences(wav, _data.sampling_rate, _data.vad_window_length,
                                 _data.vad_moving_average_width,
                                 _data.vad_max_silence_length)
    return wav.astype(np.float32)


def embed_utterance(wav: np.ndarray, using_partials: bool = True,
                    return_partials: bool = False, **kwargs):
    """Single-utterance embedding: the mean of the partial embeddings,
    renormalised."""
    if not using_partials:
        frames = wav_to_mel_spectrogram(wav)
        embed = embed_frames_batch(frames[None, ...])[0]
        return (embed, None, None) if return_partials else embed

    wave_slices, mel_slices = compute_partial_slices(len(wav), **kwargs)
    max_wave_length = wave_slices[-1].stop
    if max_wave_length >= len(wav):
        wav = np.pad(wav, (0, max_wave_length - len(wav)), "constant")
    frames = wav_to_mel_spectrogram(wav)
    frames_batch = np.stack([frames[s] for s in mel_slices])
    partial_embeds = embed_frames_batch(frames_batch)
    raw_embed = np.mean(partial_embeds, axis=0)
    embed = raw_embed / np.linalg.norm(raw_embed, 2)
    if return_partials:
        return embed, partial_embeds, wave_slices
    return embed


def embed_speaker(wavs: List[np.ndarray], **kwargs) -> np.ndarray:
    """Speaker embedding: the mean of per-utterance embeddings, renormalised."""
    partials = [embed_utterance(w, **kwargs) for w in wavs]
    raw = np.mean(np.stack(partials), axis=0)
    return raw / np.linalg.norm(raw, 2)
