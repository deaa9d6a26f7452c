"""Global signal-processing parameters shared by synthesizer and vocoder.

Same numerics as the reference's ``sp`` / ``preprocessing`` HParams
(ref: config/hparams.py:38-94) so that mels are bitwise-comparable.

This package's own copy of ``rtvc_tpu/config/signal.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from rtvc_tpu_torch.config.base import Config


@dataclasses.dataclass(frozen=True)
class SignalParams(Config):
    sample_rate: int = 16000
    n_fft: int = 1024
    num_mels: int = 80
    hop_size: int = 200      # 12.5 ms frame shift
    win_size: int = 800      # 50 ms frame length
    fmin: float = 40.0
    fmax: float = 8000.0     # must be <= sample_rate // 2
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    max_abs_value: float = 4.0
    preemphasis: float = 0.97
    preemphasize: bool = True


@dataclasses.dataclass(frozen=True)
class PreprocessingParams(Config):
    """Dataset preprocessing + Griffin-Lim knobs (ref: config/hparams.py:54-94)."""

    max_mel_frames: int = 1200
    rescale: bool = True
    rescaling_max: float = 0.9
    synthesis_batch_size: int = 24

    # Mel visualization and Griffin-Lim
    signal_normalization: bool = True
    power: float = 1.5
    griffin_lim_iters: int = 80
    # Fast phase reconstruction toggle (ref hparams `use_lws`,
    # config/hparams.py — routes inverse spectrograms through the lws
    # package there; here it selects momentum-accelerated Griffin-Lim,
    # ops/audio.fast_griffin_lim)
    use_lws: bool = False

    # Audio processing options
    allow_clipping_in_normalization: bool = True
    clip_mels_length: bool = True
    symmetric_mels: bool = True
    trim_silence: bool = True
    silence_min_duration_split: float = 0.4
    utterance_min_duration: float = 0.6
    trim_start_end_silence: bool = True
    trim_silence_top_db: float = 60.0
    pitch_max_freq: float = 600.0

    # Text preprocessing
    cleaner_names: Tuple[str, ...] = ("english_cleaners",)
    min_text_len: int = 2
    extract_durations_with_dijkstra: bool = True

    # Silence tweaks for prediction models
    silence_prob_shift: float = 0.25
    silence_threshold: float = -11.0

    # Attention scoring during dataset loading
    filter_attention: bool = True
    min_attention_sharpness: float = 0.5
    min_attention_alignment: float = 0.95


@dataclasses.dataclass(frozen=True)
class SV2TTSParams(Config):
    """Cross-stage globals (ref: config/hparams.py:33-35)."""

    speaker_embedding_size: int = 768


sp = SignalParams()
preprocessing = PreprocessingParams()
sv2tts = SV2TTSParams()
