"""Speaker-encoder data and model parameters.

Same numerics as the reference (ref: encoder/params_data.py:1-28,
encoder/params_model.py:1-16).

This package's own copy of ``rtvc_tpu/config/encoder.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import dataclasses

from rtvc_tpu_torch.config.base import Config


@dataclasses.dataclass(frozen=True)
class EncoderDataParams(Config):
    # Mel filterbank
    mel_window_length: int = 25   # ms
    mel_window_step: int = 10     # ms
    mel_n_channels: int = 40

    # Audio
    sampling_rate: int = 16000
    partials_n_frames: int = 160      # 1600 ms
    inference_n_frames: int = 80      # 800 ms

    # Voice activity detection
    vad_window_length: int = 30       # ms; granularity of the VAD
    vad_moving_average_width: int = 8
    vad_max_silence_length: int = 6

    # Volume normalization
    audio_norm_target_dBFS: float = -30.0


@dataclasses.dataclass(frozen=True)
class EncoderModelParams(Config):
    model_hidden_size: int = 768
    model_embedding_size: int = 768
    model_num_layers: int = 3

    # Training
    learning_rate_init: float = 1e-6
    speakers_per_batch: int = 64
    utterances_per_speaker: int = 10


encoder_data = EncoderDataParams()
encoder_model = EncoderModelParams()
