"""Synthesizer model hyper-parameters: Tacotron, ForwardTacotron, FastPitch.

Same numerics as the reference (ref: config/hparams.py:97-217). Unlike the
reference — whose ``fast_pitch`` HParams is an empty stub and whose FastPitch
is unregistered (ref: config/hparams.py:215-217, synthesizer/models/base.py:9-10)
— FastPitch here gets real, wired-up parameters.

This package's own copy of ``rtvc_tpu/config/synthesizer.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from rtvc_tpu_torch.config.base import Config

# (r, loops, batch_size, init_lr, end_lr) — ref: config/hparams.py:127-135
TacotronSchedule = Tuple[Tuple[int, int, int, float, float], ...]
# (loops, batch_size, init_lr, end_lr) — ref: config/hparams.py:193-199
ForwardSchedule = Tuple[Tuple[int, int, float, float], ...]


@dataclasses.dataclass(frozen=True)
class TacotronParams(Config):
    embed_dims: int = 256
    encoder_dims: int = 128
    decoder_dims: int = 256
    postnet_dims: int = 128
    encoder_K: int = 16
    lstm_dims: int = 512
    postnet_K: int = 8
    num_highways: int = 4
    dropout: float = 0.5
    stop_threshold: float = -3.4
    max_r: int = 20
    # LSA attention (ref: synthesizer/models/tacotron.py:179-216)
    attn_filters: int = 32
    attn_kernel_size: int = 31
    # Inference caps (ref: synthesizer/models/tacotron.py:393)
    max_decoder_steps: int = 2000

    tts_schedule: TacotronSchedule = (
        (7, 1, 112, 1e-3, 1e-7),
        (6, 2, 100, 9e-4, 1e-7),
        (5, 4, 88, 8e-4, 1e-7),
        (4, 8, 76, 7e-4, 1e-7),
        (3, 16, 64, 5e-4, 1e-7),
        (2, 16, 44, 4e-4, 1e-7),
        (1, 16, 22, 2e-4, 1e-7),
    )
    tts_clip_grad_norm: float = 1.0
    eval_interval: int = 500
    eval_num_samples: int = 1


@dataclasses.dataclass(frozen=True)
class ForwardTacotronParams(Config):
    embed_dims: int = 256
    series_embed_dims: int = 64

    duration_conv_dims: int = 256
    duration_rnn_dims: int = 64
    duration_dropout: float = 0.5

    pitch_conv_dims: int = 256
    pitch_rnn_dims: int = 128
    pitch_dropout: float = 0.5
    pitch_strength: float = 1.0

    energy_conv_dims: int = 256
    energy_rnn_dims: int = 64
    energy_dropout: float = 0.5
    energy_strength: float = 1.0

    prenet_dims: int = 256
    prenet_k: int = 16
    prenet_num_highways: int = 4
    prenet_dropout: float = 0.5

    rnn_dims: int = 512

    postnet_dims: int = 256
    postnet_k: int = 8
    postnet_num_highways: int = 4
    postnet_dropout: float = 0.0

    tts_schedule: ForwardSchedule = (
        (1, 16, 1e-3, 5e-4),
        (2, 24, 5e-4, 5e-4),
        (4, 32, 5e-4, 5e-4),
        (8, 40, 5e-4, 5e-4),
        (16, 48, 5e-4, 5e-4),
        (32, 48, 5e-4, 5e-4),
        (64, 48, 5e-4, 5e-4),
    )

    duration_loss_factor: float = 0.1
    pitch_loss_factor: float = 0.1
    energy_loss_factor: float = 0.1
    pitch_zoneout: float = 0.0
    energy_zoneout: float = 0.0
    clip_grad_norm: float = 1.0
    eval_interval: int = 500
    eval_num_samples: int = 1


@dataclasses.dataclass(frozen=True)
class FastPitchParams(Config):
    """Transformer NAR synthesizer (ref model code: synthesizer/models/fast_pitch.py).

    The reference ships the model but never wires hyper-parameters for it; these
    defaults follow the FastPitch paper scaled to the repo's 80-mel/768-embed
    setting so the family is actually usable here.
    """

    embed_dims: int = 384          # d_model
    n_heads: int = 1
    conv_kernel: int = 3           # conv1/conv2 kernel in FFT blocks
    conv_dims: int = 1536          # d_fft
    dropout: float = 0.1
    n_layers_enc: int = 6          # prenet FFT blocks
    n_layers_dec: int = 6          # postnet FFT blocks

    # duration/pitch/energy transformer predictors
    series_d_model: int = 256
    series_n_heads: int = 1
    series_layers: int = 2
    series_d_fft: int = 1024
    series_dropout: float = 0.1
    pitch_strength: float = 1.0
    energy_strength: float = 1.0

    tts_schedule: ForwardSchedule = (
        (1, 16, 1e-3, 5e-4),
        (2, 24, 5e-4, 5e-4),
        (4, 32, 5e-4, 5e-4),
        (8, 40, 5e-4, 5e-4),
        (16, 48, 5e-4, 5e-4),
        (32, 48, 5e-4, 5e-4),
        (64, 48, 5e-4, 5e-4),
    )
    duration_loss_factor: float = 0.1
    pitch_loss_factor: float = 0.1
    energy_loss_factor: float = 0.1
    clip_grad_norm: float = 1.0
    eval_interval: int = 500
    eval_num_samples: int = 1


tacotron = TacotronParams()
forward_tacotron = ForwardTacotronParams()
fast_pitch = FastPitchParams()
