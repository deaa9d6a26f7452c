"""Typed configuration layer (replaces ref config/hparams.py + config/paths.py +
encoder/params_{data,model}.py + dataset registries).

This package's own copy of ``rtvc_tpu/config/__init__.py``: the port imports nothing
of the JAX package.
"""
from rtvc_tpu_torch.config.base import Config
from rtvc_tpu_torch.config.encoder import (
    EncoderDataParams,
    EncoderModelParams,
    encoder_data,
    encoder_model,
)
from rtvc_tpu_torch.config.paths import SynthesizerPaths, synthesizer_paths
from rtvc_tpu_torch.config.signal import (
    PreprocessingParams,
    SignalParams,
    SV2TTSParams,
    preprocessing,
    sp,
    sv2tts,
)
from rtvc_tpu_torch.config.synthesizer import (
    FastPitchParams,
    ForwardTacotronParams,
    TacotronParams,
    fast_pitch,
    forward_tacotron,
    tacotron,
)
from rtvc_tpu_torch.config.vocoder import (
    MODE_BITS,
    MODE_MOL,
    MODE_RAW,
    WaveRNNParams,
    wavernn_fatchord,
    wavernn_geneing,
    wavernn_runtimeracer,
)

__all__ = [
    "Config",
    "EncoderDataParams",
    "EncoderModelParams",
    "encoder_data",
    "encoder_model",
    "SynthesizerPaths",
    "synthesizer_paths",
    "PreprocessingParams",
    "SignalParams",
    "SV2TTSParams",
    "preprocessing",
    "sp",
    "sv2tts",
    "FastPitchParams",
    "ForwardTacotronParams",
    "TacotronParams",
    "fast_pitch",
    "forward_tacotron",
    "tacotron",
    "MODE_BITS",
    "MODE_MOL",
    "MODE_RAW",
    "WaveRNNParams",
    "wavernn_fatchord",
    "wavernn_geneing",
    "wavernn_runtimeracer",
]
