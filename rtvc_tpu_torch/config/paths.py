"""Artifact directory layout for preprocessing outputs.

Mirrors the reference's ``PathParams`` (ref: config/paths.py:29-51) — the
directory names are the on-disk contract between preprocessing, training and
GTA synthesis, so they are kept identical.

This package's own copy of ``rtvc_tpu/config/paths.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import dataclasses

from rtvc_tpu_torch.config.base import Config


@dataclasses.dataclass(frozen=True)
class SynthesizerPaths(Config):
    wav_dir: str = "wav"
    mel_dir: str = "mels"
    embed_dir: str = "embeds"
    duration_dir: str = "duration"
    attention_dir: str = "attention"
    alignment_dir: str = "alignment"
    phoneme_pitch_dir: str = "phoneme_pitch"
    phoneme_energy_dir: str = "phoneme_energy"
    # GTA output (ref: synthesizer/synthesize.py:34-40)
    gta_mel_dir: str = "mels_gta"
    metadata_file: str = "train.json"
    gta_metadata_file: str = "synthesized.json"


synthesizer_paths = SynthesizerPaths()
