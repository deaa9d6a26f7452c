"""Named dataset registries: corpus names to relative directory layouts and
audio / transcript extensions, so the preprocessing entry modules accept the
same ``--datasets`` names as the reference (ref: encoder/config.py:1-94,
synthesizer/config.py:1-79).

This package's own copy of ``rtvc_tpu/config/datasets.py``: plain data.
"""
from __future__ import annotations

librispeech_datasets = {
    "train": {
        "clean": ["LibriSpeech/train-clean-100", "LibriSpeech/train-clean-360"],
        "other": ["LibriSpeech/train-other-500"],
    },
    "test": {"clean": ["LibriSpeech/test-clean"], "other": ["LibriSpeech/test-other"]},
    "dev": {"clean": ["LibriSpeech/dev-clean"], "other": ["LibriSpeech/dev-other"]},
}

libritts_datasets = {
    "train": {
        "clean": ["LibriTTS/train-clean-100", "LibriTTS/train-clean-360"],
        "other": ["LibriTTS/train-other-500"],
    },
    "test": {"clean": ["LibriTTS/test-clean"], "other": ["LibriTTS/test-other"]},
    "dev": {"clean": ["LibriTTS/dev-clean"], "other": ["LibriTTS/dev-other"]},
}

voxceleb_datasets = {
    "voxceleb1": {
        "train": ["voxceleb/VoxCeleb1/dev/wav"],
        "test": ["voxceleb/VoxCeleb1/test_wav"],
    },
    "voxceleb2": {
        "train": ["voxceleb/VoxCeleb2/dev/wav"],
        "test": ["voxceleb/VoxCeleb2/test_wav"],
    },
}

# OpenSLR corpora laid out as <root>/speakers/<speaker>/... wav files
slr_datasets_wav = {
    f"slr{n}": [f"slr{n}/speakers"]
    for n in (41, 42, 43, 44, 61, 63, 64, 65, 66, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80)
}
slr_datasets_wav["slr51"] = ["TEDLIUM_release-3/speakers"]  # TED-LIUM v3
slr_datasets_wav["slr96"] = ["slr96/train/audio"]
slr_datasets_wav["slr100"] = [  # Multilingual TEDx (without translations)
    f"mtedx/{lang}-{lang}/data/train"
    for lang in ("ar", "de", "el", "es", "fr", "it", "pt", "ru")
]

slr_datasets_flac = {
    "slr82": ["slr82/CN-Celeb_flac/data", "slr82/CN-Celeb2_flac/data"],
}

commonvoice_datasets = {
    "commonvoice-7": {
        "all": ["cv-corpus-7.0-2021-07-21/speakers"],
        "en": ["cv-corpus-7.0-2021-07-21/en/speakers"],
    },
}

other_datasets = {
    "LJSpeech-1.1": [],
    "VCTK": ["VCTK-Corpus/wav48_silence_trimmed"],
    "nasjonalbank": ["nasjonal-bank/speakers"],
}

anglophone_nationalites = ["australia", "canada", "ireland", "uk", "usa"]

# Synthesizer-side per-corpus layout: directory roots + audio/transcript
# extensions (ref: synthesizer/config.py:1-23).
synthesizer_datasets = {
    "cv-corpus-7.0-2021-07-21": {
        "directories": ["speakers"],
        "audio_extensions": [".wav", ".flac"],
        "transcript_extension": ".txt",
    },
    "LibriTTS": {
        "directories": ["train-clean-100", "train-clean-360", "train-other-500"],
        "audio_extensions": [".wav", ".flac"],
        "transcript_extension": ".original.txt",
    },
    "TEDLIUM_release-3": {
        "directories": ["speakers"],
        "audio_extensions": [".wav"],
        "transcript_extension": ".txt",
    },
    "VCTK-Corpus": {
        "directories": ["speakers"],
        "audio_extensions": [".flac"],
        "transcript_extension": ".txt",
    },
}
