"""Synthesizer preprocessing, the alignment pass (pass 3 of
``rtvc_tpu/data/synthesizer_preprocess.py``, its ``create_align_features``).

A trained Tacotron's teacher-forced attention (``inference.attention.
TacotronAligner``) gives each utterance's durations per character (the
shortest monotonic path, ``data.duration_extractor``); the F0 track
(``ops.pitch.estimate_f0``) and the mel's energy are averaged over each
character's frames. Five files an utterance: ``duration/``,
``attention/`` (the attention score), ``alignment/`` (the alignment score),
``phoneme_pitch/`` and ``phoneme_energy/``, the non-autoregressive
synthesizers' training inputs. One process takes every utterance; the audio
and embedding passes are not ported yet.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from rtvc_tpu_torch.config import preprocessing, sp, synthesizer_paths
from rtvc_tpu_torch.data.duration_extractor import DurationExtractor, attention_scores
from rtvc_tpu_torch.ops.pitch import estimate_f0
from rtvc_tpu_torch.text import text_to_sequence


def create_align_features(synthesizer_root: Path, synthesizer_model_fpath: Optional[Path] = None,
                          skip_existing: bool = False, aligner=None, device=None) -> int:
    """Durations, attention and alignment scores, and pitch and energy per
    character for every utterance of ``<synthesizer_root>/train.json`` with
    frames, read from its ``wav/``, ``mels/`` and ``embeds/``. ``aligner``
    (anything with ``TacotronAligner.attention``'s contract) replaces the
    Tacotron read from ``synthesizer_model_fpath`` on ``device``;
    ``skip_existing`` leaves out utterances whose energy file exists.
    Returns the number of utterances aligned."""
    from rtvc_tpu_torch.inference.attention import TacotronAligner

    root = Path(synthesizer_root)
    paths = synthesizer_paths
    for d in (paths.duration_dir, paths.attention_dir, paths.alignment_dir,
              paths.phoneme_pitch_dir, paths.phoneme_energy_dir):
        (root / d).mkdir(exist_ok=True)
    metadata = json.loads((root / paths.metadata_file).read_text())
    utterances = [(m[0], m[3].strip()) for lines in metadata.values()
                  for m in (line.split("|") for line in lines) if int(m[2])]
    if skip_existing:
        done = {p.name for p in (root / paths.phoneme_energy_dir).glob("phoneme-energy-*.npy")}
        utterances = [(u, t) for u, t in utterances if f"phoneme-energy-{u}.npy" not in done]

    aligner = aligner or TacotronAligner(synthesizer_model_fpath, device=device)
    extractor = DurationExtractor(silence_threshold=preprocessing.silence_threshold,
                                  silence_prob_shift=preprocessing.silence_prob_shift)
    for utterance_id, text in utterances:
        wav = np.load(root / paths.wav_dir / f"audio-{utterance_id}.npy")
        mel = np.load(root / paths.mel_dir / f"mel-{utterance_id}.npy").T.astype(np.float32)
        embed = np.load(root / paths.embed_dir / f"embed-{utterance_id}.npy")
        tokens = np.asarray(text_to_sequence(text, preprocessing.cleaner_names), dtype=np.int32)
        mel_len = mel.shape[-1]

        att = aligner.attention(tokens, mel, embed)  # (T_mel, T_text)
        align_score = float(attention_scores(att[None], np.asarray([mel_len]))[0][0])
        f0 = estimate_f0(wav.astype(np.float64), sp.sample_rate, sp.hop_size).astype(np.float32)
        duration, att_score = extractor(tokens, mel, att[:mel_len])
        duration = duration.astype(np.int64)
        if duration.sum() != mel_len:
            print("WARNING: Sum of durations did not match mel length for item %s!"
                  % utterance_id)
        energy = np.linalg.norm(np.exp(mel), axis=0, ord=2)

        # each character's mean over its frames: voiced F0 below the pitch
        # ceiling, and the energy
        durs_cum = np.cumsum(np.pad(duration, (1, 0)))
        pitch_char = np.zeros(duration.shape[0], dtype=np.float32)
        energy_char = np.zeros(duration.shape[0], dtype=np.float32)
        for idx, (a, b) in enumerate(zip(durs_cum[:-1], durs_cum[1:])):
            values = f0[a:b][f0[a:b] != 0.0]
            values = values[values < preprocessing.pitch_max_freq]
            pitch_char[idx] = float(np.mean(values)) if len(values) else 0.0
            seg = energy[a:b]
            energy_char[idx] = float(np.mean(seg)) if len(seg) else 0.0

        for d, name, value in ((paths.duration_dir, "duration", duration),
                               (paths.attention_dir, "attention", np.float32(att_score)),
                               (paths.alignment_dir, "alignment", np.float32(align_score)),
                               (paths.phoneme_pitch_dir, "phoneme-pitch", pitch_char),
                               (paths.phoneme_energy_dir, "phoneme-energy", energy_char)):
            np.save(root / d / f"{name}-{utterance_id}.npy", value, allow_pickle=False)
    print("Aligned %d utterances." % len(utterances))
    return len(utterances)
