"""Synthesizer dataset preprocessing: the three passes of
``rtvc_tpu/data/synthesizer_preprocess.py``, same files on disk.

1. Audio (:func:`synthesizer_preprocess_dataset`): each speaker directory's
   utterances are loaded, rescaled, trimmed (the VAD, then the leading and
   trailing silence), turned into normalised mels (``ops.audio.
   melspectrogram``: K6 once an utterance on the card) and written as
   ``mels/mel-<id>.npy`` and ``wav/audio-<id>.npy``, with ``train.json``
   keyed by speaker directory ("utt_id|n_samples|n_frames|text" lines),
   saved at exit as well when the pass fails part way. Speakers go through
   a thread pool.
2. Embeddings (:func:`create_embeddings`): the speaker encoder
   (``inference.encoder``, its LSTMs through K3 on the card) over every
   saved wav → ``embeds/embed-<id>.npy``, on a thread pool.
3. Alignment features (:func:`create_align_features`): a trained
   Tacotron's teacher-forced attention (``inference.attention.
   TacotronAligner``) gives each utterance's durations per character (the
   shortest monotonic path, ``data.duration_extractor``); the F0 track
   (``ops.pitch.estimate_f0``) and the mel's energy are averaged over each
   character's frames. Five files an utterance: ``duration/``,
   ``attention/`` (the attention score), ``alignment/`` (the alignment
   score), ``phoneme_pitch/`` and ``phoneme_energy/``, the
   non-autoregressive synthesizers' training inputs. One process takes
   every utterance.

:func:`split_on_silences` cuts a long utterance at aligned silences, with
log-MMSE denoising, for corpora that ship word alignments.
"""
from __future__ import annotations

import atexit
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from shutil import copyfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rtvc_tpu_torch.config import preprocessing, sp, synthesizer_paths
from rtvc_tpu_torch.data.duration_extractor import DurationExtractor, attention_scores
from rtvc_tpu_torch.ops import logmmse
from rtvc_tpu_torch.ops.pitch import estimate_f0
from rtvc_tpu_torch.text import text_to_sequence
from rtvc_tpu_torch.utils.io import load_wav


def _save_metadata(metadata: Dict, fpath: Path) -> None:
    with Path(fpath).open("w", encoding="utf-8") as f:
        json.dump(metadata, f)


# ---------------------------------------------------------------------------
# Pass 1: audio
# ---------------------------------------------------------------------------


def process_utterance(utterance_id: str, wav: np.ndarray, text: str, out_dir: Path,
                      device=None) -> Optional[Tuple[str, int, int, str]]:
    """Trim → mel → save the mel and the wav. The mel is computed on
    ``device`` (the card unless the caller names another; RuntimeError
    without one), so K6 runs there. Returns (utterance_id, n_samples,
    n_frames, text), or None when the utterance is dropped: shorter than
    ``utterance_min_duration`` after trimming, or past ``max_mel_frames``."""
    from rtvc_tpu_torch.inference import encoder as enc
    from rtvc_tpu_torch.models.factories import resolve_device
    from rtvc_tpu_torch.ops.audio import melspectrogram
    from rtvc_tpu_torch.ops.vad import trim_silence

    device = resolve_device(device)
    if preprocessing.trim_silence:
        wav = enc.preprocess_wav(wav, normalize=False, trim_silence=True)
    if preprocessing.trim_start_end_silence:
        wav = trim_silence(wav, preprocessing.trim_silence_top_db)

    if len(wav) < preprocessing.utterance_min_duration * sp.sample_rate:
        return None

    with torch.no_grad():
        mel = melspectrogram(torch.as_tensor(np.asarray(wav, np.float32)).to(device), sp,
                             preprocessing).cpu().numpy().astype(np.float32)
    mel_frames = mel.shape[1]
    if mel_frames > preprocessing.max_mel_frames and preprocessing.clip_mels_length:
        return None

    out_dir = Path(out_dir)
    np.save(out_dir / synthesizer_paths.mel_dir / ("mel-%s.npy" % utterance_id), mel.T,
            allow_pickle=False)
    np.save(out_dir / synthesizer_paths.wav_dir / ("audio-%s.npy" % utterance_id), wav,
            allow_pickle=False)
    return utterance_id, len(wav), mel_frames, text


def preprocess_speaker(speaker_dir: Path, out_dir: Path, audio_extensions: Sequence[str],
                       transcript_extension: str, device=None) -> Dict:
    """One speaker directory → its utterances' files and metadata lines."""
    speaker_dir = Path(speaker_dir)
    result = {"speaker_dir": str(speaker_dir), "metadata": []}
    for ext in audio_extensions:
        for wav_fpath in sorted(speaker_dir.glob("**/*%s" % ext)):
            utterance_id = "%s_%s" % (speaker_dir.name, wav_fpath.stem)
            try:
                wav, _ = load_wav(wav_fpath, target_sr=sp.sample_rate)
            except Exception as e:  # one unreadable file skips that file, as in the reference
                print("Unable to load audio file %s: %r" % (wav_fpath, e))
                continue
            if preprocessing.rescale:
                wav = wav / np.abs(wav).max() * preprocessing.rescaling_max

            text_fpath = wav_fpath.with_suffix(transcript_extension)
            if not text_fpath.exists():
                continue
            text = text_fpath.read_text().strip()
            if len(text) < preprocessing.min_text_len:
                continue

            output = process_utterance(utterance_id, wav, text, out_dir, device)
            if output is not None:
                result["metadata"].append(output)
    return result


def synthesizer_preprocess_dataset(datasets_root: Path, out_dir: Path, dataset_name: str,
                                   subfolders: Sequence[str], audio_extensions: Sequence[str],
                                   transcript_extension: str, n_processes: int = 4,
                                   skip_existing: bool = False, device=None) -> int:
    """The audio pass over ``<datasets_root>/<dataset_name>/<subfolder>/
    <speaker>/``, speakers on ``n_processes`` threads, mels on ``device``
    (the card unless the caller names another). An existing ``train.json``
    is kept and its speakers skipped with ``skip_existing``, else copied to
    ``train_backup_<time>.json`` and replaced. The metadata is saved at
    interpreter exit too, so that a pass that fails part way keeps the
    speakers it finished. Returns the number of utterances in
    ``train.json``."""
    from rtvc_tpu_torch.models.factories import resolve_device

    device = resolve_device(device)
    dataset_root = Path(datasets_root) / dataset_name
    input_dirs = [dataset_root / sub.strip() for sub in subfolders]
    input_dirs = [d for d in input_dirs if d.exists()]
    if not input_dirs:
        raise FileNotFoundError("No input directories found under %s" % dataset_root)

    out_dir = Path(out_dir)
    (out_dir / synthesizer_paths.mel_dir).mkdir(parents=True, exist_ok=True)
    (out_dir / synthesizer_paths.wav_dir).mkdir(parents=True, exist_ok=True)
    metadata_fpath = out_dir / synthesizer_paths.metadata_file

    metadata: Dict[str, List[str]] = {}
    if metadata_fpath.is_file():
        if skip_existing:
            metadata = json.loads(metadata_fpath.read_text())
        else:
            copyfile(metadata_fpath, out_dir / ("train_backup_%f.json" % time.time()))

    speaker_dirs = [d for input_dir in input_dirs for d in sorted(input_dir.glob("*"))
                    if d.is_dir()]
    if skip_existing:
        speaker_dirs = [d for d in speaker_dirs if str(d) not in metadata]

    atexit.register(_save_metadata, metadata, metadata_fpath)
    with ThreadPoolExecutor(max_workers=n_processes) as pool:
        for speaker_metadata in pool.map(
                lambda d: preprocess_speaker(d, out_dir, audio_extensions,
                                             transcript_extension, device),
                speaker_dirs):
            metadata[speaker_metadata["speaker_dir"]] = [
                "|".join(str(x) for x in m) for m in speaker_metadata["metadata"]]
    _save_metadata(metadata, metadata_fpath)
    atexit.unregister(_save_metadata)

    lines = [line.split("|") for utts in metadata.values() for line in utts]
    if lines:
        mel_frames = sum(int(m[2]) for m in lines)
        timesteps = sum(int(m[1]) for m in lines)
        hours = timesteps / sp.sample_rate / 3600
        print("The dataset consists of %d utterances, %d mel frames, %d audio timesteps "
              "(%.2f hours)." % (len(lines), mel_frames, timesteps, hours))
        print("Max input length (text chars): %d" % max(len(m[3]) for m in lines))
        print("Max mel frames length: %d" % max(int(m[2]) for m in lines))
        print("Max audio timesteps length: %d" % max(int(m[1]) for m in lines))
    return len(lines)


# ---------------------------------------------------------------------------
# Silence-based utterance splitting (alignment-aware corpora)
# ---------------------------------------------------------------------------


def split_on_silences(wav_fpath: Path, words: Sequence[str], end_times: Sequence[float],
                      transcript: Optional[str] = None) -> Tuple[List[np.ndarray], List[str]]:
    """Split a long utterance at aligned silences of at least
    ``silence_min_duration_split``, denoised with the silent stretches as
    the log-MMSE noise profile; segments shorter than
    ``utterance_min_duration`` are merged into their shorter neighbour while
    the join stays under ``max_mel_frames``. Returns the wavs and texts."""
    wav, _ = load_wav(wav_fpath, target_sr=sp.sample_rate)
    if preprocessing.rescale:
        wav = wav / np.abs(wav).max() * preprocessing.rescaling_max

    words = np.asarray(words)
    start_times = np.asarray([0.0] + list(end_times[:-1]))
    end_times = np.asarray(end_times)
    if not len(words) == len(end_times) == len(start_times):
        raise ValueError("split_on_silences: %d words for %d end times"
                         % (len(words), len(end_times)))

    if words[0] != "" and words[-1] != "":
        text = transcript if transcript is not None else " ".join(words).replace("  ", " ")
        return [wav], [text]

    mask = (words == "") & (end_times - start_times >= preprocessing.silence_min_duration_split)
    mask[0] = mask[-1] = True
    breaks = np.where(mask)[0]

    # the silent stretches are the noise profile
    silence_times = np.asarray([[start_times[i], end_times[i]] for i in breaks])
    silence_samples = (silence_times * sp.sample_rate).astype(np.int64)
    noisy = (np.concatenate([wav[s:e] for s, e in silence_samples]) if len(silence_samples)
             else np.zeros(0))
    if len(noisy) > sp.sample_rate * 0.02:
        profile = logmmse.profile_noise(noisy, sp.sample_rate)
        wav = logmmse.denoise(wav, profile, eta=0)

    # merge segments that are too short into their shortest neighbour
    segments = list(zip(breaks[:-1], breaks[1:]))
    seg_durations = [start_times[e] - end_times[s] for s, e in segments]
    i = 0
    max_dur = sp.hop_size * preprocessing.max_mel_frames / sp.sample_rate
    while i < len(segments) and len(segments) > 1:
        if seg_durations[i] < preprocessing.utterance_min_duration:
            left = float("inf") if i == 0 else seg_durations[i - 1]
            right = float("inf") if i == len(segments) - 1 else seg_durations[i + 1]
            joined = seg_durations[i] + min(left, right)
            if joined > max_dur:
                i += 1
                continue
            j = i - 1 if left <= right else i
            segments[j] = (segments[j][0], segments[j + 1][1])
            seg_durations[j] = joined
            del segments[j + 1], seg_durations[j + 1]
        else:
            i += 1

    seg_times = (np.asarray([[end_times[s], start_times[e]] for s, e in segments])
                 * sp.sample_rate).astype(np.int64)
    wavs = [wav[s:e] for s, e in seg_times]
    texts = [" ".join(words[s + 1:e]).replace("  ", " ") for s, e in segments]
    return wavs, texts


# ---------------------------------------------------------------------------
# Pass 2: embeddings
# ---------------------------------------------------------------------------


def create_embeddings(synthesizer_root: Path, encoder_model_fpath: Optional[Path] = None,
                      skip_existing: bool = False, n_processes: int = 4, device=None) -> int:
    """The speaker encoder's embedding of every utterance of
    ``<synthesizer_root>/train.json``, from its saved wav, on
    ``n_processes`` threads. The installed encoder (``inference.encoder``)
    is used if there is one, else the checkpoint at ``encoder_model_fpath``
    (any format of ``train.checkpoints.read_model``) is installed on
    ``device`` (the card unless the caller names another). With
    ``skip_existing`` utterances whose embedding file exists are left out.
    Returns the number of utterances embedded."""
    from rtvc_tpu_torch.inference import encoder as enc

    synthesizer_root = Path(synthesizer_root)
    wav_dir = synthesizer_root / synthesizer_paths.wav_dir
    metadata_fpath = synthesizer_root / synthesizer_paths.metadata_file
    if not (wav_dir.exists() and metadata_fpath.exists()):
        raise FileNotFoundError("create_embeddings: %s needs the audio pass's %s and %s"
                                % (synthesizer_root, wav_dir.name, metadata_fpath.name))
    embed_dir = synthesizer_root / synthesizer_paths.embed_dir
    embed_dir.mkdir(exist_ok=True)

    metadata = json.loads(metadata_fpath.read_text())
    utterance_ids = [line.split("|")[0] for lines in metadata.values() for line in lines]
    if skip_existing:
        existing = {p.name for p in embed_dir.glob("embed-*.npy")}
        utterance_ids = [u for u in utterance_ids if ("embed-%s.npy" % u) not in existing]

    if not enc.is_loaded():
        if encoder_model_fpath is not None and Path(encoder_model_fpath).exists():
            enc.load_model(encoder_model_fpath, device=device)
        else:
            raise RuntimeError("Encoder model not loaded and no weights found at %s"
                               % encoder_model_fpath)

    def embed_one(utterance_id: str):
        wav = np.load(wav_dir / ("audio-%s.npy" % utterance_id))
        wav = enc.preprocess_wav(wav)
        embed = enc.embed_utterance(wav)
        np.save(embed_dir / ("embed-%s.npy" % utterance_id), embed, allow_pickle=False)

    # the forward passes share the one card: the pool overlaps the host's
    # work (files, the VAD, the mel frames) with the launches
    with ThreadPoolExecutor(max_workers=n_processes) as pool:
        list(pool.map(embed_one, utterance_ids))
    print("Embedded %d utterances." % len(utterance_ids))
    return len(utterance_ids)


# ---------------------------------------------------------------------------
# Pass 3: alignment features (durations / pitch / energy)
# ---------------------------------------------------------------------------


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
