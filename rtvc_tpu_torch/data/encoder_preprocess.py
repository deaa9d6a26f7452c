"""Speaker-encoder dataset preprocessing (the port's counterpart of
``rtvc_tpu/data/encoder_preprocess.py``).

Per speaker directory: every audio file of the given extensions is loaded
(``utils.io.load_wav``: wav, mp3, and flac / m4a / ... through the codec
shim), resampled, volume-normalised and trimmed by the VAD
(``inference.encoder.preprocess_wav``), turned into 40-mel frames
(``wav_to_mel_spectrogram``) and kept if it has at least one partial's
frames. One ``combined.npz`` archive of ``frames_<i>.npy`` arrays and a
``_sources.txt`` manifest a speaker, and the dataset's statistics in
``Log_<dataset>.txt``: the files ``data.ge2e_sampler.
SpeakerVerificationDataset`` reads. Speakers go through a thread pool. All
of it runs on the host: the encoder frontend is numpy and PyTorch on the CPU.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from rtvc_tpu_torch.config.encoder import EncoderDataParams
from rtvc_tpu_torch.inference import encoder as encoder_inference


class DatasetLog:
    """Text-file log of a dataset's parameters and statistics, rewritten at
    every line; samples may be added from many threads."""

    def __init__(self, root: Path, name: str):
        self.path = Path(root) / ("Log_%s.txt" % name.replace("/", "_"))
        self._lines: List[str] = []
        self._lock = threading.Lock()
        self.sample_data: Dict[str, List[float]] = {}
        start = datetime.now().strftime("%A %d %B %Y at %H:%M")
        self.write_line("Creating dataset %s on %s" % (name, start))
        self.write_line("-----")
        self._log_params()

    def _log_params(self):
        params = EncoderDataParams()
        self.write_line("Parameter values:")
        for field, value in params.asdict().items():
            self.write_line("\t%s: %s" % (field, value))
        self.write_line("-----")

    def write_line(self, line: str):
        self._lines.append(line)
        self.path.write_text("\n".join(self._lines) + "\n")

    def add_sample(self, **kwargs):
        with self._lock:
            for name, value in kwargs.items():
                self.sample_data.setdefault(name, []).append(value)

    def finalize(self):
        self.write_line("Statistics:")
        for name, values in self.sample_data.items():
            self.write_line("\t%s:" % name)
            self.write_line("\t\tmin %.3f, max %.3f" % (np.min(values), np.max(values)))
            self.write_line("\t\tmean %.3f, median %.3f" % (np.mean(values), np.median(values)))
        self.write_line("-----")
        end = datetime.now().strftime("%A %d %B %Y at %H:%M")
        self.write_line("Finished on %s" % end)


def _preprocess_speaker(speaker_dir: Path, out_dir: Path, extensions: Sequence[str],
                        skip_existing: bool, data: EncoderDataParams,
                        logger: Optional[DatasetLog]) -> int:
    speaker_name = "_".join(speaker_dir.relative_to(speaker_dir.parent).parts)
    speaker_out_dir = out_dir / speaker_name
    speaker_out_dir.mkdir(exist_ok=True, parents=True)
    sources_fpath = speaker_out_dir / "_sources.txt"
    npz_fpath = speaker_out_dir / "combined.npz"

    if skip_existing and npz_fpath.exists() and sources_fpath.exists():
        return 0

    arrays: Dict[str, np.ndarray] = {}
    sources: List[str] = []
    count = 0
    for ext in extensions:
        for wav_fpath in sorted(speaker_dir.glob("**/*%s" % ext)):
            try:
                wav = encoder_inference.preprocess_wav(wav_fpath)
            except Exception as e:  # one unreadable file skips that file, as in the reference
                print("Skipping %s: %r" % (wav_fpath, e))
                continue
            if len(wav) == 0:
                continue
            frames = encoder_inference.wav_to_mel_spectrogram(wav)
            if len(frames) < data.partials_n_frames:
                continue
            key = "frames_%d.npy" % count
            arrays[key] = frames.astype(np.float32)
            sources.append("%s,%s" % (key, wav_fpath.name))
            if logger is not None:
                logger.add_sample(duration=len(wav) / data.sampling_rate)
            count += 1

    if not arrays:
        return 0
    np.savez(npz_fpath, **arrays)
    sources_fpath.write_text("\n".join(sources) + "\n")
    return count


def preprocess_speaker_dirs(speaker_dirs: Sequence[Path], dataset_name: str,
                            datasets_root: Path, out_dir: Path, extensions: Sequence[str],
                            skip_existing: bool, n_threads: int = 4) -> int:
    """Preprocess a list of speaker directories on ``n_threads`` threads;
    returns the number of utterances kept."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = DatasetLog(out_dir, dataset_name)
    data = EncoderDataParams()

    print("%s: Preprocessing data for %d speakers." % (dataset_name, len(speaker_dirs)))
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        results = list(pool.map(
            lambda d: _preprocess_speaker(d, out_dir, extensions, skip_existing, data, logger),
            speaker_dirs))
    print("Done preprocessing %s: %d utterances." % (dataset_name, int(np.sum(results))))
    logger.finalize()
    return int(np.sum(results))


def encoder_preprocess_dataset(datasets_root: Path, out_dir: Path, dataset_paths: Sequence[str],
                               dataset_name: str,
                               extensions: Sequence[str] = (".wav", ".flac", ".m4a", ".mp3"),
                               skip_existing: bool = False, n_threads: int = 4) -> int:
    """Preprocess a named dataset: each subdirectory of each of its paths
    under ``datasets_root`` is one speaker. Returns the number of utterances
    kept."""
    datasets_root = Path(datasets_root)
    speaker_dirs: List[Path] = []
    for rel in dataset_paths:
        root = datasets_root / rel
        if not root.exists():
            print("Couldn't find %s, skipping this dataset." % root)
            continue
        speaker_dirs.extend(sorted(d for d in root.glob("*") if d.is_dir()))
    return preprocess_speaker_dirs(speaker_dirs, dataset_name, datasets_root, out_dir,
                                   extensions, skip_existing, n_threads)
