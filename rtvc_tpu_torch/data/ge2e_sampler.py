"""GE2E batch sampling for speaker-encoder training.

Behavior parity with the reference's data objects (ref:
encoder/data_objects/): ``RandomCycler`` constrained-random sampling
(random_cycler.py:5-36), per-speaker ``combined.npz`` archives with random
fixed-length crops (speaker.py:24-46), and (S·U, n_frames, n_mels) batch
stacking (speaker_batch.py:6-12). Instead of a torch DataLoader, batches come
from a plain infinite iterator with an optional background-thread prefetcher
(the host side feeds a single train step: simple double-buffering, not
worker processes).

This package's own copy of ``rtvc_tpu/data/ge2e_sampler.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import queue
import random
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np


class RandomCycler:
    """Constrained random order with the reference's guarantees (ref:
    random_cycler.py:5-36): over m draws from n items, each item appears
    between m//n and ((m-1)//n)+1 times, and at most 2·(n−1) other items
    separate two appearances of the same item. Implemented as sequentially
    drained full shuffles."""

    def __init__(self, source):
        if len(source) == 0:
            raise Exception("Can't create RandomCycler from an empty collection")
        self.all_items = list(source)
        self._queue: list = []

    def sample(self, count: int) -> list:
        out: list = []
        while len(out) < count:
            if not self._queue:
                self._queue = random.sample(self.all_items, len(self.all_items))
            take = min(count - len(out), len(self._queue))
            out.extend(self._queue[:take])
            del self._queue[:take]
        return out

    def __next__(self):
        return self.sample(1)[0]


class Utterance:
    """One utterance inside a speaker's ``combined.npz``
    (ref: data_objects/utterance.py)."""

    def __init__(self, frames_fname: str, wave_fpath: str):
        self.frames_fname = frames_fname
        self.wave_fpath = wave_fpath

    def get_frames(self, npz) -> np.ndarray:
        return npz[self.frames_fname]

    def random_partial(self, n_frames: int, npz) -> Tuple[np.ndarray, Tuple[int, int]]:
        """Random ``n_frames`` crop (zero-pads short utterances)."""
        frames = self.get_frames(npz)
        if frames.shape[0] < n_frames:
            pad = np.zeros((n_frames - frames.shape[0], frames.shape[1]),
                           dtype=frames.dtype)
            frames = np.concatenate([frames, pad], axis=0)
        if frames.shape[0] == n_frames:
            start = 0
        else:
            start = np.random.randint(0, frames.shape[0] - n_frames)
        end = start + n_frames
        return frames[start:end], (start, end)


class Speaker:
    """Lazily-loaded speaker directory with ``combined.npz`` + ``_sources.txt``
    (ref: speaker.py:8-46)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.name = self.root.name
        self.utterances: Optional[List[Utterance]] = None
        self.utterance_cycler: Optional[RandomCycler] = None

    def _load_utterances(self):
        with self.root.joinpath("_sources.txt").open("r") as f:
            sources = [line.strip().split(",") for line in f if line.strip()]
        if len(sources) < 1:
            raise Exception("No sources found for: %s" % self.root)
        mapping = {frames_fname: wave_fpath for frames_fname, wave_fpath in sources}
        self.utterances = [Utterance(f, w) for f, w in mapping.items()]
        self.utterance_cycler = RandomCycler(self.utterances)

    def random_partial(self, count: int, n_frames: int):
        if self.utterances is None:
            self._load_utterances()
        with np.load(self.root.joinpath("combined.npz")) as data:
            utterances = self.utterance_cycler.sample(count)
            return [(u,) + u.random_partial(n_frames, data) for u in utterances]


class SpeakerVerificationDataset:
    """Infinite speaker sampler over a preprocessed dataset root
    (ref: speaker_verification_dataset.py:12-40).

    ``process_index``/``process_count``: multi-process DP shards the
    SPEAKER LIST disjointly (deterministic sorted split), so one global
    GE2E batch never contains the same speaker from two processes — a
    collision would make the contrastive loss push apart two batch rows
    of the same identity."""

    def __init__(self, datasets_root: Path, process_index: int = 0,
                 process_count: int = 1):
        self.root = Path(datasets_root)
        speaker_dirs = sorted(f for f in self.root.glob("*") if f.is_dir())
        if len(speaker_dirs) == 0:
            raise Exception(
                "No speakers found. Make sure you are pointing to the "
                "directory containing all preprocessed speaker directories."
            )
        if process_count > 1:
            speaker_dirs = speaker_dirs[process_index::process_count]
            if not speaker_dirs:
                raise Exception(
                    f"Process {process_index}/{process_count} got an empty "
                    "speaker shard — too few speakers for this process count."
                )
        self.speakers = [Speaker(d) for d in speaker_dirs]
        self.speaker_cycler = RandomCycler(self.speakers)

    def get_logs(self) -> str:
        log_string = ""
        for log_fpath in self.root.glob("*.txt"):
            with log_fpath.open("r") as log_file:
                log_string += "".join(log_file.readlines())
        return log_string


def speaker_batch_iterator(
    dataset: SpeakerVerificationDataset,
    speakers_per_batch: int,
    utterances_per_speaker: int,
    n_frames: int,
    prefetch: int = 2,
    seed: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Infinite iterator of (S·U, n_frames, n_mels) float32 batches with a
    background prefetch thread (double buffering for the device)."""
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)

    def make_batch() -> np.ndarray:
        speakers = [next(dataset.speaker_cycler) for _ in range(speakers_per_batch)]
        partials = [s.random_partial(utterances_per_speaker, n_frames) for s in speakers]
        return np.stack(
            [frames for plist in partials for _, frames, _ in plist]
        ).astype(np.float32)

    if prefetch <= 0:
        while True:
            yield make_batch()

    q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            try:
                q.put(make_batch(), timeout=1.0)
            except queue.Full:
                continue

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
