"""Synthesizer training dataset + collate (ref: synthesizer/synthesizer_dataset.py).

Reads the ``train.json`` metadata contract (speaker → "utt_id|n_samples|
n_frames|text" lines) and the per-element artifact directories; the collate
pads text and mels (to an r-multiple, with the symmetric-mel silence value)
exactly like the reference (:116-179).

The text and mel buckets round padded shapes up to fixed steps, so a
training session sees a handful of batch shapes instead of one per batch.

This package's own copy of ``rtvc_tpu/data/synthesizer_dataset.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Sequence

import numpy as np

from rtvc_tpu_torch.config import preprocessing, sp, synthesizer_paths
from rtvc_tpu_torch.text import text_to_sequence


def pad1d(x, max_len, pad_value=0):
    return np.pad(x, (0, max_len - len(x)), mode="constant", constant_values=pad_value)


def pad2d(x, max_len, pad_value=0):
    return np.pad(
        x, ((0, 0), (0, max_len - x.shape[-1])), mode="constant",
        constant_values=pad_value,
    )


def _bucket(n: int, step: int) -> int:
    return -(-n // step) * step


class SynthesizerDataset:
    """Lazy per-utterance loader keyed by ``train.json``
    (ref: synthesizer_dataset.py:12-113)."""

    def __init__(self, synthesizer_root: Path, elements_to_provide: Sequence[str]):
        self.synthesizer_root = Path(synthesizer_root)
        self.elements_to_provide = list(elements_to_provide)
        self.paths = synthesizer_paths

        self.metadata_fpath = self.synthesizer_root / self.paths.metadata_file
        assert self.metadata_fpath.exists(), self.metadata_fpath

        metadata: List[List[str]] = []
        with self.metadata_fpath.open("r") as f:
            metadata_dict = json.load(f)
            for _speaker, lines in metadata_dict.items():
                metadata.extend([line.split("|") for line in lines])

        # column 2 (n_frames) == 0 marks dropped utterances
        self.samples_fnames = [x[0] for x in metadata if int(x[2])]
        self.samples_texts = [x[3].strip() for x in metadata if int(x[2])]
        self.metadata = metadata

    def __len__(self) -> int:
        return len(self.samples_fnames)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        utterance_id = self.samples_fnames[index]
        text = np.asarray(
            text_to_sequence(self.samples_texts[index], preprocessing.cleaner_names),
            dtype=np.int32,
        )
        root = self.synthesizer_root
        out: Dict[str, np.ndarray] = {"index": index, "text": text}

        def load(dirname, pattern):
            return np.load(root / dirname / (pattern % utterance_id))

        if "mel" in self.elements_to_provide:
            out["mel"] = load(self.paths.mel_dir, "mel-%s.npy").T.astype(np.float32)
        if "embed" in self.elements_to_provide:
            out["embed"] = load(self.paths.embed_dir, "embed-%s.npy").astype(np.float32)
        if "duration" in self.elements_to_provide:
            out["duration"] = load(self.paths.duration_dir, "duration-%s.npy").astype(np.float32)
        if "attention" in self.elements_to_provide:
            out["attention"] = load(self.paths.attention_dir, "attention-%s.npy").astype(np.float32)
        if "alignment" in self.elements_to_provide:
            out["alignment"] = load(self.paths.alignment_dir, "alignment-%s.npy").astype(np.float32)
        if "phoneme_pitch" in self.elements_to_provide:
            out["phoneme_pitch"] = load(
                self.paths.phoneme_pitch_dir, "phoneme-pitch-%s.npy"
            ).astype(np.float32)
        if "phoneme_energy" in self.elements_to_provide:
            out["phoneme_energy"] = load(
                self.paths.phoneme_energy_dir, "phoneme-energy-%s.npy"
            ).astype(np.float32)
        return out

    def get_logs(self) -> str:
        with self.metadata_fpath.open("r") as f:
            metadata_dict = json.load(f)
        speakers = len(metadata_dict)
        utterances = sum(len(v) for v in metadata_dict.values())
        return (
            f"Speakers: {speakers}\nUtterances: {utterances}\n"
            f"Avg. Utterance / Speaker: {utterances / max(speakers, 1)}\n"
        )


def collate_synthesizer(
    batch: List[Dict[str, np.ndarray]],
    r: int,
    text_bucket: int = 32,
    mel_bucket: int = 0,
) -> Dict[str, np.ndarray]:
    """Pad a list of samples into one batch dict (ref: collate_synthesizer,
    synthesizer_dataset.py:116-179). ``mel_bucket`` > 0 additionally rounds
    the padded mel length up (fewer distinct batch shapes)."""
    x_lens = np.asarray([len(b["text"]) for b in batch], dtype=np.int32)
    max_x_len = int(x_lens.max())
    if text_bucket:
        max_x_len = _bucket(max_x_len, text_bucket)
    chars = np.stack([pad1d(b["text"], max_x_len) for b in batch]).astype(np.int32)

    out: Dict[str, np.ndarray] = {
        "indices": np.asarray([b["index"] for b in batch]),
        "chars": chars,
        "x_lens": x_lens,
    }

    if "mel" in batch[0]:
        spec_lens = np.asarray([b["mel"].shape[-1] for b in batch], dtype=np.int32)
        max_spec_len = int(spec_lens.max()) + 1
        if max_spec_len % r != 0:
            max_spec_len += r - max_spec_len % r
        if mel_bucket:
            max_spec_len = _bucket(max_spec_len, mel_bucket * r) if mel_bucket else max_spec_len
        # symmetric mels: silence is -max_abs_value (ref: :140-145)
        pad_value = -sp.max_abs_value if preprocessing.symmetric_mels else 0.0
        out["mels"] = np.stack(
            [pad2d(b["mel"], max_spec_len, pad_value) for b in batch]
        ).astype(np.float32)
        out["spec_lens"] = spec_lens
        # Stop-token targets: 1 from the last real frame onwards
        # (ref builds them in the trainer, synthesizer/train.py:245-248)
        stop = np.zeros((len(batch), max_spec_len), dtype=np.float32)
        for i, n in enumerate(spec_lens):
            stop[i, int(n) - 1 :] = 1.0
        out["stop"] = stop

    if "embed" in batch[0]:
        out["embeds"] = np.stack([b["embed"] for b in batch]).astype(np.float32)

    for key, pad_val in (
        ("duration", 0),
        ("phoneme_pitch", 0.0),
        ("phoneme_energy", 0.0),
    ):
        if key in batch[0]:
            max_len = max(len(b[key]) for b in batch)
            if text_bucket:
                max_len = max(_bucket(max_len, text_bucket), max_x_len)
            out[key + "s"] = np.stack(
                [pad1d(b[key], max_len, pad_val) for b in batch]
            ).astype(np.float32)

    for key in ("attention", "alignment"):
        if key in batch[0]:
            out[key + "s"] = np.stack([b[key] for b in batch])
    return out


class batch_iterator:
    """One epoch of collated batches, length-sorted into buckets then
    shuffled (minimizes padding and the number of batch shapes). Sized + lazy:
    ``len()`` is known upfront, batches are built on demand (the trainer
    never materializes an epoch in memory)."""

    def __init__(
        self,
        dataset: SynthesizerDataset,
        batch_size: int,
        r: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        mel_bucket: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ):
        """``batch_size`` is the GLOBAL batch. With ``process_count`` > 1
        every process builds the same deterministic global batch list (same
        seed required) and yields its own slice of each batch, collated at
        the GLOBAL padded shape so the per-process arrays assemble into one
        global array (local shapes must be identical across processes)."""
        self.dataset = dataset
        self.r = r
        self.mel_bucket = mel_bucket
        if batch_size % process_count:
            raise ValueError(
                f"global batch {batch_size} must divide by process_count "
                f"{process_count}"
            )
        if process_count > 1 and not drop_last:
            # the trailing short batch would yield ragged/empty local shards
            # across processes (a collective over them would hang)
            raise ValueError("process_count > 1 requires drop_last=True")
        self.process_index = process_index
        self.process_count = process_count
        self.local = batch_size // process_count
        self.shuffle = shuffle
        # persistent rng: each __iter__ yields a freshly shuffled epoch (the
        # torch-DataLoader semantics of ref synthesizer/train.py:172-180);
        # same seed + same number of __iter__ calls keeps multi-process
        # batch lists in lockstep
        self.rng = np.random.default_rng(seed)
        order = np.argsort(
            [len(dataset.samples_texts[i]) for i in range(len(dataset))]
        )
        batches = [
            order[i : i + batch_size] for i in range(0, len(order), batch_size)
        ]
        if drop_last:
            batches = [b for b in batches if len(b) == batch_size]
        self.batches = batches

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = list(self.batches)
        if self.shuffle:
            self.rng.shuffle(batches)
        for idx in batches:
            out = collate_synthesizer(
                [self.dataset[int(i)] for i in idx], self.r,
                mel_bucket=self.mel_bucket,
            )
            if self.process_count > 1:
                lo = self.process_index * self.local
                out = {
                    k: v[lo : lo + self.local] if hasattr(v, "ndim") else v
                    for k, v in out.items()
                }
            yield out
