"""Vocoder training dataset + collate (ref: vocoder/vocoder_dataset.py).

Pairs GTA (or ground-truth) mels with wav arrays, re-applies preemphasis,
quantizes on the fly (mu-law / bit labels / 16-bit for MOL), and crops random
hop-aligned ``seq_len`` windows with the conditioning pad
(ref: vocoder_dataset.py:33-103). All crops of a session share one shape.

This package's own copy of ``rtvc_tpu/data/vocoder_dataset.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

from rtvc_tpu_torch.config import sp
from rtvc_tpu_torch.config.vocoder import MODE_MOL, WaveRNNParams


# Host-side (numpy) mirrors of ops/audio.py's preemphasis / float_2_label /
# encode_mu_law. The loader runs per item on the host thread, so it stays in
# numpy and touches no device.


def _pre_emphasis_np(wav: np.ndarray, k: float) -> np.ndarray:
    """FIR y[n] = x[n] - k·x[n-1] (ops/audio.py:32-34)."""
    return np.concatenate([wav[:1], wav[1:] - k * wav[:-1]])


def _float_2_label_np(x: np.ndarray, bits: int) -> np.ndarray:
    """Float [-1, 1] → label [0, 2^bits - 1] (ops/audio.py:318-321)."""
    y = (x + 1.0) * (2.0**bits - 1.0) / 2.0
    return np.clip(y, 0.0, 2.0**bits - 1.0)


def _encode_mu_law_np(x: np.ndarray, mu: int) -> np.ndarray:
    """Mu-law companding → integer labels (ops/audio.py:324-328)."""
    m = mu - 1
    fx = np.sign(x) * np.log1p(m * np.abs(x)) / np.log1p(np.float32(m))
    return np.floor((fx + 1.0) / 2.0 * m + 0.5)


class VocoderDataset:
    def __init__(
        self,
        metadata_fpath: Path,
        mel_dir: Path,
        wav_dir: Path,
        vocoder_hparams: WaveRNNParams,
    ):
        self.metadata_fpath = Path(metadata_fpath)
        mel_dir, wav_dir = Path(mel_dir), Path(wav_dir)

        metadata: List[List[str]] = []
        with self.metadata_fpath.open("r") as f:
            metadata_dict = json.load(f)
            for line in metadata_dict.values():
                metadata.extend([line.split("|")])

        fnames = [x[0] for x in metadata if int(x[2])]
        gta_fpaths = [mel_dir / ("%s.npy" % f) for f in fnames]
        wav_fpaths = [wav_dir / ("audio-%s.npy" % f) for f in fnames]
        self.hp = vocoder_hparams
        self.samples_fpaths = list(zip(gta_fpaths, wav_fpaths))
        self.metadata = metadata

    def __len__(self) -> int:
        return len(self.samples_fpaths)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray, int]:
        mel_path, wav_path = self.samples_fpaths[index]

        # Mel range → [-1, 1] (ref: vocoder_dataset.py:37-38)
        mel = np.load(mel_path).T.astype(np.float32) / sp.max_abs_value

        wav = np.load(wav_path)
        if sp.preemphasis:
            wav = _pre_emphasis_np(wav, sp.preemphasis)
        wav = np.clip(wav, -1, 1)

        # Pad to a hop multiple covering all mel frames (ref: :46-51)
        r_pad = (len(wav) // sp.hop_size + 1) * sp.hop_size - len(wav)
        wav = np.pad(wav, (0, r_pad), mode="constant")
        assert len(wav) >= mel.shape[1] * sp.hop_size
        wav = wav[: mel.shape[1] * sp.hop_size]

        # Quantize (ref: :53-60)
        if self.hp.mode == MODE_MOL:
            quant = _float_2_label_np(wav, bits=16)
        elif self.hp.mu_law:
            quant = _encode_mu_law_np(wav, mu=2**self.hp.bits)
        else:
            quant = _float_2_label_np(wav, bits=self.hp.bits)
        return mel.astype(np.float32), quant.astype(np.int64), index

    def get_logs(self) -> str:
        return "Samples: {0}\n".format(len(self.samples_fpaths))


def collate_vocoder(
    batch: List[Tuple[np.ndarray, np.ndarray, int]],
    hp: WaveRNNParams,
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """Random hop-aligned crops → {x, y (labels), y_float, mels, indices}
    (ref: collate_vocoder, vocoder_dataset.py:73-103)."""
    mel_win = hp.seq_len // sp.hop_size + 2 * hp.pad
    max_offsets = [x[0].shape[-1] - 2 - (mel_win + 2 * hp.pad) for x in batch]
    mel_offsets = [rng.integers(0, max(off, 1)) for off in max_offsets]
    sig_offsets = [(off + hp.pad) * sp.hop_size for off in mel_offsets]

    mels = np.stack(
        [x[0][:, mel_offsets[i] : mel_offsets[i] + mel_win] for i, x in enumerate(batch)]
    ).astype(np.float32)
    labels = np.stack(
        [
            x[1][sig_offsets[i] : sig_offsets[i] + hp.seq_len + 1]
            for i, x in enumerate(batch)
        ]
    ).astype(np.int64)

    x_labels = labels[:, : hp.seq_len]
    y_labels = labels[:, 1:]

    bits = 16 if hp.mode == MODE_MOL else hp.bits
    x = 2.0 * x_labels.astype(np.float32) / (2**bits - 1.0) - 1.0  # label_2_float
    y_float = 2.0 * y_labels.astype(np.float32) / (2**bits - 1.0) - 1.0

    return {
        "x": x,
        "y": y_labels.astype(np.int32),
        "y_float": y_float,
        "mels": mels,
        "indices": np.asarray([x[2] for x in batch]),
    }


class batch_iterator:
    """Sized lazy epoch iterable (len known upfront, batches built on demand).

    Each ``__iter__`` call yields a FRESH epoch: a new shuffle order and new
    random crop offsets drawn from the persistent rng — the torch-DataLoader
    semantics the reference trains with (ref: vocoder/train.py:126-133, a
    DataLoader whose sampler/collate re-randomize every epoch). The trainer
    constructs this once per session and iterates it once per epoch; feeding
    it identical crops every epoch makes the model memorize a handful of
    fixed windows instead of learning the mel→wave map (observed: CE ≈ 1 on
    the fixed crops, CE ≈ chance-or-worse everywhere else, free-run MCD
    ~34 dB)."""

    def __init__(
        self,
        dataset: VocoderDataset,
        batch_size: int,
        hp: WaveRNNParams,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ):
        """``batch_size`` is the GLOBAL batch; with ``process_count`` > 1
        every process builds the same deterministic global batch list (same
        seed required, same number of ``__iter__`` calls) and yields only its
        own contiguous slice of each — the Accelerate per-rank loader shard
        (ref: vocoder/train.py:129)."""
        self.dataset = dataset
        self.hp = hp
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        if batch_size % process_count:
            raise ValueError(
                f"global batch {batch_size} must divide by process_count "
                f"{process_count}"
            )
        if process_count > 1 and not drop_last:
            # a trailing short batch would shard raggedly across processes
            raise ValueError("process_count > 1 requires drop_last=True")
        self.batch_size = batch_size
        self.local = batch_size // process_count
        self.process_index = process_index

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        lo = self.process_index * self.local
        for idx in batches:
            yield collate_vocoder(
                [self.dataset[int(i)] for i in idx[lo : lo + self.local]],
                self.hp, self.rng,
            )
