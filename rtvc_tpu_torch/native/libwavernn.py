"""ctypes binding of the native WaveRNN engine (counterpart of
``rtvc_tpu/native/libwavernn.py``), the vocoder's second backend: a host
CPU engine in C++ (``native/src``), reached only when a caller asks for it
by name (``inference.vocoder.load_model(..., voc_type="libwavernn")``).

``Vocoder{load, setRandomSeed, vocode_mel}`` folds the mel with overlap
into chunks sized to its worker pool, generates them on OS threads (ctypes
releases the GIL during the C call), one engine instance a thread, merges
them with an equal-power crossfade, then applies the mu-law decode,
de-emphasis and fade-out; ``_Instance.mel_to_wav`` is one unfolded
sequence. The code is a copy of the original, held equal in source to it
by ``tests/test_torch_imports.py`` except for the imports, the ``jnp``
stand-in that hands ``ops.audio``'s filters host tensors, and the
library's path: the port's own build of the copied sources
(``_build.build_wavernn_engine``) instead of ``build.sh``'s.
"""
from __future__ import annotations

import ctypes
import math
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np

import torch

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.config import sp
from rtvc_tpu_torch.config import vocoder as voc_cfg


class jnp:
    """What the original's decode asks of ``jax.numpy``, on host tensors:
    ``asarray(wav, float32)`` hands ``ops.audio``'s mu-law decode and
    de-emphasis a CPU tensor, which ``np.asarray`` reads back."""

    float32 = torch.float32

    @staticmethod
    def asarray(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype)


def _load_lib(path: Optional[Path] = None) -> ctypes.CDLL:
    """The engine's library: ``path``, or the port's own build of
    ``native/src`` (``_build.build_wavernn_engine``, compiled on first
    use)."""
    path = _build.build_wavernn_engine().library if path is None else Path(path)
    lib = ctypes.CDLL(str(path))
    lib.rtvc_vocoder_create.restype = ctypes.c_void_p
    lib.rtvc_vocoder_destroy.argtypes = [ctypes.c_void_p]
    lib.rtvc_vocoder_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtvc_vocoder_load.restype = ctypes.c_int
    lib.rtvc_vocoder_set_seed.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rtvc_vocoder_hop.argtypes = [ctypes.c_void_p]
    lib.rtvc_vocoder_hop.restype = ctypes.c_int
    lib.rtvc_vocoder_n_classes.argtypes = [ctypes.c_void_p]
    lib.rtvc_vocoder_n_classes.restype = ctypes.c_int
    lib.rtvc_vocoder_mode.argtypes = [ctypes.c_void_p]
    lib.rtvc_vocoder_mode.restype = ctypes.c_int
    lib.rtvc_vocoder_mel_to_wav.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.c_int,
    ]
    lib.rtvc_vocoder_mel_to_wav.restype = ctypes.c_long
    lib.rtvc_vocoder_mel_to_wav_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.c_int,
    ]
    lib.rtvc_vocoder_mel_to_wav_batch.restype = ctypes.c_long
    return lib


class _Instance:
    """One native model instance (one per worker thread, private weights —
    same isolation decision as the reference, ref: inference.py:48-54)."""

    def __init__(self, lib: ctypes.CDLL, weights_path: Path):
        self._lib = lib
        self._h = lib.rtvc_vocoder_create()
        if lib.rtvc_vocoder_load(self._h, str(weights_path).encode()) != 0:
            raise RuntimeError(f"Failed to load native weights: {weights_path}")

    def __del__(self):
        try:
            self._lib.rtvc_vocoder_destroy(self._h)
        except Exception:
            pass

    def set_seed(self, seed: int):
        self._lib.rtvc_vocoder_set_seed(self._h, seed)

    @property
    def hop(self) -> int:
        return self._lib.rtvc_vocoder_hop(self._h)

    def mel_to_wav(self, mel: np.ndarray, argmax: bool = False) -> np.ndarray:
        mel = np.ascontiguousarray(mel, dtype=np.float32)
        n_mels, n_frames = mel.shape
        out = np.zeros(n_frames * self.hop + 16, dtype=np.float32)
        n = self._lib.rtvc_vocoder_mel_to_wav(
            self._h,
            mel.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_mels,
            n_frames,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(out),
            1 if argmax else 0,
        )
        if n < 0:
            raise RuntimeError("native mel_to_wav failed")
        return out[:n]

    def mel_to_wav_batch(self, mels: np.ndarray,
                         argmax: bool = False) -> np.ndarray:
        """mels (B, n_mels, n_frames) → (B, T). All chunks advance in
        LOCKSTEP inside the engine: each weight matrix is traversed once
        per sample step for the whole batch, so B independent AR chains
        fill the FMA pipe a single chain leaves idle — the CPU analogue
        of the TPU fold batching (BENCHMARKS.md round 4)."""
        mels = np.ascontiguousarray(mels, dtype=np.float32)
        B, n_mels, n_frames = mels.shape
        cap = B * (n_frames * self.hop + 16)
        out = np.zeros(cap, dtype=np.float32)
        t = self._lib.rtvc_vocoder_mel_to_wav_batch(
            self._h,
            mels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            B,
            n_mels,
            n_frames,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cap,
            1 if argmax else 0,
        )
        if t < 0:
            raise RuntimeError("native mel_to_wav_batch failed")
        return out[: B * t].reshape(B, t)


def fold_mel_with_overlap(
    mel: np.ndarray, target_frames: int, overlap_frames: int
) -> List[Tuple[int, np.ndarray]]:
    """Mel-domain fold: overlapping frame chunks (offset, chunk)
    (ref mel-domain variant: libwavernn/inference.py:135-164)."""
    n_frames = mel.shape[1]
    step = target_frames + overlap_frames
    if n_frames <= target_frames + 2 * overlap_frames:
        return [(0, mel)]
    chunks = []
    start = 0
    while start < n_frames:
        end = min(start + target_frames + 2 * overlap_frames, n_frames)
        chunks.append((start, mel[:, start:end]))
        if end >= n_frames:
            break
        start += step
    return chunks


def unfold_with_overlap(
    chunks: List[Tuple[int, np.ndarray]], total_samples: int, hop: int,
    overlap_frames: int,
) -> np.ndarray:
    """Equal-power crossfade merge of chunk waveforms
    (ref: libwavernn/inference.py:166-198)."""
    out = np.zeros(total_samples, dtype=np.float64)
    overlap = overlap_frames * hop
    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = np.linspace(-1.0, 1.0, max(fade_len, 1))
    fade_in = np.concatenate([np.zeros(silence_len), np.sqrt(0.5 * (1 + t))])
    fade_out = np.concatenate([np.sqrt(0.5 * (1 - t)), np.zeros(silence_len)])

    for idx, (offset_frames, wav) in enumerate(chunks):
        wav = wav.astype(np.float64).copy()
        if idx > 0 and overlap > 0 and len(wav) >= overlap:
            wav[:overlap] *= fade_in
        if idx < len(chunks) - 1 and overlap > 0 and len(wav) >= overlap:
            wav[-overlap:] *= fade_out
        start = offset_frames * hop
        end = min(start + len(wav), total_samples)
        out[start:end] += wav[: end - start]
    return out


class Vocoder:
    """Reference-compatible surface (ref: libwavernn/inference.py:20-128):
    ``Vocoder(model_fpath, model_type).load(); vocode_mel(mel)``."""

    def __init__(self, model_fpath, model_type: str = "runtimeracer-wavernn",
                 verbose: bool = True, batch: int = 1):
        """``batch`` > 1 decodes fold chunks in LOCKSTEP, B chains per
        instance (ILP batching, BENCHMARKS.md round 4), composed with the
        per-core instance fan-out: sub-batches are laned across the pool,
        so an M-core box runs M×B chains in flight. Lockstep decoding is
        not bit-identical to per-chunk decoding (different FMA reduction
        order), so the default keeps the reference's fan-out contract
        (pool-size-invariant audio)."""
        self.model_fpath = Path(model_fpath)
        self.model_type = model_type
        self.verbose = verbose
        self.batch = max(int(batch), 1)
        self.cfg = {
            "fatchord-wavernn": voc_cfg.wavernn_fatchord,
            "geneing-wavernn": voc_cfg.wavernn_geneing,
            "runtimeracer-wavernn": voc_cfg.wavernn_runtimeracer,
        }[model_type]
        self._lib: Optional[ctypes.CDLL] = None
        self._instances: List[_Instance] = []
        self._seed = 0

    def load(self, n_threads: Optional[int] = None):
        if not Path(self.model_fpath).exists():
            raise FileNotFoundError(
                f"No native weights at {self.model_fpath} — export with "
                f"vocoder_convert_model.py first."
            )
        self._lib = _load_lib()
        if n_threads is None:
            # per-core fan-out like the reference (inference.py:37-54);
            # lockstep batching composes with it (B chains per instance,
            # sub-batches laned across the pool)
            n_threads = max(os.cpu_count() or 1, 1)
        self._instances = [
            _Instance(self._lib, self.model_fpath) for _ in range(n_threads)
        ]
        if self.verbose:
            print(
                "Loaded native WaveRNN engine with %d worker instance(s)."
                % len(self._instances)
            )

    def is_loaded(self) -> bool:
        return bool(self._instances)

    def setRandomSeed(self, seed: int):
        self._seed = int(seed)
        for i, inst in enumerate(self._instances):
            inst.set_seed(seed + i)

    def vocode_mel(self, mel: np.ndarray, normalize: bool = True,
                   progress_callback: Optional[Callable] = None,
                   argmax: bool = False) -> np.ndarray:
        """mel (80, T) in synthesizer format → float64 waveform."""
        from rtvc_tpu_torch.ops.audio import de_emphasis, decode_mu_law

        assert self.is_loaded(), "Call load() before vocode_mel()"
        if normalize:
            mel = mel / sp.max_abs_value
        mel = np.ascontiguousarray(mel, dtype=np.float32)
        n_frames = mel.shape[1]
        hop = self._instances[0].hop
        wave_len = (n_frames - 1) * hop

        # Chunk so all workers finish in one cycle
        # (ref sizing idea: inference.py:87-101)
        overlap_frames = max(self.cfg.gen_overlap // hop, 1)
        # lockstep mode fills batch width × pool; thread mode fills the
        # pool — either way gen_target stays the quality floor
        split = self.batch * max(len(self._instances), 1)
        target_frames = max(
            self.cfg.gen_target // hop,
            math.ceil(n_frames / split),
        )
        chunks = fold_mel_with_overlap(mel, target_frames, overlap_frames)

        def run(args):
            i, (offset, chunk) = args
            inst = self._instances[i % len(self._instances)]
            return offset, inst.mel_to_wav(chunk, argmax=argmax)

        if self.batch > 1 and len(chunks) > 1:
            # lockstep ILP batching composed with the fan-out: group
            # equal-length chunks (the fold makes all but the last equal),
            # sub-batch to the lockstep width, and lane the sub-batches
            # across the instance pool — M instances × B chains in flight,
            # each lane serializing its own instance (no shared state).
            by_len = {}
            for off, chunk in chunks:
                by_len.setdefault(chunk.shape[1], []).append((off, chunk))
            subs = []
            for group in by_len.values():
                for i in range(0, len(group), self.batch):
                    subs.append(group[i : i + self.batch])
            n_lanes = min(max(len(self._instances), 1), len(subs))

            def run_lane(k):
                out = []
                inst = self._instances[k]
                for sub in subs[k::n_lanes]:
                    if len(sub) == 1:
                        out.append(
                            (sub[0][0],
                             inst.mel_to_wav(sub[0][1], argmax=argmax)))
                        continue
                    wavs = inst.mel_to_wav_batch(
                        np.stack([c for _, c in sub]), argmax=argmax)
                    out.extend(
                        (off, wavs[j]) for j, (off, _) in enumerate(sub))
                return out

            if n_lanes == 1:
                results = run_lane(0)
            else:
                with ThreadPoolExecutor(max_workers=n_lanes) as pool:
                    results = [r for lane in pool.map(run_lane,
                                                      range(n_lanes))
                               for r in lane]
            results.sort(key=lambda r: r[0])
        elif len(chunks) == 1 or len(self._instances) == 1:
            results = [run((i, c)) for i, c in enumerate(chunks)]
        else:
            with ThreadPoolExecutor(max_workers=len(self._instances)) as pool:
                results = list(pool.map(run, enumerate(chunks)))

        total = n_frames * hop
        wav = unfold_with_overlap(results, total, hop, overlap_frames)

        if self.cfg.mu_law and self.cfg.mode == "RAW":
            wav = np.asarray(
                decode_mu_law(jnp.asarray(wav, jnp.float32),
                              2**self.cfg.bits, from_labels=False),
                dtype=np.float64,
            )
        if sp.preemphasize:
            wav = np.asarray(
                de_emphasis(jnp.asarray(wav, jnp.float32), sp.preemphasis),
                dtype=np.float64,
            )

        wav = wav[:wave_len]
        fade_len = min(20 * hop, len(wav))
        wav[-fade_len:] *= np.linspace(1.0, 0.0, fade_len)
        if progress_callback is not None:
            progress_callback(len(wav), len(wav), len(chunks), 0.0)
        return wav
