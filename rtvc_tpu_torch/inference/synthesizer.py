"""Synthesizer inference for the three synthesizers (counterpart of
``rtvc_tpu/inference/synthesizer.py``).

``Synthesizer.synthesize_spectrograms`` keeps every padding of the JAX
package that changes the numbers:

* character sequences are padded with 0 to a multiple of 32. In Tacotron
  the attention mask multiplies the logits, so pad characters take part in
  the softmax; in ForwardTacotron and FastPitch the predictors run over the
  pad characters too, and their predicted durations count in each mel's
  length (as in the JAX package);
* Tacotron's postnet runs on a frame bucket (multiple of 128) padded with
  the silence value ``-max_abs_value``, which the CBHG BiGRU's backward pass
  sees, and trailing frames below the stop threshold are trimmed.

Tacotron's decoder loop runs through the K2 kernel on a card
(``ops.tacotron_decode``). ForwardTacotron and FastPitch generate in one
parallel pass (``models.forward_tacotron.forward_generate``,
``models.fast_pitch.fastpitch_generate``: ForwardTacotron's BiLSTM through
K3 and its five BiGRUs through K4) and take ``speed_modifier``,
``pitch_function`` and ``energy_function``; each mel is trimmed to its
row's duration sum, and the durations are its "alignments".
``make_spectrogram`` (waveform or file → training-format mel, through the K6
kernel) and ``griffin_lim`` (mel → waveform without a vocoder) are module
functions and static helpers of ``Synthesizer``; both work on the card
unless the caller names another device.

``Synthesizer.load`` (and the module-level ``load_model``) reads a
checkpoint in any of the formats of ``train/checkpoints.py:read_model``,
rebuilding the model at the widths its config names (the defaults for a
reference ``.pt``, which carries none) and taking the reduction factor
from the file (2 when it names none).
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from rtvc_tpu_torch.config import preprocessing, sp
from rtvc_tpu_torch.text import text_to_sequence
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import tacotron as taco
from rtvc_tpu_torch.models.fast_pitch import fastpitch_generate
from rtvc_tpu_torch.models.forward_tacotron import forward_generate
from rtvc_tpu_torch.ops import audio as audio_ops
from rtvc_tpu_torch.ops.tacotron_decode import tacotron_decode
from rtvc_tpu_torch.train.checkpoints import read_model
from rtvc_tpu_torch.utils.io import load_wav
from rtvc_tpu_torch.utils.profiler import count, span

_CHAR_BUCKET = 32
_FRAME_BUCKET = 128


def pad1d(x, max_len, pad_value=0):
    return np.pad(x, (0, max_len - len(x)), mode="constant",
                  constant_values=pad_value)


def text_ids(texts: List[str]) -> np.ndarray:
    """Texts → character ids (B, T), padded with 0 to a multiple of 32."""
    seqs = [text_to_sequence(text.strip(), preprocessing.cleaner_names) for text in texts]
    bucket_len = -(-max(len(t) for t in seqs) // _CHAR_BUCKET) * _CHAR_BUCKET
    return np.stack([pad1d(t, bucket_len) for t in seqs]).astype(np.int64)


class Synthesizer:
    """Holds one synthesizer model: ``load`` reads it from ``model_fpath``
    (lazily, on the first synthesis), ``load_bundle`` installs one from
    memory. The model lives on the card unless ``device`` names another."""

    sample_rate = sp.sample_rate

    def __init__(self, model_fpath: Optional[Union[str, Path]] = None, verbose: bool = True,
                 device=None):
        self.model_fpath = None if model_fpath is None else Path(model_fpath)
        self.verbose = verbose
        self.device = device
        self._bundle: Optional[factories.SynModel] = None
        self._step = 0
        self._r = 2

    def is_loaded(self) -> bool:
        return self._bundle is not None

    def get_model_type(self) -> str:
        if not self.is_loaded():
            self.load()
        return self._bundle.model_type

    def load(self):
        """Read the model of ``model_fpath``."""
        if self.model_fpath is None:
            raise ValueError("Synthesizer has no checkpoint path; pass model_fpath or "
                             "install a model with load_bundle()")
        ckpt = read_model(self.model_fpath, "synthesizer")
        self.load_bundle(factories.from_checkpoint(ckpt, "synthesizer", self.device),
                         r=ckpt.r or 2)
        self._step = ckpt.step
        if self.verbose:
            print("Loaded synthesizer of model '%s' at path '%s'."
                  % (self._bundle.model_type, self.model_fpath.name))
            print("Model has been trained to step %d." % self._step)

    def load_bundle(self, bundle: factories.SynModel, r: int = 2):
        """Install an in-memory model of any of the three types (self-tests,
        benchmarks); ``r`` is Tacotron's reduction factor."""
        self._bundle = bundle
        self._r = r

    @torch.no_grad()
    def synthesize_spectrograms(self, texts: List[str],
                                embeddings: Union[np.ndarray, List[np.ndarray]],
                                return_alignments: bool = False, speed_modifier: float = 1.0,
                                pitch_function: Optional[Callable] = None,
                                energy_function: Optional[Callable] = None, seed: int = 0,
                                prenet_dropout: bool = True):
        """texts + speaker embeddings → list of (80, Mi) mels (and the
        alignments: Tacotron's attention, the NAR synthesizers' durations).
        The NAR synthesizers divide their predicted durations by ``alpha =
        1 / speed_modifier``, as the JAX package does, and
        ``pitch_function`` / ``energy_function`` map their (B, 1, T)
        predictions (numpy in, array-like out); Tacotron ignores all three.
        ``prenet_dropout=False`` is Tacotron's deterministic test hook (the
        reference keeps prenet dropout on at inference)."""
        if not self.is_loaded():
            self.load()
        with span("rtvc.synth.synthesize"):
            if not isinstance(embeddings, list):
                embeddings = [embeddings] if np.ndim(embeddings) == 1 else list(embeddings)
            bs = preprocessing.synthesis_batch_size
            specs, alignments = [], []
            for i in range(0, len(texts), bs):
                chars = text_ids(texts[i:i + bs])
                embeds = np.stack(embeddings[i:i + bs]).astype(np.float32)
                if self._bundle.model_type == factories.MODEL_TYPE_TACOTRON:
                    mels, aligns = self._generate(chars, embeds, seed, prenet_dropout)
                else:
                    mels, aligns = self._generate_forward(chars, embeds, speed_modifier,
                                                          pitch_function, energy_function)
                specs.extend(mels)
                alignments.extend(aligns)
            return (specs, alignments) if return_alignments else specs

    def encode(self, chars: np.ndarray, embeds: np.ndarray, seed: int,
               prenet_dropout: bool = True):
        """Character ids (B, T) and speaker embeddings (B, E) → the
        encoder's outputs (contiguous) and the character mask, on the
        model's device; the encoder prenet's dropout draws from a generator
        of ``seed``. The first half of a synthesis, which the streaming
        clone shares."""
        model = self._bundle.model
        dev = model.post_proj.weight.device
        with span("rtvc.synth.encode"):
            chars_t = torch.as_tensor(chars, device=dev)
            g = torch.Generator(device=dev).manual_seed(seed)
            enc_seq, enc_proj = taco.encode(model, chars_t, torch.as_tensor(embeds, device=dev),
                                            g, prenet_dropout)
            return enc_seq.contiguous(), enc_proj.contiguous(), (chars_t != 0).to(torch.float32)

    def _generate(self, chars: np.ndarray, embeds: np.ndarray, seed: int,
                  prenet_dropout: bool):
        d, model, cfg = self._bundle.dims, self._bundle.model, self._bundle.config
        r = self._r
        dev = model.post_proj.weight.device
        max_steps = (cfg.max_decoder_steps // r) * r
        enc_seq, enc_proj, mask = self.encode(chars, embeds, seed, prenet_dropout)
        with span("rtvc.synth.decode"):
            mel_buf, attn, stops = tacotron_decode(
                model, d, enc_seq, enc_proj, mask, seed, r, max_steps, dropout=prenet_dropout)
            n = max(taco.stop_iterations(stops, r) * r, r)

        with span("rtvc.synth.postnet"):
            bucket = -(-n // _FRAME_BUCKET) * _FRAME_BUCKET
            mel_trim = torch.full((chars.shape[0], d.n_mels, bucket), -sp.max_abs_value,
                                  device=dev)
            mel_trim[:, :, :n] = mel_buf[:, :, :n]
            linear = taco.postnet(model, mel_trim).transpose(1, 2).cpu().numpy()

        # The postnet output is the final mel; trailing frames below the stop
        # threshold are trimmed.
        with span("rtvc.synth.trim"):
            mels, aligns = [], []
            attn_np = attn[:, :n // r].cpu().numpy()
            for b in range(linear.shape[0]):
                m = linear[b, :, :n]
                end = m.shape[1]
                while end > 1 and np.max(m[:, end - 1]) < cfg.stop_threshold:
                    end -= 1
                mels.append(m[:, :end].astype(np.float32))
                aligns.append(attn_np[b])
            return mels, aligns

    def _generate_forward(self, chars: np.ndarray, embeds: np.ndarray, speed_modifier: float,
                          pitch_function: Optional[Callable],
                          energy_function: Optional[Callable]):
        """ForwardTacotron or FastPitch: each mel trimmed to its row's
        duration sum (at least one frame), the durations as alignments.
        Counts the frames the pad characters (id 0) take inside the
        returned mels (``rtvc.synth.pad_frames``)."""
        gen = (fastpitch_generate if self._bundle.model_type == factories.MODEL_TYPE_FASTPITCH
               else forward_generate)
        dev = next(self._bundle.model.parameters()).device
        with span("rtvc.synth.forward"):
            mel, durs = gen(self._bundle.model, torch.as_tensor(chars, device=dev),
                            torch.as_tensor(embeds, device=dev), alpha=1.0 / speed_modifier,
                            pitch_function=pitch_function, energy_function=energy_function)
        with span("rtvc.synth.copy"):
            mel = mel.cpu().numpy()
            mels = [mel[b, :, :max(int(durs[b].sum()), 1)].astype(np.float32)
                    for b in range(mel.shape[0])]
        count("rtvc.synth.pad_frames", int(np.sum(np.where(chars == 0, durs, 0))))
        return mels, list(durs)


_model: Optional[Synthesizer] = None


def load_model(weights_fpath, verbose: bool = True, device=None) -> None:
    """Install the module's synthesizer from a checkpoint, on the card
    unless ``device`` names another."""
    global _model
    _model = Synthesizer(weights_fpath, verbose, device)
    _model.load()


def is_loaded() -> bool:
    return _model is not None and _model.is_loaded()


def get_model_type() -> str:
    if not is_loaded():
        raise Exception("Please load Synthesizer in memory before using it")
    return _model.get_model_type()


def synthesize_spectrograms(texts: List[str], embeddings: Union[np.ndarray, List[np.ndarray]],
                            return_alignments: bool = False, speed_modifier: float = 1.0,
                            pitch_function: Optional[Callable] = None,
                            energy_function: Optional[Callable] = None, seed: int = 0):
    """The module's synthesizer: texts + speaker embeddings → list of
    (80, Mi) mels (see ``Synthesizer.synthesize_spectrograms``)."""
    if not is_loaded():
        raise Exception("Please load Synthesizer in memory before using it")
    return _model.synthesize_spectrograms(texts, embeddings,
                                          return_alignments=return_alignments,
                                          speed_modifier=speed_modifier,
                                          pitch_function=pitch_function,
                                          energy_function=energy_function, seed=seed)


def load_preprocess_wav(fpath) -> np.ndarray:
    """Load a file at the synthesizer's sample rate and rescale it like the
    synthesizer's training audio."""
    wav, _ = load_wav(fpath, target_sr=sp.sample_rate)
    if preprocessing.rescale:
        wav = wav / np.abs(wav).max() * preprocessing.rescaling_max
    return wav


def make_spectrogram(fpath_or_wav: Union[str, Path, np.ndarray], device=None) -> np.ndarray:
    """Waveform or file → training-format mel (80, T), float32."""
    if isinstance(fpath_or_wav, (str, Path)):
        wav = load_preprocess_wav(fpath_or_wav)
    else:
        wav = fpath_or_wav
    wav = torch.as_tensor(np.asarray(wav, np.float32), device=factories.resolve_device(device))
    return audio_ops.melspectrogram(wav, sp, preprocessing).cpu().numpy()


def griffin_lim(mel: np.ndarray, seed: int = 0, device=None) -> np.ndarray:
    """Invert a training-format mel (80, T) with Griffin-Lim, from a random
    initial phase seeded by ``seed``."""
    device = factories.resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    mel = torch.as_tensor(np.asarray(mel, np.float32), device=device)
    return audio_ops.inv_mel_spectrogram(mel, sp, preprocessing, g).cpu().numpy()


# the reference calls these as static helpers of Synthesizer
Synthesizer.load_preprocess_wav = staticmethod(load_preprocess_wav)
Synthesizer.make_spectrogram = staticmethod(make_spectrogram)
Synthesizer.griffin_lim = staticmethod(griffin_lim)
