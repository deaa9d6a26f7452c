"""Synthesizer inference, Tacotron branch (counterpart of
``rtvc_tpu/inference/synthesizer.py``).

``Synthesizer.synthesize_spectrograms`` keeps every padding of the JAX
package that changes the numbers:

* character sequences are padded to a multiple of 32 — the attention mask
  multiplies the logits, so pad characters take part in the softmax;
* the postnet runs on a frame bucket (multiple of 128) padded with the
  silence value ``-max_abs_value``, which the CBHG BiGRU's backward pass sees;
* trailing frames below the stop threshold are trimmed.

The decoder loop runs through the K2 kernel on a card (``ops.tacotron_decode``).
Loading ``.ckpt`` files and the non-autoregressive synthesizers are later
slices.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from rtvc_tpu_torch.config import preprocessing, sp
from rtvc_tpu_torch.text import text_to_sequence
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import tacotron as taco
from rtvc_tpu_torch.ops.tacotron_decode import tacotron_decode

_CHAR_BUCKET = 32
_FRAME_BUCKET = 128


def pad1d(x, max_len, pad_value=0):
    return np.pad(x, (0, max_len - len(x)), mode="constant",
                  constant_values=pad_value)


class Synthesizer:
    """Holds one synthesizer model; ``load_bundle`` installs it."""

    sample_rate = sp.sample_rate

    def __init__(self, model_fpath=None, verbose: bool = True):
        self.model_fpath = model_fpath
        self.verbose = verbose
        self._bundle: Optional[factories.SynModel] = None
        self._r = 2

    def is_loaded(self) -> bool:
        return self._bundle is not None

    def load(self):
        raise NotImplementedError(
            "loading synthesizer checkpoints is not ported to rtvc_tpu_torch "
            "yet; install a model with load_bundle()")

    def load_bundle(self, bundle: factories.SynModel, r: int = 2):
        """Install an in-memory model (self-tests, benchmarks)."""
        if bundle.model_type != factories.MODEL_TYPE_TACOTRON:
            raise NotImplementedError(f"{bundle.model_type} is a later slice")
        self._bundle = bundle
        self._r = r

    @torch.no_grad()
    def synthesize_spectrograms(self, texts: List[str],
                                embeddings: Union[np.ndarray, List[np.ndarray]],
                                return_alignments: bool = False, seed: int = 0,
                                prenet_dropout: bool = True):
        """texts + speaker embeddings → list of (80, Mi) mels.
        ``prenet_dropout=False`` is the deterministic test hook (the
        reference keeps prenet dropout on at inference)."""
        if not self.is_loaded():
            self.load()
        inputs = [text_to_sequence(text.strip(), preprocessing.cleaner_names)
                  for text in texts]
        if not isinstance(embeddings, list):
            embeddings = [embeddings] if np.ndim(embeddings) == 1 else list(embeddings)
        bs = preprocessing.synthesis_batch_size
        specs, alignments = [], []
        for i in range(0, len(inputs), bs):
            batch = inputs[i:i + bs]
            bucket_len = -(-max(len(t) for t in batch) // _CHAR_BUCKET) * _CHAR_BUCKET
            chars = np.stack([pad1d(t, bucket_len) for t in batch]).astype(np.int64)
            embeds = np.stack(embeddings[i:i + bs]).astype(np.float32)
            mels, aligns = self._generate(chars, embeds, seed, prenet_dropout)
            specs.extend(mels)
            alignments.extend(aligns)
        return (specs, alignments) if return_alignments else specs

    def _generate(self, chars: np.ndarray, embeds: np.ndarray, seed: int,
                  prenet_dropout: bool):
        d, model, cfg = self._bundle.dims, self._bundle.model, self._bundle.config
        r = self._r
        dev = model.post_proj.weight.device
        max_steps = (cfg.max_decoder_steps // r) * r
        chars_t = torch.as_tensor(chars, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        enc_seq, enc_proj = taco.encode(model, chars_t,
                                        torch.as_tensor(embeds, device=dev), g,
                                        prenet_dropout)
        mask = (chars_t != 0).to(torch.float32)
        mel_buf, attn, stops = tacotron_decode(
            model, d, enc_seq.contiguous(), enc_proj.contiguous(), mask, seed, r,
            max_steps, dropout=prenet_dropout)
        n = max(taco.stop_iterations(stops, r) * r, r)

        bucket = -(-n // _FRAME_BUCKET) * _FRAME_BUCKET
        mel_trim = torch.full((chars.shape[0], d.n_mels, bucket), -sp.max_abs_value,
                              device=dev)
        mel_trim[:, :, :n] = mel_buf[:, :, :n]
        linear = taco.postnet(model, mel_trim).transpose(1, 2).cpu().numpy()

        # The postnet output is the final mel; trailing frames below the stop
        # threshold are trimmed.
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
