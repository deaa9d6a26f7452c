"""Teacher-forced Tacotron attention for the alignment pass (counterpart of
``rtvc_tpu/inference/attention.py``).

A trained Tacotron runs teacher-forced at r 1 over (text, mel, embedding)
in eval mode (``models.tacotron.tacotron_forward(train=False)``: running
BatchNorm statistics, no zoneout; the prenets' dropout stays on, as in the
JAX package) and gives the attention of every mel frame over the
characters, from which ``data.duration_extractor`` takes the durations. One
utterance is one batch row: its decoder chain is one K5 forward launch at
B 1 on a card, K5's plain version on the CPU.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from rtvc_tpu_torch.config import preprocessing, sp
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models.tacotron import tacotron_forward
from rtvc_tpu_torch.train.checkpoints import read_model

MEL_BUCKET = 32   # the padded mel length is a multiple of this
TEXT_BUCKET = 16  # the padded text length too


class TacotronAligner:
    """A Tacotron read from ``model_fpath`` (any format of
    ``train.checkpoints.read_model``) or given as ``bundle``, on the card
    unless ``device`` names another. Each call draws the prenets' dropout
    from a generator seeded 0, so the same inputs give the same attention."""

    def __init__(self, model_fpath: Optional[Path] = None,
                 bundle: Optional[factories.SynModel] = None, device=None):
        if bundle is None:
            bundle = factories.from_checkpoint(read_model(model_fpath, "synthesizer"),
                                               "synthesizer", device)
        if bundle.model_type != factories.MODEL_TYPE_TACOTRON:
            raise ValueError(f"the alignment pass needs a Tacotron, not a {bundle.model_type}")
        self.bundle = bundle
        self.device = next(bundle.model.parameters()).device

    @torch.no_grad()
    def attention(self, tokens: np.ndarray, mel: np.ndarray, embed: np.ndarray) -> np.ndarray:
        """tokens (T_text,), mel (n_mels, T_mel), embed (E,) → attention
        (T_mel, T_text) as numpy. The mel takes at least one silent frame
        and is padded with silence to a multiple of 32 frames (the reference
        pads one frame), the text with 0 to a multiple of 16."""
        mel_len = mel.shape[-1]
        pad_value = -sp.max_abs_value if preprocessing.symmetric_mels else 0.0
        padded_len = -(-(mel_len + 1) // MEL_BUCKET) * MEL_BUCKET
        mel_p = np.full((mel.shape[0], padded_len), pad_value, np.float32)
        mel_p[:, :mel_len] = mel
        tok_p = np.zeros(-(-len(tokens) // TEXT_BUCKET) * TEXT_BUCKET, np.int64)
        tok_p[:len(tokens)] = tokens
        dev = self.device
        model = self.bundle.model.eval()
        generator = torch.Generator(device=dev).manual_seed(0)
        _, _, attn, _, _ = tacotron_forward(
            model, self.bundle.dims, torch.as_tensor(tok_p[None], device=dev),
            torch.as_tensor(mel_p[None], device=dev),
            torch.as_tensor(np.asarray(embed, np.float32)[None], device=dev), 1, generator,
            train=False)
        return attn[0, :mel_len, :len(tokens)].cpu().numpy()
