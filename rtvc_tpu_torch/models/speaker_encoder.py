"""GE2E speaker encoder: 3-layer LSTM → Linear → ReLU → L2 normalise
(counterpart of ``rtvc_tpu/models/speaker_encoder.py:SpeakerEncoder``)."""
from __future__ import annotations

import torch
from torch import nn

from rtvc_tpu.config.encoder import EncoderDataParams, EncoderModelParams
from rtvc_tpu_torch.models.layers import LSTM, Linear


class SpeakerEncoder(nn.Module):
    """Utterance mel frames (B, T, n_mels) → L2-normalised embeddings
    (B, embedding_size). ``similarity_weight`` / ``similarity_bias`` are the
    GE2E scale the reference's state dict carries; inference does not use
    them."""

    def __init__(self, model: EncoderModelParams = EncoderModelParams(),
                 data: EncoderDataParams = EncoderDataParams(), device=None):
        super().__init__()
        self.lstm = LSTM(data.mel_n_channels, model.model_hidden_size,
                         model.model_num_layers, device=device)
        self.linear = Linear(model.model_hidden_size, model.model_embedding_size,
                             device=device)
        self.similarity_weight = nn.Parameter(torch.empty(1, device=device))
        self.similarity_bias = nn.Parameter(torch.empty(1, device=device))

    def forward(self, utterances: torch.Tensor) -> torch.Tensor:
        _, (hidden, _) = self.lstm(utterances)
        embeds_raw = torch.relu(self.linear(hidden[-1]))
        return embeds_raw / torch.linalg.norm(embeds_raw, dim=1, keepdim=True)
