"""GE2E speaker encoder: 3-layer LSTM → Linear → ReLU → L2 normalise, and
the GE2E loss and equal error rate it trains with (counterpart of
``rtvc_tpu/models/speaker_encoder.py``)."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
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
        self.model_cfg, self.data_cfg = model, data
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


def init_similarity_params() -> Dict[str, torch.Tensor]:
    """The GE2E similarity scale at its initial w = 10, b = -5."""
    return {"similarity_weight": torch.tensor([10.0]),
            "similarity_bias": torch.tensor([-5.0])}


def similarity_matrix(embeds: torch.Tensor, sim_weight: torch.Tensor,
                      sim_bias: torch.Tensor) -> torch.Tensor:
    """GE2E similarity matrix (S, U, S) of embeds (S, U, E): ``sim[j, u, k]``
    is the cosine of e_ju with speaker k's centroid, where on the diagonal
    (k = j) the centroid excludes utterance u; then scaled by w and shifted
    by b."""
    S, U, _ = embeds.shape
    incl = embeds.mean(dim=1)
    incl = incl / (torch.linalg.norm(incl, dim=1, keepdim=True) + 1e-5)
    excl = (embeds.sum(dim=1, keepdim=True) - embeds) / (U - 1)
    excl = excl / (torch.linalg.norm(excl, dim=2, keepdim=True) + 1e-5)
    sim_incl = torch.einsum("jue,ke->juk", embeds, incl)
    sim_excl = (embeds * excl).sum(dim=2)
    diag = torch.eye(S, dtype=torch.bool, device=embeds.device)[:, None, :]
    sim = torch.where(diag, sim_excl[:, :, None], sim_incl)
    return sim * sim_weight + sim_bias


def ge2e_loss(embeds: torch.Tensor, sim_weight: torch.Tensor, sim_bias: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GE2E softmax loss of embeds (S, U, E) → (scalar loss, the flattened
    (S·U, S) similarity matrix)."""
    S, U, _ = embeds.shape
    sim = similarity_matrix(embeds, sim_weight, sim_bias).reshape(S * U, S)
    targets = torch.arange(S, device=embeds.device).repeat_interleave(U)
    return nn.functional.cross_entropy(sim, targets), sim


def _roc_curve(labels: np.ndarray, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(fpr, tpr) at every distinct score threshold, from (0, 0), dropping
    the points that lie on a straight segment between their neighbours
    (the ROC that ``sklearn.metrics.roc_curve`` returns)."""
    order = np.argsort(scores, kind="mergesort")[::-1]
    scores, labels = scores[order], labels[order].astype(np.float64)
    idx = np.r_[np.where(np.diff(scores))[0], labels.size - 1]
    tps = np.cumsum(labels)[idx]
    fps = 1 + idx - tps
    if fps.size > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[keep], tps[keep]
    fps, tps = np.r_[0.0, fps], np.r_[0.0, tps]
    return fps / fps[-1], tps / tps[-1]


def compute_eer(sim_matrix: np.ndarray, speakers_per_batch: int) -> float:
    """Equal error rate of the flattened (S·U, S) similarity matrix: the
    false-positive rate where it equals the false-negative rate on the ROC,
    linearly interpolated. A host-side metric, not backpropagated."""
    from scipy.interpolate import interp1d
    from scipy.optimize import brentq

    sim_matrix = np.asarray(sim_matrix)
    utterances = sim_matrix.shape[0] // speakers_per_batch
    truth = np.repeat(np.arange(speakers_per_batch), utterances)
    labels = np.eye(speakers_per_batch, dtype=int)[truth]
    fpr, tpr = _roc_curve(labels.flatten(), sim_matrix.flatten())
    return float(brentq(lambda x: 1.0 - x - interp1d(fpr, tpr)(x), 0.0, 1.0))
