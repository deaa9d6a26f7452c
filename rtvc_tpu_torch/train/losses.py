"""Training losses (counterpart of ``rtvc_tpu/train/losses.py``; the GE2E
loss is ``models.speaker_encoder.ge2e_loss``)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def cross_entropy_bits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over quantised-sample classes: logits (..., C),
    integer labels (...) (the RAW and BITS vocoder heads)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())


def tacotron_loss(m1_hat: torch.Tensor, m2_hat: torch.Tensor, stop_pred: torch.Tensor,
                  mels: torch.Tensor, stop_target: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MSE + L1 on the decoder's mel, MSE on the postnet's, binary cross
    entropy on the stop tokens (probabilities clipped to [1e-7, 1 - 1e-7])
    → (total, {"m1", "m2", "stop"})."""
    diff = m1_hat - mels
    m1_loss = (diff ** 2).mean() + diff.abs().mean()
    m2_loss = ((m2_hat - mels) ** 2).mean()
    p = stop_pred.clamp(1e-7, 1.0 - 1e-7)
    stop_loss = -(stop_target * torch.log(p) + (1.0 - stop_target) * torch.log1p(-p)).mean()
    return m1_loss + m2_loss + stop_loss, {"m1": m1_loss, "m2": m2_loss, "stop": stop_loss}
