"""Training losses (counterpart of ``rtvc_tpu/train/losses.py``; the GE2E
loss is ``models.speaker_encoder.ge2e_loss``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_bits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over quantised-sample classes: logits (..., C),
    integer labels (...) (the RAW and BITS vocoder heads)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
