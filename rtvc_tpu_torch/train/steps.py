"""Training steps for the speaker encoder and the WaveRNN vocoder
(counterpart of ``rtvc_tpu/train/steps.py``).

Each ``make_*_train_step`` returns a closure over the model and its
optimizer that runs one step in place: forward, loss, backward, the
gradient operations of the reference, and the optimizer's update. After a
step every parameter's ``.grad`` holds the gradient the optimizer applied.
Both steps run in f32; the bf16 autocast policy is a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

from rtvc_tpu_torch.models.speaker_encoder import SpeakerEncoder, ge2e_loss
from rtvc_tpu_torch.models.wavernn import WaveRNN, WaveRNNDims, wavernn_forward
from rtvc_tpu_torch.train.losses import cross_entropy_bits

Tensor = torch.Tensor


def check_compute_dtype(compute_dtype: str) -> None:
    """Accept ``auto`` and ``f32`` (both run f32 here); refuse ``bf16``."""
    if compute_dtype in ("auto", "f32"):
        return
    if compute_dtype == "bf16":
        raise NotImplementedError(
            "compute_dtype='bf16' is not ported yet: the bf16 autocast policy is "
            "a later slice (ROADMAP Queue 1, item 5); use 'f32' or 'auto'")
    raise ValueError(f"unknown compute_dtype {compute_dtype!r}")


def global_norm(grads: Iterable[Tensor]) -> Tensor:
    """The L2 norm of all gradients taken together."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def make_encoder_train_step(model: SpeakerEncoder, optimizer: torch.optim.Optimizer,
                            speakers_per_batch: int, utterances_per_speaker: int,
                            compute_dtype: str = "f32"
                            ) -> Callable[[Tensor], Tuple[Tensor, Tensor, Tensor, Tensor]]:
    """GE2E step: forward → GE2E loss → the similarity scale's gradients
    × 0.01 → global-norm clip to 3 by ``min(1, 3 / (‖g‖ + 1e-6))`` → the
    optimizer. ``step(utterances (S·U, T, n_mels))`` returns (loss, the
    gradient norm before clipping, the (S·U, S) similarity matrix, embeds
    (S, U, E)), all detached."""
    check_compute_dtype(compute_dtype)
    params = [p for p in model.parameters() if p.requires_grad]
    sim_params = (model.similarity_weight, model.similarity_bias)

    def step(inputs: Tensor):
        optimizer.zero_grad(set_to_none=True)
        embeds = model(inputs).float().reshape(speakers_per_batch, utterances_per_speaker, -1)
        loss, sim = ge2e_loss(embeds, model.similarity_weight, model.similarity_bias)
        loss.backward()
        with torch.no_grad():
            for p in sim_params:
                p.grad.mul_(0.01)
            gnorm = global_norm(p.grad for p in params)
            scale = torch.clamp(3.0 / (gnorm + 1e-6), max=1.0)
            for p in params:
                p.grad.mul_(scale)
        optimizer.step()
        return loss.detach(), gnorm, sim.detach(), embeds.detach()

    return step


def make_wavernn_train_step(model: WaveRNN, d: WaveRNNDims,
                            optimizer: torch.optim.Optimizer, compute_dtype: str = "f32"
                            ) -> Callable[[Dict[str, Tensor]], Tensor]:
    """Teacher-forced WaveRNN step with the cross-entropy loss of the RAW
    head: ``step({"x", "y", "mels"})`` runs the forward with batch
    statistics, the backward and the optimizer, installs the BatchNorms'
    new running statistics, and returns the loss, detached."""
    check_compute_dtype(compute_dtype)
    buffers = dict(model.named_buffers())

    def step(batch: Dict[str, Tensor]) -> Tensor:
        optimizer.zero_grad(set_to_none=True)
        logits, new_stats = wavernn_forward(model, d, batch["x"], batch["mels"])
        loss = cross_entropy_bits(logits.float(), batch["y"])
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            for name, value in new_stats.items():
                buffers[name].copy_(value)
        return loss.detach()

    return step
