"""Training steps for the speaker encoder, the three synthesizers
(Tacotron, ForwardTacotron, FastPitch) and the WaveRNN vocoder (counterpart
of ``rtvc_tpu/train/steps.py``).

Each ``make_*_train_step`` returns a closure over the model and its
optimizer that runs one step in place: forward, loss, backward, the
gradient operations of the reference, and the optimizer's update. After a
step every parameter's ``.grad`` holds the gradient the optimizer applied.
All steps run in f32; the bf16 autocast policy is a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from rtvc_tpu_torch.models.speaker_encoder import SpeakerEncoder, ge2e_loss
from rtvc_tpu_torch.models.tacotron import Tacotron, TacotronDims, tacotron_forward
from rtvc_tpu_torch.config.vocoder import MODE_BITS, MODE_MOL, MODE_RAW
from rtvc_tpu_torch.models.distribution import discretized_mix_logistic_loss
from rtvc_tpu_torch.models.wavernn import VOC_GENEING, WaveRNN, WaveRNNDims, wavernn_forward
from rtvc_tpu_torch.train.losses import cross_entropy_bits, nll_from_log_probs, tacotron_loss

Tensor = torch.Tensor


def check_compute_dtype(compute_dtype: str) -> None:
    """Accept ``auto`` and ``f32`` (both run f32 here); refuse ``bf16``."""
    if compute_dtype in ("auto", "f32"):
        return
    if compute_dtype == "bf16":
        raise NotImplementedError(
            "compute_dtype='bf16' is not ported yet: the bf16 autocast policy is "
            "a later slice (ROADMAP Queue 1, \"The bf16 policy\"); use 'f32' or 'auto'")
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


def make_tacotron_train_step(model: Tacotron, d: TacotronDims,
                             optimizer: torch.optim.Optimizer, r: int,
                             clip_grad_norm: Optional[float] = 1.0
                             ) -> Callable[..., Tuple[Dict[str, Tensor], Tensor]]:
    """Teacher-forced Tacotron step at reduction factor ``r``: forward (the
    decoder chain through K5) → ``tacotron_loss`` → backward → global-norm
    clip by ``min(1, c / (‖g‖ + 1e-6))`` → the optimizer; then the
    BatchNorms' new running statistics are installed.

    ``step({"chars", "mels", "embeds", "stop"}, generator=None)`` returns
    ({"loss", "grad_norm" (before clipping), "m1", "m2", "stop"}, attention
    (B, steps // r, T_text)), all detached. ``generator`` feeds the prenets'
    dropout and the zoneout masks; ``prenet_dropout`` and ``zoneout_masks``
    pass through to :func:`tacotron_forward` so that a test can share them."""
    params = [p for p in model.parameters() if p.requires_grad]
    buffers = dict(model.named_buffers())

    def step(batch: Dict[str, Tensor], generator: Optional[torch.Generator] = None,
             prenet_dropout: bool = True, zoneout_masks=None):
        optimizer.zero_grad(set_to_none=True)
        m1, m2, attn, stop_pred, new_stats = tacotron_forward(
            model, d, batch["chars"], batch["mels"], batch["embeds"], r, generator,
            prenet_dropout=prenet_dropout, zoneout_masks=zoneout_masks)
        loss, parts = tacotron_loss(m1.float(), m2.float(), stop_pred.float(), batch["mels"],
                                    batch["stop"])
        loss.backward()
        with torch.no_grad():
            gnorm = global_norm(p.grad for p in params)
            if clip_grad_norm is not None:
                scale = torch.clamp(clip_grad_norm / (gnorm + 1e-6), max=1.0)
                for p in params:
                    p.grad.mul_(scale)
        optimizer.step()
        with torch.no_grad():
            for name, value in new_stats.items():
                buffers[name].copy_(value)
        stats = {"loss": loss.detach(), "grad_norm": gnorm,
                 **{k: v.detach() for k, v in parts.items()}}
        return stats, attn.detach()

    return step


def masked_l1_lastdim(pred: Tensor, target: Tensor, lens: Tensor) -> Tensor:
    """L1 over the positions before each row's length on the last (time)
    axis, divided by the mask's sum after it is broadcast to ``pred``'s
    shape (for mels: n_mels × valid frames), as the JAX package does."""
    t = torch.arange(pred.shape[-1], device=pred.device)
    mask = (t[None, :] < lens[:, None]).to(pred.dtype)
    while mask.ndim < pred.ndim:
        mask = mask[:, None, :]
    mask = mask.expand(pred.shape)
    return ((pred - target).abs() * mask).sum() / mask.sum().clamp_min(1.0)


def make_nar_synth_train_step(model_type: str, model, optimizer: torch.optim.Optimizer, cfg,
                              compute_dtype: str = "f32"
                              ) -> Callable[..., Dict[str, Tensor]]:
    """ForwardTacotron or FastPitch step: the pitch and energy inputs take
    zoneout (``cfg.pitch_zoneout`` / ``energy_zoneout``: an entry is zeroed
    with that probability) → the training forward → masked L1 on the mel
    and the postnet mel over ``spec_lens``, and on the durations, pitch and
    energy over ``x_lens``, weighted by the config's loss factors →
    backward → global-norm clip at ``cfg.clip_grad_norm`` → the optimizer;
    then the BatchNorms' new running statistics are installed.

    ``step({"chars", "mels", "embeds", "durations", "spec_lens", "x_lens",
    "pitch", "energy"}, generator=None)`` returns {"loss", "grad_norm"
    (before clipping), "m1", "m2", "dur", "pitch", "energy"}, detached;
    ``generator`` feeds the zoneout draws and the forward's dropout."""
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.models.fast_pitch import fastpitch_forward
    from rtvc_tpu_torch.models.forward_tacotron import forward_tacotron_forward

    check_compute_dtype(compute_dtype)
    forward = (forward_tacotron_forward if model_type == factories.MODEL_TYPE_FORWARD_TACOTRON
               else fastpitch_forward)
    pitch_zoneout = getattr(cfg, "pitch_zoneout", 0.0)
    energy_zoneout = getattr(cfg, "energy_zoneout", 0.0)
    params = [p for p in model.parameters() if p.requires_grad]
    buffers = dict(model.named_buffers())

    def zoneout(x: Tensor, p: float, generator) -> Tensor:
        return x * (torch.rand(x.shape, generator=generator, device=x.device) > p)

    def step(batch: Dict[str, Tensor], generator: Optional[torch.Generator] = None):
        optimizer.zero_grad(set_to_none=True)
        pitch, energy = batch["pitch"], batch["energy"]
        pitch_in = zoneout(pitch, pitch_zoneout, generator)
        energy_in = zoneout(energy, energy_zoneout, generator)
        mel_hat, mel_post, dur_hat, pitch_hat, energy_hat, new_stats = forward(
            model, batch["chars"], batch["mels"], batch["durations"], batch["embeds"],
            batch["spec_lens"], pitch_in, energy_in, generator)
        mels, spec_lens, x_lens = batch["mels"], batch["spec_lens"], batch["x_lens"]
        parts = {
            "m1": masked_l1_lastdim(mel_hat.float(), mels, spec_lens),
            "m2": masked_l1_lastdim(mel_post.float(), mels, spec_lens),
            "dur": masked_l1_lastdim(dur_hat.float()[:, None, :], batch["durations"][:, None, :],
                                     x_lens),
            "pitch": masked_l1_lastdim(pitch_hat.float(), pitch[:, None, :], x_lens),
            "energy": masked_l1_lastdim(energy_hat.float(), energy[:, None, :], x_lens)}
        loss = (parts["m1"] + parts["m2"] + cfg.duration_loss_factor * parts["dur"]
                + cfg.pitch_loss_factor * parts["pitch"]
                + cfg.energy_loss_factor * parts["energy"])
        loss.backward()
        with torch.no_grad():
            gnorm = global_norm(p.grad for p in params)
            scale = torch.clamp(cfg.clip_grad_norm / (gnorm + 1e-6), max=1.0)
            for p in params:
                p.grad.mul_(scale)
        optimizer.step()
        with torch.no_grad():
            for name, value in new_stats.items():
                buffers[name].copy_(value)
        return {"loss": loss.detach(), "grad_norm": gnorm,
                **{k: v.detach() for k, v in parts.items()}}

    return step


def make_wavernn_train_step(model: WaveRNN, d: WaveRNNDims,
                            optimizer: torch.optim.Optimizer, compute_dtype: str = "f32"
                            ) -> Callable[[Dict[str, Tensor]], Tensor]:
    """Teacher-forced WaveRNN step: ``step({"x", "y", "y_float", "mels"})``
    runs the forward with batch statistics, the loss, the backward and the
    optimizer, installs the BatchNorms' new running statistics, and returns
    the loss, detached. The loss follows the head: the discretized
    mixture-of-logistics likelihood of ``y_float`` in MOL mode, the NLL of
    ``y`` under geneing's BITS log-probabilities, the cross entropy of ``y``
    otherwise (``y_float`` is read in MOL mode only).

    geneing's RAW mode has a beta head of two columns; a cross entropy over
    them is not its likelihood, so training that cell raises."""
    check_compute_dtype(compute_dtype)
    if d.variant == VOC_GENEING and d.mode == MODE_RAW:
        raise NotImplementedError(
            "training geneing-wavernn in RAW mode (the beta head) is not supported: a "
            "cross entropy over its two columns is not a likelihood of that head; "
            "train it in BITS or MOL mode")
    buffers = dict(model.named_buffers())

    def loss_of(out: Tensor, batch: Dict[str, Tensor]) -> Tensor:
        if d.mode == MODE_MOL:
            return discretized_mix_logistic_loss(out.transpose(1, 2),
                                                 batch["y_float"][:, :, None])
        if d.mode == MODE_BITS and d.variant == VOC_GENEING:
            return nll_from_log_probs(out, batch["y"])
        return cross_entropy_bits(out, batch["y"])

    def step(batch: Dict[str, Tensor]) -> Tensor:
        optimizer.zero_grad(set_to_none=True)
        out, new_stats = wavernn_forward(model, d, batch["x"], batch["mels"])
        loss = loss_of(out.float(), batch)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            for name, value in new_stats.items():
                buffers[name].copy_(value)
        return loss.detach()

    return step
