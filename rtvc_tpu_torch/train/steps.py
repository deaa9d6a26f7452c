"""Training steps for the speaker encoder, the three synthesizers
(Tacotron, ForwardTacotron, FastPitch) and the WaveRNN vocoder (counterpart
of ``rtvc_tpu/train/steps.py``).

Each ``make_*_train_step`` returns a closure over the model and its
optimizer that runs one step in place: forward, loss, backward, the
gradient operations of the reference, and the optimizer's update. After a
step every parameter's ``.grad`` holds the gradient the optimizer applied.

``compute_dtype`` ("auto" and "f32": f32; "bf16": the mixed-precision policy
of ``ops.precision``) applies the policy as the JAX package's ``_policy``
does: the forward runs on bf16 casts of the parameters and of the batch's
float leaves, the losses are taken in f32 against the f32 batch, and the
gradients reach the f32 master parameters in f32, where the clip and the
optimizer (whose state stays f32) act on them.

``dp`` (a process group of ``parallel.distributed``, None for one process)
makes a step the global batch's step while each rank holds its own rows, as
the JAX package's step jitted over the global sharded batch is: the model's
BatchNorms take the global batch's moments in the step's forward
(``layers.sync_batch_norms``), random masks are drawn at the global batch's
shape and each rank keeps its rows (``distributed.ShardRows``), the
gradients are averaged over the ranks right after ``backward()`` (before any
scale or clip, so the norm is the global gradient's), and the returned
statistics are the global batch's. The
GE2E loss reads the gathered global embeddings. A loss that is a plain mean
over the rows of shards of one (globally padded) shape averages over the
ranks to the global mean; the masked L1 losses of the non-autoregressive
steps divide by the global mask count instead.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from rtvc_tpu_torch.models.speaker_encoder import SpeakerEncoder, ge2e_loss
from rtvc_tpu_torch.models.tacotron import Tacotron, TacotronDims, tacotron_forward
from rtvc_tpu_torch.config.vocoder import MODE_BITS, MODE_MOL, MODE_RAW
from rtvc_tpu_torch.models.distribution import discretized_mix_logistic_loss
from rtvc_tpu_torch.models.wavernn import VOC_GENEING, WaveRNN, WaveRNNDims, wavernn_forward
from rtvc_tpu_torch.models.layers import sync_batch_norms
from rtvc_tpu_torch.ops import precision
from rtvc_tpu_torch.parallel import distributed
from rtvc_tpu_torch.train.losses import cross_entropy_bits, nll_from_log_probs, tacotron_loss

Tensor = torch.Tensor


def global_norm(grads: Iterable[Tensor]) -> Tensor:
    """The L2 norm of all gradients taken together."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def make_encoder_train_step(model: SpeakerEncoder, optimizer: torch.optim.Optimizer,
                            speakers_per_batch: int, utterances_per_speaker: int,
                            compute_dtype: str = "f32", dp=None
                            ) -> Callable[[Tensor], Tuple[Tensor, Tensor, Tensor, Tensor]]:
    """GE2E step: forward → GE2E loss → the similarity scale's gradients
    × 0.01 → global-norm clip to 3 by ``min(1, 3 / (‖g‖ + 1e-6))`` → the
    optimizer. ``step(utterances (S·U, T, n_mels))`` returns (loss, the
    gradient norm before clipping, the (S·U, S) similarity matrix, embeds
    (S, U, E)), all detached. Under the bf16 policy the embeddings come out
    f32 and the similarity and loss use the f32 similarity parameters.

    With ``dp`` each rank gives its own speakers' utterances (the rows of
    its speakers_per_batch / ranks speakers); the loss, the similarity
    matrix and the embeddings are the global batch's on every rank. Every
    rank's loss reads every rank's embeddings, so each rank's model
    gradient is the number of ranks times its share of the global one, and
    the average over the ranks is the global gradient."""
    cdt = precision.resolve(compute_dtype)
    params = [p for p in model.parameters() if p.requires_grad]
    sim_params = (model.similarity_weight, model.similarity_bias)

    def step(inputs: Tensor):
        optimizer.zero_grad(set_to_none=True)
        with precision.policy(model, cdt):
            embeds = model(precision.cast_floats(inputs, cdt))
        embeds = embeds.float().reshape(-1, utterances_per_speaker, embeds.shape[-1])
        if dp is not None:
            embeds = distributed.all_gather_rows(embeds, dp)
        if embeds.shape[0] != speakers_per_batch:
            raise ValueError(f"the GE2E batch holds {embeds.shape[0]} speakers, not "
                             f"{speakers_per_batch}")
        loss, sim = ge2e_loss(embeds, model.similarity_weight, model.similarity_bias)
        loss.backward()
        if dp is not None:
            distributed.average_gradients(params, dp)
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
                             clip_grad_norm: Optional[float] = 1.0, compute_dtype: str = "f32",
                             dp=None) -> Callable[..., Tuple[Dict[str, Tensor], Tensor]]:
    """Teacher-forced Tacotron step at reduction factor ``r``: forward (the
    decoder chain through K5) → ``tacotron_loss`` → backward → global-norm
    clip by ``min(1, c / (‖g‖ + 1e-6))`` → the optimizer; then the
    BatchNorms' new running statistics are installed.

    ``step({"chars", "mels", "embeds", "stop"}, generator=None)`` returns
    ({"loss", "grad_norm" (before clipping), "m1", "m2", "stop"}, attention
    (B, steps // r, T_text)), all detached. ``generator`` feeds the prenets'
    dropout and the zoneout masks; ``prenet_dropout`` and ``zoneout_masks``
    pass through to :func:`tacotron_forward` so that a test can share them.
    Under the bf16 policy the decoder chain (K5) runs in f32 on widened
    inputs, and the attention comes out f32. With ``dp`` the attention is
    this rank's rows'."""
    cdt = precision.resolve(compute_dtype)
    params = [p for p in model.parameters() if p.requires_grad]
    buffers = dict(model.named_buffers())

    def step(batch: Dict[str, Tensor], generator: Optional[torch.Generator] = None,
             prenet_dropout: bool = True, zoneout_masks=None):
        optimizer.zero_grad(set_to_none=True)
        b = precision.cast_floats(batch, cdt)
        with precision.policy(model, cdt), sync_batch_norms(model, dp):
            m1, m2, attn, stop_pred, new_stats = tacotron_forward(
                model, d, b["chars"], b["mels"], b["embeds"], r,
                distributed.shard_rows(generator, dp), prenet_dropout=prenet_dropout,
                zoneout_masks=zoneout_masks)
        # plain means over this rank's rows: shards of one padded shape
        # (``data.synthesizer_dataset``), so the ranks' mean is the global one
        loss, parts = tacotron_loss(m1.float(), m2.float(), stop_pred.float(), batch["mels"],
                                    batch["stop"])
        loss.backward()
        gnorm = _clip(params, clip_grad_norm, dp)
        optimizer.step()
        _install(buffers, new_stats)
        return _global_stats({"loss": loss, "grad_norm": gnorm, **parts}, dp), attn.detach()

    return step


def _clip(params, clip_grad_norm: Optional[float], dp) -> Tensor:
    """The gradients averaged over ``dp``'s ranks, then clipped to
    ``clip_grad_norm`` by ``min(1, c / (‖g‖ + 1e-6))`` (no clip for None).
    Returns the norm before clipping."""
    if dp is not None:
        distributed.average_gradients(params, dp)
    with torch.no_grad():
        gnorm = global_norm(p.grad for p in params)
        if clip_grad_norm is not None:
            scale = torch.clamp(clip_grad_norm / (gnorm + 1e-6), max=1.0)
            for p in params:
                p.grad.mul_(scale)
    return gnorm


def _install(buffers: Dict[str, Tensor], new_stats: Dict[str, Tensor]) -> None:
    """The BatchNorms' new running statistics into their buffers."""
    with torch.no_grad():
        for name, value in new_stats.items():
            buffers[name].copy_(value)


def _global_stats(stats: Dict[str, Tensor], dp) -> Dict[str, Tensor]:
    """``stats``, detached; with ``dp`` the losses are averaged over the
    ranks (the gradient norm is the averaged gradient's already)."""
    stats = {k: v.detach() for k, v in stats.items()}
    if dp is None:
        return stats
    names = [k for k in stats if k != "grad_norm"]
    mean = distributed.mean_over_ranks(torch.stack([stats[k].float() for k in names]), dp)
    return {**stats, **dict(zip(names, mean))}


def masked_l1_lastdim(pred: Tensor, target: Tensor, lens: Tensor, dp=None) -> Tensor:
    """L1 over the positions before each row's length on the last (time)
    axis, divided by the mask's sum after it is broadcast to ``pred``'s
    shape (for mels: n_mels × valid frames), as the JAX package does. With
    ``dp`` the divisor is the global mask sum over the number of ranks, so
    that the ranks' losses average to the global batch's."""
    t = torch.arange(pred.shape[-1], device=pred.device)
    mask = (t[None, :] < lens[:, None]).to(pred.dtype)
    while mask.ndim < pred.ndim:
        mask = mask[:, None, :]
    mask = mask.expand(pred.shape)
    count = mask.sum()
    if dp is not None:
        count = distributed.mean_over_ranks(count, dp)
    return ((pred - target).abs() * mask).sum() / count.clamp_min(1.0)


def make_nar_synth_train_step(model_type: str, model, optimizer: torch.optim.Optimizer, cfg,
                              compute_dtype: str = "f32", dp=None
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

    cdt = precision.resolve(compute_dtype)
    forward = (forward_tacotron_forward if model_type == factories.MODEL_TYPE_FORWARD_TACOTRON
               else fastpitch_forward)
    pitch_zoneout = getattr(cfg, "pitch_zoneout", 0.0)
    energy_zoneout = getattr(cfg, "energy_zoneout", 0.0)
    params = [p for p in model.parameters() if p.requires_grad]
    buffers = dict(model.named_buffers())

    def zoneout(x: Tensor, p: float, generator) -> Tensor:
        return x * (distributed.uniform(x.shape, generator, x.device) > p)

    def l1(pred, target, lens):
        return masked_l1_lastdim(pred, target, lens, dp)

    def step(batch: Dict[str, Tensor], generator: Optional[torch.Generator] = None):
        optimizer.zero_grad(set_to_none=True)
        generator = distributed.shard_rows(generator, dp)
        pitch, energy = batch["pitch"], batch["energy"]
        b = precision.cast_floats({**batch, "pitch_in": zoneout(pitch, pitch_zoneout, generator),
                                   "energy_in": zoneout(energy, energy_zoneout, generator)},
                                  cdt)
        with precision.policy(model, cdt), sync_batch_norms(model, dp):
            mel_hat, mel_post, dur_hat, pitch_hat, energy_hat, new_stats = forward(
                model, b["chars"], b["mels"], b["durations"], b["embeds"], b["spec_lens"],
                b["pitch_in"], b["energy_in"], generator)
        mels, spec_lens, x_lens = batch["mels"], batch["spec_lens"], batch["x_lens"]
        parts = {
            "m1": l1(mel_hat.float(), mels, spec_lens),
            "m2": l1(mel_post.float(), mels, spec_lens),
            "dur": l1(dur_hat.float()[:, None, :], batch["durations"][:, None, :], x_lens),
            "pitch": l1(pitch_hat.float(), pitch[:, None, :], x_lens),
            "energy": l1(energy_hat.float(), energy[:, None, :], x_lens)}
        loss = (parts["m1"] + parts["m2"] + cfg.duration_loss_factor * parts["dur"]
                + cfg.pitch_loss_factor * parts["pitch"]
                + cfg.energy_loss_factor * parts["energy"])
        loss.backward()
        gnorm = _clip(params, cfg.clip_grad_norm, dp)
        optimizer.step()
        _install(buffers, new_stats)
        return _global_stats({"loss": loss, "grad_norm": gnorm, **parts}, dp)

    return step


def make_wavernn_train_step(model: WaveRNN, d: WaveRNNDims,
                            optimizer: torch.optim.Optimizer, compute_dtype: str = "f32",
                            dp=None) -> Callable[[Dict[str, Tensor]], Tensor]:
    """Teacher-forced WaveRNN step: ``step({"x", "y", "y_float", "mels"})``
    runs the forward with batch statistics, the loss, the backward and the
    optimizer, installs the BatchNorms' new running statistics, and returns
    the loss, detached. The loss follows the head: the discretized
    mixture-of-logistics likelihood of ``y_float`` in MOL mode, the NLL of
    ``y`` under geneing's BITS log-probabilities, the cross entropy of ``y``
    otherwise (``y_float`` is read in MOL mode only).

    geneing's RAW mode has a beta head of two columns; a cross entropy over
    them is not its likelihood, so training that cell raises."""
    cdt = precision.resolve(compute_dtype)
    if d.variant == VOC_GENEING and d.mode == MODE_RAW:
        raise NotImplementedError(
            "training geneing-wavernn in RAW mode (the beta head) is not supported: a "
            "cross entropy over its two columns is not a likelihood of that head; "
            "train it in BITS or MOL mode")
    params = [p for p in model.parameters() if p.requires_grad]
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
        b = precision.cast_floats(batch, cdt)
        with precision.policy(model, cdt), sync_batch_norms(model, dp):
            out, new_stats = wavernn_forward(model, d, b["x"], b["mels"])
        # a plain mean over this rank's crops, all of one shape
        # (``data.vocoder_dataset``): the ranks' mean is the global one
        loss = loss_of(out.float(), batch)
        loss.backward()
        if dp is not None:
            distributed.average_gradients(params, dp)
        optimizer.step()
        _install(buffers, new_stats)
        return _global_stats({"loss": loss}, dp)["loss"]

    return step
