"""Training loops for the GE2E speaker encoder, Tacotron and the
WaveRNN vocoders (counterpart of ``rtvc_tpu/train/trainer.py``).

  * encoder — GE2E steps over a batch iterator, EER every ``eer_every``
    steps, rolling saves and immutable backups;
  * synthesizer — Tacotron over the progressive schedule of its config (the
    reduction factor, batch size and learning-rate range change per
    session; per-step linear LR decay within a session);
  * vocoder — the session schedule of the WaveRNN config (per-step linear
    LR decay within a session), in-loop structured pruning, loss-anomaly
    detection.

Each trainer builds its model from an explicit ``torch.Generator`` seed on
the ``device`` its caller names, and resumes from its own checkpoint
(``<models_dir>/<run_id>/<run_id>.pt``: model, optimizer and step).
Multi-GPU data parallelism is a later slice.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from rtvc_tpu_torch.utils.metrics import MetricsLogger, ValueWindow, simple_table, stream
from rtvc_tpu_torch.utils.profiler import Profiler
from rtvc_tpu_torch.train import checkpoints as ckpt


def linear_session_lr(init_lr: float, end_lr: float, step_in_session: int,
                      session_steps: int) -> float:
    """Linear decay within a session (SGDR-style restarts across sessions)."""
    if session_steps <= 1:
        return end_lr
    frac = min(max(step_in_session / (session_steps - 1), 0.0), 1.0)
    return init_lr + (end_lr - init_lr) * frac


class AnomalyDetector:
    """Loss-anomaly detection: a rolling average of |Δloss|; trips when the
    current delta exceeds ``multiplier`` × that average after ``warmup``
    deltas; raises on a NaN or infinite loss."""

    def __init__(self, multiplier: float = 6.0, window: int = 100, warmup: int = 20):
        self.multiplier = multiplier
        self.window = ValueWindow(window)
        self.prev_loss: Optional[float] = None
        self.warmup = warmup
        self.seen = 0

    def check(self, loss: float) -> bool:
        """Returns True if this step's loss is anomalous."""
        if not np.isfinite(loss):
            raise FloatingPointError("Loss is NaN/Inf — training diverged (anomaly detection)")
        anomalous = False
        if self.prev_loss is not None:
            delta = abs(loss - self.prev_loss)
            self.seen += 1
            if (self.seen > self.warmup and self.window.count > 0
                    and delta > self.multiplier * max(self.window.average, 1e-12)):
                anomalous = True
            self.window.append(delta)
        self.prev_loss = loss
        return anomalous


def make_optimizer(params, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam (β = 0.9, 0.999, ε = 1e-8, as ``optax.adam``); the trainers set
    its learning rate every step."""
    return torch.optim.Adam(params, lr=lr)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class CheckpointCadence:
    """A rolling save every ``save_every`` steps and an immutable backup
    every ``backup_every`` steps."""

    def __init__(self, model_dir: Path, run_id: str, model_type: Optional[str],
                 save_every: int = 1000, backup_every: int = 10000):
        self.model_dir = Path(model_dir)
        self.model_dir.mkdir(parents=True, exist_ok=True)
        self.model_type = model_type
        self.save_every = save_every
        self.backup_every = backup_every
        self.path = self.model_dir / f"{run_id}.pt"

    def maybe_save(self, step: int, model, optimizer=None, extras=None,
                   force: bool = False) -> None:
        do_save = force or (self.save_every > 0 and step % self.save_every == 0)
        do_backup = self.backup_every > 0 and step % self.backup_every == 0 and step > 0
        if do_save or do_backup:
            ckpt.save_checkpoint(self.path, model, step, self.model_type, optimizer, extras)
        if do_backup:
            ckpt.backup_checkpoint(self.path, self.model_dir / "backups", step)


def _resume(cadence: CheckpointCadence, model, optimizer, device, what: str) -> int:
    state = ckpt.load_checkpoint(cadence.path, map_location=device)
    model.load_state_dict(state["state_dict"])
    optimizer.load_state_dict(state["optimizer"])
    print(f"Resuming {what} run at step {state['step']}")
    return state["step"]


# ---------------------------------------------------------------------------
# Speaker encoder
# ---------------------------------------------------------------------------


def train_encoder(
    run_id: str,
    data_iterator: Iterable,
    models_dir: Path,
    speakers_per_batch: int = 64,
    utterances_per_speaker: int = 10,
    learning_rate: float = 1e-6,
    total_steps: Optional[int] = None,
    end_after: Optional[int] = None,
    save_every: int = 500,
    backup_every: int = 7500,
    eer_every: int = 10,
    resume: bool = True,
    profile: bool = False,
    model=None,
    projection_hook=None,
    projection_every: int = 0,
    compute_dtype: str = "f32",
    *,
    device,
    seed: int = 0,
) -> Dict[str, Any]:
    """GE2E training loop. ``data_iterator`` yields (S·U, T, n_mels) batches
    (numpy or tensors); ``model`` defaults to a ``SpeakerEncoder`` of the
    default widths with weights drawn from ``seed``. Returns the final step,
    the model, the last step's metrics, and every step's loss and wall
    milliseconds (``losses``, ``step_ms``)."""
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.models.speaker_encoder import compute_eer
    from rtvc_tpu_torch.train.steps import make_encoder_train_step

    device = torch.device(device)
    if model is None:
        model = factories.init_encoder_model(seed=seed, device=device)
    model.to(device).train()
    optimizer = make_optimizer(model.parameters(), learning_rate)
    step_fn = make_encoder_train_step(model, optimizer, speakers_per_batch,
                                      utterances_per_speaker, compute_dtype)
    cadence = CheckpointCadence(Path(models_dir) / run_id, run_id, "speaker_encoder",
                                save_every, backup_every)
    metrics = MetricsLogger(Path(models_dir) / run_id / "metrics.tsv")
    step = 0
    if resume and cadence.path.exists():
        step = _resume(cadence, model, optimizer, device, f"encoder {run_id}")
    if end_after is not None:
        # a relative stop: end_after more steps from wherever the run resumed
        total_steps = min(total_steps or np.inf, step + end_after)
    extras = {"config": {"model": model.model_cfg.asdict(), "data": model.data_cfg.asdict()}}
    profiler = Profiler(summarize_every=10, disabled=not profile)
    loss_window, time_window = ValueWindow(100), ValueWindow(100)
    losses, step_ms = [], []
    last: Dict[str, Any] = {}

    t_last = time.perf_counter()
    for batch in data_iterator:
        if total_steps is not None and step >= total_steps:
            break
        profiler.tick("data fetch")
        inputs = torch.as_tensor(batch, dtype=torch.float32, device=device)
        loss_t, gnorm_t, sim, embeds = step_fn(inputs)
        loss, gnorm = (float(v) for v in torch.stack([loss_t, gnorm_t]).cpu())
        profiler.tick("forward+backward+step")
        step += 1
        now = time.perf_counter()
        time_window.append(now - t_last)
        step_ms.append((now - t_last) * 1000.0)
        t_last = now
        losses.append(loss)
        loss_window.append(loss)
        logged = {"loss": loss, "grad_norm": gnorm}
        if eer_every > 0 and step % eer_every == 0:
            logged["eer"] = compute_eer(sim.cpu().numpy(), speakers_per_batch)
        metrics.log(step, logged)
        last = logged
        if projection_hook is not None and projection_every > 0 \
                and step % projection_every == 0:
            projection_hook(step, embeds.reshape(-1, embeds.shape[-1]).cpu().numpy())
        stream("Step %d | loss %.4f (avg %.4f) | %.2f steps/s "
               % (step, loss, loss_window.average, 1.0 / max(time_window.average, 1e-9)))
        profiler.tick("metrics")
        cadence.maybe_save(step, model, optimizer, extras)
        t_last = time.perf_counter()

    cadence.maybe_save(step, model, optimizer, extras, force=True)
    print()
    return {"step": step, "model": model, "losses": losses, "step_ms": step_ms, **last}


# ---------------------------------------------------------------------------
# Synthesizer (Tacotron)
# ---------------------------------------------------------------------------


def train_synthesizer(
    run_id: str,
    model_type: str,
    models_dir: Path,
    epoch_batches: Callable[[int, int], Iterable[Dict[str, np.ndarray]]],
    save_every: int = 1000,
    backup_every: int = 25000,
    seed: int = 0,
    max_steps: Optional[int] = None,
    override_hp=None,
    resume: bool = True,
    *,
    device,
) -> Dict[str, Any]:
    """Tacotron training (f32) over the config's session schedule
    ``(r, loops, batch_size, init_lr, end_lr)``.

    ``epoch_batches(session_index, r)`` returns a sized, re-iterable source of
    collated batches (``rtvc_tpu_torch.data.synthesizer_dataset.batch_iterator``
    is one: each iteration is a fresh epoch); a source without a length
    raises TypeError rather than being frozen into a list and replayed.
    The step is rebuilt at every session, since ``r`` changes.
    Each step draws its dropout and zoneout noise from a generator seeded by
    (``seed``, step), so a resumed run repeats what an unbroken run does at
    the same step. A resume in the middle of a session takes up that
    session's learning-rate decay where it stood and ends the session at its
    own step count. The other synthesizers (ForwardTacotron, FastPitch)
    raise NotImplementedError: they are a later slice.

    Returns the final step, the model, the last step's statistics, and every
    step's loss, learning rate and wall milliseconds (``losses``, ``lrs``,
    ``step_ms``)."""
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.train.steps import make_tacotron_train_step

    factories.get_model_train_elements(model_type)  # raises for a type not trained yet
    device = torch.device(device)
    bundle = factories.init_syn_model(model_type, seed=seed, override_hp=override_hp,
                                      device=device)
    cfg, dims, model = bundle.config, bundle.dims, bundle.model.train()
    optimizer = make_optimizer(model.parameters())
    cadence = CheckpointCadence(Path(models_dir) / run_id, run_id, model_type,
                                save_every, backup_every)
    metrics = MetricsLogger(Path(models_dir) / run_id / "metrics.tsv")
    step = 0
    if resume and cadence.path.exists():
        step = _resume(cadence, model, optimizer, device, f"{model_type} {run_id}")
    generator = torch.Generator(device=device)
    loss_window, time_window = ValueWindow(100), ValueWindow(100)
    losses, lrs, step_ms = [], [], []
    last: Dict[str, float] = {}
    session_start_step = 0
    r = cfg.tts_schedule[0][0]
    done = False

    def extras():
        # the running statistics are in the state dict too; the extras name
        # them apart, with the reduction factor the weights were last
        # trained at, as the reference's checkpoints do
        return {"r": r, "config": cfg.asdict(), "batch_stats": dict(model.named_buffers())}

    for session_idx, (r, loops, batch_size, init_lr, end_lr) in enumerate(cfg.tts_schedule):
        session_batches = epoch_batches(session_idx, r)
        if not hasattr(session_batches, "__len__"):
            raise TypeError("epoch_batches must return a sized, re-iterable batch source "
                            "(each iteration one fresh epoch), such as "
                            "rtvc_tpu_torch.data.synthesizer_dataset.batch_iterator")
        n_epochs = int(loops)
        session_steps = max(len(session_batches) * n_epochs, 1)
        if step - session_start_step >= session_steps:
            session_start_step += session_steps
            continue
        simple_table([("Session", session_idx + 1), ("r", r), ("Batch", batch_size),
                      ("LR", f"{init_lr:g}→{end_lr:g}"), ("Steps", session_steps)])
        step_fn = make_tacotron_train_step(model, dims, optimizer, r, cfg.tts_clip_grad_norm)
        t_last = time.perf_counter()
        for _ in range(n_epochs):
            for batch in session_batches:
                # a resume in the middle of a session has fewer steps left
                # than the session's epochs hold
                if step - session_start_step >= session_steps:
                    break
                lr = linear_session_lr(init_lr, end_lr, step - session_start_step,
                                       session_steps)
                set_lr(optimizer, lr)
                generator.manual_seed(seed * 1_000_003 + step)
                stats, _ = step_fn(
                    {"chars": torch.as_tensor(batch["chars"], device=device),
                     "mels": torch.as_tensor(batch["mels"], dtype=torch.float32, device=device),
                     "embeds": torch.as_tensor(batch["embeds"], dtype=torch.float32,
                                               device=device),
                     "stop": torch.as_tensor(batch["stop"], dtype=torch.float32,
                                             device=device)},
                    generator)
                names = list(stats)
                last = dict(zip(names, (float(v) for v in
                                        torch.stack([stats[k] for k in names]).cpu())))
                loss = last["loss"]
                step += 1
                now = time.perf_counter()
                time_window.append(now - t_last)
                step_ms.append((now - t_last) * 1000.0)
                losses.append(loss)
                lrs.append(lr)
                loss_window.append(loss)
                metrics.log(step, {**last, "lr": lr})
                stream("Session %d | Step %d | lr %.2e | loss %.4f (avg %.4f) | %.2f steps/s "
                       % (session_idx + 1, step, lr, loss, loss_window.average,
                          1.0 / max(time_window.average, 1e-9)))
                cadence.maybe_save(step, model, optimizer, extras())
                done = max_steps is not None and step >= max_steps
                t_last = time.perf_counter()
                if done:
                    break
            if done or step - session_start_step >= session_steps:
                break
        session_start_step += session_steps
        if done:
            break

    cadence.maybe_save(step, model, optimizer, extras(), force=True)
    print()
    return {"step": step, "model": model, "losses": losses, "lrs": lrs, "step_ms": step_ms,
            "r": r, **last}


# ---------------------------------------------------------------------------
# Vocoder (WaveRNN)
# ---------------------------------------------------------------------------


def train_vocoder(
    run_id: str,
    model_type: str,
    models_dir: Path,
    epoch_batches: Callable[[int], Iterable[Dict[str, np.ndarray]]],
    save_every: int = 1000,
    backup_every: int = 25000,
    gen_hook: Optional[Callable] = None,
    gen_every: int = 0,
    seed: int = 0,
    max_steps: Optional[int] = None,
    override_hp=None,
    resume: bool = True,
    compute_dtype: str = "f32",
    *,
    device,
) -> Dict[str, Any]:
    """WaveRNN training over the config's session schedule.

    ``epoch_batches(session_index)`` returns a sized, re-iterable batch
    source for one session (``rtvc_tpu_torch.data.vocoder_dataset.batch_iterator``
    is one: each iteration is a fresh epoch with a new shuffle and new
    crops); it is iterated once per epoch. A source without a length raises
    TypeError, rather than being frozen into a list and replayed. Returns
    the final step, the model, the last loss, and every step's loss and wall
    milliseconds (``losses``, ``step_ms``)."""
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.train.pruning import (
        apply_prune_masks,
        compute_prune_masks,
        count_pruned,
    )
    from rtvc_tpu_torch.train.steps import make_wavernn_train_step

    device = torch.device(device)
    cfg = override_hp or factories.default_config(model_type)
    dims = factories.wavernn_dims(model_type, cfg)
    model = factories.init_wavernn(dims, seed=seed, device=device).train()
    optimizer = make_optimizer(model.parameters())
    step_fn = make_wavernn_train_step(model, dims, optimizer, compute_dtype)
    cadence = CheckpointCadence(Path(models_dir) / run_id, run_id, model_type,
                                save_every, backup_every)
    metrics = MetricsLogger(Path(models_dir) / run_id / "metrics.tsv")
    step = 0
    if resume and cadence.path.exists():
        step = _resume(cadence, model, optimizer, device, f"{model_type} {run_id}")
    extras = {"config": cfg.asdict()}
    detector = AnomalyDetector(cfg.anomaly_trigger_multiplier) if cfg.anomaly_detection else None
    loss_window, time_window = ValueWindow(100), ValueWindow(100)
    losses, step_ms = [], []
    session_start_step = 0
    prune_info = (0, 0)
    loss = float("nan")
    done = False

    for session_idx, (loops, init_lr, end_lr, batch_size) in enumerate(cfg.voc_tts_schedule):
        session_batches = epoch_batches(session_idx)
        if not hasattr(session_batches, "__len__"):
            raise TypeError("epoch_batches must return a sized, re-iterable batch source "
                            "(each iteration one fresh epoch), such as "
                            "rtvc_tpu_torch.data.vocoder_dataset.batch_iterator")
        n_epochs = max(int(np.ceil(loops)), 1)
        session_steps = max(int(len(session_batches) * loops), 1)
        if step - session_start_step >= session_steps:
            session_start_step += session_steps
            continue
        simple_table([("Session", session_idx + 1), ("Batch", batch_size),
                      ("LR", f"{init_lr:g}→{end_lr:g}"), ("Steps", session_steps),
                      ("Mode", cfg.mode)])
        t_last = time.perf_counter()
        for _ in range(n_epochs):
            for batch in session_batches:
                if step - session_start_step >= session_steps:
                    break
                lr = linear_session_lr(init_lr, end_lr, step - session_start_step,
                                       session_steps)
                set_lr(optimizer, lr)
                loss = float(step_fn({k: torch.as_tensor(batch[k], device=device)
                                      for k in ("x", "y", "y_float", "mels")
                                      if k in batch}))
                step += 1
                if cfg.use_sparsification and step >= cfg.start_prune:
                    masks = compute_prune_masks(model, dims, step, cfg.start_prune,
                                                cfg.prune_steps, cfg.sparsity_target,
                                                cfg.sparsity_target_rnn, cfg.sparse_group)
                    apply_prune_masks(model, masks)
                    if step % 100 == 0:
                        prune_info = count_pruned(masks)
                if detector is not None and detector.check(loss):
                    print("\n[anomaly] |Δloss| exceeded %.1f× rolling average at step %d "
                          "(loss %.4f)" % (cfg.anomaly_trigger_multiplier, step, loss))
                now = time.perf_counter()
                time_window.append(now - t_last)
                step_ms.append((now - t_last) * 1000.0)
                losses.append(loss)
                loss_window.append(loss)
                metrics.log(step, {"loss": loss, "lr": lr, "pruned": prune_info[0]})
                stream("Session %d | Step %d | loss %.4f (avg %.4f) | %.2f steps/s "
                       % (session_idx + 1, step, loss, loss_window.average,
                          1.0 / max(time_window.average, 1e-9)))
                cadence.maybe_save(step, model, optimizer, extras)
                if gen_hook is not None and gen_every > 0 and step % gen_every == 0:
                    gen_hook(step, model)
                done = max_steps is not None and step >= max_steps
                t_last = time.perf_counter()
                if done:
                    break
            if done or step - session_start_step >= session_steps:
                break
        session_start_step += session_steps
        if done:
            break

    cadence.maybe_save(step, model, optimizer, extras, force=True)
    print()
    return {"step": step, "model": model, "loss": loss, "losses": losses, "step_ms": step_ms}
