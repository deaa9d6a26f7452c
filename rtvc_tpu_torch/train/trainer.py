"""Training loops for the GE2E speaker encoder, the three synthesizers and
the WaveRNN vocoders (counterpart of ``rtvc_tpu/train/trainer.py``).

  * encoder — GE2E steps over a batch iterator, EER every ``eer_every``
    steps, rolling saves and immutable backups;
  * synthesizer — Tacotron, ForwardTacotron or FastPitch over the
    progressive schedule of its config (the batch size and learning-rate
    range, and Tacotron's reduction factor, change per session; per-step
    linear LR decay within a session);
  * vocoder — the session schedule of the WaveRNN config (per-step linear
    LR decay within a session), in-loop structured pruning, loss-anomaly
    detection.

Each trainer builds its model from an explicit ``torch.Generator`` seed on
the ``device`` its caller names, and resumes from its own checkpoint
(``<models_dir>/<run_id>/<run_id>.pt``: model, optimizer and step), or
takes up a run of the JAX package's trainers from its ``<run_id>.ckpt``
(:func:`_resume`).

With ``dp`` (a process group of ``parallel.distributed``) a trainer runs
one rank of a data-parallel run: its source yields this rank's rows of
every global batch, the parameters and buffers start as rank 0's, each step
is the global batch's step (``train.steps``), the sample hooks run on rank
0 only, and a checkpoint is written by rank 0 after every rank has reached
it.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from rtvc_tpu_torch.parallel import distributed
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
    every ``backup_every`` steps. With several processes every one waits
    for the others at a save, and only the main process writes."""

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
        if not (do_save or do_backup):
            return
        # the cadence depends on the step alone, so every process gets here
        distributed.wait_for_everyone()
        if not distributed.is_main_process():
            return
        ckpt.save_checkpoint(self.path, model, step, self.model_type, optimizer, extras)
        if do_backup:
            ckpt.backup_checkpoint(self.path, self.model_dir / "backups", step)


def batch_tensor(x, device) -> torch.Tensor:
    """A batch entry on ``device``: integers as int64, floats as f32."""
    x = torch.as_tensor(x)
    dtype = torch.long if not x.is_floating_point() else torch.float32
    return x.to(device=device, dtype=dtype)


def _resume(cadence: CheckpointCadence, model, optimizer, device, what: str, kind: str) -> int:
    """The step a run resumes at, 0 for a new run. The port's own
    ``<run_id>.pt`` gives the model, Adam and the step. Without one, a JAX
    package's ``<run_id>.ckpt`` beside it is taken up as the JAX trainers
    take up their own: the parameters and running statistics (``read_model``
    of ``kind``, loaded strictly) and the step, with Adam started afresh (the
    JAX trainers do not read their ``opt_state`` back). The trainers'
    schedules then put the run in the session, r and learning rate of its
    step, and it saves ``<run_id>.pt`` from then on. A ``<run_id>.ckpt``
    that ``read_model`` cannot read raises."""
    if cadence.path.exists():
        state = ckpt.load_checkpoint(cadence.path, map_location=device)
        model.load_state_dict(state["state_dict"])
        optimizer.load_state_dict(state["optimizer"])
        print(f"Resuming {what} run at step {state['step']}")
        return state["step"]
    jax_path = cadence.path.with_suffix(".ckpt")
    if jax_path.exists():
        read = ckpt.read_model(jax_path, kind)
        model.load_state_dict(read.state_dict, strict=True)
        print(f"Taking up the JAX run {what} from {jax_path.name} at step {read.step} "
              f"(parameters and running statistics; Adam starts afresh, as in the JAX "
              f"trainers); saving {cadence.path.name} from here on")
        return read.step
    return 0


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
    dp=None,
) -> Dict[str, Any]:
    """GE2E training loop. ``data_iterator`` yields (S·U, T, n_mels) batches
    (numpy or tensors); ``model`` defaults to a ``SpeakerEncoder`` of the
    default widths with weights drawn from ``seed``. Returns the final step,
    the model, the last step's metrics, and every step's loss and wall
    milliseconds (``losses``, ``step_ms``). With ``dp`` the source yields
    this rank's speakers (``speakers_per_batch`` / ranks of them); the EER
    and ``projection_hook`` read the global similarity matrix and
    embeddings, and the hook runs on rank 0."""
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.models.speaker_encoder import compute_eer
    from rtvc_tpu_torch.train.steps import make_encoder_train_step

    device = torch.device(device)
    if model is None:
        model = factories.init_encoder_model(seed=seed, device=device)
    model.to(device).train()
    optimizer = make_optimizer(model.parameters(), learning_rate)
    step_fn = make_encoder_train_step(model, optimizer, speakers_per_batch,
                                      utterances_per_speaker, compute_dtype, dp)
    cadence = CheckpointCadence(Path(models_dir) / run_id, run_id, "speaker_encoder",
                                save_every, backup_every)
    metrics = MetricsLogger(Path(models_dir) / run_id / "metrics.tsv")
    step = _resume(cadence, model, optimizer, device, f"encoder {run_id}", "encoder") \
        if resume else 0
    if dp is not None:
        distributed.replicate_global(model, dp)
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
                and step % projection_every == 0 and distributed.is_main_process():
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
# Synthesizers
# ---------------------------------------------------------------------------

# the batch keys each synthesizer's step reads, with the collated batch's
# key for each (``data.synthesizer_dataset.collate_synthesizer``)
TACOTRON_BATCH_KEYS = {"chars": "chars", "mels": "mels", "embeds": "embeds", "stop": "stop"}
NAR_BATCH_KEYS = {"chars": "chars", "mels": "mels", "embeds": "embeds",
                  "durations": "durations", "spec_lens": "spec_lens", "x_lens": "x_lens",
                  "pitch": "phoneme_pitchs", "energy": "phoneme_energys"}


def sessions(model_type: str, schedule):
    """The schedule as (r, loops, batch_size, init_lr, end_lr) sessions:
    Tacotron's as they are, the non-autoregressive synthesizers' (loops,
    batch_size, init_lr, end_lr) at r 1."""
    from rtvc_tpu_torch.models import factories

    if model_type == factories.MODEL_TYPE_TACOTRON:
        return [tuple(s) for s in schedule]
    return [(1, *s) for s in schedule]


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
    eval_hook: Optional[Callable] = None,
    eval_interval: int = 500,
    compute_dtype: str = "f32",
    *,
    device,
    dp=None,
) -> Dict[str, Any]:
    """Synthesizer training over the config's session schedule:
    Tacotron's ``(r, loops, batch_size, init_lr, end_lr)``, ForwardTacotron's
    and FastPitch's ``(loops, batch_size, init_lr, end_lr)`` at r 1.

    ``epoch_batches(session_index, r)`` returns a sized, re-iterable source of
    collated batches (``rtvc_tpu_torch.data.synthesizer_dataset.batch_iterator``
    is one: each iteration is a fresh epoch); a source without a length
    raises TypeError rather than being frozen into a list and replayed.
    Tacotron's step is rebuilt at every session, since ``r`` changes; its
    batches carry ``chars``, ``mels``, ``embeds`` and ``stop``, the
    non-autoregressive synthesizers' also ``durations``, ``spec_lens``,
    ``x_lens``, ``phoneme_pitchs`` and ``phoneme_energys`` (the alignment
    pass's files, collated). Each step draws its dropout and zoneout noise
    from a generator seeded by (``seed``, step), so a resumed run repeats
    what an unbroken run does at the same step. A resume in the middle of a
    session takes up that session's learning-rate decay where it stood and
    ends the session at its own step count. ``eval_hook(step, model, r)``
    runs after every ``eval_interval``-th step's save (``train.eval_hooks``).
    ``compute_dtype`` is the steps' policy (``train.steps``: "auto" and
    "f32" train in f32, "bf16" under the bf16 policy); the checkpoints hold
    the f32 master weights either way, so a run resumes under either.
    With ``dp`` the sources yield this rank's rows of every global batch
    (the schedule's batch sizes are global), each step draws its noise for
    the global batch from the same generator on every rank, and the
    evaluation hook runs on rank 0.

    Returns the final step, the model, the last step's statistics, and every
    step's loss, learning rate and wall milliseconds (``losses``, ``lrs``,
    ``step_ms``)."""
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.ops import precision
    from rtvc_tpu_torch.train.steps import (
        make_nar_synth_train_step,
        make_tacotron_train_step,
    )

    precision.resolve(compute_dtype)

    is_tacotron = model_type == factories.MODEL_TYPE_TACOTRON
    device = torch.device(device)
    bundle = factories.init_syn_model(model_type, seed=seed, override_hp=override_hp,
                                      device=device)
    cfg, dims, model = bundle.config, bundle.dims, bundle.model.train()
    optimizer = make_optimizer(model.parameters())
    cadence = CheckpointCadence(Path(models_dir) / run_id, run_id, model_type,
                                save_every, backup_every)
    metrics = MetricsLogger(Path(models_dir) / run_id / "metrics.tsv")
    step = _resume(cadence, model, optimizer, device, f"{model_type} {run_id}",
                   "synthesizer") if resume else 0
    if dp is not None:
        distributed.replicate_global(model, dp)
    generator = torch.Generator(device=device)
    loss_window, time_window = ValueWindow(100), ValueWindow(100)
    losses, lrs, step_ms = [], [], []
    last: Dict[str, float] = {}
    session_start_step = 0
    schedule = sessions(model_type, cfg.tts_schedule)
    r = schedule[0][0]
    keys = TACOTRON_BATCH_KEYS if is_tacotron else NAR_BATCH_KEYS
    done = False

    def extras():
        # the running statistics are in the state dict too; the extras name
        # them apart, with the reduction factor the weights were last
        # trained at, as the reference's checkpoints do
        return {"r": r, "config": cfg.asdict(), "batch_stats": dict(model.named_buffers())}

    for session_idx, (r, loops, batch_size, init_lr, end_lr) in enumerate(schedule):
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
        simple_table([("Session", session_idx + 1), ("r", r if is_tacotron else "-"),
                      ("Batch", batch_size), ("LR", f"{init_lr:g}→{end_lr:g}"),
                      ("Steps", session_steps)])
        if is_tacotron:
            tacotron_step = make_tacotron_train_step(model, dims, optimizer, r,
                                                     cfg.tts_clip_grad_norm, compute_dtype, dp)

            def step_fn(batch, generator):
                return tacotron_step(batch, generator)[0]
        else:
            step_fn = make_nar_synth_train_step(model_type, model, optimizer, cfg,
                                                compute_dtype, dp)
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
                stats = step_fn({k: batch_tensor(batch[src], device) for k, src in keys.items()},
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
                if eval_hook is not None and eval_interval > 0 and step % eval_interval == 0 \
                        and distributed.is_main_process():
                    eval_hook(step, model, r)
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
    dp=None,
) -> Dict[str, Any]:
    """WaveRNN training over the config's session schedule.

    ``epoch_batches(session_index)`` returns a sized, re-iterable batch
    source for one session (``rtvc_tpu_torch.data.vocoder_dataset.batch_iterator``
    is one: each iteration is a fresh epoch with a new shuffle and new
    crops); it is iterated once per epoch. A source without a length raises
    TypeError, rather than being frozen into a list and replayed. Returns
    the final step, the model, the last loss, and every step's loss and wall
    milliseconds (``losses``, ``step_ms``). With ``dp`` the sources yield
    this rank's rows of every global batch; the pruning masks come from the
    replicated weights, so every rank derives the same ones, and
    ``gen_hook`` runs on rank 0."""
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
    step_fn = make_wavernn_train_step(model, dims, optimizer, compute_dtype, dp)
    cadence = CheckpointCadence(Path(models_dir) / run_id, run_id, model_type,
                                save_every, backup_every)
    metrics = MetricsLogger(Path(models_dir) / run_id / "metrics.tsv")
    step = _resume(cadence, model, optimizer, device, f"{model_type} {run_id}",
                   "vocoder") if resume else 0
    if dp is not None:
        distributed.replicate_global(model, dp)
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
                if gen_hook is not None and gen_every > 0 and step % gen_every == 0 \
                        and distributed.is_main_process():
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
