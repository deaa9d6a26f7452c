"""Where a full-width training step spends its time on one NVIDIA GPU.

    python -m rtvc_tpu_torch.profile_train [--compute_dtype {auto,f32,bf16}]

Takes GE2E steps (64 speakers x 10 utterances x 160 frames, 3 x LSTM-768),
WaveRNN steps of the three variants at the first session of their schedules
(runtimeracer and fatchord batch 40 x 1000 samples, geneing 40 x 1400),
Tacotron steps (the first session of its schedule: r 7, batch 112, 602
frames, 160 characters), ForwardTacotron steps at the first session's batch
16 and the schedule's largest, 48 (900 frames, 160 characters) and FastPitch
steps at batch 16, with seeded random weights and synthetic batches. For
each it prints the
wall time of three steps ending in a device sync, the peak device memory, and a
``torch.profiler`` table of device time by kernel over a few more steps,
with the idle share 1 - (summed device self time / profiled wall time),
the device time of each of the port's own kernels (csrc/), which the
table's top rows may leave out, and that of cuDNN's convolution backward.
Then it times the recurrences alone, forward plus backward at the same
shapes, through ``LSTMSeqFn`` / ``GRUSeqFn`` and through cuDNN's
``nn.LSTM`` / ``nn.GRU`` (TF32 off) as a bar to measure against.
``--compute_dtype bf16`` takes every step under the bf16 training policy
(``ops/precision.py``) and times the recurrences alone on bf16 streams,
cuDNN's in bf16 too; ``auto`` (the default) and ``f32`` in f32.

Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.config.signal import sp
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.ops import precision
from rtvc_tpu_torch.ops.gru_seq import GRUSeqFn
from rtvc_tpu_torch.ops.lstm_seq import LSTMSeqFn
from rtvc_tpu_torch.train import steps, trainer


def own_kernels():
    """The names of the port's own kernels: the ``__global__`` functions of
    csrc/*.cu."""
    found = set()
    for src in _build.SRC_DIR.glob("*.cu"):
        found.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                                src.read_text()))
    return found


def kernel_name(key):
    """A profiler key → the kernel's bare name (no namespace, template
    arguments or parameters)."""
    key = re.sub(r"^void ", "", key.replace("(anonymous namespace)::", ""))
    return re.split(r"[(<]", key)[0].split("::")[-1]


def profile_step(name, step, batch, n):
    """Wall ms of 3 synced steps, peak memory, then a profiler table."""
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    print(f"{name}: wall ms per step {walls}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    table = prof.key_averages()
    # kernels only, as the table's own total counts them: an autograd
    # Function's annotation row repeats the device time of its kernels
    device = sum(e.self_device_time_total for e in table
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    print(f"{name}: {n} steps profiled, wall {wall:.1f} ms, summed device self time "
          f"{device:.1f} ms, idle share {1 - device / wall:.4f}")
    print(table.table(sort_by="self_device_time_total", row_limit=12, max_name_column_width=60))
    names, own = own_kernels(), {}
    for e in table:  # one row a kernel name (the profiler splits one by its arguments)
        if e.device_type == DeviceType.CUDA and kernel_name(e.key) in names:
            ms, calls = own.get(kernel_name(e.key), (0.0, 0))
            own[kernel_name(e.key)] = (ms + e.self_device_time_total / 1e3, calls + e.count)
    print(f"{name}: the port's kernels, device ms over {n} steps (calls): "
          + "; ".join(f"{k} {ms:.3f} ({c})" for k, (ms, c) in
                      sorted(own.items(), key=lambda r: -r[1][0])))
    conv_bwd = sum(e.device_time_total for e in table if e.key == "aten::convolution_backward")
    print(f"{name}: aten::convolution_backward (cuDNN), device ms over {n} steps: "
          f"{conv_bwd / 1e3:.3f}")


def fwd_bwd_ms(fn, args, reps=5):
    """CUDA-event mean ms of ``fn(*args)`` and a backward from its first
    output, after one warm-up call."""
    def once():
        out = fn(*args)
        y = out[0] if isinstance(out, tuple) else out
        y.backward(torch.ones_like(y))

    once()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        once()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def encoder_step(dev, compute_dtype="f32"):
    S, U, T = 64, 10, 160
    model = factories.init_encoder_model(seed=0, device=dev).train()
    step = steps.make_encoder_train_step(
        model, trainer.make_optimizer(model.parameters(), 1e-4), S, U, compute_dtype)
    g = torch.Generator().manual_seed(6)
    base = torch.rand(S, 1, 1, 40, generator=g)
    x = (base + 0.1 * torch.randn(S, U, T, 40, generator=g)).clamp(0, 1)
    return step, x.reshape(S * U, T, 40).to(dev)


def vocoder_step(dev, model_type=factories.MODEL_TYPE_RUNTIMERACER, compute_dtype="f32"):
    cfg = factories.default_config(model_type)
    d = factories.wavernn_dims(model_type, cfg)
    model = factories.init_wavernn(d, seed=0, device=dev).train()
    step = steps.make_wavernn_train_step(
        model, d, trainer.make_optimizer(model.parameters(), 1e-3), compute_dtype)
    B, L = int(cfg.voc_tts_schedule[0][3]), cfg.seq_len
    rng = np.random.default_rng(8)
    batch = {"x": rng.uniform(-1, 1, (B, L)).astype(np.float32),
             "y": rng.integers(0, 2 ** cfg.bits, (B, L)),
             "mels": rng.uniform(0, 1, (B, sp.num_mels, L // sp.hop_size + 2 * cfg.pad)
                                 ).astype(np.float32)}
    return step, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def synthetic_tacotron_batch(batch_size, n_chars, frames, seed, speaker_dims=768):
    """One batch shaped like ``collate_synthesizer``'s: chars (B, n_chars) int
    with zero-padded tails, mels (B, num_mels, frames) a model can learn from
    (smooth in time and across bins, mostly below zero as speech mels are,
    inside the symmetric range), unit-norm embeds and stop targets."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(n_chars // 2, n_chars + 1, batch_size)
    spec_lens = rng.integers(frames // 2, frames, batch_size)
    embeds = rng.standard_normal((batch_size, speaker_dims)).astype(np.float32)
    t, m = np.arange(frames)[None, None, :], np.arange(sp.num_mels)[None, :, None]
    phase = rng.uniform(0, 6.3, (batch_size, 1, 1))
    mels = (-1.5 + 2 * np.sin(2 * np.pi * (t / 97 + m / 40) + phase)
            + 0.3 * rng.standard_normal((batch_size, sp.num_mels, frames)))
    return {"chars": np.where(np.arange(n_chars)[None, :] < lens[:, None],
                              rng.integers(1, 60, (batch_size, n_chars)), 0).astype(np.int32),
            "mels": np.clip(mels, -sp.max_abs_value, sp.max_abs_value).astype(np.float32),
            "embeds": embeds / np.linalg.norm(embeds, axis=1, keepdims=True),
            "stop": (np.arange(frames)[None, :] >= spec_lens[:, None] - 1).astype(np.float32)}


def synthesizer_step(dev, compute_dtype="f32"):
    cfg = factories.default_config(factories.MODEL_TYPE_TACOTRON)
    bundle = factories.init_syn_model(factories.MODEL_TYPE_TACOTRON, seed=0, device=dev)
    model = bundle.model.train()
    r, _, B, lr, _ = cfg.tts_schedule[0]
    raw = steps.make_tacotron_train_step(model, bundle.dims,
                                         trainer.make_optimizer(model.parameters(), lr), r,
                                         cfg.tts_clip_grad_norm, compute_dtype)
    batch = synthetic_tacotron_batch(B, 160, 86 * r, seed=12)
    generator = torch.Generator(device=dev).manual_seed(0)
    return (lambda b: raw(b, generator)), {k: torch.from_numpy(v).to(dev)
                                           for k, v in batch.items()}


def synthetic_nar_batch(batch_size, n_chars, frames, seed, speaker_dims=768):
    """One batch shaped like ``collate_synthesizer``'s for the
    non-autoregressive synthesizers: ``synthetic_tacotron_batch``'s chars,
    mels and embeds, ``x_lens``, ``spec_lens`` in [frames / 2, frames),
    integer ``durations`` over each row's characters summing to its
    ``spec_lens``, and pitch (Hz, 0 on a tenth of the characters) and energy
    per character."""
    out = synthetic_tacotron_batch(batch_size, n_chars, frames, seed, speaker_dims)
    del out["stop"]
    rng = np.random.default_rng(seed + 1)
    x_lens = (out["chars"] != 0).sum(axis=1).astype(np.int32)
    spec_lens = rng.integers(frames // 2, frames, batch_size).astype(np.int32)
    durations = np.zeros((batch_size, n_chars), np.float32)
    for b, (n, f) in enumerate(zip(x_lens, spec_lens)):
        cuts = np.sort(rng.integers(0, f + 1, n - 1))
        durations[b, :n] = np.diff(np.concatenate([[0], cuts, [f]]))
    valid = durations > 0
    out.update(x_lens=x_lens, spec_lens=spec_lens, durations=durations,
               phoneme_pitchs=np.where(valid & (rng.uniform(size=valid.shape) > 0.1),
                                       rng.uniform(90, 250, valid.shape), 0).astype(np.float32),
               phoneme_energys=np.where(valid, rng.uniform(1, 10, valid.shape), 0).astype(
                   np.float32))
    return out


def nar_step(dev, model_type, batch_size, n_chars=160, frames=900, compute_dtype="f32"):
    """A ForwardTacotron or FastPitch step at full width (the config's
    defaults) and the first session's learning rate, on
    ``synthetic_nar_batch``, as the trainer feeds it."""
    cfg = factories.default_config(model_type)
    model = factories.init_syn_model(model_type, seed=0, device=dev).model.train()
    raw = steps.make_nar_synth_train_step(
        model_type, model, trainer.make_optimizer(model.parameters(), cfg.tts_schedule[0][2]),
        cfg, compute_dtype)
    batch = synthetic_nar_batch(batch_size, n_chars, frames, seed=13)
    generator = torch.Generator(device=dev).manual_seed(0)
    return (lambda b: raw(b, generator)), {k: trainer.batch_tensor(batch[src], dev)
                                           for k, src in trainer.NAR_BATCH_KEYS.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--compute_dtype", choices=["auto", "f32", "bf16"], default="auto",
                        help="the steps' policy (train/steps.py); auto = f32 on the card")
    cdt_name = parser.parse_args(argv).compute_dtype
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cdt = precision.resolve(cdt_name)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"compute dtype: {cdt}")
    profile_step("GE2E step 640 x 160 x 40", *encoder_step(dev, cdt_name), n=2)
    for model_type in (factories.MODEL_TYPE_RUNTIMERACER, factories.MODEL_TYPE_FATCHORD,
                       factories.MODEL_TYPE_GENEING):
        cfg = factories.default_config(model_type)
        profile_step(f"WaveRNN {model_type} step {cfg.voc_tts_schedule[0][3]} x {cfg.seq_len}",
                     *vocoder_step(dev, model_type, cdt_name), n=3)
    profile_step("Tacotron step 112 x 602 frames x 160 chars, r 7",
                 *synthesizer_step(dev, cdt_name), n=2)
    for model_type, B in ((factories.MODEL_TYPE_FORWARD_TACOTRON, 16),
                          (factories.MODEL_TYPE_FORWARD_TACOTRON, 48),
                          (factories.MODEL_TYPE_FASTPITCH, 16)):
        profile_step(f"{model_type} step {B} x 900 frames x 160 chars",
                     *nar_step(dev, model_type, B, compute_dtype=cdt_name), n=2)

    def leaf(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev) * scale).to(cdt).requires_grad_()

    H = 768
    zero = torch.zeros(640, H, device=dev)  # the state stays f32 under either policy
    port = fwd_bwd_ms(LSTMSeqFn.apply,
                      (leaf(640, 160, 4 * H), leaf(4 * H, H, scale=H ** -0.5), zero, zero))
    cudnn = fwd_bwd_ms(torch.nn.LSTM(H, H, batch_first=True, device=dev, dtype=cdt),
                       (leaf(640, 160, H),))
    print(f"fwd+bwd 640 x 160, H {H}: LSTMSeqFn {port:.3f} ms (recurrence only), "
          f"cuDNN nn.LSTM {cudnn:.3f} ms (input projection included)")
    for B in (16, 48):
        H = 512
        zero = torch.zeros(B, H, device=dev)
        port = fwd_bwd_ms(LSTMSeqFn.apply,
                          (leaf(B, 900, 4 * H), leaf(4 * H, H, scale=H ** -0.5), zero, zero))
        cudnn = fwd_bwd_ms(torch.nn.LSTM(1280, H, batch_first=True, device=dev, dtype=cdt),
                           (leaf(B, 900, 1280),))
        print(f"fwd+bwd {B} x 900, H {H} (ForwardTacotron's BiLSTM, one direction): LSTMSeqFn "
              f"{port:.3f} ms (recurrence only), cuDNN nn.LSTM(1280, {H}) {cudnn:.3f} ms "
              f"(input projection included)")
    for T, H in ((1000, 256), (1000, 512), (1400, 256)):
        port = fwd_bwd_ms(GRUSeqFn.apply,
                          (leaf(40, T, 3 * H), leaf(3 * H, H, scale=H ** -0.5), leaf(3 * H)))
        cudnn = fwd_bwd_ms(torch.nn.GRU(H, H, batch_first=True, device=dev, dtype=cdt),
                           (leaf(40, T, H),))
        print(f"fwd+bwd 40 x {T}, H {H}: GRUSeqFn {port:.3f} ms (recurrence only), "
              f"cuDNN nn.GRU {cudnn:.3f} ms (input projection included)")
    print(f"jax imported: {'jax' in sys.modules}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
