#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rtvc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``rtvc_tpu_torch/csrc`` (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes of the clone path, and times both with CUDA events:
   K3 LSTM sequence (8 x 160 x 768; W_hh resident in shared memory, a slice
   of the hidden units per CTA, a grid barrier per step: the plan taken and
   the barrier's own cost are printed), K2 Tacotron decoder (split over the
   card, a grid barrier a phase: the plan is printed; full width at B 1 x T
   64, B 2 x T 32 and B 24 x T 160, prenet dropout off, then seeded dropout,
   beside the one-CTA kernel's times), K1 WaveRNN loop (every
   layer's weights resident in shared memory across the card, a grid
   barrier per layer: the plan is printed; every variant x head cell at
   full width: fatchord RAW and MOL, geneing BITS, RAW (beta) and MOL,
   runtimeracer RAW and MOL; 8 folds x 512 steps, greedy; then sampled from
   fixed head outputs against a chi-square or a Kolmogorov-Smirnov test; and
   runtimeracer RAW over 6, 8, 13, 39, 64, 132, 169 and 264 folds and at the
   5 s clone's 13 and the paragraph's 169 folds x 8000 steps), K6 mel
   projection (each mel over its band of
   the filterbank: a minute of audio, 4801 frames x 513 bins, the clone's
   make_spectrogram size, 400 frames, and a 3.77 s utterance, 302 frames;
   the kernel's device time and the wrapper's host work apart).
3. Serves five clone requests through the public API at the default widths
   with seeded random weights: preprocess_wav → embed_utterance →
   synthesize_spectrograms → infer_waveform, and checks the outputs and
   that every kernel of the path was launched (K4 four times a request: the
   encoder's and the postnet's CBHG BiGRUs, one launch a direction), and
   prints the median clone time with its stage split and the device time of
   one synthesize call by kernel. Then vocodes three mels in
   one ``infer_waveforms`` call (one K1 launch), serves the last request
   through the fatchord and geneing vocoders at their configs' windows (twice
   each: the first request of a model also loads its layers' kernels), and
   one request without a vocoder: ``Synthesizer.griffin_lim`` at 30
   iterations, then ``make_spectrogram`` of the result (one K6 launch, held
   to K6's plain version on the same magnitudes).
4. Serves with loaded weights: writes the seeded full-width encoder and
   runtimeracer vocoder as the port's trainer files and the Tacotron as a
   reference ``.pt`` (with the decoder's r, a step buffer and BatchNorm's
   batch counters), loads them through ``encoder.load_model``,
   ``synthesizer.load_model`` and ``vocoder.load_model`` (each state equal
   bit for bit to the model it was written from), starts
   ``rtvc_tpu_torch.serve.create_server`` on a free loopback port and warms
   it as ``serve.main`` does (``vocoder.warmup`` and ``warm_clone`` on its
   model thread), then ``GET /health``, ``POST /embed``, three ``POST
   /clone`` of the 3 s prompt one at a time and two at once, then two ``POST
   /stream`` (chunked transfer of a streaming WAV; the client's time to the
   first audio byte and to the last; the PCM equal byte for byte to
   ``stream_clone`` replayed in process after ``set_seed``). Every answer is
   checked (200, a wav of (frames - 1) x 200 samples), the launches are K1
   and K2 once, K3 three times and K4 four times a clone (the warm clone
   included), plus K3 three times for /embed, warmup's K1 and the warm
   stream's launches (two chunks, three resumed K2 launches), and the three
   sequential clones replayed in process after ``set_seed`` give the same
   bytes. The Tacotron serves at its default ``max_decoder_steps``, so every
   kernel runs at shapes no other phase gives it (2000 frames: K2 over 1000
   iterations, K4 over the postnet's 2048 frames, K1 over 59 folds): each
   launch of the first served clone is held against its plain version on
   the inputs it was given (K2 and K1 with dropout off and greedy, at their
   phases' tolerances). Prints each request's wall time, the warm-up's, the
   first clone after it beside the second, and the replay's times, on lines
   that begin with the card's name and power limit. This phase runs first,
   so that the warm-up pays for the process's first launches.
4a. The browser toolbox (``phase_toolbox``, after the serve phase): the
   same checkpoints loaded again (the Tacotron cut to 400 frames), served by
   ``create_server(..., ui=True)`` over a samples directory of one of the
   repository's mp3s and a wav; ``GET /``, ``/api/samples``, ``POST
   /api/load`` by ``?sample=`` (the mp3 where libmpg123 or the codec shim
   decodes it, else its refusal checked and the wav loaded) and by a WAV
   body, ``/api/projection``, ``/api/synthesize?seed=3`` twice (equal
   bytes), ``/api/mel``, ``/api/autotune?n_seeds=3`` and ``GET /api/stream``;
   the launches counted (K3 three times an embedding, K2, K4 four times and
   K1 once a synthesis and an autotune seed, the stream's resumed K2, its
   postnets' K4 and its K1 once a chunk) and every one of them held to its
   plain version on the inputs it was given; ``/api/synthesize`` and an
   autotune timed without the recording. Then the native WaveRNN engine
   (``native/``): built with g++ from the copied sources, the vocoder
   exported to RTVCNAT1, a 20-frame mel decoded greedily and unfolded on the
   engine and on K1 (equal labels up to a near-tie, whose step is printed;
   samples within 2e-4 before it), and the clone's mel vocoded through
   ``vocoder.load_model(voc_type="libwavernn")`` on every host core, its
   rate in kHz beside K1's and the host CPU's model name.
4b. Streams (``inference.streaming.stream_clone``) at the default widths.
   With the kernels of 2., K2 resumed launch by launch at B 1 x T 64 and
   B 2 x T 32 over 200 iterations in launches of 8 and then 24: with
   dropout on the joined launches equal one launch in bits (mel, stops, the
   carried state); dropout off each launch within 1e-6 of the plain loop
   from the carry it was given; the stop token forced to fire inside a
   launch; a 24-iteration launch timed beside one of 200. After the clones
   of 3., five streamed clones of the 3 s prompt (a first chunk of 16
   frames, then 48), each one's time to the first audio, chunk emit times
   and real-time factor printed. The first is counted (K3 for the
   embedding, K4 for the encoder and each chunk's postnet, K2 and K1 once a
   chunk), its raw decoder frames equal ``synthesize_spectrograms``' K2
   frames bit for bit for the same seed, its samples number (Σ valid frames
   − 1) x 200, and its first chunk's postnet K4 and vocoder K1 launches are
   held to their plain versions.
4c. The non-autoregressive synthesizers at their default widths (seeded
   random weights, the duration head set to 6 frames a character: 384
   frames for a text in the 64-character bucket, 4.8 s). Five
   ForwardTacotron clones of the 3 s prompt through the public API (median,
   stage split; K3 twice for its BiLSTM and K4 ten times for its five
   BiGRUs a synthesis, plus the embedding's K3 and the vocoder's K1; every
   K3 and K4 launch of the first request held to its plain version on its
   own inputs), then K3 (B 1 x T 384 x H 512) and K4 (B 1, H 64 / 128 / 256
   at T 64 and H 256 at T 384) alone, each beside its bound, its plain
   version, cuDNN's ``nn.LSTM(1280, 512)`` / ``nn.GRU`` and every other plan
   the kernel has for the shape; five FastPitch clones (no K3 or K4 in
   the synthesize stage); one streamed ForwardTacotron clone (TTFA,
   cadence, (frames - 1) x 200 samples); ForwardTacotron written as a
   reference ``.pt`` and FastPitch as a port trainer file, loaded through
   ``synthesizer.load_model`` bit for bit, each serving one ``/clone`` and
   one ``/stream`` after ``warm_clone``.
5. Holds the training kernels against autograd through their plain
   versions and times both: K3 forward with residuals and backward at the
   GE2E training shape (640 x 160 x 768; two runs of its backward must give
   equal bits), K4 forward and backward at the
   vocoder training shapes (40 x 1000 x 256 for runtimeracer, 40 x 1000 x 512
   for fatchord, 40 x 1400 x 256 for geneing; W_hh resident in shared memory
   as for K3, the plans printed; two runs of its backward must give equal
   bits), and K4 at the Tacotron CBHG BiGRUs' shapes (H 64: 1 x 64 and 1 x
   512 for a clone, 112 x 160 and 112 x 602 for a training step) beside
   cuDNN's nn.GRU(64, 64) (the library yardstick, as at the other shapes),
   and, for the CBHG's whole BiGRU, cuDNN's bidirectional nn.GRU(128, 64)
   beside the port's GRU module.
   K5, the teacher-forced Tacotron decoder chain, forward and backward at the
   Tacotron training shape (112 rows x 86 iterations x 160 characters,
   D 256 / L 512 / E 896, zoneout masks at p 0.1, padded char mask) and at
   the schedule's last session (22 rows x 602 iterations), each direction
   split over the card (a grid barrier a phase: the plans are printed),
   beside the one-CTA-a-row kernels' times; two runs of each must give equal
   bits, and at 112 rows every candidate plan of each direction is held to
   its plain version and timed.
6. Trains at full width with seeded random weights: ``train_encoder`` for 3
   GE2E steps on (640, 160, 40) partials, then resumes from its checkpoint
   for a 4th; ``train_vocoder("runtimeracer-wavernn")`` for 5 steps on one
   batch of 40 x 1000 samples, then 3 steps each of ``fatchord-wavernn``
   (40 x 1000, two GRUs of 512) and ``geneing-wavernn`` (40 x 1400, BITS);
   ``train_synthesizer("tacotron")`` for 3 steps
   of its first session (r 7, batch 112, 602 frames, 160 characters) on one
   synthetic batch, then a resume for a 4th. Checks finite losses, the EER,
   the resume steps, falling vocoder and synthesizer losses, and each path's
   kernel launch counts (K4 four times each way a Tacotron step).

7. The non-autoregressive synthesizers' training. The alignment pass: the
   seeded Tacotron written as a trainer file, read back through
   ``TacotronAligner``, and ``create_align_features`` over five utterances of
   200-1200 frames (one K5 forward launch at B 1, r 1 each; five files each,
   durations summing to the mel, the first K5 launch held to its plain
   version, two passes equal in bits; ms an utterance with K5's device
   time). K3 forward with residuals and backward at ForwardTacotron's
   BiLSTM (B 16 and 48 x 900 x 512, every instantiation timed), K4 both ways
   at its BiGRUs' shapes (B 16: T 160 x H 64 / 128 / 256, T 900 x H 256) and
   K5's forward at B 1 x 1216 x 160, each beside its bound, its plain
   version and cuDNN. ``train_synthesizer`` for ForwardTacotron and
   FastPitch at full width, 3 steps and a resume each at B 16 x 900 frames x
   160 characters (falling losses; ForwardTacotron's K3 and K4 launches
   counted and those of its first step held to their plain versions on
   copies of their inputs; FastPitch launches no kernel of ours), then one
   ForwardTacotron step at B 48 with its peak memory.

8. The GTA pass and the trainers' samples (``phase_gta``,
   ``phase_gta_train``). A synthesizer corpus of 16 utterances of 200-1200
   frames (the last at ``max_mel_frames``) with texts of 40-159 characters,
   wavs, and the alignment pass's files (seeded durations summing to each
   mel); ``python -m rtvc_tpu_torch.vocoder_preprocess``'s ``main`` at
   ``--batch_size 8`` from a checkpoint of each type (Tacotron at r 2:
   two K5 forward launches at B 8, 334 and 602 iterations; ForwardTacotron:
   its BiLSTM through K3 and its BiGRUs through K4 at B 8 over the
   regulated frames; FastPitch). 16 mels of (frames, 80), finite, and a
   ``synthesized.json`` of 16 lines; every K5, K4 and K3 launch held to its
   plain version; a second pass equal in bits; a ``--skip_existing`` pass
   that writes nothing; ms an utterance per type, and each kernel at the
   pass's shapes beside its bound, plain version and cuDNN. Then the
   runtimeracer vocoder trained for 3 steps on the Tacotron pass's mels with
   the entry point's ``gen_hook`` at ``save_every`` 2 (``gen_testset``, its
   items cut to 2: K1 once an item, each launch held greedily to its plain
   version), and the Tacotron (K2 held to its plain version), ForwardTacotron
   and FastPitch evaluation hooks once each (ForwardTacotron's K3 and K4
   launches held to their plain versions): their wavs finite, their PNGs
   written exactly where matplotlib imports (the card's machine has none),
   each hook's time.

9. The bf16 training policy (``ops/precision.py``, ``phase_bf16_train``).
   K3's bf16 instantiation (bf16 streams and W_hh, f32 state), forward with
   residuals and backward, at the GE2E step's 640 x 160 x 768 and
   ForwardTacotron's BiLSTM, 16 and 48 x 900 x 512; K4's at runtimeracer's
   40 x 1000 x 256 and the Tacotron CBHG's 112 x 602 x 64: each held to its
   plain bf16 version (bf16 outputs within torch.testing's bf16 tolerance,
   f32 outputs within 1e-4) and timed beside the f32 kernel, the plain
   version and cuDNN in bf16; K3's plan names its design (the tensor-core
   mode of ``csrc/lstm_seq_mma.cu`` or the CUDA-core one of
   ``csrc/lstm_seq.cu``), and both designs are held and timed on the same
   inputs through explicit plans. Then three full-width bf16 steps of each trainer
   through its entry function on the f32 runs' weights and batches (GE2E,
   Tacotron, ForwardTacotron, FastPitch, runtimeracer): finite losses, f32
   master weights, the first loss within 5 % of the f32 run's, the launches
   of the bf16 path only (K5 in f32 for Tacotron), and the ms per step beside
   the f32 run's.

10. The vocoder's generation options (``phase_vocoder_options``, after the
   inference kernels). K1's three instantiations beside f32 / f32, (f32
   weights, bf16 streams), (bf16, bf16) and (bf16 weights, f32 streams), in
   all seven variant x head cells at 8 folds x 512 steps, greedy, against
   their plain versions at the same pair (head inputs within 1e-4 with f32
   weights, within 1e-3 with bf16 weights, whose rounded states part at
   bf16 midpoints; labels equal up to a near-tie) and timed beside the f32
   kernel on the same values; each at the 5 s clone's 13 folds x 8000
   steps, (bf16, bf16) held there too. Then ``set_generation_options``
   through the clone's vocode stage: f32, bf16 streams, bf16 weights and
   streams, bf16 weights, five requests each in turns (every launch on its
   instantiation's counter; ``stream_dtype=None`` returns to f32); what bf16
   does to the audio through the port's ``utils/genquality.py`` (greedy
   agreement, ``bench_quality.py``'s sampled mel divergence beside two
   seeds', ``fold_fidelity`` at the checkpoint's window and at 400 / 160,
   the mel-cepstral distortion; printed readings); a streamed clone and a
   ``vocode_pipelined`` batch at bf16 streams beside f32. After the GE2E
   training run, ``utils/dashboard.serve`` over its directory answers
   ``GET /`` and ``GET /data.json`` with the run's loss.

11. The SV2TTS preprocessing passes (``phase_preprocess``, after the
   alignment pass). A seeded corpus of 4 speakers x 4 utterances of 1.5-14 s
   (voiced segments between pauses, one speaker at 22 050 Hz, one in flac
   and one utterance in mp3 where the codec shim and libmp3lame are there)
   and three utterances the audio pass leaves out (past max_mel_frames,
   under utterance_min_duration, a transcript under min_text_len). Encoder
   preprocessing on four threads, read back by ``SpeakerVerificationDataset``
   (a 4 x 4 x 160 x 40 batch through the encoder on the card within 1e-4 of
   the CPU); the audio pass on the card (one K6 launch an utterance that
   reaches its mel, each kept one's held to its plain version and timed at
   its shape; four threads equal to
   one in bits; the CPU route's files equal, its mels within 2e-4); the
   embedding pass (three K3 launches an utterance, each held to its plain
   version, one cell a partial-batch size; four threads equal to one in
   bits; the CPU encoder within 1e-4); the alignment pass on their output and
   ``SynthesizerDataset`` serving every element the non-autoregressive
   trainers read. Each pass's ms an utterance on one and four threads beside
   its device time and the host's share.

12. Multi-GPU and the dataset tools (``phase_dp``, ``phase_dp_nccl``,
   ``phase_sharded_generation``, ``phase_scripts``, after the GTA phases).
   Two processes on the one card over gloo (NCCL refuses two ranks on one
   device; each is this script run as ``--dp-worker``) train GE2E (64 x 10
   x 160 global), runtimeracer (40 x 1000 global, pruning from step 0) and
   Tacotron (B 112 global, its first session) for 2 steps each on their
   rows of the same global batches this process trains on alone: the ranks
   end bitwise equal, only rank 0 writes a checkpoint, each rank's K3, K4
   and K5 launches of its first step are held to their plain versions, and
   each run is held to the one process's (GE2E within atol 1e-5, rtol
   1e-4; Tacotron and runtimeracer within 2e-4 / 1e-3 but for Adam's sign
   flips, at most two learning rates a step on at most 0.05 % of the
   entries (``DP_SHARE``; ``dp_fault_control.py`` reads what a planted
   fault gives), and, for runtimeracer, pruning groups swapped at a near-tie of their
   norms: ``dp_against_one``); each rank's ms per step beside the one
   process's, two processes sharing one card, not a multi-GPU speed. Then
   one process in an NCCL group of one (``setup_from_args`` with
   ``RTVC_NUM_PROCESSES=1``) takes the GE2E steps, equal to the run without
   a group. K1 through ``parallel/generation.py:generate_sharded`` at the
   clone's 13 folds x 8000 steps over ``[cuda:0]`` and ``[cuda:0, cuda:0]``,
   greedy, against one launch (within 1e-6, or a near-tie), each launch
   held to its plain version over 512 steps. ``scripts/ted_project``'s copy
   on 2 speakers x 3 utterances (18 K3 launches held to their plain
   versions, the embeddings against the CPU's; its plot raises the port's
   ImportError where matplotlib is missing).

13. The DeepMind dual-softmax WaveRNN (``phase_deepmind``, after the
   non-autoregressive training runs) at full width (hidden 896,
   quantisation 256), seeded: K4 alone at B 40 x 1000 x 896 both ways (the
   cooperative plan, one group of 112 slices of 8 units), held to its plain
   versions and timed beside cuDNN's ``nn.GRU(3, 896)``; three Adam steps of
   ``deepmind_loss`` at B 40 x 1001 labels of a harmonic waveform (finite,
   falling losses, K4 once each way a step, the first step's launches held
   to their plain versions); ``generate`` at batch 1 and 4 x 16,000 samples
   (the same seed the same waveform, with and without the loop's CUDA
   graphs; the drawn labels teacher-forced through K4 give the logits they
   were drawn from within 1e-3; kHz printed). K4's entries get the H 896
   cells and the training run's launches.

K1's, K3's and K4's lines also give the times of the earlier kernels (one
CTA per fold or batch row, the weights re-read from L2 every step) on the
same card model, K3's its time as a share of its time before K4 and K1 came
to share its helpers, and K6's line the kernel's device time apart from its
wrapper's.

Beside each kernel's time it gives the least time the card could take for the
same work (``bound_ms``: the larger of the bytes the function must move, each
input read once and each output written once, over the card's memory rate, and
its operations over the card's f32 rate, its bf16 tensor-core rate for the bf16
instantiations), and where one PyTorch call computes
the same function (cuDNN's ``nn.LSTM`` / ``nn.GRU``, ``torch.matmul`` for K6's
product) that call's time.

Prints the card, each phase, one JSON line describing the kernels, and as
its last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, without a CUDA device or if any phase fails.
"""
import contextlib
import importlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps=3):
    """Mean milliseconds of ``fn()`` on the card, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# Published peaks of one H100 SXM (NVIDIA's data sheet): f32 outside the tensor
# cores, dense bf16 in them, and device memory. Every kernel here computes in
# f32; the bf16 instantiations' bounds take the bf16 peak for the same work.
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, peak=F32_FLOPS):
    """The least milliseconds the card could take, and which side sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations"}


def device_ms(fn, reps=20):
    """Mean milliseconds of device time of the kernels ``fn()`` launches (the
    profiler's self device time, without the host's part of a call), after
    one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    check(us > 0, "the profiler recorded no device time")
    return us / reps / 1e3


def kernels_device_ms(fn):
    """Device ms of one ``fn()`` by kernel, after one warm-up call: each of
    the port's own kernels (csrc/) by name, the rest as "other", and "all"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rtvc_tpu_torch.profile_train import kernel_name, own_kernels

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names, out = own_kernels(), {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = kernel_name(e.key)
            name = name if name in names else "other"
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    check(out, "the profiler recorded no device time")
    out["all"] = sum(out.values())
    return out


# K3 before W_hh became resident in shared memory (one CTA per batch row that
# re-read W_hh from L2 every step), CUDA-event ms on an NVIDIA H100 80GB HBM3 at
# 700 W: inference forward at 8 x 160 x 768, training forward and backward
# at 640 x 160 x 768. Printed beside the new times in the phases' own lines
# only: the "kernels" line holds what this run measured.
K3_EARLIER_MS = {"fwd": 19.201, "fwd_train": 128.434, "bwd": 117.167}
# K3's times with W_hh resident in shared memory, before the other kernels
# came to share its helpers (common.cuh), on the same card model and power
# limit: this run's K3 lines give their time as a share of these.
K3_RESIDENT_MS = {"fwd": 0.770, "fwd_train": 17.707, "bwd": 19.388}
# K4 with one CTA per batch row (W_hh re-read from L2 every step), forward /
# backward CUDA-event ms on an NVIDIA H100 80GB HBM3 at 700 W, by (B, T, H);
# and at the narrow widths (H <= 128) the cooperative plan, before the
# row-resident mode took them, on the same card model and power limit, from
# PERF.md section 6 (None where that call timed no backward: the GTA pass's).
# Printed beside the new times in the phases' own lines only, as an earlier
# call's: the same call's cooperative time is printed beside them.
K4_EARLIER_MS = {(40, 1000, 256): (14.695, 11.296), (40, 1000, 512): (45.079, 39.280),
                 (40, 1400, 256): (20.621, 15.835)}
K4_COOPERATIVE_EARLIER_MS = {
    (1, 64, 64): (0.265, 0.144), (1, 512, 64): (1.816, 0.939), (112, 160, 64): (0.699, 0.446),
    (112, 602, 64): (2.581, 1.533), (56, 602, 64): (2.369, 1.408),
    (16, 160, 64): (0.653, 0.385), (16, 160, 128): (0.401, 0.430),
    (8, 160, 64): (0.644, None), (8, 160, 128): (0.393, None)}
# K1 with one CTA per fold (the weights re-read from L2 every step), greedy
# 8 folds x 512 steps, ms on the same card, by cell.
K1_EARLIER_MS = {"fatchord-wavernn RAW": 90.739, "fatchord-wavernn MOL": 83.330,
                 "geneing-wavernn BITS": 19.827, "geneing-wavernn RAW": 16.519,
                 "geneing-wavernn MOL": 14.266, "runtimeracer-wavernn RAW": 64.415,
                 "runtimeracer-wavernn MOL": 57.882}


def phase_barrier(dev):
    """The grid barrier alone: launches of 1000 barriers and nothing else, over
    one CTA per SM and over K3's two grids at H 768; microseconds a barrier."""
    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.ops.lstm_seq import grid_barrier_steps

    sms, smem = _build.device_limits(dev)
    steps = 1000
    us = {n: cuda_ms(lambda: grid_barrier_steps(n, steps, dev)) / steps * 1e3
          for n in (sms, 128, 64)}
    print(f"grid barrier on {sms} SMs ({smem} bytes of shared memory a block): "
          + ", ".join(f"{n} CTAs {t:.3f} us" for n, t in us.items()) + " a barrier")
    return us


def k3_plan(B, H, dev, backward=False, elem=4):
    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.ops.lstm_seq import describe, plan

    return describe(plan(B, H, *_build.device_limits(dev), backward=backward, elem=elem))


def rnn_ms(rnn, B, T, H, dev, backward=True, dtype=None):
    """(forward ms, backward ms) of a recurrence module over (B, T,
    ``rnn.input_size``) inputs in f32 (``rtvc_tpu_torch`` switches TF32 off
    when it is imported), or in ``dtype`` (module and inputs): cuDNN's as
    the yardstick beside K3 and K4, or the port's ``GRU``; it includes the
    input projection, which the kernels leave to a matmul outside. The
    backward is the time of forward plus backward less the forward's; with
    ``backward=False`` the forward runs without a graph and the second value
    is None."""
    import torch

    dtype = dtype or torch.float32
    g = torch.Generator().manual_seed(10)
    x = torch.randn(B, T, rnn.input_size, generator=g).to(dev, dtype).requires_grad_(backward)
    dys = torch.randn(B, T, H * (2 if rnn.bidirectional else 1), generator=g).to(dev, dtype)
    rnn = rnn.to(dev, dtype).train(backward)
    with torch.set_grad_enabled(backward):
        fwd = cuda_ms(lambda: rnn(x))
    if not backward:
        return fwd, None
    return fwd, cuda_ms(lambda: rnn(x)[0].backward(dys)) - fwd


def phase_lstm(dev):
    import torch

    from rtvc_tpu_torch.ops.lstm_seq import lstm_seq, lstm_seq_plain

    B, T, H = 8, 160, 768
    g = torch.Generator().manual_seed(0)
    xg = torch.randn(B, T, 4 * H, generator=g).to(dev)
    w_hh = ((torch.rand(4 * H, H, generator=g) * 2 - 1) * H ** -0.5).to(dev)
    h0 = (torch.randn(B, H, generator=g) * 0.5).to(dev)
    c0 = (torch.randn(B, H, generator=g) * 0.5).to(dev)
    got = lstm_seq(xg, w_hh, h0, c0)
    ref = lstm_seq_plain(xg, w_hh, h0, c0)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    check(err <= 1e-4, f"K3 lstm_seq differs from its plain version: {err}")
    ms = cuda_ms(lambda: lstm_seq(xg, w_hh, h0, c0))
    plain_ms = cuda_ms(lambda: lstm_seq_plain(xg, w_hh, h0, c0))
    library_ms, _ = rnn_ms(torch.nn.LSTM(H, H, batch_first=True), B, T, H, dev,
                           backward=False)
    b = bound(nbytes(xg, w_hh, h0, c0, *got), 2 * B * T * 4 * H * H)
    print(f"K3 lstm_seq B={B} T={T} H={H} ({k3_plan(B, H, dev)}): max_abs_err {err:.3e} "
          f"(tol 1e-4), kernel {ms:.3f} ms ({ms / K3_RESIDENT_MS['fwd']:.3f} of "
          f"{K3_RESIDENT_MS['fwd']} ms before the sharing; earlier kernel "
          f"{K3_EARLIER_MS['fwd']} ms), "
          f"plain {plain_ms:.3f} ms, nn.LSTM {library_ms:.3f} ms, "
          f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    return {"name": "lstm_seq", "source": "rtvc_tpu_torch/csrc/lstm_seq.cu",
            "replaces": "rtvc_tpu/ops/pallas/lstm_train_kernel.py:300",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": library_ms}


# K2 as one CTA that streamed every weight out of L2 each iteration (before it
# was split over the card), 200 iterations at r 2, dropout off, CUDA-event ms
# on an NVIDIA H100 80GB HBM3 at 700 W, by (B, T): the mean of two runs of
# `profile_tacotron.py --wrapper` over that package, in one call with the split
# kernel. Printed beside the new times in the phase's own lines only.
K2_EARLIER_MS = {(1, 64): 131.332, (2, 32): 144.811, (24, 160): 4331.052}
# (B, T) of K2's three cells: the clone's one text (its 64-character bucket),
# two texts of 32, and the synthesis batch of 24 in a long-sentence bucket.
K2_SHAPES = ((1, 64), (2, 32), (24, 160))


def k2_check(model, d, seq, proj, mask, r, max_steps):
    """K2 against its plain version on the same encoder outputs, dropout
    off: the same stop iteration, mel within 1e-4, attention within 1e-5.
    Returns the kernel's (mel, attention, stops), its stop iteration and
    the two errors."""
    import torch

    from rtvc_tpu_torch.models import tacotron as taco
    from rtvc_tpu_torch.ops import tacotron_decode as td

    B, T = mask.shape
    with torch.no_grad():
        km, ka, ks = td.tacotron_decode(model, d, seq, proj, mask, 0, r, max_steps, False)
        pm, pa, ps = td.tacotron_decode_plain(model, d, seq, proj, mask, 0, r, max_steps, False)
        torch.cuda.synchronize()
    n_k, n_p = taco.stop_iterations(ks, r), taco.stop_iterations(ps, r)
    err_mel = float((km - pm).abs().max())
    err_attn = float((ka - pa).abs().max())
    per_iter = (km - pm).abs().amax(dim=(0, 1)).reshape(-1, r).amax(dim=1)
    bad = torch.nonzero(per_iter > 1e-4)
    check(n_k == n_p, f"K2 B={B} T={T}: stop iteration {n_k} != plain {n_p}")
    check(err_mel <= 1e-4, f"K2 B={B} T={T}: mel differs from its plain version: {err_mel}"
          f" (first iteration over tol {int(bad[0]) if len(bad) else None})")
    check(err_attn <= 1e-5, f"K2 B={B} T={T}: attention differs from its plain version: "
          f"{err_attn}")
    return km, ka, ks, n_k, err_mel, err_attn


def k2_bound(model, d, r, n_k, B, T, *tensors):
    """K2's bound for n_k iterations at B x T: each weight applied once to
    each of the B rows an iteration (of mel_proj only the r frames' rows
    are read), ``tensors`` read or written once."""
    dec = model.decoder
    mats = [dec.prenet.fc1.weight, dec.prenet.fc2.weight, dec.attn_rnn.weight_ih,
            dec.attn_rnn.weight_hh, dec.attn_net.W.weight, dec.rnn_input.weight,
            dec.res_rnn1.weight_ih, dec.res_rnn1.weight_hh, dec.res_rnn2.weight_ih,
            dec.res_rnn2.weight_hh, dec.stop_proj.weight]
    mel_rows = r * d.n_mels * d.lstm_dims
    NF, _, KS = dec.attn_net.conv.weight.shape
    attention = T * (NF * KS + d.decoder_dims * NF + d.decoder_dims + d.enc_out_dims)
    flops = 2 * n_k * B * (sum(m.numel() for m in mats) + mel_rows + attention)
    return bound(nbytes(*mats, *tensors) + 4 * mel_rows, flops)


def k2_cell(dev, syn, B, T):
    """K2 at one shape against its plain version (dropout off: the same stop
    iteration, mel within 1e-4, attention within 1e-5), its seeded dropout,
    and its time beside the plain version's and its bound."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.models import tacotron as taco
    from rtvc_tpu_torch.ops import tacotron_decode as td

    d, model = syn.dims, syn.model
    r, max_steps = 2, (syn.config.max_decoder_steps // 2) * 2
    g = torch.Generator().manual_seed(1)
    chars = torch.randint(1, d.num_chars, (B, T), generator=g)
    lengths = torch.randint(T * 5 // 8, T + 1, (B,), generator=g)
    for b in range(B):
        chars[b, int(lengths[b]):] = 0
    spk = torch.randn(B, d.speaker_embedding_size, generator=g)
    spk = spk / spk.norm(dim=1, keepdim=True)
    p = td.plan(B, T, td.DecoderShape.of(model, d), r, *_build.device_limits(dev))
    with torch.no_grad():
        seq, proj = taco.encode(model, chars.to(dev), spk.to(dev), prenet_dropout=False)
        seq, proj = seq.contiguous(), proj.contiguous()
        mask = (chars != 0).float().to(dev)
        km, ka, ks, n_k, err_mel, err_attn = k2_check(model, d, seq, proj, mask, r, max_steps)

        def kernel(seed=0, dropout=False):
            return td.tacotron_decode(model, d, seq, proj, mask, seed, r, max_steps, dropout)

        def plain():
            return td.tacotron_decode_plain(model, d, seq, proj, mask, 0, r, max_steps, False)

        a1, a2, b1 = kernel(1, True)[0], kernel(1, True)[0], kernel(2, True)[0]
        check(torch.equal(a1, a2), f"K2 B={B} T={T} dropout: one seed does not repeat")
        check(not torch.equal(a1, b1), f"K2 B={B} T={T} dropout: two seeds give the same mel")
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, reps=2)
    b = k2_bound(model, d, r, n_k, B, T, seq, proj, mask, km, ka, ks)
    print(f"K2 tacotron_decode B={B} T={T} iters={n_k}/{ks.shape[1]} (plan: {p.ctas} CTAs, "
          f"weights {'resident' if p.resident else 'read from L2'}, {p.nb} rows an item, "
          f"{p.smem} bytes of shared memory a CTA): mel err {err_mel:.3e} (tol 1e-4), attn "
          f"err {err_attn:.3e} (tol 1e-5); dropout seeded: repeat ok, seeds differ; kernel "
          f"{ms:.3f} ms ({ms / n_k * 1e3:.2f} us an iteration; one-CTA kernel "
          f"{K2_EARLIER_MS[(B, T)]} ms), plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"by {b['bound_by']}")
    return {"max_abs_err": max(err_mel, err_attn), "ms": ms, "plain_ms": plain_ms, **b}


def phase_tacotron(dev, syn):
    """K2 at its three cells; the kernels line takes the clone's (B 1 x T 64)
    times and the largest error of the three."""
    cells = {shape: k2_cell(dev, syn, *shape) for shape in K2_SHAPES}
    clone = cells[K2_SHAPES[0]]
    return {"name": "tacotron_decode", "source": "rtvc_tpu_torch/csrc/tacotron_decode.cu",
            "replaces": "rtvc_tpu/ops/pallas/tacotron_kernel.py:427",
            **clone, "max_abs_err": max(c["max_abs_err"] for c in cells.values()),
            "library_ms": None}


# K2 resumed chunk by chunk: (B, T) of its cells, and the launches a decode
# of 200 iterations is cut into, the stream's (a first chunk of 16 frames,
# then 48, at r 2).
K2_CHUNK_SHAPES = ((1, 64), (2, 32))
K2_CHUNK_ITERS = (8, 24)
K2_PAD = -4.0


def k2_chunks(model, d, seq, proj, mask, seed, r, cuts, dropout, min_iters=0):
    """A decode as K2 launches of ``cuts`` iterations, each resumed from the
    last one's carry (on the CPU, the plain loop's draws from one generator
    through them all): [((carry, prev, done, start, n) it was given, its
    DecodeChunk)]."""
    import torch

    from rtvc_tpu_torch.ops import tacotron_decode as td

    state = k2_zero_state(d, *mask.shape, mask.device)
    g = torch.Generator(device=mask.device).manual_seed(seed)  # the plain version's draws
    outs, start = [], 0
    for n in cuts:
        out = td.tacotron_decode_chunk(model, d, seq, proj, mask, seed, r, *state, start, n,
                                       min_iters, K2_PAD, dropout, g)
        outs.append(((*state, start, n), out))
        state, start = (out.carry, out.prev, out.done), start + n
    return outs


def k2_zero_state(d, B, T, dev):
    """(carry, prev, done) at the start of a decode."""
    import torch

    from rtvc_tpu_torch.models import tacotron as taco

    return (taco.init_decoder_carry(d, B, T, device=dev), torch.zeros(B, d.n_mels, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def k2_state(out):
    return (*out.carry, out.prev)


def k2_chunk_check(model, d, seq, proj, mask, r, cuts, min_iters=0):
    """Each launch of a chunked decode, dropout off, against the plain loop
    from the carry it was given: the same valid iterations and stop, mel
    within 1e-6, attention and the carry out within 1e-5 relative. Returns
    the launches and the largest mel and carry errors."""
    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops import tacotron_decode as td

    B, T = mask.shape
    outs = k2_chunks(model, d, seq, proj, mask, 0, r, cuts, False, min_iters)
    err_mel = err_carry = 0.0
    for (carry, prev, done, start, n), out in outs:
        ref = td.tacotron_decode_chunk_plain(model, d, seq, proj, mask, 0, r, carry, prev, done,
                                             start, n, min_iters, K2_PAD, False)
        where = f"K2 chunk B={B} T={T} iterations {start}-{start + n - 1}"
        check((int(out.valid), int(out.done)) == (int(ref.valid), int(ref.done)),
              f"{where}: valid / done {int(out.valid)} / {int(out.done)}, plain "
              f"{int(ref.valid)} / {int(ref.done)}")
        err_mel = max(err_mel, float((out.mel - ref.mel).abs().max()))
        err_carry = max(err_carry, rel_err(out.attn, ref.attn),
                        *(rel_err(a, b) for a, b in zip(k2_state(out), k2_state(ref))))
        check(err_mel <= 1e-6, f"{where}: mel differs from the plain loop from its carry: "
              f"{err_mel}")
        check(err_carry <= 1e-5, f"{where}: attention or carry differs from the plain loop's "
              f"by {err_carry} (relative)")
    return outs, err_mel, err_carry


def k2_chunk_cell(dev, syn, B, T):
    """K2 resumed launch by launch at one shape, full width: with dropout on
    the chunks of 200 iterations (8, then 24 at a time) joined equal one
    launch of 200 in bits (mel, stops, the carry) and the whole-utterance
    launch too; dropout off each launch is held to the plain loop from its
    carry (``k2_chunk_check``); the stop token forced on fires in the middle
    of a launch (valid iterations, the pad, the carry frozen at the stop, and
    a launch after it that writes only the pad); then the time of one 24-
    iteration launch against one of 200 and its bound."""
    import torch

    from rtvc_tpu_torch.ops import tacotron_decode as td

    d, model = syn.dims, syn.model
    r, n_total = 2, 200
    cuts = [K2_CHUNK_ITERS[0]]
    while sum(cuts) < n_total:
        cuts.append(min(K2_CHUNK_ITERS[1], n_total - sum(cuts)))
    g = torch.Generator().manual_seed(4)
    chars = torch.randint(1, d.num_chars, (B, T), generator=g)
    chars[:, T - T // 8:] = 0
    spk = torch.nn.functional.normalize(torch.randn(B, d.speaker_embedding_size, generator=g))
    with torch.no_grad():
        seq, proj = (t.contiguous() for t in taco_encode(model, chars, spk, dev))
        mask = (chars != 0).float().to(dev)
        [(_, one)] = k2_chunks(model, d, seq, proj, mask, 11, r, [n_total], True)
        parts = [out for _, out in k2_chunks(model, d, seq, proj, mask, 11, r, cuts, True)]
        whole = td.tacotron_decode(model, d, seq, proj, mask, 11, r, 2 * n_total, True)
        torch.cuda.synchronize()
        where = f"K2 chunks B={B} T={T} {cuts[0]}, then {cuts[1]} iterations, dropout on"
        check(all(torch.equal(torch.cat([getattr(o, k) for o in parts], 1 + (k == "mel")),
                              getattr(one, k)) for k in ("mel", "attn", "stops")),
              f"{where}: the joined chunks differ from one launch")
        check(all(torch.equal(a, b) for a, b in zip(k2_state(parts[-1]), k2_state(one))),
              f"{where}: the final carry differs from one launch's")
        check(sum(int(o.valid) for o in parts) == int(one.valid) == n_total,
              f"{where}: {[int(o.valid) for o in parts]} valid iterations, one launch "
              f"{int(one.valid)}")
        check(torch.equal(whole[0], one.mel) and torch.equal(whole[2], one.stops),
              f"{where}: the whole-utterance launch differs from the resumable one")
        outs, err_mel, err_carry = k2_chunk_check(model, d, seq, proj, mask, r, cuts)
        # every stop token on: it fires at iteration 6 (the first past step
        # 10), and at 9 when min_iters holds it off
        bias = model.decoder.stop_proj.bias.clone()
        model.decoder.stop_proj.bias.fill_(30.0)
        try:
            stops = []
            for min_iters, at in ((0, 6), (9, 9)):
                s_outs, s_mel, s_carry = k2_chunk_check(model, d, seq, proj, mask, r, [4] * 4,
                                                        min_iters)
                valid = [int(o.valid) for _, o in s_outs]
                want = [min(4, max(0, at + 1 - 4 * i)) for i in range(4)]
                check(valid == want, f"K2 chunk B={B} T={T} stop forced (min_iters "
                      f"{min_iters}): valid {valid}, want {want}")
                for (carry, prev, done, _, _), o in s_outs[at // 4 + 1:]:
                    check(bool((o.mel == K2_PAD).all()) and all(
                        torch.equal(a, b) for a, b in zip(k2_state(o), (*carry, prev))),
                          f"K2 chunk B={B} T={T}: a launch after the stop wrote more than "
                          f"the pad or moved the carry")
                stopped = s_outs[at // 4][1]
                check(bool((stopped.mel[:, :, 2 * valid[at // 4]:] == K2_PAD).all()),
                      f"K2 chunk B={B} T={T}: no pad after the stop")
                stops.append(f"fired at {at} (min_iters {min_iters}): valid {valid}, mel "
                             f"{s_mel:.1e}, carry {s_carry:.1e} from the plain loop")
                err_mel, err_carry = max(err_mel, s_mel), max(err_carry, s_carry)
        finally:
            model.decoder.stop_proj.bias.copy_(bias)
        (carry, prev, done, start, n) = outs[1][0]

        def chunk():
            return td.tacotron_decode_chunk(model, d, seq, proj, mask, 0, r, carry, prev, done,
                                            start, n, 0, K2_PAD, False)

        def plain_chunk():
            return td.tacotron_decode_chunk_plain(model, d, seq, proj, mask, 0, r, carry, prev,
                                                  done, start, n, 0, K2_PAD, False)

        ms = cuda_ms(chunk)
        zero = k2_zero_state(d, B, T, dev)
        ms_one = cuda_ms(lambda: td.tacotron_decode_chunk(
            model, d, seq, proj, mask, 0, r, *zero, 0, n_total, 0, K2_PAD, False), reps=2)
        plain_ms = cuda_ms(plain_chunk, reps=2)
        out = chunk()
    b = k2_bound(model, d, r, n, B, T, seq, proj, mask, out.mel, out.attn, out.stops,
                 *carry, prev, *k2_state(out))
    print(f"K2 tacotron_decode_chunk B={B} T={T}: {len(cuts)} launches ({cuts[0]}, then "
          f"{cuts[1]} iterations) joined equal one launch of {n_total} in bits with dropout on "
          f"(mel, attention, stops, carry), and the whole-utterance launch; dropout off each "
          f"launch within mel {err_mel:.3e} (tol 1e-6), attention and carry {err_carry:.3e} "
          f"relative (tol 1e-5) of the plain loop from its carry; stop forced: "
          + "; ".join(stops) + f"; a {n}-iteration launch {ms:.3f} ms ({ms / n * 1e3:.2f} us an "
          f"iteration), one of {n_total} {ms_one:.3f} ms ({ms_one / n_total * 1e3:.2f} us), plain "
          f"{plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    return {"max_abs_err": err_mel, "carry_rel_err": err_carry, "ms": ms, "plain_ms": plain_ms,
            "one_launch_ms": ms_one, **b}


def taco_encode(model, chars, spk, dev):
    from rtvc_tpu_torch.models import tacotron as taco

    return taco.encode(model, chars.to(dev), spk.to(dev), prenet_dropout=False)


def phase_tacotron_chunks(dev, syn):
    """K2 resumed (``k2_chunk_cell``) at its two cells; the kernels line
    takes the stream's (B 1 x T 64) times and the largest error."""
    cells = {shape: k2_chunk_cell(dev, syn, *shape) for shape in K2_CHUNK_SHAPES}
    clone = cells[K2_CHUNK_SHAPES[0]]
    return {"name": "tacotron_decode_chunk", "source": "rtvc_tpu_torch/csrc/tacotron_decode.cu",
            "replaces": "rtvc_tpu/ops/pallas/tacotron_kernel.py:427",
            **clone, "max_abs_err": max(c["max_abs_err"] for c in cells.values()),
            "library_ms": None}


# The fold counts the clone path (phase_clone) gives each variant's K1: a
# 5 s request at the variant's window, and for runtimeracer also the batched
# vocode of three requests. The fold count picks the kernel's items (4 or 8
# folds) and its fold blocks.
K1_MAIN_FOLDS = {"runtimeracer-wavernn": (13, 39), "fatchord-wavernn": (20,),
                 "geneing-wavernn": (20,)}
# K1's instantiations beside f32 / f32 (the vocoder's generation options):
# (compute_dtype, stream_dtype), and the head inputs' tolerance against the
# plain version by compute dtype. bf16 weights round the carried states and
# the fed-back sample, and the kernel's and the plain version's f32 sums, a
# few units apart, round to different bf16 values where they lie that close
# to a midpoint: a state moves by one bf16 unit there (measured on an H100
# at 8 folds x 512 steps: up to 1.2e-4). tests/test_torch_cuda.py's rounding
# probe holds each rounding point to 1e-4 where no sum's order matters.
K1_PAIRS = (("f32", "bf16"), ("bf16", "bf16"), ("bf16", "f32"))
K1_PAIR_TOL = {"f32": 1e-4, "bf16": 1e-3}
K1_CELLS = (("fatchord-wavernn", "RAW"), ("fatchord-wavernn", "MOL"),
            ("geneing-wavernn", "BITS"), ("geneing-wavernn", "RAW"), ("geneing-wavernn", "MOL"),
            ("runtimeracer-wavernn", "RAW"), ("runtimeracer-wavernn", "MOL"))


def voc_model(model_type, mode, dev, seed=0):
    """A full-width vocoder of a variant in a mode, seeded random weights."""
    from rtvc_tpu_torch.models import factories

    cfg = factories.default_config(model_type).replace(mode=mode)
    return factories.init_voc_model(model_type, seed=seed, override_hp=cfg, device=dev)


def k1_streams(voc, B, T, seed, dev):
    """Seeded conditioning streams of B folds x T steps for a vocoder."""
    import torch

    from rtvc_tpu_torch.models import wavernn as wrn

    d = voc.dims
    g = torch.Generator().manual_seed(seed)
    mels_up = (torch.rand(B, T, d.feat_dims, generator=g) * 2 - 1).to(dev)
    aux = (torch.randn(B, T, d.res_out_dims, generator=g) * 0.5).to(dev)
    with torch.no_grad():
        return {k: v.contiguous() for k, v in wrn.hoist_aux(voc.model, d, mels_up, aux).items()}


def k1_check(d, w, streams, tol=1e-4):
    """Greedy K1 against its plain version on the same streams (at their
    dtypes: the instantiation they pick). Categorical heads: equal class
    labels (a fold is cut at a near-tie of the two top logits), logits
    within ``tol``, samples within 1e-6. MOL and beta heads feed a
    continuous sample back: samples and head inputs within ``tol`` over all
    steps (MOL: up to a near-tie of the two most likely components).
    ``tol`` is 1e-4, and 1e-3 for bf16 weights (``K1_PAIR_TOL``). Under
    bf16 weights the fed-back sample is rounded to bf16 and the beta head's
    greedy sample, the mode (α − 1)/(α + β − 2) or the mean past α, β = 1,
    moves by more than ``tol`` for head inputs within it where α + β nears 2
    or at the branch: there a beta fold is cut where its head inputs still
    agree within ``tol`` and the kernel's sample is the plain head's on the
    kernel's own head inputs (within 1e-5), the beta head's counterpart of
    a near-tie. Returns the kernel's samples, the head inputs' and the
    samples' largest errors, the samples' tolerance and the folds cut at a
    near-tie."""
    import torch

    from rtvc_tpu_torch.ops.wavernn_generate import (
        _head_sample,
        wavernn_generate_core,
        wavernn_generate_core_plain,
    )

    cell = f"{d.variant} {d.mode}"
    kw = dict(variant=d.variant, head=d.head)
    rounded = w["i_col"].dtype == torch.bfloat16
    with torch.no_grad():
        got, k_logits = wavernn_generate_core(w, streams, 0, argmax=True, return_logits=True,
                                              **kw)
        ref, p_logits = wavernn_generate_core_plain(w, streams, 0, argmax=True,
                                                    return_logits=True, **kw)
        torch.cuda.synchronize()
    B, T = got.shape
    where = f"K1 {cell} at {B} folds x {T} steps"
    if w["i_col"].dtype != torch.float32 or streams["i_cond"].dtype != torch.float32:
        where += f" ({w['i_col'].dtype}, {streams['i_cond'].dtype})"
    C, head_tol = d.n_classes, tol
    err, sample_err, flips = 0.0, 0.0, 0
    for b in range(B):
        if d.head == "categorical":
            # Samples are compared as class labels: the label → [-1, 1]
            # division may round differently by one ulp in the two versions.
            differ = torch.round((got[b] + 1) * (C - 1) / 2) != torch.round(
                (ref[b] + 1) * (C - 1) / 2)
            choice, tol = p_logits[b], 1e-6
        else:
            differ = (got[b] - ref[b]).abs() > head_tol
            choice, tol = p_logits[b, :, :C // 3], head_tol
        idx = torch.nonzero(differ)
        t_end = int(idx[0]) if len(idx) else T
        if t_end < T:
            noise = float((k_logits[b, t_end] - p_logits[b, t_end]).abs().max())
            growth = [float((got[b, :t + 1] - ref[b, :t + 1]).abs().max())
                      for t in range(0, t_end + 1, max(t_end // 8, 1))]
            print(f"{where}, fold {b}: samples differ first at step {t_end}, head input "
                  f"difference {noise:.3e}; sample difference by step {growth}")
            check(d.head != "beta" or rounded,
                  f"{where}: greedy samples differ at fold {b} step {t_end}")
            if d.head == "beta":
                again = _head_sample("beta", k_logits[b, t_end][None], True, None)
                off = abs(float(again[0]) - float(got[b, t_end]))
                check(noise <= head_tol and off <= 1e-5,
                      f"{where}: the beta sample parts at fold {b} step {t_end} with head "
                      f"inputs {noise} apart and {off} from the plain head's on them")
            else:
                # a near-tie: the plain version's top-2 gap (classes, or
                # mixture components) is within the two versions'
                # disagreement there
                top2 = torch.topk(choice[t_end], 2).values
                gap = float(top2[0] - top2[1])
                check(gap <= 2 * noise, f"{where}: greedy decode differs at fold {b} step "
                      f"{t_end} with a gap of {gap}, above twice the head input difference "
                      f"{noise}")
            flips += 1
        t_cmp = min(t_end + 1, T)
        err = max(err, float((k_logits[b, :t_cmp] - p_logits[b, :t_cmp]).abs().max()))
        if t_end:
            sample_err = max(sample_err, float((got[b, :t_end] - ref[b, :t_end]).abs().max()))
    check(err <= head_tol, f"{where}: head inputs differ from the plain version's: {err}")
    check(sample_err <= tol, f"{where}: greedy samples differ: {sample_err}")
    check(bool(torch.isfinite(got).all()) and float(got.std()) > 0, f"{where}: output")
    return got, err, sample_err, tol, flips


def k1_pair(w, streams, pair):
    """Weights and streams cast to a (compute_dtype, stream_dtype) pair of
    names, as ``models.wavernn.generate_core`` casts them."""
    from rtvc_tpu_torch.ops import precision

    compute, stream = (precision.resolve(n) for n in pair)
    return ({k: v.to(compute) for k, v in w.items()},
            {k: v.to(stream).contiguous() for k, v in streams.items()})


def k1_greedy_cell(dev, voc, B=8, T=512, pair=None):
    """One variant x head cell of K1 at full width, greedy, kernel against
    plain (``k1_check``), timed. With ``pair`` (compute_dtype, stream_dtype)
    the instantiation of that pair on the cell's weights and streams cast to
    it, at its tolerance, its plan and its bound, with the f32 kernel timed
    beside it on the values before the cast. Returns the cell's errors,
    times and bound, and the cell's f32 weights and streams."""
    import torch

    from rtvc_tpu_torch.models import wavernn as wrn
    from rtvc_tpu_torch.ops.wavernn_generate import (
        wavernn_generate_core,
        wavernn_generate_core_plain,
    )

    d, model = voc.dims, voc.model
    cell = f"{d.variant} {d.mode}"
    kw = dict(variant=d.variant, head=d.head)
    f32_streams = k1_streams(voc, B, T, 2, dev)
    with torch.no_grad():
        f32_w = wrn.step_weights(model, d)
    pair = pair or ("f32", "f32")
    w, streams = k1_pair(f32_w, f32_streams, pair)
    head_tol = K1_PAIR_TOL[pair[0]]
    got, err, sample_err, tol, flips = k1_check(d, w, streams, head_tol)
    with torch.no_grad():
        ms = cuda_ms(lambda: wavernn_generate_core(w, streams, 0, argmax=True, **kw))
        plain_ms = cuda_ms(lambda: wavernn_generate_core_plain(w, streams, 0, argmax=True, **kw),
                           reps=1)
        f32_ms = ms if pair == ("f32", "f32") else cuda_ms(
            lambda: wavernn_generate_core(f32_w, f32_streams, 0, argmax=True, **kw))
    b = k1_bound(w, streams, got)
    p = k1_plan(d, B, dev, elem=w["i_col"].element_size())
    tag, beside = "", f"earlier kernel {K1_EARLIER_MS[cell]} ms"
    if pair != ("f32", "f32"):
        tag = f" at {pair[0]} weights, {pair[1]} streams"
        beside = f"the f32 kernel on the same values {f32_ms:.3f} ms"
    print(f"K1 {cell}{tag} greedy {B} folds x {T} steps ({p.ctas} CTAs: {p.units} units of each "
          f"GRU, {p.fc_rows} rows of each FC, {p.last_rows} of the last; {p.nb} folds an item; "
          f"{p.fb} a fold block; {p.smem} bytes of shared memory): head input max_abs_err "
          f"{err:.3e} (tol {head_tol:g}), sample err {sample_err:.3e} (tol {tol:g}), {flips} "
          f"folds cut at a near-tie; kernel {ms:.3f} ms ({ms / T * 1e3:.2f} us a step; {beside}), "
          f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    return {"cell": cell, "max_abs_err": max(err, sample_err), "ms": ms, "plain_ms": plain_ms,
            **b, "plan": list(p[:6]), **({"f32_ms": f32_ms} if tag else {})}, f32_w, f32_streams


def k1_main_folds(dev, voc, w, T=512):
    """A cell at the fold counts the clone path gives its variant
    (``K1_MAIN_FOLDS``), greedy against the plain version (``k1_check``):
    the fold count picks the kernel's items and fold blocks. Returns the
    largest error."""
    d = voc.dims
    errs = {}
    for B in K1_MAIN_FOLDS[d.variant]:
        _, err, sample_err, _, flips = k1_check(d, w, k1_streams(voc, B, T, 7, dev))
        errs[B] = max(err, sample_err)
        print(f"K1 {d.variant} {d.mode} greedy at the clone's {B} folds x {T} steps "
              f"({list(k1_plan(d, B, dev)[:6])}): max_abs_err {errs[B]:.3e} against the plain "
              f"version, {flips} folds cut at a near-tie")
    return max(errs.values())


def k1_bound(w, streams, samples):
    """K1's bound: every weight applied once to every fold and step; the
    weights, the streams and the samples moved once (at their dtypes' bytes);
    the operations at the f32 peak, or at the bf16 peak for bf16 weights."""
    import torch

    B, T = samples.shape
    flops = 2 * B * T * sum(v.numel() for v in w.values() if v.ndim == 2)
    peak = BF16_FLOPS if w["i_col"].dtype == torch.bfloat16 else F32_FLOPS
    return bound(nbytes(*w.values(), *streams.values(), samples), flops, peak)


def k1_plan(d, B, dev, elem=4):
    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.ops.wavernn_generate import plan

    return plan(d.variant, d.rnn_dims, d.fc_dims, d.n_classes, B, *_build.device_limits(dev),
                head=d.head, elem=elem)


def k1_fold_sweep(dev, voc, folds=(8, 6, 13, 39, 64, 132, 169, 264), T=512):
    """runtimeracer RAW, greedy, at 6 to 264 folds x 512 steps and at the 5 s
    clone's and the paragraph's shapes, 13 and 169 folds x 8000 steps: every
    launch against the plain version (``k1_check``); the first 8 folds of
    every launch also repeat the 8-fold launch's samples (folds are
    independent, and a fold's sums do not depend on the plan). Prints µs a
    step at each."""
    import torch

    from rtvc_tpu_torch.models import wavernn as wrn
    from rtvc_tpu_torch.ops.wavernn_generate import wavernn_generate_core

    d, model = voc.dims, voc.model
    kw = dict(variant=d.variant, head=d.head)
    full = k1_streams(voc, max(folds), T, 9, dev)
    with torch.no_grad():
        w = wrn.step_weights(model, d)
    sweep, first = [], None

    def point(streams):
        B, steps = streams["i_cond"].shape[:2]
        got, err, sample_err, _, flips = k1_check(d, w, streams)
        with torch.no_grad():
            ms = cuda_ms(lambda: wavernn_generate_core(w, streams, 0, argmax=True, **kw),
                         reps=2 if steps > T else 3)
        sweep.append({"folds": B, "steps": steps, "ms": ms, "us_a_step": ms / steps * 1e3,
                      "max_abs_err": max(err, sample_err), "near_ties": flips,
                      "plan": list(k1_plan(d, B, dev)[:6]), **k1_bound(w, streams, got)})
        return got

    for B in folds:
        got = point({k: v[:B].contiguous() for k, v in full.items()})
        first = got[:8] if first is None else first
        check(torch.equal(got[:8], first[:B]), f"K1 at {B} folds: the first 8 folds differ "
              f"from the 8-fold launch's")
    long_T = 8000
    reps = -(-long_T // T)
    for B in (13, 169):
        point({k: v[:B].repeat(1, reps, 1)[:, :long_T].contiguous() for k, v in full.items()})
    print("K1 runtimeracer RAW fold sweep, greedy, each launch against the plain version: "
          + "; ".join(f"{e['folds']} folds x {e['steps']} steps {e['ms']:.3f} ms "
                      f"({e['us_a_step']:.2f} us a step, bound {e['bound_ms']:.4f} ms), "
                      f"max_abs_err {e['max_abs_err']:.3e}, {e['near_ties']} near-ties"
                      for e in sweep)
        + "; the first 8 folds repeat at every fold count")
    return sweep


def k1_sampled_cell(dev, voc, w, streams):
    """The cell's sampled head from fixed head outputs (the last FC's weights
    zeroed, its bias set), 8 folds x 2048 steps: a chi-square test against
    softmax(bias) for a categorical head, a Kolmogorov-Smirnov test against
    the mixture's analytic CDF for MOL and against scipy's Beta for the beta
    head (p > 1e-3 each); one seed repeats its samples."""
    import torch
    from scipy import stats

    from rtvc_tpu_torch.ops.wavernn_generate import LAYERS, wavernn_generate_core

    d = voc.dims
    cell = f"{d.variant} {d.mode}"
    C = d.n_classes
    rng = np.random.default_rng(3)
    if d.head == "categorical":
        bias = rng.normal(0, 1.5, C)
    elif d.head == "mol":
        logit, mean = rng.normal(0, 1, C // 3), rng.uniform(-0.6, 0.6, C // 3)
        log_scale = rng.uniform(-4.5, -3.5, C // 3)
        bias = np.concatenate([logit, mean, log_scale])
    else:
        alpha, beta = 2.5, 4.0
        bias = np.log([alpha, beta])
    last = LAYERS[d.variant].fcs[-1].name
    w_fixed = dict(w, **{f"{last}_w": torch.zeros_like(w[f"{last}_w"]),
                         f"{last}_b": torch.tensor(bias, dtype=torch.float32, device=dev)})
    long_streams = {k: v.repeat(1, 4, 1).contiguous() for k, v in streams.items()}
    kw = dict(variant=d.variant, head=d.head)
    with torch.no_grad():
        samples = wavernn_generate_core(w_fixed, long_streams, 2024, **kw)
        again = wavernn_generate_core(w_fixed, long_streams, 2024, **kw)
        other = wavernn_generate_core(w_fixed, long_streams, 2025, **kw)
    check(torch.equal(samples, again), f"K1 {cell} sampler: one seed does not repeat")
    check(not torch.equal(samples, other), f"K1 {cell} sampler: two seeds give the same samples")
    x = samples.reshape(-1).double().cpu().numpy()
    check(np.isfinite(x).all() and np.abs(x).max() <= 1.0, f"K1 {cell} samples out of range")
    if d.head == "categorical":
        labels = np.rint((x + 1) * (C - 1) / 2).astype(np.int64)
        p = np.exp(bias - bias.max())
        expected = p / p.sum() * labels.size
        counts = np.bincount(labels, minlength=C)
        keep = expected >= 5
        obs = np.append(counts[keep], counts[~keep].sum())
        exp = np.append(expected[keep], expected[~keep].sum())
        pvalue, test = float(stats.chisquare(obs, exp).pvalue), "chi-square"
    elif d.head == "mol":
        pi = np.exp(logit - logit.max())
        pi /= pi.sum()

        def cdf(v):
            z = (np.asarray(v)[..., None] - mean) / np.exp(log_scale)
            return (pi / (1.0 + np.exp(-z))).sum(-1)

        pvalue, test = float(stats.kstest(x, cdf).pvalue), "KS against the mixture's CDF"
    else:
        pvalue = float(stats.kstest((x + 1.0) / 2.0, stats.beta(alpha, beta).cdf).pvalue)
        test = f"KS against Beta({alpha}, {beta})"
    print(f"K1 {cell} sampled from fixed head outputs: {x.size} draws, {test} p = {pvalue:.4f} "
          f"(need > 1e-3); seed repeats")
    check(pvalue > 1e-3, f"K1 {cell} sampler fails its distribution test: p = {pvalue}")


def phase_wavernn(dev):
    """K1, every variant x head cell at full default width: greedy against
    the plain version at 8 folds and at the clone path's fold counts, then
    the sampled head's distribution; runtimeracer RAW also over a sweep of
    fold counts. One kernels entry per variant: the times of its default
    cell (fatchord RAW, geneing BITS, runtimeracer RAW), the largest error
    of its cells, every cell's numbers under ``cells``."""
    import torch

    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.ops.wavernn_generate import COUNT_NAME

    entries = {}
    for model_type, mode in K1_CELLS:
        voc = voc_model(model_type, mode, dev)
        cell, w, streams = k1_greedy_cell(dev, voc)
        k1_sampled_cell(dev, voc, w, streams)
        if (model_type, mode) == ("runtimeracer-wavernn", "RAW"):
            cell["fold_sweep"] = k1_fold_sweep(dev, voc)
            main_err = max(e["max_abs_err"] for e in cell["fold_sweep"])
        else:
            main_err = k1_main_folds(dev, voc, w)
        cell["max_abs_err"] = max(cell["max_abs_err"], main_err)
        e = entries.setdefault(model_type, {
            "name": COUNT_NAME[model_type], "source": "rtvc_tpu_torch/csrc/wavernn_generate.cu",
            "replaces": "rtvc_tpu/ops/pallas/wavernn_kernel.py:309", "max_abs_err": 0.0,
            "library_ms": None, "cells": []})
        e["max_abs_err"] = max(e["max_abs_err"], cell["max_abs_err"])
        e["cells"].append(cell)
        if mode == factories.default_config(model_type).mode:
            e.update({k: cell[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
        del voc, w, streams
        torch.cuda.empty_cache()
    return list(entries.values())


# the vocoder's generation options through the API, in turns: the options
# set and the launch counter its K1 launch adds to
VOC_OPTIONS = (({"stream_dtype": None}, "wavernn_generate_runtimeracer"),
               ({"stream_dtype": "bf16"}, "wavernn_generate_bf16_streams"),
               ({"compute_dtype": "bf16", "stream_dtype": "bf16"}, "wavernn_generate_bf16"),
               ({"compute_dtype": "bf16", "stream_dtype": None}, "wavernn_generate_bf16_weights"))
VOC_OPTION_RUNS = 5
QUALITY_FRAMES = 160  # bench_quality.py's divergence mel


def k1_pairs_at_the_clone_shape(dev, voc, entries, T=8000, B=13):
    """runtimeracer RAW at the 5 s clone's 13 folds x 8000 steps under each
    pair, the kernel timed beside the f32 kernel on the values before the
    cast; (bf16, bf16) also held to its plain version there (``k1_check``)."""
    import torch

    from rtvc_tpu_torch.models import wavernn as wrn
    from rtvc_tpu_torch.ops.wavernn_generate import wavernn_generate_core

    d = voc.dims
    kw = dict(variant=d.variant, head=d.head)
    base = k1_streams(voc, B, 512, 9, dev)
    f32_streams = {k: v.repeat(1, -(-T // 512), 1)[:, :T].contiguous() for k, v in base.items()}
    with torch.no_grad():
        f32_w = wrn.step_weights(voc.model, d)
        f32_ms = cuda_ms(lambda: wavernn_generate_core(f32_w, f32_streams, 0, argmax=True, **kw),
                         reps=2)
    for pair in K1_PAIRS:
        w, streams = k1_pair(f32_w, f32_streams, pair)
        err = None
        if pair == ("bf16", "bf16"):
            _, err, sample_err, _, flips = k1_check(d, w, streams, K1_PAIR_TOL[pair[0]])
            err = max(err, sample_err)
        with torch.no_grad():
            ms = cuda_ms(lambda: wavernn_generate_core(w, streams, 0, argmax=True, **kw), reps=2)
        e = entries[pair]
        e["clone_shape"] = {"folds": B, "steps": T, "ms": ms, "f32_ms": f32_ms,
                            **k1_bound(w, streams, torch.empty(B, T))}
        if err is not None:
            e["clone_shape"]["max_abs_err"] = err
            e["max_abs_err"] = max(e["max_abs_err"], err)
        print(f"K1 runtimeracer RAW at {pair[0]} weights, {pair[1]} streams, the 5 s clone's "
              f"{B} folds x {T} steps: {ms:.3f} ms against the f32 kernel's {f32_ms:.3f} ms"
              + ("" if err is None else f"; against the plain version max_abs_err {err:.3e} "
                 f"(tol {K1_PAIR_TOL[pair[0]]:g}), {flips} near-ties"))


def voc_quality_readings(dev, voc, mel):
    """What bf16 does to the audio, through ``utils/genquality.py`` at full
    width (printed readings, no gate): the share of equal samples of the
    greedy decodes of one mel at each pair against f32 (folded at 400 / 160,
    unfolded); ``bench_quality.py``'s ``bf16_stream_sampled_divergence``
    (``mel_l2_distance`` between the f32 and the pair's sampled decodes
    under one seed, beside two f32 seeds' distance); ``fold_fidelity`` at
    the checkpoint's window and at 400 / 160, f32 and bf16 streams; the
    mel-cepstral distortion between the f32 and the pair's greedy decodes.
    Returns the readings."""
    import torch
    import torch.nn.functional as F

    from rtvc_tpu_torch.config import preprocessing, sp
    from rtvc_tpu_torch.models import wavernn as wrn
    from rtvc_tpu_torch.utils import genquality

    d, model, cfg = voc.dims, voc.model, voc.config
    mels = F.pad(torch.as_tensor(mel, device=dev)[None], (d.pad, d.pad))
    with torch.no_grad():
        mels_up, aux, _ = wrn.upsample_forward(model, d, mels)

    def greedy(pair):
        return genquality._argmax_decode_batched(model, d, mels_up, aux, 400, 160, *pair)[0]

    def sampled(pair, seed):
        return wrn.wavernn_generate(model, d, mel, seed, target=400, overlap=160,
                                    mu_law=cfg.mu_law, compute_dtype=pair[0],
                                    stream_dtype=pair[1])

    out = {}
    ref, ref_wav, other = greedy(("f32", "f32")), sampled(("f32", "f32"), 0), None
    for pair in K1_PAIRS:
        got = greedy(pair)
        wav = sampled(pair, 0)
        other = sampled(("f32", "f32"), 1) if other is None else other
        d_pair = genquality.mel_l2_distance(ref_wav, wav, sp, preprocessing, device=dev)
        d_seed = genquality.mel_l2_distance(ref_wav, other, sp, preprocessing, device=dev)
        r = {"greedy_agreement": float((got == ref).mean()),
             "sampled_divergence": d_pair, "different_seed_floor": d_seed,
             "ratio": d_pair / max(d_seed, 1e-9),
             "greedy_mcd_db": genquality.mel_cepstral_distortion(ref, got, sp, preprocessing,
                                                                 device=dev)}
        check(all(np.isfinite(v) for v in r.values()) and all(np.isfinite(x).all()
              for x in (got, wav)), f"non-finite quality readings at {pair}: {r}")
        out["/".join(pair)] = r
        print(f"bf16 and the audio, {pair[0]} weights and {pair[1]} streams against f32, "
              f"runtimeracer RAW, a {mel.shape[1]}-frame mel at 400 / 160: greedy samples equal "
              f"{r['greedy_agreement']:.5f}; sampled (one seed) mel_l2_distance {d_pair:.3e} "
              f"beside two f32 seeds' {d_seed:.4f}, ratio {r['ratio']:.3e}; greedy mel-cepstral "
              f"distortion {r['greedy_mcd_db']:.4f} dB")
    for stream in ("f32", "bf16"):
        ff = genquality.fold_fidelity(model, d, mel, [(cfg.gen_target, cfg.gen_overlap),
                                                      (400, 160)], stream_dtype=stream)
        out[f"fold_fidelity/{stream} streams"] = ff
        check(all(np.isfinite(x["aligned_rms"]) and np.isfinite(x["join_click_ratio"])
                  for x in ff), f"fold_fidelity at {stream} streams: {ff}")
        print(f"fold_fidelity at {stream} streams (greedy, against the unbatched decode): "
              + "; ".join(f"{x['target']} / {x['overlap']}: {x['num_folds']} folds, aligned_rms "
                          f"{x['aligned_rms']:.3e}, join_click_ratio {x['join_click_ratio']:.3f}"
                          for x in ff))
    return out


def phase_vocoder_options(dev, card, syn, voc):
    """The vocoder's generation options (``inference.vocoder.
    set_generation_options`` and the streaming functions' ``stream_dtype`` /
    ``compute_dtype``) and K1's three new instantiations, (f32 weights, bf16
    streams), (bf16, bf16) and (bf16 weights, f32 streams):

    1. each in all seven variant x head cells at full width, 8 folds x 512
       steps, greedy, against its plain version at the same pair
       (``k1_greedy_cell``: ``k1_check`` at ``K1_PAIR_TOL``), timed beside
       the f32 kernel on the same values, with its bound and its plan;
    2. each at the 5 s clone's 13 folds x 8000 steps (runtimeracer RAW);
    3. through the API: the clone's vocode stage (the Tacotron's 400-frame
       mel of the 3 s prompt's clone, runtimeracer) under f32, bf16 streams,
       bf16 weights and streams, and bf16 weights, five requests each in
       turns; every launch counted on its instantiation's counter; then
       ``stream_dtype=None`` and no ``compute_dtype`` return the next launch
       to the f32 kernel;
    4. what bf16 does to the audio (``voc_quality_readings``);
    5. one streamed clone and one ``vocode_pipelined`` batch at bf16 streams
       beside f32: as many chunks and samples, each launch on the pair's
       counter, TTFA printed.

    Returns the "kernels" line's three entries (with their launches on the
    API path and by path) and the readings."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder
    from rtvc_tpu_torch.inference.pipelined import vocode_pipelined
    from rtvc_tpu_torch.inference.streaming import stream_clone
    from rtvc_tpu_torch.ops import precision
    from rtvc_tpu_torch.ops.wavernn_generate import count_name
    from rtvc_tpu_torch.profile_stream import TEXT, line, stats
    from rtvc_tpu_torch.serve import voiced_prompt

    entries = {pair: {"name": count_name("runtimeracer-wavernn",
                                         *(precision.resolve(n) for n in pair)),
                      "source": "rtvc_tpu_torch/csrc/wavernn_generate.cu",
                      "replaces": "rtvc_tpu/ops/pallas/wavernn_kernel.py:309", "max_abs_err": 0.0,
                      "library_ms": None, "cells": []} for pair in K1_PAIRS}
    for model_type, mode in K1_CELLS:
        cell_voc = voc_model(model_type, mode, dev)
        for pair in K1_PAIRS:
            cell, _, _ = k1_greedy_cell(dev, cell_voc, pair=pair)
            e = entries[pair]
            e["cells"].append(cell)
            e["max_abs_err"] = max(e["max_abs_err"], cell["max_abs_err"])
            if (model_type, mode) == ("runtimeracer-wavernn", "RAW"):
                e.update({k: cell[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
        del cell_voc
        torch.cuda.empty_cache()
    k1_pairs_at_the_clone_shape(dev, voc, entries)

    encoder.init_random_model(seed=0, device=dev)
    synth = synthesizer.Synthesizer()
    synth.load_bundle(syn, r=2)
    vocoder.load_bundle(voc)
    vocoder.set_seed(0)
    embed = encoder.embed_utterance(encoder.preprocess_wav(voiced_prompt(0)))
    mel = synth.synthesize_spectrograms([TEXT], [embed])[0]
    check(mel.shape[1] == CLONE_FRAMES, f"the options' clone mel has {mel.shape[1]} frames")
    vocoder.set_generation_options(stream_dtype=None)
    check(vocoder._gen_backend() == (torch.float32, torch.float32),
          f"the options start at {vocoder._gen_backend()}, want f32")
    times = {name: [] for _, name in VOC_OPTIONS}
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    for _ in range(VOC_OPTION_RUNS):
        for options, name in VOC_OPTIONS:
            vocoder.set_generation_options(**options)
            before = _build.launch_counts[name]
            wav, ms = timed_ms(lambda: vocoder.infer_waveform(mel))
            check(_build.launch_counts[name] == before + 1,
                  f"infer_waveform under {options} did not launch {name}")
            check(wav.shape == ((mel.shape[1] - 1) * 200,) and np.isfinite(wav).all()
                  and float(np.abs(wav).max()) > 0, f"the vocode under {options}: {wav.shape}")
            times[name].append(ms)
    counts = dict(_build.launch_counts)
    want = {name: VOC_OPTION_RUNS for _, name in VOC_OPTIONS}
    check(counts == want, f"the options' vocodes launched {counts}, want {want}")
    vocoder.set_generation_options(stream_dtype=None)
    vocoder.infer_waveform(mel)
    check(_build.launch_counts["wavernn_generate_runtimeracer"] == VOC_OPTION_RUNS + 1
          and dict(_build.launch_counts) == {**want, "wavernn_generate_runtimeracer":
                                             VOC_OPTION_RUNS + 1},
          f"after set_generation_options(stream_dtype=None) the launch was {_build.launch_counts}")
    f32_median = float(np.median(times["wavernn_generate_runtimeracer"]))
    for options, name in VOC_OPTIONS:
        med = float(np.median(times[name]))
        print(f"{card}: the clone's vocode stage ({mel.shape[1]} frames, runtimeracer, window "
              f"{voc.config.gen_target} / {voc.config.gen_overlap}) under {options or 'f32'}: "
              f"median {med:.1f} ms of {VOC_OPTION_RUNS} in turns ("
              + ", ".join(f"{t:.1f}" for t in times[name]) + f"), {med / f32_median:.3f} of f32")
    for pair in K1_PAIRS:
        entries[pair]["vocode_median_ms"] = float(np.median(times[entries[pair]["name"]]))
    entries_counts = {entries[p]["name"]: counts[entries[p]["name"]] for p in K1_PAIRS}

    readings = voc_quality_readings(dev, voc, mel[:, :QUALITY_FRAMES])

    # a streamed clone and a pipelined batch at bf16 streams, beside f32
    streams, stream_counts = {}, {}
    for stream in ("f32", "bf16"):
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        chunks = list(stream_clone(synth, voc, TEXT, embed, stream_dtype=stream, **STREAM_KW))
        streams[stream] = stats(chunks, t0, time.perf_counter(), voc.dims.hop_length,
                                synth.sample_rate)
        stream_counts[stream] = dict(_build.launch_counts)
        print(f"{card}: stream at {stream} streams: {line(streams[stream])}")
    n = len(streams["f32"]["emit_ms"])
    check(len(streams["bf16"]["emit_ms"]) == n
          and streams["bf16"]["samples"] == streams["f32"]["samples"]
          and streams["bf16"]["frames"] == streams["f32"]["frames"],
          f"the bf16-stream clone streamed {streams['bf16']} against f32's {streams['f32']}")
    check(stream_counts["bf16"].get("wavernn_generate_bf16_streams") == n
          and "wavernn_generate_runtimeracer" not in stream_counts["bf16"],
          f"the bf16-stream clone launched {stream_counts['bf16']} for {n} chunks")
    batch = [mel, mel[:, :250], mel[:, :96]]
    piped = {}
    for stream in ("f32", "bf16"):
        _build.launch_counts.clear()
        piped[stream], ms = timed_ms(lambda: list(vocode_pipelined(voc, batch, seed=3,
                                                                   stream_dtype=stream)))
        check(dict(_build.launch_counts) == {count_name(
            "runtimeracer-wavernn", torch.float32, precision.resolve(stream)): len(batch)},
            f"vocode_pipelined at {stream} streams launched {dict(_build.launch_counts)}")
        print(f"vocode_pipelined of {[m.shape[1] for m in batch]} frames at {stream} streams: "
              f"{[len(x) for x in piped[stream]]} samples in {ms:.1f} ms")
    check([len(x) for x in piped["bf16"]] == [len(x) for x in piped["f32"]]
          == [(m.shape[1] - 1) * 200 for m in batch]
          and all(np.isfinite(x).all() for x in piped["bf16"]), "vocode_pipelined at bf16")
    for pair in K1_PAIRS:
        e = entries[pair]
        e["launches_by_path"] = {f"clone vocode stage ({VOC_OPTION_RUNS} requests)":
                                 entries_counts[e["name"]]}
        if pair == ("f32", "bf16"):
            e["launches_by_path"][f"stream (1, {n} chunks)"] = n
            e["launches_by_path"]["vocode_pipelined (3 utterances)"] = len(batch)
    return list(entries.values()), entries_counts, readings


def dashboard_check(run_dir):
    """``utils/dashboard.serve`` over a training run's directory in the
    background: ``GET /`` answers 200 with the page, ``GET /data.json``
    holds the run's metrics (its loss among them) with their points."""
    import urllib.request

    from rtvc_tpu_torch.utils.dashboard import serve

    server = serve(run_dir, port=0, background=True)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
            status, page = r.status, r.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/data.json", timeout=10) as r:
            data = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    metrics = data.get("metrics", {})
    check(status == 200 and b"dashboard" in page, f"the dashboard's page answered {status}")
    check("loss" in metrics and len(metrics["loss"]) > 0,
          f"the dashboard over {run_dir} holds {sorted(metrics)}")
    print(f"dashboard over {run_dir.name}: GET / 200 ({len(page)} bytes), data.json metrics "
          f"{ {k: len(v) for k, v in metrics.items()} } points")


# the frames of the clone's mel (the decoder's 200 iterations at r 2: the
# seeded random weights never stop it early), checked in phase_clone
CLONE_FRAMES = 400


def phase_mel(dev):
    """K6 against its plain version at a minute of audio (4801 frames x 513
    bins → 80 mels), at the clone path's ``make_spectrogram`` size (the
    Griffin-Lim wav of a 400-frame mel, (400 - 1) x 200 samples: 400
    frames) and at a 3.77 s utterance (302 frames), tolerance 2e-4 absolute on the normalised scale of [-4, 4], two
    runs giving the same bits; at each, timed by CUDA events (the wrapper's
    host work included) and by the profiler (the kernel's device time alone)
    beside the plain version and ``torch.matmul(basis, mag)``, the library
    call that does the dense product alone. The bound counts the banded work:
    the magnitudes, the band weights and the mel moved once, 2 FLOP a band
    entry a frame."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.config import preprocessing as pp
    from rtvc_tpu_torch.config import sp
    from rtvc_tpu_torch.ops import audio
    from rtvc_tpu_torch.ops import mel_project as mp

    g = torch.Generator().manual_seed(13)
    basis = mp.mel_basis(sp, dev)
    bands = mp.mel_bands(basis.cpu().numpy())
    cells = {}
    for n in (60 * sp.sample_rate, (CLONE_FRAMES - 1) * sp.hop_size, 60320):
        t = torch.arange(n) / sp.sample_rate
        wav = (0.3 * torch.sin(2 * np.pi * 220 * t) * torch.sin(2 * np.pi * 1.5 * t) ** 2
               + 0.02 * torch.randn(n, generator=g)).to(dev)
        mag = audio.stft_magnitude(audio.preemphasis(wav, sp.preemphasis), sp.n_fft,
                                   sp.hop_size, sp.win_size).contiguous()
        n_bins, T = mag.shape
        got = mp.mel_project_normalize(mag, sp, pp)
        ref = mp.mel_project_normalize_plain(mag, sp, pp)
        torch.cuda.synchronize()
        check(got.shape == ref.shape == (sp.num_mels, 1 + n // sp.hop_size),
              f"K6 output shape {tuple(got.shape)}")
        err = float((got - ref).abs().max())
        check(err <= 2e-4, f"K6 differs from its plain version at {T} frames: {err}")
        check(torch.equal(got, mp.mel_project_normalize(mag, sp, pp)),
              f"K6 at {T} frames: two runs on the same inputs differ in their bits")
        check(float(ref.std()) > 0.5, "K6: the test signal's mel is flat")
        ms = cuda_ms(lambda: mp.mel_project_normalize(mag, sp, pp), reps=20)
        plain_ms = cuda_ms(lambda: mp.mel_project_normalize_plain(mag, sp, pp), reps=20)
        library_ms = cuda_ms(lambda: torch.matmul(basis, mag), reps=20)
        device = device_ms(lambda: mp.mel_project_normalize(mag, sp, pp))
        # the wrapper's host work a call: the enqueue time of calls whose
        # kernels take less than it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            mp.mel_project_normalize(mag, sp, pp)
        host_ms = (time.perf_counter() - t0) * 10.0
        torch.cuda.synchronize()
        library_device = device_ms(lambda: torch.matmul(basis, mag))
        b = bound(nbytes(mag, got) + 4 * (len(bands.weights) + 4 * sp.num_mels),
                  2 * T * int(bands.width.sum()))
        dense = bound(nbytes(mag, basis, got), 2 * T * n_bins * sp.num_mels)
        mpc = mp.mels_per_cta(T, sp.num_mels, _build.device_limits(dev)[0])
        print(f"K6 mel_project {n_bins} bins x {T} frames -> {sp.num_mels} mels ({mpc} mels a "
              f"CTA, {-(-T // mp.FRAMES) * -(-sp.num_mels // mpc)} CTAs): max_abs_err {err:.3e} "
              f"(tol 2e-4), bits repeat; kernel {ms:.4f} ms a call ({device:.4f} ms of it on "
              f"the device, {host_ms:.4f} ms of host work a call), plain {plain_ms:.4f} ms, "
              f"torch.matmul alone {library_ms:.4f} ms a call ({library_device:.4f} ms on the "
              f"device), bound {b['bound_ms']:.5f} ms by "
              f"{b['bound_by']} over the bands ({int(bands.width.sum())} of "
              f"{n_bins * sp.num_mels} entries; the dense product's {dense['bound_ms']:.5f} ms "
              f"by {dense['bound_by']})")
        cells[T] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                    "library_ms": library_ms, "device_ms": device, "host_ms": host_ms,
                    "library_device_ms": library_device, "dense_bound_ms": dense["bound_ms"]}
    return {"name": "mel_project", "source": "rtvc_tpu_torch/csrc/mel_project.cu",
            "replaces": "rtvc_tpu/ops/pallas/mel_kernel.py:51", **cells[max(cells)],
            "max_abs_err": max(c["max_abs_err"] for c in cells.values()),
            "shapes": [{"T": T, **c} for T, c in cells.items()]}


def phase_clone(dev, syn, voc):
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.config import preprocessing, sp
    from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.ops import audio
    from rtvc_tpu_torch.ops.mel_project import mel_project_normalize_plain
    from rtvc_tpu_torch.ops.wavernn_generate import COUNT_NAME
    from rtvc_tpu_torch.serve import voiced_prompt

    encoder.init_random_model(seed=0, device=dev)
    synth = synthesizer.Synthesizer()
    synth.load_bundle(syn, r=2)
    vocoder.load_bundle(voc)
    vocoder.set_seed(0)
    texts = ["The quick brown fox jumps over the lazy dog.",
             "Voice cloning on a single graphics card.",
             "Hello there, this is a test of the clone path.",
             "A fourth request, for the median of five.",
             "And a fifth one, to close the set."]

    _build.launch_counts.clear()
    stages = []
    for i, text in enumerate(texts):
        wav = voiced_prompt(i)
        pre, t_pre = timed_ms(lambda: encoder.preprocess_wav(wav))
        embed, t_emb = timed_ms(lambda: encoder.embed_utterance(pre))
        specs, t_syn = timed_ms(lambda: synth.synthesize_spectrograms([text], [embed]))
        mel = specs[0]
        out, t_voc = timed_ms(lambda: vocoder.infer_waveform(mel))
        check(embed.shape == (768,), f"embedding shape {embed.shape}")
        check(abs(float(np.linalg.norm(embed)) - 1.0) < 1e-4, "embedding is not unit norm")
        check(mel.ndim == 2 and mel.shape[0] == 80, f"mel shape {mel.shape}")
        check(out.shape == ((mel.shape[1] - 1) * 200,), f"wav length {out.shape} for "
              f"{mel.shape[1]} frames")
        check(all(np.isfinite(a).all() for a in (embed, mel, out)), "non-finite output")
        print(f"clone {i}: prompt {len(wav)} -> {len(pre)} samples, mel {mel.shape[1]} "
              f"frames, wav {len(out)} samples ({len(out) / 16000:.2f} s); "
              f"preprocess {t_pre:.1f} ms, embed {t_emb:.1f} ms, "
              f"synthesize {t_syn:.1f} ms, vocode {t_voc:.1f} ms")
        stages.append((t_pre, t_emb, t_syn, t_voc))
    split = np.median(np.array(stages), axis=0)
    print(f"clone median over {len(texts)} requests: "
          f"{float(np.median(np.array(stages).sum(axis=1))):.1f} ms (stage medians: preprocess "
          f"{split[0]:.1f}, embed {split[1]:.1f}, synthesize {split[2]:.1f}, vocode "
          f"{split[3]:.1f} ms)")
    counts = dict(_build.launch_counts)
    print(f"launches in the clone run: {counts}")
    for name in ("lstm_seq", "tacotron_decode", "wavernn_generate_runtimeracer"):
        check(counts.get(name, 0) > 0, f"{name} was not launched by the clone path")
    # the encoder's and the postnet's BiGRUs: two K4 launches each a request
    check(counts.get("gru_seq", 0) == 4 * len(texts) and "gru_seq_bwd" not in counts,
          f"the clone path launched gru_seq {counts.get('gru_seq', 0)} times in {len(texts)} "
          f"requests, want {4 * len(texts)}, and no backward")
    by_kernel = kernels_device_ms(lambda: synth.synthesize_spectrograms([texts[0]], [embed]))
    print(f"synthesize stage median {split[2]:.1f} ms; device ms of one synthesize call by "
          f"kernel (profiled): " + ", ".join(f"{k} {v:.3f}" for k, v in by_kernel.items()))

    # the three mels of a batch of requests in one launch of the sample loop
    mels = [mel[:, :n] for n in (mel.shape[1], mel.shape[1] * 5 // 8, mel.shape[1] // 3)]
    _build.launch_counts.clear()
    wavs, t_batch = timed_ms(lambda: vocoder.infer_waveforms(mels))
    batch_counts = dict(_build.launch_counts)
    check(batch_counts == {"wavernn_generate_runtimeracer": 1},
          f"infer_waveforms of {len(mels)} mels launched {batch_counts}, want one K1 launch")
    for m, out in zip(mels, wavs):
        check(out.shape == ((m.shape[1] - 1) * 200,) and np.isfinite(out).all(),
              f"batched wav {out.shape} for {m.shape[1]} frames")
    print(f"batched vocode of {[m.shape[1] for m in mels]} frames: one launch, "
          f"{[len(o) for o in wavs]} samples, {t_batch:.1f} ms")

    # the same request through the other two variants at their configs' windows
    for model_type in ("fatchord-wavernn", "geneing-wavernn"):
        other = voc_model(model_type, factories.default_config(model_type).mode, dev)
        vocoder.load_bundle(other)
        name = COUNT_NAME[model_type]
        _build.launch_counts.clear()
        out, t_voc = timed_ms(lambda: vocoder.infer_waveform(mel))
        counts[name] = _build.launch_counts[name]
        check(counts[name] == 1, f"{name} launched {counts[name]} times for one request")
        check(out.shape == ((mel.shape[1] - 1) * 200,) and np.isfinite(out).all()
              and float(np.abs(out).max()) > 0, f"{model_type} wav {out.shape}")
        # the first request of a model also loads what its layers launch
        _, t_again = timed_ms(lambda: vocoder.infer_waveform(mel))
        print(f"clone through {model_type} ({other.config.mode}, window "
              f"{other.config.gen_target} / {other.config.gen_overlap}): mel {mel.shape[1]} "
              f"frames -> {len(out)} samples, vocode {t_voc:.1f} ms, {t_again:.1f} ms for "
              f"the same request again")
    vocoder.load_bundle(voc)

    # a request without a vocoder: Griffin-Lim, then the mel of what it gave
    gl_pp = preprocessing.replace(griffin_lim_iters=30)
    saved, synthesizer.preprocessing = synthesizer.preprocessing, gl_pp
    try:
        _build.launch_counts.clear()
        gl_wav, t_gl = timed_ms(lambda: synthesizer.Synthesizer.griffin_lim(mel, seed=0))
        check(dict(_build.launch_counts) == {}, "Griffin-Lim launched a kernel")
        remel, t_mel = timed_ms(lambda: synthesizer.Synthesizer.make_spectrogram(gl_wav))
    finally:
        synthesizer.preprocessing = saved
    counts["mel_project"] = _build.launch_counts["mel_project"]
    check(counts["mel_project"] == 1, f"make_spectrogram launched mel_project "
          f"{counts['mel_project']} times")
    check(gl_wav.shape == ((mel.shape[1] - 1) * 200,) and np.isfinite(gl_wav).all()
          and float(np.abs(gl_wav).max()) > 0, f"Griffin-Lim wav {gl_wav.shape}")
    check(remel.shape == mel.shape and remel.dtype == np.float32 and np.isfinite(remel).all()
          and float(np.abs(remel).max()) <= 4.0, f"make_spectrogram gave {remel.shape}")
    check(mel.shape[1] == CLONE_FRAMES, f"the clone's mel has {mel.shape[1]} frames, phase_mel "
          f"measured K6 at {CLONE_FRAMES}")
    # K6 at the shape this path gave it, against its plain version
    mag = audio._stft_mag(torch.as_tensor(gl_wav, device=dev), sp).contiguous()
    remel_err = float(np.abs(remel - mel_project_normalize_plain(mag, sp, gl_pp).cpu().numpy())
                      .max())
    check(remel_err <= 2e-4, f"make_spectrogram's K6 differs from its plain version: {remel_err}")
    print(f"vocoder-less request: Griffin-Lim (30 iterations) {len(gl_wav)} samples in "
          f"{t_gl:.1f} ms, make_spectrogram {remel.shape} in {t_mel:.1f} ms, max_abs_err "
          f"{remel_err:.3e} against K6's plain version (tol 2e-4)")
    return counts


# the streaming clone's kernel wrappers where its path looks them up
STREAM_KERNELS = (("rtvc_tpu_torch.models.layers", "lstm_seq"),
                  ("rtvc_tpu_torch.models.layers", "gru_seq_fwd"),
                  ("rtvc_tpu_torch.inference.streaming", "tacotron_decode_chunk"),
                  ("rtvc_tpu_torch.models.wavernn", "wavernn_generate_core"))
STREAM_RUNS = 5
# the stream's first chunk ramps it: 16 frames (0.2 s of audio), then 48
STREAM_KW = {"first_chunk_frames": 16}


def phase_stream(dev, card, syn, voc):
    """The streaming clone at full width (the Tacotron at ``max_decoder_steps``
    400, the runtimeracer vocoder, the 3 s prompt): five runs of
    ``stream_clone`` (a first chunk of 16 frames, then 48), each one's TTFA,
    chunk cadence and real-time factor printed. The first run, with the
    prompt's embedding before it, is the path whose launches are counted:
    K3 for the embedding, K4 for the encoder's BiGRU and each chunk's
    postnet, K2 resumed once a chunk, K1 once a chunk. Its raw decoder frames
    must equal ``synthesize_spectrograms``' K2 frames for the same seed bit
    for bit, its samples number (Σ valid frames − 1)·hop, and its first
    chunk's postnet K4 and vocoder K1 launches are held to their plain
    versions on the inputs they were given. Returns the counts."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder
    from rtvc_tpu_torch.inference.streaming import stream_clone
    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops.gru_seq import gru_seq_fwd_plain
    from rtvc_tpu_torch.profile_stream import TEXT, line, measure, stats
    from rtvc_tpu_torch.serve import voiced_prompt

    encoder.init_random_model(seed=0, device=dev)
    synth = synthesizer.Synthesizer()
    synth.load_bundle(syn, r=2)
    vocoder.load_bundle(voc)
    hop = voc.dims.hop_length
    prompt = encoder.preprocess_wav(voiced_prompt(0))

    torch.cuda.synchronize()
    _build.launch_counts.clear()
    with recorded_calls(STREAM_KERNELS) as calls:
        embed = encoder.embed_utterance(prompt)
        t0 = time.perf_counter()
        chunks = list(stream_clone(synth, voc, TEXT, embed, **STREAM_KW))
        runs = [stats(chunks, t0, time.perf_counter(), hop, synth.sample_rate)]
    counts = dict(_build.launch_counts)
    n = len(chunks)
    frames = sum(c.frames for c in chunks)
    want = {"lstm_seq": 3, "gru_seq": 2 + 2 * n, "tacotron_decode_chunk": n,
            "wavernn_generate_runtimeracer": n}
    check(counts == want, f"the stream launched {counts}, want {want} for {n} chunks")
    samples = sum(len(c.wav) for c in chunks)
    check(samples == (frames - 1) * hop and chunks[-1].final
          and not any(c.final for c in chunks[:-1])
          and all(np.isfinite(c.wav).all() for c in chunks),
          f"the stream gave {samples} samples for {frames} frames in {n} chunks")
    # the raw decoder frames against the batch path's K2 frames, same seed
    with recorded_calls((("rtvc_tpu_torch.inference.synthesizer", "tacotron_decode"),)) as batch:
        synth.synthesize_spectrograms([TEXT], [embed])
    [(_, _, (km, _, _))] = batch["tacotron_decode"]
    decoded = [out for _, _, out in calls["tacotron_decode_chunk"]]
    streamed = torch.cat([o.mel[:, :, :int(o.valid) * 2] for o in decoded], dim=2)
    check(streamed.shape[2] == frames and torch.equal(streamed, km[:, :, :frames]),
          f"the streamed raw frames ({streamed.shape[2]}) differ from the batch path's K2 "
          f"frames ({km.shape[2]}) for the same seed")
    # the first chunk's postnet (K4, after the encoder's two) and vocoder launches
    with torch.no_grad():
        post_err = max(rel_err(a, b) for args, _, out in calls["gru_seq_fwd"][2:4]
                       for a, b in zip(out, gru_seq_fwd_plain(*args)))
    check(post_err <= 1e-4, f"the first chunk's postnet K4 differs from its plain version by "
          f"{post_err} (relative)")
    [(w, streams, *_), _, _] = calls["wavernn_generate_core"][0]
    got, k1_err, sample_err, tol, flips = k1_check(voc.dims, w, streams)
    print(f"stream: {n} chunks of {[c.frames for c in chunks]} frames, {samples} samples = "
          f"({frames} - 1) x {hop}; the raw decoder frames equal synthesize_spectrograms' K2 "
          f"frames for seed 0 bit for bit; launches {counts}; the first chunk's postnet K4 "
          f"{post_err:.3e} relative, K1 ({got.shape[0]} folds x {got.shape[1]} steps, greedy) "
          f"head inputs {k1_err:.3e} samples {sample_err:.3e} (tol {tol:g}), {flips} near-ties, "
          f"from their plain versions on their own inputs")
    runs += measure(synth, voc, TEXT, embed, STREAM_RUNS - 1, **STREAM_KW)
    for i, run in enumerate(runs):
        print(f"{card}: stream {i} of {STREAM_RUNS}{' (counted and checked)' if i == 0 else ''}: "
              f"{line(run)}")
    print(f"{card}: stream: median TTFA {float(np.median([r['ttfa_ms'] for r in runs])):.1f} ms, "
          f"median RTF {float(np.median([r['rtf'] for r in runs])):.2f}")
    return counts, runs


# ForwardTacotron and FastPitch at their default widths with seeded random
# weights; the duration head set to weight 0 and bias 6.0, so that every
# character of the clone texts' 64-character bucket takes 6 frames: 384 mel
# frames (4.8 s), the scale of the Tacotron clone's 400 (random predictors
# give near-zero durations, which the guard turns into 2 frames a character)
NAR_DUR_BIAS = 6.0
NAR_FRAMES = 384
NAR_TYPES = ("forward-tacotron", "fast-pitch")
# the NAR clone's kernel wrappers where its path looks them up: the encoder's
# LSTM and ForwardTacotron's BiLSTM (K3, both recorded under "lstm_seq") and
# every GRU (K4)
NAR_KERNELS = (("rtvc_tpu_torch.models.layers", "lstm_seq"),
               ("rtvc_tpu_torch.models.forward_tacotron", "lstm_seq"),
               ("rtvc_tpu_torch.models.layers", "gru_seq_fwd"))
# K3 and K4 at ForwardTacotron's shapes, B 1: (kernel, T, H, the module's input
# width): the BiLSTM over the frames (2 x 256 + 768 in), the predictors'
# BiGRUs over the text bucket (H 64 duration and energy, H 128 pitch, conv
# widths 256 in), the prenet CBHG's over the text bucket and the postnet's over
# the frames (H 256, 256 in)
NAR_SHAPES = (("lstm_seq", NAR_FRAMES, 512, 1280), ("gru_seq", 64, 64, 256),
              ("gru_seq", 64, 128, 256), ("gru_seq", 64, 256, 256),
              ("gru_seq", NAR_FRAMES, 256, 256))


def timed_ms(fn):
    """(fn(), wall ms) between two device syncs."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def nar_kernel_checks(calls):
    """Every K3 and K4 launch of one NAR clone again on the inputs it was
    given, against its plain version: K3 within 1e-4 absolute, K4 1e-4
    relative (the serve phase's tolerances). Returns a line of the shapes
    and errors."""
    import torch

    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops.gru_seq import gru_seq_fwd, gru_seq_fwd_plain
    from rtvc_tpu_torch.ops.lstm_seq import lstm_seq, lstm_seq_plain

    parts = []
    with torch.no_grad():
        for args, _, _ in calls["lstm_seq"]:
            err = max(float((a - b).abs().max())
                      for a, b in zip(lstm_seq(*args), lstm_seq_plain(*args)))
            B, T, G = args[0].shape
            check(err <= 1e-4, f"K3 at the NAR clone's B={B} T={T} H={G // 4}: {err}")
            parts.append(f"K3 B={B} T={T} H={G // 4} {err:.3e}")
        for args, _, _ in calls["gru_seq_fwd"]:
            err = max(rel_err(a, b) for a, b in zip(gru_seq_fwd(*args), gru_seq_fwd_plain(*args)))
            B, T, G = args[0].shape
            check(err <= 1e-4, f"K4 at the NAR clone's B={B} T={T} H={G // 3}: rel err {err}")
            parts.append(f"K4 B={B} T={T} H={G // 3} rel {err:.3e}")
    return "; ".join(parts)


def k3_candidates_ms(xg, w_hh, h0, dev):
    """K3's forward at one shape under each instantiation that fits it (6 or
    10 units a CTA), launched with a plan made here, timed in
    ``profile_gru.rounds_ms``: {units: ms}."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.profile_gru import rounds_ms
    from rtvc_tpu_torch.ops.lstm_seq import FWD_SLICES, WARPS, Plan

    B, T, _ = xg.shape
    H = w_hh.shape[1]
    sms, smem_limit = _build.device_limits(dev)
    lib, stream = _build.library(), _build.stream_handle(dev)
    ys, hT, cT = (torch.empty(B, T, H, device=dev), torch.empty(B, H, device=dev),
                  torch.empty(B, H, device=dev))
    runs = {}
    for units, _ in FWD_SLICES:
        smem = 4 * (4 * units * (-(-H // 4) * 4) + WARPS * (-(-4 * units // 32) * 32))
        if -(-H // units) > sms or smem > smem_limit or B > WARPS:
            continue
        p = Plan(1, -(-H // units), units, 1, B, smem)

        def run(p=p):
            sync = torch.zeros(32, device=dev, dtype=torch.int32)
            _build.check(lib.rtvc_lstm_seq_fwd(
                xg.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), h0.data_ptr(), ys.data_ptr(),
                hT.data_ptr(), cT.data_ptr(), None, None, B, T, H, _build.int_array(p),
                sync.data_ptr(), stream), "rtvc_lstm_seq_fwd")

        runs[units] = run
    return rounds_ms(runs)


def k4_candidates_ms(xg, w_hh, b_hh, dev):
    """K4's forward at one shape under every candidate plan of both modes
    (``ops/gru_seq.py:row_plan`` and ``candidates``), each launched with an
    explicit plan (``launch_fwd``), timed in ``profile_gru.rounds_ms``:
    [(ms, plan)], fastest first."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.ops.gru_seq import candidates, launch_fwd, row_plan
    from rtvc_tpu_torch.profile_gru import rounds_ms

    B, T, G = xg.shape
    H = G // 3
    limits = _build.device_limits(dev)
    ys, gates = torch.empty(B, T, H, device=dev), torch.empty(B, T, 4 * H, device=dev)
    rows = row_plan(B, H, limits[1])
    runs = {p: (lambda p=p: launch_fwd(p, xg, w_hh, b_hh, ys, gates))
            for p in [*([rows] if rows else []), *candidates(B, H, *limits)]}
    return sorted(((ms, p) for p, ms in rounds_ms(runs).items()), key=lambda mp: mp[0])


def k4_cooperative(xg, w_hh, b_hh, bwd_args, dev):
    """K4's cooperative kernels (``ops/gru_seq.py:cooperative_plan``) on an
    explicit plan, the earlier design at a width the row-resident mode now
    takes: (ys, gates, dxg) of one run and the forward's and the backward's
    CUDA-event ms, in the streams' dtype."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.ops.gru_seq import cooperative_plan, launch_bwd, launch_fwd

    B, T, G = xg.shape
    H = G // 3
    dt = xg.dtype
    limits, elem = _build.device_limits(dev), _build.elem_bytes(dt)
    p_fwd = cooperative_plan(B, H, *limits, elem=elem)
    p_bwd = cooperative_plan(B, H, *limits, backward=True, elem=elem)
    ys, gates = (torch.empty(B, T, n * H, device=dev, dtype=dt) for n in (1, 4))
    dxg, dhg = (torch.empty(B, T, 3 * H, device=dev) for _ in range(2))
    dys, b_gates, b_ys, _ = bwd_args

    def fwd():
        launch_fwd(p_fwd, xg, w_hh, b_hh, ys, gates)

    def bwd():
        launch_bwd(p_bwd, dys, b_gates, b_ys, w_hh, dxg, dhg)

    fwd()
    bwd()
    torch.cuda.synchronize()
    out = (ys.clone(), gates.clone(), dxg.clone())
    return out, cuda_ms(fwd), cuda_ms(bwd)


def rnn_fwd_cell(name, args, I):
    """K3 (``lstm_seq``) or K4 (``gru_seq_fwd``) on ``args`` under no grad,
    against its plain version (max abs and max rel error; the caller
    checks), its time and its plain version's by CUDA events, cuDNN's
    ``nn.LSTM(I, H)`` / ``nn.GRU(I, H)`` (input projection included), and its
    bound: the inputs read once and the outputs a caller without a gradient
    reads written once (K3's ys, h_T and c_T; K4's ys, not the gates that
    only its backward reads)."""
    import torch

    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops.gru_seq import gru_seq_fwd, gru_seq_fwd_plain
    from rtvc_tpu_torch.ops.lstm_seq import lstm_seq, lstm_seq_plain

    lstm = name == "lstm_seq"
    kernel, plain = (lstm_seq, lstm_seq_plain) if lstm else (gru_seq_fwd, gru_seq_fwd_plain)
    n = 4 if lstm else 3
    B, T, G = args[0].shape
    H = G // n
    with torch.no_grad():
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        rel = max(rel_err(a, b) for a, b in zip(got, want))
        ms = cuda_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps=2)
    library = f"nn.{'LSTM' if lstm else 'GRU'}({I}, {H})"
    rnn = (torch.nn.LSTM if lstm else torch.nn.GRU)(I, H, batch_first=True)
    lib_ms, _ = rnn_ms(rnn, B, T, H, args[0].device, backward=False)
    b = bound(nbytes(*args, *(got if lstm else got[:1])), 2 * B * T * n * H * H)
    return {"B": B, "T": T, "H": H, "max_abs_err": abs_err, "rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, **b, "library_ms": lib_ms,
            "library": f"{library}, input projection included"}


def nar_kernel_cells(dev, card):
    """K3 and K4 at ``NAR_SHAPES``, B 1, seeded inputs (``rnn_fwd_cell``):
    each against its plain version (K3 1e-4 absolute, K4 1e-4 relative),
    its time beside its bound, its plain version's and cuDNN's, and the
    plan's time beside every other plan the kernel has for the shape.
    Returns {kernel: [cell]}."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.ops.gru_seq import describe as k4_describe
    from rtvc_tpu_torch.ops.gru_seq import mode as k4_mode
    from rtvc_tpu_torch.ops.gru_seq import plan as k4_plan
    from rtvc_tpu_torch.ops.lstm_seq import plan as lstm_plan

    out = {"lstm_seq": [], "gru_seq": []}
    limits = _build.device_limits(dev)
    for kernel, T, H, I in NAR_SHAPES:
        g = torch.Generator().manual_seed(H + T)
        n = 4 if kernel == "lstm_seq" else 3
        xg = torch.randn(1, T, n * H, generator=g).to(dev)
        w = ((torch.rand(n * H, H, generator=g) * 2 - 1) * H ** -0.5).to(dev)
        if kernel == "lstm_seq":
            h0 = torch.zeros(1, H, device=dev)
            c = rnn_fwd_cell("lstm_seq", (xg, w, h0, h0), I)
            err = c["max_abs_err"]
            check(err <= 1e-4, f"K3 at B 1 x T {T} x H {H}: {err} from its plain version")
            p = lstm_plan(1, H, *limits)
            others = k3_candidates_ms(xg, w, h0, dev)
            plans = ", ".join(f"{u} units a CTA {t:.3f} ms" + (" (plan)" if u == p.units else "")
                              for u, t in others.items())
        else:
            bias = ((torch.rand(3 * H, generator=g) * 2 - 1) * H ** -0.5).to(dev)
            c = rnn_fwd_cell("gru_seq_fwd", (xg, w, bias), I)
            err = c["rel_err"]
            check(err <= 1e-4, f"K4 at B 1 x T {T} x H {H}: rel err {err} from its plain "
                  f"version")
            p = k4_plan(1, H, *limits)
            others = k4_candidates_ms(xg, w, bias, dev)
            plans = "; ".join(f"{t:.3f} / {k4_describe(q)}" + (" (plan)" if q == p else "")
                              for t, q in others)
        described = (k4_describe(p) if n == 3 else
                     f"{p.groups} groups x {p.slices} slices of {p.units} units")
        print(f"{card}: NAR {kernel} B=1 T={T} H={H}: plan ({described}) "
              f"{'abs' if n == 4 else 'rel'} err {err:.3e} (tol "
              f"1e-4), kernel {c['ms']:.3f} ms ({c['ms'] / T * 1e3:.2f} us a step), plain "
              f"{c['plain_ms']:.3f} ms, {c['library']} {c['library_ms']:.3f} ms, "
              f"bound {c['bound_ms']:.4f} ms by {c['bound_by']}; every plan, ms / "
              f"{'plan' if n == 3 else '(groups, slices, units, nb)'}: {plans}")
        out[kernel].append({**c, "plan": list(p[:5]), "path": "forward-tacotron clone",
                            **({"mode": k4_mode(p)} if n == 3 else {})})
    return out


def nar_clones(dev, card, synth, texts, record):
    """Clones of ``texts`` through the public API with ``synth``; each one
    checked (384 frames, (frames - 1) x 200 samples, finite), the launches
    counted, the first's K3 and K4 launches recorded when ``record``.
    Returns (counts, stage ms per request, the first's recorded calls)."""
    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.inference import encoder, vocoder
    from rtvc_tpu_torch.serve import voiced_prompt

    model_type = synth.get_model_type()
    _build.launch_counts.clear()
    stages, first_calls = [], {}
    for i, text in enumerate(texts):
        wav = voiced_prompt(i)
        with (recorded_calls(NAR_KERNELS) if record and i == 0
              else contextlib.nullcontext({})) as calls:
            pre, t_pre = timed_ms(lambda: encoder.preprocess_wav(wav))
            embed, t_emb = timed_ms(lambda: encoder.embed_utterance(pre))
            (specs, durs), t_syn = timed_ms(lambda: synth.synthesize_spectrograms(
                [text], [embed], return_alignments=True))
            mel = specs[0]
            out, t_voc = timed_ms(lambda: vocoder.infer_waveform(mel))
        first_calls = first_calls or calls
        check(mel.shape == (80, NAR_FRAMES) and int(durs[0].sum()) == NAR_FRAMES
              and durs[0].shape == (64,), f"{model_type}: mel {mel.shape}, durations "
              f"{durs[0].shape} summing to {int(durs[0].sum())}, want 64 x 6 = {NAR_FRAMES}")
        check(out.shape == ((NAR_FRAMES - 1) * 200,), f"{model_type}: wav {out.shape}")
        check(all(np.isfinite(a).all() for a in (embed, mel, out)), f"{model_type}: non-finite")
        print(f"{model_type} clone {i}: mel {mel.shape[1]} frames, wav {len(out)} samples "
              f"({len(out) / 16000:.2f} s); preprocess {t_pre:.1f} ms, embed {t_emb:.1f} ms, "
              f"synthesize {t_syn:.1f} ms, vocode {t_voc:.1f} ms")
        stages.append((t_pre, t_emb, t_syn, t_voc))
    split = np.median(np.array(stages), axis=0)
    print(f"{card}: {model_type} clone median over {len(texts)} requests: "
          f"{float(np.median(np.array(stages).sum(axis=1))):.1f} ms (stage medians: preprocess "
          f"{split[0]:.1f}, embed {split[1]:.1f}, synthesize {split[2]:.1f}, vocode "
          f"{split[3]:.1f} ms; {NAR_FRAMES} frames)")
    return dict(_build.launch_counts), stages, first_calls


def write_nar_checkpoints(ckpt_dir, ft, fp):
    """ForwardTacotron as a reference ``.pt`` (its model type, a step buffer,
    BatchNorm's batch counters), FastPitch as a port trainer file."""
    import torch

    from rtvc_tpu_torch.train.checkpoints import save_checkpoint

    state = dict(ft.model.state_dict())
    for name in [n for n in state if n.endswith(".running_mean")]:
        state[name.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(7)
    state["step"] = torch.full((1,), 3000, dtype=torch.long)
    paths = {"forward-tacotron": ckpt_dir / "forward_tacotron.pt",
             "fast-pitch": ckpt_dir / "fast_pitch.pt"}
    torch.save({"step": 3000, "model_state": state, "optimizer_state": {},
                "model_type": ft.model_type}, paths["forward-tacotron"])
    save_checkpoint(paths["fast-pitch"], fp.model, 1000, fp.model_type,
                    extras={"config": fp.config.asdict()})
    return paths


def phase_nar(dev, card, voc):
    """The non-autoregressive synthesizers at their default widths (seeded
    random weights, the duration head at ``NAR_DUR_BIAS``: 384 frames a
    clone text), the runtimeracer vocoder, the 3 s prompt:

    - five ForwardTacotron clones through the public API (median and stage
      split; K3 3 (embedding) + 2 and K4 10 launches, K1 1 a request; the
      first request's K3 and K4 launches held to their plain versions on
      their own inputs), the device time of one synthesize call by kernel;
    - K3 and K4 at the path's shapes (``nar_kernel_cells``);
    - five FastPitch clones (K3 3 and K1 1 a request, no K4);
    - one streamed ForwardTacotron clone (``stream_clone``: the batch mel
      through ``stream_vocode``), its TTFA and cadence, (frames - 1) x 200
      samples;
    - ForwardTacotron written as a reference ``.pt`` and FastPitch as a port
      trainer file, loaded through ``synthesizer.load_model`` (each state
      equal bit for bit to the model it was written from), each serving one
      ``/clone`` and one ``/stream`` through ``serve.create_server`` after
      ``warm_clone``.

    Returns {"counts": {type: launches of five clones}, "stream_counts",
    "cells": K3 and K4 cells}."""
    import threading

    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder
    from rtvc_tpu_torch.inference.streaming import stream_clone
    from rtvc_tpu_torch.profile_stream import TEXT, line, nar_synthesizer, stats
    from rtvc_tpu_torch.serve import _parse_wav, _wav_bytes, create_server, voiced_prompt

    encoder.init_random_model(seed=0, device=dev)
    vocoder.load_bundle(voc)
    vocoder.set_seed(0)
    texts = ["The quick brown fox jumps over the lazy dog.",
             "Voice cloning on a single graphics card.",
             "Hello there, this is a test of the clone path.",
             "A fourth request, for the median of five.",
             "And a fifth one, to close the set."]
    synths = {t: nar_synthesizer(t, dev, frames_per_char=NAR_DUR_BIAS) for t in NAR_TYPES}
    counts, calls = {}, None
    for model_type, synth in synths.items():
        counts[model_type], _, first = nar_clones(dev, card, synth, texts,
                                                  model_type == "forward-tacotron")
        calls = calls or first
        by_kernel = kernels_device_ms(lambda: synth.synthesize_spectrograms([texts[0]],
                                                                            [np.zeros(768)]))
        print(f"{card}: {model_type}: device ms of one synthesize call by kernel (profiled): "
              + ", ".join(f"{k} {v:.3f}" for k, v in by_kernel.items()))
    n = len(texts)
    want = {"forward-tacotron": {"lstm_seq": 5 * n, "gru_seq": 10 * n,
                                 "wavernn_generate_runtimeracer": n},
            "fast-pitch": {"lstm_seq": 3 * n, "wavernn_generate_runtimeracer": n}}
    check(counts == want, f"the NAR clones launched {counts}, want {want}")
    check(len(calls["lstm_seq"]) == 5 and len(calls["gru_seq_fwd"]) == 10,
          f"one ForwardTacotron clone called K3 {len(calls['lstm_seq'])} and K4 "
          f"{len(calls['gru_seq_fwd'])} times, want 5 and 10")
    print(f"NAR: the first ForwardTacotron clone's K3 and K4 launches on their own inputs "
          f"against their plain versions: {nar_kernel_checks(calls)}")
    cells = nar_kernel_cells(dev, card)

    # one streamed ForwardTacotron clone: the batch mel through stream_vocode
    ft = synths["forward-tacotron"]
    embed = encoder.embed_utterance(encoder.preprocess_wav(voiced_prompt(0)))
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    chunks = list(stream_clone(ft, voc, TEXT, embed, first_chunk_frames=16))
    run = stats(chunks, t0, time.perf_counter(), voc.dims.hop_length, ft.sample_rate)
    stream_counts = dict(_build.launch_counts)
    frames = sum(c.frames for c in chunks)
    samples = sum(len(c.wav) for c in chunks)
    check(frames == NAR_FRAMES and samples == (frames - 1) * 200 and chunks[-1].final
          and all(np.isfinite(c.wav).all() for c in chunks),
          f"the NAR stream gave {samples} samples for {frames} frames")
    check(stream_counts == {"lstm_seq": 2, "gru_seq": 10,
                            "wavernn_generate_runtimeracer": len(chunks)},
          f"the NAR stream launched {stream_counts} for {len(chunks)} chunks")
    print(f"{card}: NAR stream (forward-tacotron, {len(chunks)} chunks of "
          f"{[c.frames for c in chunks]} frames): {line(run)}; launches {stream_counts}")

    # checkpoints into synthesizer.load_model, then one /clone and one /stream each
    ckpt_dir = _build.BUILD_DIR / "smoke_nar_ckpts"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    loaded = {}
    try:
        paths = write_nar_checkpoints(ckpt_dir, synths["forward-tacotron"]._bundle,
                                      synths["fast-pitch"]._bundle)
        for model_type, path in paths.items():
            synthesizer.load_model(path, verbose=False, device=dev)
            loaded[model_type] = synthesizer._model
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    body = _wav_bytes(voiced_prompt(0), 16000)
    parts = []
    for model_type, synth in loaded.items():
        a, b = synth._bundle.model.state_dict(), synths[model_type]._bundle.model.state_dict()
        check(synth.get_model_type() == model_type and set(a) == set(b)
              and all(a[k].is_cuda and torch.equal(a[k], b[k]) for k in b),
              f"the loaded {model_type} differs from the model its checkpoint was written from")
        server = create_server("127.0.0.1", 0, synth=synth)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            _, t_warm = timed_ms(server.warm_clone)
            port = server.server_address[1]
            status, ctype, got, t_clone = serve_request(
                port, "POST", "/clone?text=" + texts[0].replace(" ", "%20"), body)
            s_status, _, encoding, data, t_first, t_last = stream_request(
                port, "/stream?text=" + texts[0].replace(" ", "%20"), body)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(30)
        wav_out, sr_out = _parse_wav(got) if status == 200 else (None, None)
        check(status == 200 and ctype == "audio/wav" and sr_out == 16000
              and wav_out.shape == ((NAR_FRAMES - 1) * 200,),
              f"{model_type} /clone answered {status}: {got[:200]}")
        check(s_status == 200 and encoding == "chunked"
              and len(data) - 44 == 2 * (NAR_FRAMES - 1) * 200,
              f"{model_type} /stream answered {s_status} with {len(data)} bytes")
        parts.append(f"{model_type} warm_clone {t_warm:.1f} ms, /clone {t_clone:.1f} ms, "
                     f"/stream first audio byte {t_first:.1f} ms, last {t_last:.1f} ms")
    print(f"{card}: NAR serve: ForwardTacotron from a reference .pt and FastPitch from a port "
          f"trainer file, loaded bit for bit; {NAR_FRAMES} frames a request: " + "; ".join(parts))
    return {"counts": counts, "stream_counts": stream_counts, "cells": cells}


SERVE_SEED = 1234


def serve_request(port, method, path, body=None):
    """(status, content type, body, wall ms) of one request to the server."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, resp.getheader("Content-Type"), data, (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def write_serve_checkpoints(ckpt_dir, enc, syn, voc):
    """The encoder and the vocoder in the port's trainer format, the Tacotron
    as a reference ``.pt`` with the buffers the port's modules have not
    (the decoder's r, the step counter, BatchNorm's batch counters)."""
    import torch

    from rtvc_tpu_torch.train.checkpoints import save_checkpoint

    paths = {k: ckpt_dir / f"{k}.pt" for k in ("encoder", "synthesizer", "vocoder")}
    save_checkpoint(paths["encoder"], enc, 1000, "speaker_encoder",
                    extras={"config": {"model": enc.model_cfg.asdict(),
                                       "data": enc.data_cfg.asdict()}})
    state = dict(syn.model.state_dict())
    for name in [n for n in state if n.endswith(".running_mean")]:
        state[name.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(7)
    state["decoder.r"] = torch.tensor(2, dtype=torch.int32)
    state["step"] = torch.full((1,), 3000, dtype=torch.long)
    torch.save({"step": 3000, "model_state": state, "optimizer_state": {},
                "model_type": syn.model_type}, paths["synthesizer"])
    save_checkpoint(paths["vocoder"], voc.model, 2000, voc.model_type,
                    extras={"config": voc.config.asdict()})
    return paths


# the inference wrappers where the clone path looks them up: (module, name)
SERVED_KERNELS = (("rtvc_tpu_torch.models.layers", "lstm_seq"),
                  ("rtvc_tpu_torch.models.layers", "gru_seq_fwd"),
                  ("rtvc_tpu_torch.inference.synthesizer", "tacotron_decode"),
                  ("rtvc_tpu_torch.models.wavernn", "wavernn_generate_core"))


def _kept(a):
    """A copy of a tensor argument, or of each tensor in a tuple (K5's
    weights and residuals); anything else as it is."""
    if hasattr(a, "clone"):
        return a.clone()
    if isinstance(a, tuple):
        kept = [_kept(x) for x in a]
        return type(a)(*kept) if hasattr(a, "_fields") else tuple(kept)
    return a


@contextlib.contextmanager
def recorded_calls(targets=SERVED_KERNELS, limit=None):
    """Each call of the wrappers ``targets`` ((module, name) where a path
    looks them up) inside, by name: its arguments (copies of its tensor
    arguments and of the tensors in its tuple arguments: a training step
    changes its weights in place) and a copy of what it returned; with
    ``limit`` only each wrapper's first ``limit`` calls. The wrappers run as
    they are."""
    calls = {name: [] for _, name in targets}
    saved = []
    for module, name in targets:
        mod = importlib.import_module(module)
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def record(*args, _fn=fn, _calls=calls[name], **kwargs):
            if limit is not None and len(_calls) >= limit:
                return _fn(*args, **kwargs)
            kept = tuple(_kept(a) for a in args)
            out = _fn(*args, **kwargs)
            # a copy: autograd may sum later cotangents into a returned one
            _calls.append((kept, kwargs, _kept(out)))
            return out

        setattr(mod, name, record)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def served_kernel_checks(calls, enc_layers, voc_dims):
    """Every kernel launch of one served clone again on the inputs it was
    given, against its plain version (``held_kernel_launches``). Returns a
    line of the launches and the errors."""
    n = {name: len(c) for name, c in calls.items()}
    check(n == {"lstm_seq": enc_layers, "gru_seq_fwd": 4, "tacotron_decode": 1,
                "wavernn_generate_core": 1}, f"one served clone called the wrappers {n} times")
    return held_kernel_launches(calls, voc_dims)


STREAM_SEED = 4321


def stream_request(port, path, body):
    """(status, content type, transfer encoding, body, ms to the first audio
    byte, ms to the last) of one streamed request: the 44-byte header read
    first, then one byte."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        head = resp.read(44)
        first = resp.read(1)
        t_first = (time.perf_counter() - t0) * 1e3
        data = head + first + resp.read()
        return (resp.status, resp.getheader("Content-Type"),
                resp.getheader("Transfer-Encoding"), data, t_first,
                (time.perf_counter() - t0) * 1e3)
    finally:
        conn.close()


def served_stream_checks(streamed, counts, synth, body, text):
    """Each served ``/stream`` against ``stream_clone`` replayed in process
    after ``set_seed(STREAM_SEED)``: chunked transfer of a streaming WAV
    (the header of the largest data length, 16-bit mono at 16 kHz), its PCM
    equal byte for byte, (Σ valid − 1)·hop samples; and the launches: K3
    three times and the encoder's K4 twice a stream, then K2 resumed, K1
    and the postnet's K4 twice for each chunk. Returns a line of the
    times."""
    import struct

    from rtvc_tpu_torch.inference import encoder, vocoder
    from rtvc_tpu_torch.inference.streaming import stream_clone
    from rtvc_tpu_torch.serve import _parse_wav, _pcm16, _streaming_wav_header

    vocoder.set_seed(STREAM_SEED)
    n_chunks, parts = 0, []
    for status, ctype, encoding, data, t_first, t_last in streamed:
        check(status == 200 and ctype == "audio/wav" and encoding == "chunked",
              f"/stream answered {status} {ctype} {encoding}: {data[:200]}")
        riff, _, wave_fmt, fmt_len, pcm, channels, sr, rate, align, bits, tag, data_len = \
            struct.unpack("<4sI8sIHHIIHH4sI", data[:44])
        check(data[:44] == _streaming_wav_header(16000) and riff == b"RIFF"
              and wave_fmt == b"WAVEfmt " and (fmt_len, pcm, channels, sr, rate, align, bits)
              == (16, 1, 1, 16000, 32000, 2, 16) and tag == b"data" and data_len == 0x7FFFF000,
              f"/stream's header is not a streaming WAV's: {data[:44]}")
        x, sr_in = _parse_wav(body)
        embed = encoder.embed_utterance(encoder.preprocess_wav(x, source_sr=sr_in))
        chunks = list(stream_clone(synth, None, text, embed, voc_seed=vocoder.next_seed()))
        frames = sum(c.frames for c in chunks)
        pcm_bytes = b"".join(_pcm16(c.wav) for c in chunks)
        check(len(pcm_bytes) == 2 * (frames - 1) * 200 and data[44:] == pcm_bytes,
              f"the served stream ({len(data) - 44} bytes) differs from its replay in process "
              f"after set_seed ({len(pcm_bytes)} bytes, {frames} frames)")
        n_chunks += len(chunks)
        parts.append(f"{frames} frames in {len(chunks)} chunks, first audio byte at "
                     f"{t_first:.1f} ms, last at {t_last:.1f} ms")
    n = len(streamed)
    want = {"lstm_seq": 3 * n, "gru_seq": 2 * n + 2 * n_chunks,
            "tacotron_decode_chunk": n_chunks, "wavernn_generate_runtimeracer": n_chunks}
    check(counts == want, f"the served streams launched {counts}, want {want}")
    return ("/stream of the 3 s prompt, two one after the other: " + "; ".join(parts)
            + f"; PCM equal to the replay in process byte for byte; launches {counts}")


def phase_serve(dev, card, syn, voc):
    """Checkpoints written from the seeded full-width models, loaded through
    the inference modules' ``load_model``, then served and warmed as
    ``serve.main`` does: ``vocoder.warmup`` and ``warm_clone``, ``GET
    /health``, ``POST /embed``, three ``POST /clone`` one at a time and two
    at once, each checked; the three replayed in process after ``set_seed``
    must give the same bytes, and every kernel launch of the first is held
    against its plain version on its own inputs (``served_kernel_checks``).
    The reference ``.pt`` carries no config, so the Tacotron serves at its
    default ``max_decoder_steps`` (2000 frames for these weights, which
    never stop early). It runs before the other phases: the warm-up takes
    the process's first launches."""
    import threading

    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.serve import _parse_wav, _wav_bytes, create_server, voiced_prompt

    ckpt_dir = _build.BUILD_DIR / "smoke_ckpts"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    try:
        enc = factories.init_encoder_model(0, dev)
        paths = write_serve_checkpoints(ckpt_dir, enc, syn, voc)
        encoder.load_model(paths["encoder"], device=dev)
        synthesizer.load_model(paths["synthesizer"], device=dev)
        vocoder.load_model(paths["vocoder"], device=dev)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    synth = synthesizer._model
    for name, loaded, made in (("encoder", encoder._model, enc),
                               ("synthesizer", synth._bundle.model, syn.model),
                               ("vocoder", vocoder._bundle.model, voc.model)):
        a, b = loaded.state_dict(), made.state_dict()
        check(set(a) == set(b) and all(a[k].is_cuda and torch.equal(a[k], b[k]) for k in b),
              f"the loaded {name} differs from the model its checkpoint was written from")
    check(synth._r == 2 and synthesizer.get_model_type() == "tacotron",
          f"the synthesizer loaded r {synth._r}")

    texts = ["The quick brown fox jumps over the lazy dog.",
             "Voice cloning on a single graphics card.",
             "Hello there, this is a test of the clone path."]
    sr_hz = 16000
    body = _wav_bytes(voiced_prompt(0), sr_hz)
    server = create_server("127.0.0.1", 0, synth=synth)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    _build.launch_counts.clear()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_warm = server.on_models(vocoder.warmup)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        server.warm_clone()
        torch.cuda.synchronize()
        t_warm, t_warm_clone = (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
        status, ctype, health, t_health = serve_request(port, "GET", "/health")
        health = json.loads(health)
        check(status == 200 and health == {"status": "ok", "platform": "cuda",
                                           "device": str(vocoder._bundle.model.I.weight.device),
                                           "synthesizer": True, "vocoder": True},
              f"/health answered {status}: {health}")
        status, _, emb, t_embed = serve_request(port, "POST", "/embed", body)
        check(status == 200, f"/embed answered {status}: {emb[:200]}")
        emb = np.asarray(json.loads(emb)["embed"])
        check(emb.shape == (768,) and abs(float(np.linalg.norm(emb)) - 1.0) < 1e-4,
              f"/embed gave {emb.shape}")
        vocoder.set_seed(SERVE_SEED)
        clone_path = ["/clone?text=" + t.replace(" ", "%20") for t in texts]
        with recorded_calls() as first_calls:
            served = [serve_request(port, "POST", clone_path[0], body)]
        served += [serve_request(port, "POST", path, body) for path in clone_path[1:]]
        together = [None, None]

        def concurrent(i):
            together[i] = serve_request(port, "POST", clone_path[i], body)

        workers = [threading.Thread(target=concurrent, args=(i,)) for i in range(2)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        t_together = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.launch_counts)
        # two streams of the first text, the launches counted apart
        _build.launch_counts.clear()
        vocoder.set_seed(STREAM_SEED)
        streamed = [stream_request(port, "/stream?text=" + texts[0].replace(" ", "%20"), body)
                    for _ in range(2)]
        stream_counts = dict(_build.launch_counts)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)

    # the three sequential clones again, in process through the module functions
    vocoder.set_seed(SERVE_SEED)
    frames, replay_ms = [], []
    for text, (status, ctype, got, _) in zip(texts, served):
        check(status == 200 and ctype == "audio/wav", f"/clone answered {status}: {got[:200]}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, sr = _parse_wav(body)
        embed = encoder.embed_utterance(encoder.preprocess_wav(x, source_sr=sr))
        [mel] = synthesizer.synthesize_spectrograms([text], [embed])
        wav = vocoder.infer_waveform(mel)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(embed, emb.astype(np.float32)), "/embed differs from embed_utterance")
        wav_out, sr_out = _parse_wav(got)
        check(sr_out == sr_hz and wav_out.shape == ((mel.shape[1] - 1) * 200,),
              f"/clone gave {wav_out.shape} samples at {sr_out} Hz for {mel.shape[1]} frames")
        check(got == _wav_bytes(wav, sr_hz), f"the served clone of {text!r} differs from its "
              f"replay in process after set_seed")
        frames.append(mel.shape[1])
    for i, (status, ctype, got, _) in enumerate(together):
        wav_out, sr_out = _parse_wav(got) if status == 200 else (None, None)
        check(status == 200 and ctype == "audio/wav" and sr_out == sr_hz
              and wav_out.shape == ((frames[i] - 1) * 200,) and np.isfinite(wav_out).all(),
              f"the concurrent /clone {i} answered {status}")
    # the served clones and the warm clone; K3 also for /embed; the warm
    # stream's two chunks: its embedding, its encoder, two postnets and
    # vocodes, and three decodes (the third launched before the second
    # chunk is taken)
    n = len(served) + len(together) + 1
    want = {"lstm_seq": 3 * (n + 1) + 3, "tacotron_decode": n, "gru_seq": 4 * n + 6,
            "wavernn_generate_runtimeracer": n + n_warm + 2, "tacotron_decode_chunk": 3}
    check(counts == want, f"the served run launched {counts}, want {want} ({n} clones with the "
          f"warm clone, one embed, {n_warm} warm-up vocode, a warm stream's two chunks)")
    kernel_line = served_kernel_checks(first_calls, encoder._model_cfg.model_num_layers,
                                       vocoder._bundle.dims)
    stream_line = served_stream_checks(streamed, stream_counts, synth, body, texts[0])
    t_clone = [r[3] for r in served]
    print(f"{card}: serve: checkpoints loaded bit for bit (encoder and vocoder from the port's "
          f"trainer files, Tacotron from a reference .pt, r 2); warm-up on the model thread: "
          f"vocoder.warmup ({n_warm} vocode) {t_warm:.1f} ms, warm_clone {t_warm_clone:.1f} ms; "
          f"/health {t_health:.1f} ms, /embed {t_embed:.1f} ms")
    print(f"{card}: serve: /clone of a 3 s prompt, {frames} frames, one at a time: "
          + ", ".join(f"{t:.1f}" for t in t_clone) + " ms (the first after the warm-up "
          f"{t_clone[0]:.1f} beside the second {t_clone[1]:.1f}); two at once "
          + ", ".join(f"{r[3]:.1f}" for r in together) + f" ms, {t_together:.1f} ms for both")
    print(f"{card}: serve: the same three clones in process "
          + ", ".join(f"{t:.1f}" for t in replay_ms) + f" ms (median "
          f"{float(np.median(replay_ms)):.1f}), served median {float(np.median(t_clone)):.1f} ms; "
          f"served bytes equal the replay's; launches {counts}")
    print(f"serve: the first served clone's kernels on their own inputs against their plain "
          f"versions: {kernel_line}")
    print(f"{card}: serve: {stream_line}")
    return {"served_ms": t_clone, "together_ms": [r[3] for r in together],
            "replay_ms": replay_ms, "warmup_ms": t_warm, "warm_clone_ms": t_warm_clone,
            "frames": frames, "counts": counts}


# the toolbox's requests record the served wrappers and the stream's resumed K2
TOOLBOX_KERNELS = SERVED_KERNELS + (("rtvc_tpu_torch.inference.streaming",
                                     "tacotron_decode_chunk"),)
TOOLBOX_TEXT = "Voice cloning on a single graphics card."
TOOLBOX_SEEDS = 3  # /api/autotune's n_seeds
TOOLBOX_TIMED = 3  # timed /api/synthesize requests after the checked ones
ENGINE_FRAMES = 20  # the mel the engine and K1 decode greedily, unfolded
# the gap of K1's two top logits under which the engine may choose the other
# class: both sum 512-wide f32 products, in other orders
ENGINE_TIE = 1e-3


def ui_request(port, method, path, body=None):
    """(status, headers, body, wall ms) of one request to the browser toolbox."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, dict(resp.getheaders()), data, (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def held_kernel_launches(calls, voc_dims):
    """Every K1, K2, K3 and K4 launch recorded by ``recorded_calls`` again on
    the inputs it was given, against its plain version: K3 and K4 forward
    within 1e-4 (absolute; relative for K4), K2 with dropout off
    (``k2_check``), each resumed K2 launch of a stream from the carry it was
    given, dropout off, as ``k2_chunk_check`` holds it, and K1 greedy
    (``k1_check``). A K1 launch whose inputs equal an earlier one's (a second
    request at the same seed) must give the same samples, and is not held
    again. Returns a line of the launches and the largest errors."""
    import torch

    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops import tacotron_decode as td
    from rtvc_tpu_torch.ops.gru_seq import gru_seq_fwd, gru_seq_fwd_plain
    from rtvc_tpu_torch.ops.lstm_seq import lstm_seq, lstm_seq_plain

    err = dict.fromkeys(("K3", "K4 rel", "K2 mel", "K2 attention", "K2 chunk mel",
                         "K2 chunk carry rel", "K1 head inputs", "K1 samples"), 0.0)
    flips, held, k1_seen = 0, 0, []
    with torch.no_grad():
        for args, _, _ in calls["lstm_seq"]:
            e = max(float((a - b).abs().max()) for a, b in zip(lstm_seq(*args),
                                                                  lstm_seq_plain(*args)))
            check(e <= 1e-4, f"K3 at B={args[0].shape[0]}: {e} from its plain version")
            err["K3"] = max(err["K3"], e)
        for args, _, _ in calls["gru_seq_fwd"]:
            e = max(rel_err(a, b) for a, b in zip(gru_seq_fwd(*args), gru_seq_fwd_plain(*args)))
            check(e <= 1e-4, f"K4 at T={args[0].shape[1]}: rel err {e} from its plain version")
            err["K4 rel"] = max(err["K4 rel"], e)
        for (model, d, seq, proj, mask, _seed, r, max_steps), _, _ in calls["tacotron_decode"]:
            *_, e_mel, e_attn = k2_check(model, d, seq, proj, mask, r, max_steps)
            err["K2 mel"], err["K2 attention"] = (max(err["K2 mel"], e_mel),
                                                  max(err["K2 attention"], e_attn))
        for args, _, _ in calls.get("tacotron_decode_chunk", ()):
            model, d, seq, proj, mask, _seed, r, carry, prev, done, start, n, low, pad = args[:14]
            chunk = (model, d, seq, proj, mask, 0, r, carry, prev, done, start, n, low, pad, False)
            out, ref = td.tacotron_decode_chunk(*chunk), td.tacotron_decode_chunk_plain(*chunk)
            where = f"K2 chunk, iterations {start}-{start + n - 1}"
            check((int(out.valid), int(out.done)) == (int(ref.valid), int(ref.done)),
                  f"{where}: valid / done {int(out.valid)} / {int(out.done)}, plain "
                  f"{int(ref.valid)} / {int(ref.done)}")
            e_mel = float((out.mel - ref.mel).abs().max())
            e_carry = max(rel_err(out.attn, ref.attn),
                          *(rel_err(a, b) for a, b in zip(k2_state(out), k2_state(ref))))
            check(e_mel <= 1e-6 and e_carry <= 1e-5, f"{where}: mel {e_mel}, attention and "
                  f"carry {e_carry} (relative) from the plain loop from its carry")
            err["K2 chunk mel"] = max(err["K2 chunk mel"], e_mel)
            err["K2 chunk carry rel"] = max(err["K2 chunk carry rel"], e_carry)
        for (w, streams, seed, *_), _, out in calls["wavernn_generate_core"]:
            same = [o for w0, s0, seed0, o in k1_seen if seed0 == seed and all(
                torch.equal(a[k], b[k]) for a, b in ((w, w0), (streams, s0)) for k in b)]
            if same:
                check(torch.equal(out, same[0]), "two K1 launches on equal inputs at one seed "
                      "gave different samples")
                continue
            k1_seen.append((w, streams, seed, out))
            _, e_head, e_samples, _, n_flips = k1_check(voc_dims, w, streams)
            err["K1 head inputs"] = max(err["K1 head inputs"], e_head)
            err["K1 samples"] = max(err["K1 samples"], e_samples)
            flips, held = flips + n_flips, held + 1
    n = {name: len(c) for name, c in calls.items()}
    return (f"launches held {n} (K1: {held} on distinct inputs, {flips} folds cut at a "
            f"near-tie); largest errors " + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))


def engine_checks(dev, card, voc, mel, work):
    """The native engine beside K1: the engine built from ``native/src``,
    the vocoder exported with ``native.convert.export_wavernn``, then the
    first ``ENGINE_FRAMES`` frames of ``mel`` decoded greedily and unfolded
    on both (one sequence of frames x hop steps): the same class labels up
    to a near-tie (K1's two top logits within ``ENGINE_TIE``), the samples
    before it within 2e-4 and under 5 % apart (or within 1e-5); then the
    whole mel through ``vocoder.load_model(voc_type="libwavernn")`` on every
    host core, its rate beside K1's ``infer_waveform`` of the same mel.
    Returns the rates."""
    import os

    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.config import sp
    from rtvc_tpu_torch.inference import vocoder
    from rtvc_tpu_torch.models import wavernn as tw
    from rtvc_tpu_torch.native import libwavernn
    from rtvc_tpu_torch.native.convert import export_wavernn
    from rtvc_tpu_torch.ops.wavernn_generate import wavernn_generate_core

    t0 = time.perf_counter()
    built = _build.build_wavernn_engine()
    t_build = time.perf_counter() - t0
    d = voc.dims
    weights = work / "runtimeracer.bin"
    export_wavernn(voc.model, d, weights)
    short = np.ascontiguousarray(mel[:, :ENGINE_FRAMES] / sp.max_abs_value, np.float32)
    inst = libwavernn._Instance(libwavernn._load_lib(), weights)
    t0 = time.perf_counter()
    got = inst.mel_to_wav(short, argmax=True)
    t_inst = time.perf_counter() - t0
    with torch.no_grad():
        mels = torch.nn.functional.pad(torch.from_numpy(short[None]).to(dev), (d.pad, d.pad))
        mu, aux, _ = tw.upsample_forward(voc.model, d, mels)
        streams = {k: v.contiguous() for k, v in tw.hoist_aux(voc.model, d, mu, aux).items()}
        k1, logits = wavernn_generate_core(tw.step_weights(voc.model, d), streams, 0, True,
                                           variant=d.variant, head=d.head, return_logits=True)
    k1, logits = k1[0].cpu().numpy(), logits[0].float().cpu()
    check(got.shape == k1.shape == (ENGINE_FRAMES * d.hop_length,),
          f"the engine gave {got.shape} samples, K1 {k1.shape}")
    C = d.n_classes
    labels = [np.round((x.astype(np.float64) + 1) * (C - 1) / 2) for x in (got, k1)]
    apart = np.nonzero(labels[0] != labels[1])[0]
    t_end = int(apart[0]) if len(apart) else len(k1)
    where = f"the engine against K1 at 1 x {len(k1)} steps, greedy"
    if t_end < len(k1):
        top2 = torch.topk(logits[t_end], 2).values
        gap = float(top2[0] - top2[1])
        growth = [float(np.abs(got[:t + 1] - k1[:t + 1]).max())
                  for t in range(0, t_end + 1, max(t_end // 8, 1))]
        print(f"{where}: samples differ first at step {t_end}, K1's top-2 logit gap there "
              f"{gap:.3e}; sample difference by step {growth}")
        check(gap <= ENGINE_TIE, f"{where}: the labels part at step {t_end} with a gap of "
              f"{gap}, above the near-tie bound {ENGINE_TIE}")
    sample_err = float(np.abs(got[:t_end] - k1[:t_end]).max()) if t_end else 0.0
    mismatch = float(np.mean(got[:t_end] != k1[:t_end])) if t_end else 0.0
    check(sample_err <= 2e-4 and (mismatch < 0.05 or sample_err <= 1e-5),
          f"{where}: samples {sample_err} apart, {mismatch:.1%} not equal")

    bundle = vocoder._bundle
    vocoder.load_model(weights, voc_type="libwavernn", verbose=False)
    try:
        vocoder.set_seed(0)
        wav_e, t_e = timed_ms(lambda: vocoder.infer_waveform(mel))
        n_threads = len(vocoder._native._instances)
    finally:
        vocoder.load_bundle(bundle)
    vocoder.set_seed(0)
    wav_k, t_k = timed_ms(lambda: vocoder.infer_waveform(mel))
    check(wav_e.shape == wav_k.shape == ((mel.shape[1] - 1) * d.hop_length,)
          and np.isfinite(wav_e).all(), f"the engine's vocode gave {wav_e.shape}")
    cpu = next((line.split(":", 1)[1].strip() for line in open("/proc/cpuinfo")
                if line.startswith("model name")), "unknown")
    khz_e, khz_k = len(wav_e) / t_e, len(wav_k) / t_k
    print(f"toolbox: native engine built in {t_build:.1f} s ({built.library.name}, "
          f"{built.cli.name}); {where}: labels equal through step {t_end} of {len(k1)}, "
          f"samples {sample_err:.3e} apart before it, {mismatch:.2%} not equal; one instance "
          f"{len(k1) / t_inst / 1e3:.2f} kHz greedy")
    print(f"{card}; host CPU {cpu}, {os.cpu_count()} cores: vocoder.load_model(voc_type="
          f"'libwavernn') vocodes the clone's {mel.shape[1]}-frame mel ({len(wav_e)} samples) in "
          f"{t_e:.1f} ms on {n_threads} threads: {khz_e:.2f} kHz; K1 (infer_waveform, the "
          f"checkpoint's window) {t_k:.1f} ms: {khz_k:.2f} kHz")
    return {"engine_khz": khz_e, "k1_khz": khz_k, "engine_ms": t_e, "k1_ms": t_k,
            "host_cpu": cpu, "threads": n_threads}


def phase_toolbox(dev, card, syn, voc):
    """The browser toolbox (``webui.py``) through ``serve.create_server(...,
    ui=True)`` on ``phase_serve``'s checkpoints, loaded through the inference
    modules' ``load_model`` (the Tacotron cut to ``max_decoder_steps`` 400
    frames, the clone path's depth), over a samples directory of one of the
    repository's mp3s and a wav of ``serve.voiced_prompt``. By HTTP, in
    order: ``GET /``, ``/api/samples``, ``POST /api/load`` by ``?sample=``
    (the mp3 where a decoder for it exists; else its refusal is checked and
    the wav is loaded) and by a WAV body, ``GET /api/projection``, ``POST
    /api/synthesize?seed=3`` twice (equal bytes), ``GET /api/mel``, ``POST
    /api/autotune?n_seeds=3`` and ``GET /api/stream``, each answer checked,
    every kernel launch of them counted and held to its plain version
    (``held_kernel_launches``); then ``/api/synthesize`` and an autotune
    timed without the recording. Then the native engine beside K1
    (``engine_checks``). Returns the launches and the times."""
    import threading

    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.serve import _parse_wav, _wav_bytes, create_server, voiced_prompt
    from rtvc_tpu_torch.utils import libav, mpeg
    from rtvc_tpu_torch.utils.io import save_wav

    work = _build.BUILD_DIR / "smoke_toolbox"
    shutil.rmtree(work, ignore_errors=True)
    samples = work / "samples"
    samples.mkdir(parents=True)
    server = thread = None
    try:
        enc = factories.init_encoder_model(0, dev)
        paths = write_serve_checkpoints(work, enc, syn, voc)
        encoder.load_model(paths["encoder"], device=dev)
        synthesizer.load_model(paths["synthesizer"], verbose=False, device=dev)
        vocoder.load_model(paths["vocoder"], verbose=False, device=dev)
        synth = synthesizer._model
        synth.load_bundle(synth._bundle._replace(config=synth._bundle.config.replace(
            max_decoder_steps=CLONE_FRAMES)), r=synth._r)
        mp3 = sorted((Path(__file__).resolve().parent / "samples").glob("*.mp3"))[0]
        shutil.copy(mp3, samples / mp3.name)
        save_wav(voiced_prompt(1), samples / "prompt.wav", 16000)
        mp3_decodes = mpeg.mpeg_supported() or libav.libav_supported()

        server = create_server("127.0.0.1", 0, synth=synth, samples_dir=samples)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        text = TOOLBOX_TEXT.replace(" ", "%20")
        ms = {}
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        with recorded_calls(TOOLBOX_KERNELS) as calls:
            status, headers, page, ms["page"] = ui_request(port, "GET", "/")
            check(status == 200 and headers["Content-Type"] == "text/html; charset=utf-8"
                  and b"/api/autotune" in page, f"GET / answered {status}")
            status, _, listed, ms["samples"] = ui_request(port, "GET", "/api/samples")
            check(status == 200 and json.loads(listed) == {
                "samples": sorted([mp3.name, "prompt.wav"]), "loaded": []},
                f"/api/samples answered {status}: {listed[:200]}")
            status, _, loaded, ms["load sample"] = ui_request(
                port, "POST", f"/api/load?sample={mp3.name}")
            if not mp3_decodes:
                check(status == 500 and b"libmpg123" in loaded, f"/api/load of an mp3 without "
                      f"a decoder answered {status}: {loaded[:200]}")
                print(f"toolbox: no mp3 decoder on this host (libmpg123 or the FFmpeg codec "
                      f"shim): /api/load?sample={mp3.name} answered {status} "
                      f"{json.loads(loaded)['error'][:120]!r}; loading prompt.wav instead")
                status, _, loaded, ms["load sample"] = ui_request(
                    port, "POST", "/api/load?sample=prompt.wav")
            check(status == 200, f"/api/load?sample= answered {status}: {loaded[:200]}")
            by_sample = json.loads(loaded)
            body = _wav_bytes(voiced_prompt(0), 16000)
            status, _, loaded, ms["load body"] = ui_request(port, "POST", "/api/load?name=prompt0",
                                                            body)
            check(status == 200, f"/api/load of a WAV body answered {status}: {loaded[:200]}")
            by_body = json.loads(loaded)
            for got in (by_sample, by_body):
                e = np.asarray(got["embed"])
                check(e.shape == (768,) and abs(float(np.linalg.norm(e)) - 1.0) < 1e-4
                      and got["seconds"] > 1.0, f"/api/load gave {got['name']} {e.shape}")
            status, _, points, ms["projection"] = ui_request(port, "GET", "/api/projection")
            points = json.loads(points)["points"]
            check(status == 200 and sorted(p["name"] for p in points) == sorted(
                [by_sample["name"], "prompt0"]) and all(np.isfinite([p["x"], p["y"]]).all()
                                                        for p in points),
                  f"/api/projection answered {status}: {points}")
            utt = "/api/synthesize?utt=prompt0&seed=3&text=" + text
            synthesized = [ui_request(port, "POST", utt) for _ in range(2)]
            clone_mel = server.ui_state.last_mel
            status, _, mel_json, ms["mel"] = ui_request(port, "GET", "/api/mel")
            mel_json = json.loads(mel_json)
            tune = f"/api/autotune?utt=prompt0&n_seeds={TOOLBOX_SEEDS}&text=" + text
            status_t, headers_t, tuned, ms["autotune (recorded)"] = ui_request(port, "POST", tune)
            streamed = ui_request(port, "GET", "/api/stream?utt=prompt0&text=" + text)
        counts = dict(_build.launch_counts)
        frames = clone_mel.shape[1]
        x, sr = _parse_wav(body)
        want = encoder.embed_utterance(encoder.preprocess_wav(x, source_sr=sr))
        check(np.array_equal(np.asarray(by_body["embed"]), want.astype(np.float64)),
              "/api/load's embedding differs from embed_utterance's")
        for status, headers, wav, _ in synthesized:
            check(status == 200 and headers["Content-Type"] == "audio/wav"
                  and headers["X-Mel-Frames"] == str(frames) and float(headers["X-RTF"]) > 0,
                  f"/api/synthesize answered {status} {headers}")
            out, sr_out = _parse_wav(wav)
            check(sr_out == 16000 and out.shape == ((frames - 1) * 200,)
                  and np.isfinite(out).all(), f"/api/synthesize gave {out.shape} samples")
        check(synthesized[0][2] == synthesized[1][2], "two /api/synthesize at seed 3 differ")
        check(mel_json["n_mels"] == 80 and mel_json["frames"] == frames
              and len(mel_json["mel"]) == 80, f"/api/mel gave {mel_json['n_mels']} x "
              f"{mel_json['frames']}")
        check(status_t == 200 and 0 <= int(headers_t["X-Best-Seed"]) < TOOLBOX_SEEDS
              and -1.0 <= float(headers_t["X-Similarity"]) <= 1.0,
              f"/api/autotune answered {status_t} {headers_t}")
        status, headers, data, ms["stream"] = streamed
        n_chunks = len(calls["tacotron_decode_chunk"])
        check(status == 200 and headers.get("Transfer-Encoding") == "chunked"
              and (len(data) - 44) % 2 == 0 and len(data) > 44 + 2 * 200 * 16,
              f"/api/stream answered {status}, {len(data)} bytes")
        layers = encoder._model_cfg.model_num_layers
        want = {"lstm_seq": layers * (2 + TOOLBOX_SEEDS), "tacotron_decode": 2 + TOOLBOX_SEEDS,
                "gru_seq": 4 * (2 + TOOLBOX_SEEDS) + 2 + 2 * n_chunks,
                "wavernn_generate_runtimeracer": 2 + TOOLBOX_SEEDS + n_chunks,
                "tacotron_decode_chunk": n_chunks}
        check(counts == want, f"the toolbox's requests launched {counts}, want {want} (two "
              f"loads, two syntheses, {TOOLBOX_SEEDS} autotune seeds, a stream of {n_chunks} "
              f"chunks)")
        kernel_line = held_kernel_launches(calls, vocoder._bundle.dims)

        # the times without the recording's copies
        t_synth = []
        for _ in range(TOOLBOX_TIMED):
            status, _, _, t = ui_request(port, "POST", utt)
            check(status == 200, f"a timed /api/synthesize answered {status}")
            t_synth.append(t)
        status, _, _, t_tune = ui_request(port, "POST", tune)
        check(status == 200, f"the timed /api/autotune answered {status}")
        print(f"{card}: toolbox: GET / {ms['page']:.1f} ms, /api/samples {ms['samples']:.1f} ms, "
              f"/api/load by sample {ms['load sample']:.1f} ms and by body "
              f"{ms['load body']:.1f} ms, /api/projection {ms['projection']:.1f} ms, /api/mel "
              f"{ms['mel']:.1f} ms; /api/synthesize ({frames} frames) "
              + ", ".join(f"{t:.1f}" for t in t_synth) + f" ms (median "
              f"{float(np.median(t_synth)):.1f}); /api/autotune of {TOOLBOX_SEEDS} seeds "
              f"{t_tune:.1f} ms ({t_tune / TOOLBOX_SEEDS:.1f} ms a seed; best seed "
              f"{headers_t['X-Best-Seed']}, similarity {headers_t['X-Similarity']}); "
              f"/api/stream {n_chunks} chunks in {ms['stream']:.1f} ms; launches {counts}")
        print(f"toolbox: every kernel launch of the requests on its own inputs against its "
              f"plain version: {kernel_line}")
        engine = engine_checks(dev, card, vocoder._bundle, clone_mel, work)
        return {"counts": counts, "synthesize_ms": t_synth, "autotune_ms": t_tune,
                "autotune_seed_ms": t_tune / TOOLBOX_SEEDS, "frames": frames, **engine}
    finally:
        if thread is not None:
            server.shutdown()
            thread.join(30)
        if server is not None:
            server.server_close()
        shutil.rmtree(work, ignore_errors=True)


# torch.testing's tolerance for bf16, the one the CPU tests hold the plain
# bf16 versions to against the JAX package: a kernel and its plain version
# round f32 values that their sums in another order may put on two sides of
# a bf16 rounding boundary
BF16_TOL = dict(rtol=1.6e-2, atol=1e-5)


def bf16_close(name, got, want):
    """A kernel's bf16 stream against its plain version's within
    ``BF16_TOL``; returns the largest absolute difference."""
    diff = (got.float() - want.float()).abs()
    bad = diff > BF16_TOL["atol"] + BF16_TOL["rtol"] * want.float().abs()
    check(not bool(bad.any()), f"{name}: {int(bad.sum())} entries past bf16's tolerance "
          f"{BF16_TOL}, the largest difference {float(diff.max())}")
    return float(diff.max())


def held(label, got, want):
    """A training kernel's outputs against its plain version's on the same
    inputs, in the same dtypes: bf16 streams within ``BF16_TOL``, f32
    outputs (state, dxg, dh0, dc0) within 1e-4 of their largest entry (sums
    over T in another order). Returns (the largest absolute difference, the
    largest relative error of the f32 outputs)."""
    import torch

    from rtvc_tpu_torch.ops import rel_err

    abs_err = rel = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.dtype == b.dtype, f"{label}: output {i} is {a.dtype}, its plain version's "
              f"{b.dtype}")
        if a.dtype == torch.bfloat16:
            abs_err = max(abs_err, bf16_close(f"{label} output {i}", a, b))
            continue
        e = rel_err(a, b)
        check(e <= 1e-4, f"{label}: output {i} rel err {e} from its plain version")
        rel, abs_err = max(rel, e), max(abs_err, float((a - b).abs().max()))
    return abs_err, rel


def grads_of(fn, leaves, cotangents):
    """Gradients of ``fn(*leaves)`` against ``cotangents``, on fresh leaves."""
    import torch

    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    out = fn(*leaves)
    torch.autograd.backward(out if isinstance(out, tuple) else (out,), cotangents)
    return [t.grad for t in leaves]


def phase_lstm_train(dev):
    """K3's training halves at the GE2E training shape: the forward with
    residuals and the backward, against autograd through the plain forward
    (tolerance 1e-4 of the reference's largest entry: f32 sums over T are
    taken in another order)."""
    import torch

    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops.lstm_seq import (
        LSTMSeqFn,
        lstm_seq_bwd,
        lstm_seq_bwd_plain,
        lstm_seq_fwd_train,
        lstm_seq_fwd_train_plain,
        lstm_seq_plain,
    )

    B, T, H = 640, 160, 768
    g = torch.Generator().manual_seed(4)
    xg = torch.randn(B, T, 4 * H, generator=g).to(dev)
    w_hh = ((torch.rand(4 * H, H, generator=g) * 2 - 1) * H ** -0.5).to(dev)
    h0, c0, dhT, dcT = ((torch.randn(B, H, generator=g) * 0.5).to(dev) for _ in range(4))
    dys = torch.randn(B, T, H, generator=g).to(dev)
    got = lstm_seq_fwd_train(xg, w_hh, h0, c0)
    ref = lstm_seq_fwd_train_plain(xg, w_hh, h0, c0)
    torch.cuda.synchronize()
    fwd_err = max(rel_err(a, b) for a, b in zip(got, ref))
    check(fwd_err <= 1e-4, f"K3 forward with residuals differs from its plain version: {fwd_err}")
    _, _, _, cs, gates = ref
    k_grads = grads_of(LSTMSeqFn.apply, (xg, w_hh, h0, c0), (dys, dhT, dcT))
    p_grads = grads_of(lstm_seq_plain, (xg, w_hh, h0, c0), (dys, dhT, dcT))
    torch.cuda.synchronize()
    errs = {n: rel_err(a, b) for n, a, b in zip(("dxg", "dW_hh", "dh0", "dc0"), k_grads, p_grads)}
    abs_err = max(float((a - b).abs().max()) for a, b in zip(k_grads, p_grads))
    check(max(errs.values()) <= 1e-4, f"K3 backward differs from autograd: {errs}")
    fwd_ms = cuda_ms(lambda: lstm_seq_fwd_train(xg, w_hh, h0, c0))
    fwd_plain_ms = cuda_ms(lambda: lstm_seq_fwd_train_plain(xg, w_hh, h0, c0))
    bwd_args = (dys, dhT, dcT, gates, cs, c0, w_hh)
    check(all(torch.equal(a, c) for a, c in zip(lstm_seq_bwd(*bwd_args), lstm_seq_bwd(*bwd_args))),
          "K3 backward: two runs on the same inputs differ in their bits")
    ms = cuda_ms(lambda: lstm_seq_bwd(*bwd_args))
    plain_ms = cuda_ms(lambda: lstm_seq_bwd_plain(*bwd_args))
    lib_fwd_ms, lib_bwd_ms = rnn_ms(torch.nn.LSTM(H, H, batch_first=True), B, T, H, dev)
    flops = 2 * B * T * 4 * H * H
    b = bound(nbytes(*bwd_args, k_grads[0], dhT, dcT), flops)
    fwd_b = bound(nbytes(xg, w_hh, h0, c0, *ref), flops)
    print(f"K3 lstm_seq training B={B} T={T} H={H}: forward with residuals "
          f"({k3_plan(B, H, dev)}) rel err {fwd_err:.3e}, kernel {fwd_ms:.3f} ms "
          f"({fwd_ms / K3_RESIDENT_MS['fwd_train']:.3f} of its time before the sharing; "
          f"earlier kernel {K3_EARLIER_MS['fwd_train']} ms), plain {fwd_plain_ms:.3f} ms, nn.LSTM "
          f"{lib_fwd_ms:.3f} ms, bound {fwd_b['bound_ms']:.4f} ms by {fwd_b['bound_by']}; "
          f"backward ({k3_plan(B, H, dev, backward=True)}) rel errs "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (tol 1e-4), bits repeat, kernel {ms:.3f} ms ({ms / K3_RESIDENT_MS['bwd']:.3f} "
          f"of its time before the sharing; earlier kernel {K3_EARLIER_MS['bwd']} ms), plain "
          f"{plain_ms:.3f} ms, nn.LSTM "
          f"{lib_bwd_ms:.3f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    return {"name": "lstm_seq_bwd", "source": "rtvc_tpu_torch/csrc/lstm_seq.cu",
            "replaces": "rtvc_tpu/ops/pallas/lstm_train_kernel.py:158",
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": lib_bwd_ms, "fwd_train_ms": fwd_ms,
            "fwd_train_plain_ms": fwd_plain_ms, "fwd_train_bound_ms": fwd_b["bound_ms"],
            "fwd_train_library_ms": lib_fwd_ms}


# (B, T) of the CBHG BiGRUs (hidden 64 over 128 channels) that K4 runs: the
# clone's encoder (its 64-character bucket) and postnet (its 512-frame
# bucket), the Tacotron step's encoder (160 characters) and postnet (602
# frames)
CBHG_SHAPES = ((1, 64), (1, 512), (112, 160), (112, 602))

# (B, T, H) of K4 in a ForwardTacotron training step: the predictors' BiGRUs
# (H 64 duration and energy, H 128 pitch) and the prenet CBHG's (H 256) over
# 160 characters, the postnet CBHG's (H 256) over 900 frames
NAR_TRAIN_GRU_SHAPES = ((16, 160, 64), (16, 160, 128), (16, 160, 256), (16, 900, 256))


# (B, T, H, grad) of K4's other narrow shapes on the port's paths: a DP rank's
# postnet CBHG, the ForwardTacotron step's predictors, the GTA pass's (no
# gradient)
NARROW_GRU_SHAPES = ((56, 602, 64, True), (16, 160, 64, True), (16, 160, 128, True),
                     (8, 160, 64, False), (8, 160, 128, False))


def phase_gru(dev):
    """K4 forward and backward at the three vocoder training shapes
    (runtimeracer, whose numbers are the kernels' entries; fatchord's H 512;
    geneing's T 1400), at the four CBHG BiGRU shapes (H 64) and at the other
    narrow shapes (``NARROW_GRU_SHAPES``), each against autograd through the
    plain forward; at every narrow shape the row-resident plan beside the
    cooperative one in the same call (``gru_shape``)."""
    first = gru_shape(dev, 40, 1000, 256)
    for e in first:
        e["shapes"] = []
    # B 1 is the clone's, which takes no gradient
    for B, T, H, grad in ((40, 1000, 512, True), (40, 1400, 256, True),
                          *((B, T, 64, B > 1) for B, T in CBHG_SHAPES), *NARROW_GRU_SHAPES):
        for e, other in zip(first, gru_shape(dev, B, T, H, grad=grad)):
            e["shapes"].append({"B": B, "T": T, "H": H, **{k: other[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "plan",
                "mode", "cooperative_ms", "library", "bidir_library_ms", "module_ms")}})
    return first


def cbhg_gru(dev):
    """The port's bidirectional ``GRU`` module as the CBHG builds it (128
    channels, hidden 64) with seeded weights: two input products and two K4
    sequences a pass."""
    import torch

    from rtvc_tpu_torch.models.layers import GRU

    torch.manual_seed(9)
    m = GRU(128, 64, bidirectional=True, device=dev)
    for p in m.parameters():
        torch.nn.init.uniform_(p, -0.125, 0.125)
    return m


def gru_shape(dev, B, T, H, grad=True, dtype=None, library_in=None):
    """K4 forward and backward at one shape, against autograd through the
    plain forward (tolerance as for K3), beside cuDNN's ``nn.GRU(H, H)``
    (``nn.GRU(library_in, H)`` where given: the DeepMind WaveRNN's 3 inputs),
    one direction as K4 computes it. At the CBHG's H 64 the whole BiGRU is
    timed too: cuDNN's bidirectional ``nn.GRU(128, 64)`` beside the port's
    ``GRU`` module (two K4 launches a pass). The forward's bound writes the
    gates only where its path takes a gradient (``grad``), as only the
    backward reads them.

    With ``dtype`` bf16 the bf16 instantiation instead: bf16 streams,
    weights and dys, its forward and its backward kernel each against its
    plain bf16 version on the same inputs (``held``: ys and the gates within
    ``BF16_TOL``, the f32 dxg within 1e-4), the f32 kernel timed beside it
    on the same values, cuDNN and the port's module in bf16, the plan at
    2-byte weights and the bound at the bf16 peak."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops.gru_seq import (
        GRUSeqFn,
        describe,
        gru_seq_bwd,
        gru_seq_bwd_plain,
        gru_seq_fwd,
        gru_seq_fwd_plain,
        mode,
        plan,
    )

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    tag = " bf16" if bf16 else ""
    g = torch.Generator().manual_seed(5)
    s = H ** -0.5
    xg = torch.randn(B, T, 3 * H, generator=g).to(dev, dtype)
    w_hh = ((torch.rand(3 * H, H, generator=g) * 2 - 1) * s).to(dev, dtype)
    b_hh = ((torch.rand(3 * H, generator=g) * 2 - 1) * s).to(dev, dtype)
    dys = torch.randn(B, T, H, generator=g).to(dev, dtype)
    ys, gates = gru_seq_fwd(xg, w_hh, b_hh)
    p_ys, p_gates = gru_seq_fwd_plain(xg, w_hh, b_hh)
    torch.cuda.synchronize()
    check(ys.dtype == gates.dtype == dtype, f"K4{tag} forward gave {ys.dtype}, {gates.dtype}")
    if bf16:
        fwd_abs, _ = held(f"K4 bf16 forward at B={B} T={T} H={H}", (ys, gates), (p_ys, p_gates))
        fwd_err = "bf16 tol"
    else:
        fwd_err = max(rel_err(ys, p_ys), rel_err(gates, p_gates))
        fwd_abs = max(float((ys - p_ys).abs().max()), float((gates - p_gates).abs().max()))
        check(fwd_err <= 1e-4, f"K4 forward differs from its plain version: {fwd_err}")
        fwd_err = f"rel err {fwd_err:.3e}"
    bwd_args = (dys, p_gates, p_ys, w_hh)
    if bf16:
        # dW_hh and db_hh are one product outside the kernel, from its f32 dxg
        k_grads, p_grads = (gru_seq_bwd(*bwd_args),), (gru_seq_bwd_plain(*bwd_args),)
        names = ("dxg",)
    else:
        k_grads = grads_of(GRUSeqFn.apply, (xg, w_hh, b_hh), (dys,))
        p_grads = grads_of(lambda *a: gru_seq_fwd_plain(*a)[0], (xg, w_hh, b_hh), (dys,))
        names = ("dxg", "dW_hh", "db_hh")
    torch.cuda.synchronize()
    errs = {n: rel_err(a, b) for n, a, b in zip(names, k_grads, p_grads)}
    check(k_grads[0].dtype == torch.float32, f"K4{tag} backward gave dxg in {k_grads[0].dtype}")
    bwd_abs = max(float((a - b).abs().max()) for a, b in zip(k_grads, p_grads))
    check(max(errs.values()) <= 1e-4, f"K4{tag} backward differs at B={B} T={T} H={H}: {errs}")
    check(torch.equal(gru_seq_bwd(*bwd_args), gru_seq_bwd(*bwd_args)),
          f"K4{tag} backward: two runs on the same inputs differ in their bits")
    ms = cuda_ms(lambda: gru_seq_fwd(xg, w_hh, b_hh))
    plain_ms = cuda_ms(lambda: gru_seq_fwd_plain(xg, w_hh, b_hh), reps=2)
    bwd_ms = cuda_ms(lambda: gru_seq_bwd(*bwd_args))
    bwd_plain_ms = cuda_ms(lambda: gru_seq_bwd_plain(*bwd_args), reps=2)
    f32_ms = (None, None)
    if bf16:  # the f32 kernel on the same values
        f32_in = (xg.float(), w_hh.float(), b_hh.float())
        ys32, gates32 = gru_seq_fwd(*f32_in)
        f32_ms = (cuda_ms(lambda: gru_seq_fwd(*f32_in)),
                  cuda_ms(lambda: gru_seq_bwd(dys.float(), gates32, ys32, f32_in[1])))
    cbhg = H == 64
    lib_in = library_in or H
    lib_fwd_ms, lib_bwd_ms = rnn_ms(torch.nn.GRU(lib_in, H, batch_first=True), B, T, H, dev,
                                    dtype=dtype)
    library = f"nn.GRU({lib_in}, {H}){tag}, input projection included"
    bi_fwd_ms, bi_bwd_ms = (rnn_ms(torch.nn.GRU(128, 64, batch_first=True, bidirectional=True),
                                   B, T, H, dev, dtype=dtype) if cbhg else (None, None))
    mod_fwd_ms, mod_bwd_ms = (rnn_ms(cbhg_gru(dev), B, T, H, dev, dtype=dtype) if cbhg
                              else (None, None))
    module = (f"; the whole BiGRU (128 -> 2 x 64, both directions, input products included): "
              f"nn.GRU(128, 64, bidirectional=True) forward {bi_fwd_ms:.3f} ms, backward "
              f"{bi_bwd_ms:.3f} ms, the port's GRU module forward {mod_fwd_ms:.3f} ms, "
              f"backward {mod_bwd_ms:.3f} ms" if cbhg else "")
    flops, peak = 2 * B * T * 3 * H * H, BF16_FLOPS if bf16 else F32_FLOPS
    fwd_b = bound(nbytes(xg, w_hh, b_hh, ys, *((gates,) if grad else ())), flops, peak)
    bwd_b = bound(nbytes(*bwd_args, k_grads[0]), flops, peak)
    limits, elem = _build.device_limits(dev), 2 if bf16 else 4
    p_fwd = plan(B, H, *limits, elem=elem)
    p_bwd = plan(B, H, *limits, backward=True, elem=elem)
    coop_ms = (None, None)
    if mode(p_fwd) == "row-resident":
        # the earlier design on the same inputs, through an explicit plan vector
        coop_out, *coop_ms = k4_cooperative(xg, w_hh, b_hh, bwd_args, dev)
        if not bf16:
            coop_err = max(rel_err(a, b) for a, b in zip(coop_out, (ys, gates, k_grads[0])))
            check(coop_err <= 1e-4, f"K4 at B={B} T={T} H={H}: the row-resident kernels are "
                  f"{coop_err} from the cooperative ones")
    earlier = K4_COOPERATIVE_EARLIER_MS if (B, T, H) in K4_COOPERATIVE_EARLIER_MS else K4_EARLIER_MS
    what = "cooperative plan" if earlier is K4_COOPERATIVE_EARLIER_MS else "kernel"
    was = [(f", cooperative plan {c:.3f} ms" if c is not None else "")
           + (f" (an earlier call's {what} {t} ms)" if t and not bf16 else "")
           for c, t in zip(coop_ms, earlier.get((B, T, H), (None, None)))]
    f32_was = [f", f32 kernel {t:.3f} ms" if t else "" for t in f32_ms]
    print(f"K4 gru_seq{tag} B={B} T={T} H={H}: forward ({describe(p_fwd)}) {fwd_err}, kernel "
          f"{ms:.3f} ms{was[0]}{f32_was[0]}, plain {plain_ms:.3f} ms, {library} "
          f"{lib_fwd_ms:.3f} ms, bound {fwd_b['bound_ms']:.4f} ms by {fwd_b['bound_by']}; "
          f"backward ({describe(p_bwd)}) rel errs "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (tol 1e-4), bits repeat, kernel {bwd_ms:.3f} ms{was[1]}{f32_was[1]}, "
          f"plain {bwd_plain_ms:.3f} ms, nn.GRU {lib_bwd_ms:.3f} ms, bound "
          f"{bwd_b['bound_ms']:.4f} ms by {bwd_b['bound_by']}{module}")
    extra = [{"f32_kernel_ms": t} if bf16 else {} for t in f32_ms]
    return [{"name": "gru_seq" + tag.replace(" ", "_"), "source": "rtvc_tpu_torch/csrc/gru_seq.cu",
             "replaces": "rtvc_tpu/ops/pallas/gru_train_kernel.py:71",
             "max_abs_err": fwd_abs, "ms": ms, "plain_ms": plain_ms, **fwd_b,
             "library_ms": lib_fwd_ms, "plan": list(p_fwd[:5]), "mode": mode(p_fwd),
             "cooperative_ms": coop_ms[0], "library": library,
             "bidir_library_ms": bi_fwd_ms, "module_ms": mod_fwd_ms, **extra[0]},
            {"name": "gru_seq_bwd" + tag.replace(" ", "_"),
             "source": "rtvc_tpu_torch/csrc/gru_seq.cu",
             "replaces": "rtvc_tpu/ops/pallas/gru_train_kernel.py:111",
             "max_abs_err": bwd_abs, "ms": bwd_ms, "plain_ms": bwd_plain_ms, **bwd_b,
             "library_ms": lib_bwd_ms, "plan": list(p_bwd[:5]), "mode": mode(p_bwd),
             "cooperative_ms": coop_ms[1], "library": library,
             "bidir_library_ms": bi_bwd_ms, "module_ms": mod_bwd_ms, **extra[1]}]


# K5 with one CTA a batch row (before each direction was split over the
# card), CUDA-event ms on an NVIDIA H100 80GB HBM3 at 700 W, by (B, n_iters):
# the mean of the two runs of `profile_tacotron_train.py --wrapper` over that
# package (parent, this, this, parent) in an earlier call, the one PERF.md
# section 6 quotes. Printed beside the new times in the phase's own lines
# only, marked as an earlier call's.
K5_FWD_EARLIER_MS = {(112, 86): 32.113, (22, 602): 218.737}
K5_BWD_EARLIER_MS = {(112, 86): 51.166, (22, 602): 327.727}
# (B, n_iters) of K5: the first session of the Tacotron schedule (r 7, batch
# 112, 602 frames) and the last (r 1, batch 22)
K5_SHAPES = ((112, 86), (22, 602))
K5_WIDTHS = dict(T=160, D=256, L=512, E=896, KS=31)


def k5_weights(g, dev):
    """The chain's weights at the full widths, from ``g``."""
    import torch

    from rtvc_tpu_torch.ops import tacotron_train as tk

    D, L, E, KS = (K5_WIDTHS[k] for k in ("D", "L", "E", "KS"))

    def u(*shape, fan):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * fan ** -0.5).to(dev)

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)

    return tk.TrainWeights(
        gwh=u(D, 3 * D, fan=D), gbh=u(3 * D, fan=D), wq=u(D, D, fan=D), bq=u(D, fan=D),
        mloc=r(KS, D, s=0.1), vv=u(D, fan=D), wri=u(E + D, L, fan=E + D), bri=u(L, fan=E + D),
        l1wi=u(L, 4 * L, fan=L), l1wh=u(L, 4 * L, fan=L), l1b=u(4 * L, fan=L),
        l2wi=u(L, 4 * L, fan=L), l2wh=u(L, 4 * L, fan=L), l2b=u(4 * L, fan=L),
        gwi_ctx=u(E, 3 * D, fan=E))


def k5_case(g, dev, B, n):
    """Inputs and cotangents of the chain at the full widths, from ``g``."""
    import torch

    T, D, L, E = (K5_WIDTHS[k] for k in "TDLE")

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)

    lens = torch.randint(T // 2, T + 1, (B,), generator=g)
    x = dict(xg_pre=r(n, B, 3 * D), enc_seq=r(B, T, E, s=0.5), enc_proj=r(B, T, D, s=0.5),
             char_mask=(torch.arange(T)[None, :] < lens[:, None]).float().to(dev),
             zo1=(torch.rand(n, B, L, generator=g) < 0.1).float().to(dev),
             zo2=(torch.rand(n, B, L, generator=g) < 0.1).float().to(dev))
    return x, [r(n, B, L), r(n, B, E), r(n, B, T)]


def k5_candidates(label, planner, launch, want, n, B, dev):
    """Every candidate plan of one direction forced through the kernel, each
    held to the plain version's outputs ``want`` (1e-4 of each output's
    largest entry) and timed: [(ms, plan, max rel err)], fastest first."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops import tacotron_train as tk

    T, D, L, E, KS = (K5_WIDTHS[k] for k in ("T", "D", "L", "E", "KS"))
    lib = _build.library()
    cand = []
    for c in tk.CANDIDATES:
        try:
            p = planner(n, B, T, (D, L, E, KS), dev, candidate=c)
        except ValueError as e:
            print(f"  {label} candidate {c}: {e}")
            continue
        forced = launch(lib, p)
        torch.cuda.synchronize()
        worst = max(rel_err(a, b) for a, b in zip(forced, want))
        check(worst <= 1e-4, f"{label} B={B} n={n} under candidate {p.name} differs from its "
              f"plain version: rel err {worst:.3e}")
        del forced
        cand.append((cuda_ms(lambda: launch(lib, p), reps=2), p, worst))
    return sorted(cand, key=lambda r: r[0])


def k5_cand_line(label, B, n, cand, chosen):
    return (f"  {label} B={B} n={n} candidates, ms (model ms, max rel err against the plain "
            f"version, tol 1e-4), fastest first: " + "; ".join(
                f"{p.name} {t:.3f} ({p.cost_ms:.3f}, {e:.3e})" + (" (plan)" if p == chosen else "")
                for t, p, e in cand))


def k5_fwd_bound(w, x, outputs):
    """K5's forward bound on these weights and inputs: per row and
    iteration the eight products, then the attention (the location term
    T·D·KS, energies, scores and context); ``outputs`` written once."""
    n, B, _ = x["xg_pre"].shape
    T, E = x["enc_seq"].shape[1:]
    D, L, KS = w.gwh.shape[0], w.l1wh.shape[0], w.mloc.shape[0]
    mats = D * 3 * D + D * D + (E + D) * L + 4 * L * 4 * L + E * 3 * D
    flops = 2 * n * B * (mats + T * D * KS + 2 * T * D + T * E)
    return bound(nbytes(*w, *x.values(), *outputs), flops)


def k5_fwd_cell(dev, w, x, candidates=False):
    """K5's forward at one shape through the wrapper and the card's plan,
    against its plain version (every output within 1e-4 of the reference's
    largest entry: f32 sums taken in another order, carried through every
    step), and twice: it uses no atomics, so the two runs' bits are equal.
    Its time beside the plain version's and its bound; with ``candidates``
    also every candidate plan through the kernel, each held to the plain
    version in the same way and timed, the plan's choice marked. Returns the
    cell and the plain version's residuals, which the backward's cell takes."""
    import torch

    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops import tacotron_train as tk

    n, B, _ = x["xg_pre"].shape
    T, E = x["enc_seq"].shape[1:]
    D, L, KS = w.gwh.shape[0], w.l1wh.shape[0], w.mloc.shape[0]
    chosen = tk.device_plan_fwd(n, B, T, (D, L, E, KS), dev)
    x_all, res = tk.taco_train_fwd(w, **x)
    x_again, res_again = tk.taco_train_fwd(w, **x)
    p_x, p_res = tk.taco_train_fwd_plain(w, **x)
    torch.cuda.synchronize()
    got, want = (x_all, *res), (p_x, *p_res)
    errs = dict(zip(("x_all",) + res._fields, (rel_err(a, b) for a, b in zip(got, want))))
    abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(max(errs.values()) <= 1e-4, f"K5 forward B={B} n={n} differs from its plain version: "
          f"{errs}")
    check(all(torch.equal(a, b) for a, b in zip(got, (x_again, *res_again))),
          f"K5 forward B={B} n={n}: two runs on the same inputs differ in their bits")
    del x_all, res, x_again, res_again, got
    ms = cuda_ms(lambda: tk.taco_train_fwd(w, **x))
    plain_ms = cuda_ms(lambda: tk.taco_train_fwd_plain(w, **x), reps=2)
    def launch(lib, p):
        out, res = tk.fwd_launch(lib, w, **x, p=p)
        return (out, *res)

    cand = k5_candidates("K5 forward", tk.device_plan_fwd, launch, want, n, B, dev) \
        if candidates else []
    b = k5_fwd_bound(w, x, want)
    was = K5_FWD_EARLIER_MS.get((B, n))
    print(f"K5 tacotron_train forward B={B} n_iters={n} T={T} D={D} L={L} E={E} (plan "
          f"{chosen.name}, {chosen.ctas} CTAs, {chosen.smem} bytes of shared memory a CTA, model "
          f"{chosen.cost_ms:.3f} ms): rel errs max {max(errs.values()):.3e} "
          f"({max(errs, key=errs.get)}, tol 1e-4), bits repeat, kernel {ms:.3f} ms "
          f"({ms / n * 1e3:.2f} us a step"
          + (f"; one-CTA-a-row kernel {was} ms in an earlier call" if was else "")
          + f"), plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    if cand:
        print(k5_cand_line("K5 forward", B, n, cand, chosen))
    return {"B": B, "n_iters": n, "T": T, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms, **b, "library_ms": None, "plan": chosen.name,
            "candidates": {p.name: t for t, p, _ in cand}}, p_res


def k5_bwd_cell(dev, w, x, cots, p_res, candidates=False):
    """K5's backward at one shape on the plain forward's residuals, against
    its plain version (every output within 1e-4 of the reference's largest
    entry: f32 sums taken in another order, carried through every step), and
    twice: it uses no atomics, so the two runs' bits are equal. Its time
    beside the plain version's and its bound; with ``candidates`` also every
    candidate plan through the kernel, each held to the plain version in the
    same way and timed, the plan's choice marked."""
    import torch

    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops import tacotron_train as tk

    T, D, L, E, KS = (K5_WIDTHS[k] for k in ("T", "D", "L", "E", "KS"))
    n, B, _ = cots[0].shape
    args = (p_res, x["enc_seq"], x["enc_proj"], x["char_mask"], x["zo1"], x["zo2"], *cots)
    chosen = tk.device_plan_bwd(n, B, T, (D, L, E, KS), dev)
    got, again = tk.taco_train_bwd(w, *args), tk.taco_train_bwd(w, *args)
    want = tk.taco_train_bwd_plain(w, *args)
    torch.cuda.synchronize()
    errs = {k: rel_err(a, c) for k, a, c in zip(got._fields, got, want)}
    abs_err = max(float((a - c).abs().max()) for a, c in zip(got, want))
    check(max(errs.values()) <= 1e-4, f"K5 backward B={B} n={n} differs from its plain version: "
          f"{errs}")
    check(all(torch.equal(a, c) for a, c in zip(got, again)),
          f"K5 backward B={B} n={n}: two runs on the same inputs differ in their bits")
    ms = cuda_ms(lambda: tk.taco_train_bwd(w, *args))
    plain_ms = cuda_ms(lambda: tk.taco_train_bwd_plain(w, *args), reps=2)
    cand = k5_candidates("K5 backward", tk.device_plan_bwd,
                         lambda lib, p: tk.bwd_launch(lib, w, *args, p=p), want, n, B, dev) \
        if candidates else []
    # per row and step: the eight products (lsa_W both ways), the attention:
    # the location term, its two adjoints, the energies and the context's
    # cotangent; after the walk scores x dctx for denc_seq
    mats = D * 3 * D + 2 * D * D + (E + D) * L + 4 * L * 4 * L + E * 3 * D
    flops = 2 * n * B * (mats + 3 * T * D * KS + 3 * T * D + 2 * T * E)
    # the backward reads nine matrices, three vectors, the cotangents, eight
    # residual streams, the masks and the attention memory; it writes its
    # outputs and dv and dmloc once per CTA
    read = [w.gwh, w.wq, w.wq, w.wri, w.l1wi, w.l1wh, w.l2wi, w.l2wh, w.gwi_ctx, w.bq, w.mloc,
            w.vv, p_res.ah, p_res.g4, p_res.gates1, p_res.c1, p_res.gates2, p_res.c2,
            p_res.scores, p_res.cum_T, *args[1:]]
    b = bound(nbytes(*read, *got) + 4 * (chosen.ctas - 1) * (D + KS * D), flops)
    was = K5_BWD_EARLIER_MS.get((B, n))
    print(f"K5 tacotron_train backward B={B} n_iters={n} T={T} (plan {chosen.name}, "
          f"{chosen.ctas} CTAs, {chosen.smem} bytes of shared memory a CTA, model "
          f"{chosen.cost_ms:.3f} ms): rel errs "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f" (tol 1e-4), bits repeat, kernel {ms:.3f} ms ({ms / n * 1e3:.2f} us a step; "
          f"one-CTA-a-row kernel {was} ms in an earlier call), plain {plain_ms:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']}")
    if cand:
        print(k5_cand_line("K5 backward", B, n, cand, chosen))
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, **b, "plan": chosen.name,
            "candidates": {p.name: t for t, p, _ in cand}}


def phase_taco_train_kernel(dev):
    """K5 at the Tacotron training shape (the first session of the schedule:
    batch 112, r 7, 602 frames → 86 iterations; 160 characters) and at the
    last session (batch 22, r 1, 602 iterations): the forward against its
    plain version, then the backward on the plain forward's residuals against
    its plain version (``k5_fwd_cell``, ``k5_bwd_cell``); every candidate
    plan of each at the first session."""
    import torch

    (B, n), last = K5_SHAPES
    g = torch.Generator().manual_seed(11)
    w = k5_weights(g, dev)
    x, cots = k5_case(g, dev, B, n)
    fwd_first, p_res = k5_fwd_cell(dev, w, x, candidates=True)
    bwd_first = k5_bwd_cell(dev, w, x, cots, p_res, candidates=True)
    del p_res, x, cots
    x, cots = k5_case(g, dev, *last)
    fwd_other, p_res = k5_fwd_cell(dev, w, x)
    bwd_other = k5_bwd_cell(dev, w, x, cots, p_res)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "plan")
    return [{"name": "tacotron_train_fwd", "source": "rtvc_tpu_torch/csrc/tacotron_train.cu",
             "replaces": "rtvc_tpu/ops/pallas/tacotron_train_kernel.py:109",
             **fwd_first, "library_ms": None,
             "shapes": [{"B": last[0], "n_iters": last[1], **{k: fwd_other[k] for k in keys}}]},
            {"name": "tacotron_train_bwd", "source": "rtvc_tpu_torch/csrc/tacotron_train.cu",
             "replaces": "rtvc_tpu/ops/pallas/tacotron_train_kernel.py:228",
             **bwd_first, "library_ms": None,
             "shapes": [{"B": last[0], "n_iters": last[1], **{k: bwd_other[k] for k in keys}}]}]


GE2E_SHAPE = (64, 10, 160)  # speakers, utterances a speaker, frames


def ge2e_partials(seed, n):
    """``n`` GE2E batches of (S·U, T, 40) partials: speakers scatter around
    signatures of their own, as real partials do."""
    import torch

    S, U, T = GE2E_SHAPE
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        base = torch.rand(S, 1, 1, 40, generator=g)
        yield (base + 0.1 * torch.randn(S, U, T, 40, generator=g)).clamp(0, 1).reshape(
            S * U, T, 40)


def ge2e_kw(dev, steps):
    S, U, _ = GE2E_SHAPE
    return dict(speakers_per_batch=S, utterances_per_speaker=U, learning_rate=1e-4,
                eer_every=steps, save_every=0, device=dev, seed=0)


def phase_train_encoder(dev, runs_dir):
    """GE2E training at full width (64 speakers x 10 utterances x 160 frames,
    3 x LSTM-768): 3 steps, then a resume from the checkpoint for a 4th.
    Returns the launch counts and the first run's result."""
    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.train.trainer import train_encoder

    (S, U, T), steps = GE2E_SHAPE, 3
    kw = ge2e_kw(dev, steps)
    _build.launch_counts.clear()
    out = train_encoder("encoder", ge2e_partials(6, steps), runs_dir, total_steps=steps, **kw)
    counts = dict(_build.launch_counts)
    print(f"launches in the encoder training run: {counts}")
    check(out["step"] == steps, f"encoder run ended at step {out['step']}")
    check(all(np.isfinite(out["losses"])) and np.isfinite(out["grad_norm"]),
          f"encoder loss or grad norm not finite: {out['losses']}, {out['grad_norm']}")
    check(0.0 <= out["eer"] <= 1.0, f"encoder EER {out['eer']}")
    for name in ("lstm_seq", "lstm_seq_bwd"):
        check(counts.get(name, 0) == 3 * steps,
              f"{name} launched {counts.get(name, 0)} times in {steps} encoder steps, "
              f"want {3 * steps}")
    resumed = train_encoder("encoder", ge2e_partials(7, 1), runs_dir, total_steps=steps + 1,
                            **kw)
    check(resumed["step"] == steps + 1 and len(resumed["losses"]) == 1,
          f"resume did not start at step {steps}: {resumed['step']}, {resumed['losses']}")
    check(np.isfinite(resumed["losses"][0]), "resumed encoder loss not finite")
    # the first step includes the first launch's set-up
    print(f"encoder training {S * U} x {T} x 40: losses {out['losses']} then "
          f"{resumed['losses']} after the resume, grad norm {out['grad_norm']:.4f}, "
          f"EER {out['eer']:.4f}; ms per step {[round(m, 1) for m in out['step_ms']]}, "
          f"after the resume {round(resumed['step_ms'][0], 1)}")
    return counts, out


def vocoder_epochs(model_type, steps):
    """``train_vocoder``'s ``epoch_batches`` for a few steps of the first
    session: one seeded batch of the session's size, repeated over an epoch
    long enough that the session (geneing's is a quarter of an epoch) holds
    every step, with the keys and shapes of
    ``rtvc_tpu_torch.data.vocoder_dataset.batch_iterator``: tones quantised
    to the head's classes, x the previous sample's class in [-1, 1]."""
    from rtvc_tpu_torch.config.signal import sp
    from rtvc_tpu_torch.models import factories

    cfg = factories.default_config(model_type)
    n_batches = int(np.ceil(steps / min(cfg.voc_tts_schedule[0][0], 1.0)))
    B, hop = int(cfg.voc_tts_schedule[0][3]), sp.hop_size
    L, C = cfg.seq_len, 2 ** cfg.bits
    rng = np.random.default_rng(8)
    t = np.arange(L + 1)
    wav = 0.8 * np.sin(2 * np.pi * rng.uniform(100, 400, (B, 1)) * t / sp.sample_rate
                       + rng.uniform(0, 6.3, (B, 1)))
    labels = np.round((wav + 1) * (C - 1) / 2).astype(np.int64)
    batch = {"x": (labels[:, :-1] * 2.0 / (C - 1) - 1).astype(np.float32),
             "y": labels[:, 1:],
             "y_float": (labels[:, 1:] * 2.0 / (C - 1) - 1).astype(np.float32),
             "mels": rng.uniform(0, 1, (B, sp.num_mels, L // hop + 2 * cfg.pad)).astype(
                 np.float32)}
    return lambda session: [batch] * n_batches


def phase_train_vocoder(dev, runs_dir, model_type="runtimeracer-wavernn", steps=5):
    """WaveRNN training of one variant at full width, in the first session of
    its schedule (batch 40; runtimeracer: seq_len 1000, four GRUs of 256;
    fatchord: seq_len 1000, two GRUs of 512; geneing: seq_len 1400, one GRU of
    256, BITS), for a few steps on one seeded batch repeated."""
    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.ops.wavernn_generate import LAYERS
    from rtvc_tpu_torch.train.trainer import train_vocoder

    cfg = factories.default_config(model_type)
    n_rnn = len(LAYERS[model_type].rnns)
    B, L = int(cfg.voc_tts_schedule[0][3]), cfg.seq_len
    _build.launch_counts.clear()
    out = train_vocoder(f"vocoder_{model_type}", model_type, runs_dir,
                        vocoder_epochs(model_type, steps), max_steps=steps, save_every=0,
                        device=dev, seed=0)
    counts = dict(_build.launch_counts)
    print(f"launches in the {model_type} training run: {counts}")
    losses = out["losses"]
    check(out["step"] == steps and len(losses) == steps, f"vocoder run ended at {out['step']}")
    check(all(np.isfinite(losses)), f"vocoder loss not finite: {losses}")
    check(losses[-1] < losses[0], f"vocoder loss did not fall: {losses}")
    for name in ("gru_seq", "gru_seq_bwd"):
        check(counts.get(name, 0) == n_rnn * steps,
              f"{name} launched {counts.get(name, 0)} times in {steps} {model_type} steps, "
              f"want {n_rnn * steps}")
    print(f"{model_type} training {B} x {L}: losses {[round(v, 4) for v in losses]}; ms per step "
          f"{[round(m, 1) for m in out['step_ms']]}")
    return counts, out


def tacotron_epochs():
    """``train_synthesizer``'s ``epoch_batches`` for Tacotron's first
    session (r 7, batch 112, 602 frames, 160 characters): one synthetic batch
    repeated 12 times, the session's length, over which its learning rate
    falls."""
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.profile_train import synthetic_tacotron_batch

    r, _, B, _, _ = factories.default_config(factories.MODEL_TYPE_TACOTRON).tts_schedule[0]
    batch = synthetic_tacotron_batch(B, 160, 86 * r, seed=12)
    return lambda session, r: [batch] * 12


def phase_train_synthesizer(dev, runs_dir):
    """Tacotron training at full width (the config's defaults: decoder 256,
    LSTM 512, encoder 128 + the 768-d speaker embedding) in the first session
    of its schedule (r 7, batch 112, lr 1e-3 falling) on one synthetic batch
    shaped like ``collate_synthesizer``'s: 3 steps, then a resume from the
    checkpoint for a 4th."""
    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.train.trainer import train_synthesizer

    model_type, steps = factories.MODEL_TYPE_TACOTRON, 3
    cfg = factories.default_config(model_type)
    r, _, B, _, _ = cfg.tts_schedule[0]
    T, frames = 160, 86 * r
    epochs = tacotron_epochs()

    kw = dict(save_every=0, device=dev, seed=0)
    _build.launch_counts.clear()
    out = train_synthesizer("synthesizer", model_type, runs_dir, epochs, max_steps=steps,
                            **kw)
    counts = dict(_build.launch_counts)
    print(f"launches in the synthesizer training run: {counts}")
    losses = out["losses"]
    check(out["step"] == steps and len(losses) == steps, f"synthesizer run ended at {out['step']}")
    check(all(np.isfinite(losses)) and np.isfinite(out["grad_norm"]),
          f"synthesizer loss or grad norm not finite: {losses}, {out['grad_norm']}")
    check(losses[-1] < losses[0], f"synthesizer loss did not fall on a repeated batch: {losses}")
    for name in ("tacotron_train_fwd", "tacotron_train_bwd"):
        check(counts.get(name, 0) == steps,
              f"{name} launched {counts.get(name, 0)} times in {steps} synthesizer steps")
    # the encoder's and the postnet's BiGRUs, two directions each
    for name in ("gru_seq", "gru_seq_bwd"):
        check(counts.get(name, 0) == 4 * steps,
              f"{name} launched {counts.get(name, 0)} times in {steps} synthesizer steps, "
              f"want {4 * steps}")
    resumed = train_synthesizer("synthesizer", model_type, runs_dir, epochs,
                                max_steps=steps + 1, **kw)
    check(resumed["step"] == steps + 1 and len(resumed["losses"]) == 1,
          f"resume did not start at step {steps}: {resumed['step']}, {resumed['losses']}")
    check(np.isfinite(resumed["losses"][0]) and resumed["lrs"][0] < out["lrs"][-1],
          f"resumed synthesizer step: loss {resumed['losses']}, lr {resumed['lrs']} after "
          f"{out['lrs']}")
    print(f"synthesizer training {B} x {frames} frames x {T} chars, r {r}: losses "
          f"{[round(v, 4) for v in losses]} then {[round(v, 4) for v in resumed['losses']]} "
          f"after the resume, grad norm {out['grad_norm']:.4f}; ms per step "
          f"{[round(m, 1) for m in out['step_ms']]}, after the resume "
          f"{round(resumed['step_ms'][0], 1)}")
    return counts, out


# The alignment pass's five utterances: mel frames (80 a second: 2.5, 4, 6
# and 9 s, and the preprocessing's max_mel_frames, 15 s) and the characters
# of their texts (the longest takes 160 tokens with its end mark)
ALIGN_FRAMES = (200, 320, 480, 720, 1200)
ALIGN_CHARS = (40, 64, 96, 128, 159)
ALIGN_WORDS = ("voice", "cloning", "on", "one", "graphics", "card", "the", "quick", "brown",
               "fox", "jumps", "over", "a", "lazy", "dog", "while", "every", "kernel",
               "keeps", "its", "weights", "close")
# where the alignment pass looks K5's forward up (ops.tacotron_train's
# taco_decoder_train calls it), for recording its launches
ALIGN_KERNELS = (("rtvc_tpu_torch.ops.tacotron_train", "taco_train_fwd"),)
ALIGN_FILES = (("duration", "duration"), ("attention", "attention"), ("alignment", "alignment"),
               ("phoneme_pitch", "phoneme-pitch"), ("phoneme_energy", "phoneme-energy"))


def write_align_root(root, seed=21):
    """A synthesizer root of the five ``ALIGN_FRAMES`` utterances as the
    audio and embedding passes leave one: a voiced wav (a glide of 90-190
    Hz under a syllable envelope, 200 samples a frame), a mel shaped like
    ``profile_train.synthetic_tacotron_batch``'s, a unit 768-d embedding, a
    text of ``ALIGN_CHARS`` characters, and ``train.json``. Returns the
    utterance ids, lengths and texts in the order the pass takes them."""
    rng = np.random.default_rng(seed)
    for d in ("wav", "mels", "embeds"):
        (root / d).mkdir(parents=True, exist_ok=True)
    meta, utts = {}, []
    for i, (frames, chars) in enumerate(zip(ALIGN_FRAMES, ALIGN_CHARS)):
        uid = f"align{i}"
        t = np.arange(frames * 200) / 16000
        f0 = 140 + 50 * np.sin(2 * np.pi * 0.6 * t + rng.uniform(0, 6.3))
        env = np.clip(np.sin(2 * np.pi * 2.5 * t + rng.uniform(0, 6.3)), 0, None)
        wav = (0.5 * env * np.sin(2 * np.pi * np.cumsum(f0) / 16000)
               + 0.003 * rng.standard_normal(len(t))).astype(np.float32)
        m, f = np.arange(80)[:, None], np.arange(frames)[None, :]
        mel = np.clip(-1.5 + 2 * np.sin(2 * np.pi * (f / 97 + m / 40) + rng.uniform(0, 6.3))
                      + 0.3 * rng.standard_normal((80, frames)), -4, 4).astype(np.float32)
        embed = rng.standard_normal(768).astype(np.float32)
        text = " ".join(rng.choice(ALIGN_WORDS, chars))[:chars].strip()
        text = text + "s" * (chars - len(text))
        np.save(root / "wav" / f"audio-{uid}.npy", wav)
        np.save(root / "mels" / f"mel-{uid}.npy", mel.T)
        np.save(root / "embeds" / f"embed-{uid}.npy", embed / np.linalg.norm(embed))
        meta.setdefault(f"speaker{i % 2}", []).append(f"{uid}|{len(wav)}|{frames}|{text}")
        utts.append((uid, frames, text))
    (root / "train.json").write_text(json.dumps(meta))
    order = [line.split("|")[0] for lines in meta.values() for line in lines]
    return sorted(utts, key=lambda u: order.index(u[0]))


def read_align_files(root, uid):
    return [np.load(root / d / f"{stem}-{uid}.npy") for d, stem in ALIGN_FILES]


def align_inputs(root, uid, text):
    """An utterance's tokens, mel (n_mels, T) and embedding as the
    alignment pass reads them."""
    from rtvc_tpu_torch.config import preprocessing
    from rtvc_tpu_torch.text import text_to_sequence

    tokens = np.asarray(text_to_sequence(text, preprocessing.cleaner_names), np.int32)
    mel = np.load(root / "mels" / f"mel-{uid}.npy").T.astype(np.float32)
    return tokens, mel, np.load(root / "embeds" / f"embed-{uid}.npy")


def phase_align(dev, card, syn):
    """The alignment pass at full width: the seeded Tacotron written as a
    port trainer file, read back through ``TacotronAligner`` (bit for bit),
    and ``create_align_features`` over the five ``ALIGN_FRAMES`` utterances
    (one K5 forward launch each, at B 1, r 1, over the mel padded to a
    multiple of 32 and the text to a multiple of 16). Checks the five files
    of every utterance, durations summing to the mel's length, every
    utterance's K5 launch on its own inputs against K5's plain version (1e-4
    of each output's largest entry), every utterance's durations equal to
    those the attention through K5's plain version gives, and a second
    pass's files equal to the first's in their bits; prints the milliseconds
    an utterance with K5's device time. Returns the pass's launch counts."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.config import preprocessing
    from rtvc_tpu_torch.data.duration_extractor import DurationExtractor
    from rtvc_tpu_torch.data.synthesizer_preprocess import create_align_features
    from rtvc_tpu_torch.inference.attention import MEL_BUCKET, TEXT_BUCKET, TacotronAligner
    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops import tacotron_train as tk
    from rtvc_tpu_torch.text import text_to_sequence
    from rtvc_tpu_torch.train.checkpoints import save_checkpoint

    work = _build.BUILD_DIR / "smoke_align"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "syn"
    root.mkdir(parents=True)
    try:
        ckpt = work / "tacotron.pt"
        save_checkpoint(ckpt, syn.model, 5000, syn.model_type,
                        extras={"r": 1, "config": syn.config.asdict()})
        utts = write_align_root(root)
        aligner = TacotronAligner(ckpt, device=dev)
        a, b = aligner.bundle.model.state_dict(), syn.model.state_dict()
        check(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in b),
              "the aligner's Tacotron differs from the model its checkpoint was written from")
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        with recorded_calls(ALIGN_KERNELS) as recorded:
            (n, pass_ms) = timed_ms(lambda: create_align_features(root, aligner=aligner))
        counts = dict(_build.launch_counts)
        # a K5 forward and the encoder's and the postnet's BiGRUs (K4, a
        # launch a direction) an utterance
        check(n == len(utts) and counts == {"tacotron_train_fwd": len(utts),
                                            "gru_seq": 4 * len(utts)},
              f"the alignment pass aligned {n} utterances with launches {counts}")
        first = {}
        for uid, frames, text in utts:
            files = read_align_files(root, uid)
            n_tok = len(text_to_sequence(text, preprocessing.cleaner_names))
            dur, att, align, pitch, energy = files
            check(dur.dtype == np.int64 and dur.shape == (n_tok,) and int(dur.sum()) == frames
                  and pitch.shape == energy.shape == (n_tok,) and att.shape == align.shape == ()
                  and all(np.isfinite(f).all() for f in files),
                  f"alignment of {uid}: durations {dur.shape} summing to {int(dur.sum())} for "
                  f"{frames} frames, pitch {pitch.shape}, energy {energy.shape}")
            first[uid] = files
        # every utterance's K5 launch on its own inputs against K5's plain
        # version, the 1200-frame one's walk of 1216 iterations included
        errs = {}
        with torch.no_grad():
            for (uid, frames, _), (args, _, (x_all, res)) in zip(utts,
                                                                 recorded["taco_train_fwd"]):
                n_it, B, _ = args[1].shape
                check(B == 1 and n_it == -(-(frames + 1) // MEL_BUCKET) * MEL_BUCKET,
                      f"the K5 launch of {uid} ran B {B} over {n_it} iterations")
                p_x, p_res = tk.taco_train_fwd_plain(*args)
                e = dict(zip(("x_all",) + res._fields,
                             (rel_err(a, b) for a, b in zip((x_all, *res), (p_x, *p_res)))))
                check(max(e.values()) <= 1e-4, f"K5 forward of {uid} ({n_it} iterations) "
                      f"differs from its plain version: {e}")
                errs[uid] = max(e.values())
        # every utterance's durations again with K5's plain version in the
        # kernel's place: the same path through the attention
        extractor = DurationExtractor(silence_threshold=preprocessing.silence_threshold,
                                      silence_prob_shift=preprocessing.silence_prob_shift)
        kernel_att = {uid: aligner.attention(*align_inputs(root, uid, text))
                      for uid, _, text in utts}
        att_err = 0.0
        kernel_fwd, tk.taco_train_fwd = tk.taco_train_fwd, tk.taco_train_fwd_plain
        try:
            for uid, frames, text in utts:
                tokens, mel, embed = align_inputs(root, uid, text)
                plain_att = aligner.attention(tokens, mel, embed)
                att_err = max(att_err, float(np.abs(plain_att - kernel_att[uid]).max()))
                dur, _ = extractor(tokens, mel, plain_att[:frames])
                check(np.array_equal(dur, first[uid][0]),
                      f"the durations of {uid} through K5 differ from those through its plain "
                      f"version at {int((dur != first[uid][0]).sum())} of {len(dur)} characters")
        finally:
            tk.taco_train_fwd = kernel_fwd
        create_align_features(root, aligner=aligner)
        for uid, files in first.items():
            again = read_align_files(root, uid)
            check(all(a.tobytes() == b.tobytes() for a, b in zip(files, again)),
                  f"two alignment passes differ in their bits for {uid}")
        # each utterance's attention call: wall ms and device ms by kernel
        parts = []
        for uid, frames, text in utts:
            tokens, mel, embed = align_inputs(root, uid, text)
            _, wall = timed_ms(lambda: aligner.attention(tokens, mel, embed))
            by_kernel = kernels_device_ms(lambda: aligner.attention(tokens, mel, embed))
            k5 = by_kernel.get("tacotron_train_fwd_kernel", 0.0)
            n_it = -(-(frames + 1) // MEL_BUCKET) * MEL_BUCKET
            T = -(-len(tokens) // TEXT_BUCKET) * TEXT_BUCKET
            parts.append(f"{uid} {frames} frames x {len(tokens)} tokens (K5 {n_it} x {T}): "
                         f"attention {wall:.1f} ms, device {by_kernel['all']:.2f} ms of which K5 "
                         f"{k5:.2f} ({k5 / wall:.0%} of the call)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"{card}: alignment pass, {len(utts)} utterances ({sum(ALIGN_FRAMES)} frames): "
          f"{pass_ms:.1f} ms, {pass_ms / len(utts):.1f} ms an utterance (F0 tracking, durations "
          f"and files on the host included), launches {counts}; each K5 launch against its "
          f"plain version, rel errs max {({u: f'{e:.3e}' for u, e in errs.items()})} (tol "
          f"1e-4); the attention through K5's plain version within {att_err:.3e} (abs) of "
          f"K5's, its durations equal; a second pass equal in bits; " + "; ".join(parts))
    return counts


# The preprocessing corpus: 4 speakers x 4 utterances of PRE_SECONDS (voiced
# harmonic segments between pauses of 0.3-1.0 s, leading and trailing
# silence), speaker 1 written at 22 050 Hz, speaker 2 in flac and one of
# speaker 3's utterances in mp3 where those codecs are available; and three
# that the audio pass leaves out: a 17 s utterance past max_mel_frames, a
# 0.3 s one under utterance_min_duration, and one whose transcript is under
# min_text_len.
PRE_SPEAKERS = 4
PRE_SECONDS = tuple(float(s) for s in np.linspace(1.5, 14.0, 16))
PRE_THREADS = 4
PRE_ELEMENTS = ("mel", "embed", "duration", "attention", "alignment", "phoneme_pitch",
                "phoneme_energy")
# where the embedding pass looks K3 up (the speaker encoder's LSTM layers)
PRE_KERNELS = (("rtvc_tpu_torch.models.layers", "lstm_seq"),)


def smoke_voice(seconds, sr, f0, rng, pauses=True):
    """A seeded utterance: harmonic segments (four partials over a slow
    glide) of 1-3 s between pauses of 0.3-1.0 s, after 0.2-0.4 s of
    near silence and before as much; ``pauses=False``: voiced throughout."""
    n = int(round(seconds * sr))
    wav = 2e-4 * rng.standard_normal(n)
    lead, tail = rng.uniform(0.2, 0.4, 2) if pauses else (0.05, 0.05)
    t = lead
    while t < seconds - tail - 0.2:
        seg = min(rng.uniform(1.0, 3.0) if pauses else seconds, seconds - tail - t)
        a, b = int(t * sr), int((t + seg) * sr)
        tt = np.arange(b - a) / sr
        f = f0 * (1 + 0.08 * np.sin(2 * np.pi * 0.7 * tt + rng.uniform(0, 6.3)))
        phase = 2 * np.pi * np.cumsum(f) / sr
        env = np.sin(np.pi * np.arange(b - a) / (b - a)) ** 0.3
        wav[a:b] += env * sum(0.3 / k * np.sin(k * phase) for k in range(1, 5))
        wav[a:b] += 0.004 * rng.standard_normal(b - a)
        t += seg + (rng.uniform(0.3, 1.0) if pauses else 0.0)
    return wav.astype(np.float32)


def smoke_text(seconds, rng):
    """A transcript of about 10 characters a second (at most 150)."""
    chars = min(150, int(10 * seconds))
    text = " ".join(rng.choice(ALIGN_WORDS, chars))[:chars].strip()
    return text + "s" * (chars - len(text))


def write_preprocess_corpus(speakers_dir, codecs, seed=41):
    """The corpus of ``PRE_SECONDS`` under ``speakers_dir`` (see above),
    with the formats ``codecs`` allows ({"flac": bool, "mp3": bool}).
    Returns {utterance id: (seconds, text, file name)} of the 16 utterances
    the audio pass should keep."""
    from rtvc_tpu_torch.utils import libav, mpeg
    from rtvc_tpu_torch.utils.io import save_wav_float

    rng = np.random.default_rng(seed)
    kept = {}

    def write(d, stem, wav, sr, text, fmt="wav"):
        path = d / f"{stem}.{fmt}"
        if fmt == "flac":
            libav.encode_audio(path, wav, sr)
        elif fmt == "mp3":
            mpeg.encode_mpeg(wav, sr, path)
        else:
            save_wav_float(wav, path, sr)
        (d / f"{stem}.txt").write_text(text)
        return path.name

    for s in range(PRE_SPEAKERS):
        d = speakers_dir / f"spk{s}"
        d.mkdir(parents=True)
        sr = 22050 if s == 1 else 16000
        for u in range(4):
            seconds = PRE_SECONDS[4 * u + s]
            fmt = ("flac" if s == 2 and codecs["flac"] else
                   "mp3" if (s, u) == (3, 1) and codecs["mp3"] else "wav")
            text = smoke_text(seconds, rng)
            name = write(d, f"utt{u}", smoke_voice(seconds, sr, 100 + 30 * s + 7 * u, rng), sr,
                         text, fmt)
            kept[f"spk{s}_utt{u}"] = (seconds, text, name)
    write(speakers_dir / "spk0", "long", smoke_voice(17.0, 16000, 140, rng, pauses=False),
          16000, smoke_text(17.0, rng))
    write(speakers_dir / "spk1", "short", smoke_voice(0.3, 22050, 150, rng, pauses=False),
          22050, smoke_text(1.0, rng))
    write(speakers_dir / "spk2", "terse", smoke_voice(3.0, 16000, 160, rng), 16000, "a")
    return kept


@contextlib.contextmanager
def call_ms(module, name):
    """Wall ms of every call of ``module.name`` inside, by calling thread
    ({thread: [ms, ...]} in call order)."""
    import threading

    mod = importlib.import_module(module)
    fn = getattr(mod, name)
    by_thread = {}

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        by_thread.setdefault(threading.get_ident(), []).append(
            (time.perf_counter() - t0) * 1e3)
        return out

    setattr(mod, name, timed)
    try:
        yield by_thread
    finally:
        setattr(mod, name, fn)


def first_apart(by_thread):
    """(mean ms of each thread's first call, mean ms of the later calls,
    threads)."""
    firsts = [v[0] for v in by_thread.values()]
    rest = [ms for v in by_thread.values() for ms in v[1:]]
    return float(np.mean(firsts)), float(np.mean(rest)) if rest else float("nan"), len(firsts)


def same_files(a, b, sub):
    names = sorted(p.name for p in (a / sub).iterdir())
    return names == sorted(p.name for p in (b / sub).iterdir()) and all(
        (a / sub / n).read_bytes() == (b / sub / n).read_bytes() for n in names)


def k6_pass_cell(dev, wav, saved_mel):
    """K6 at one utterance of the audio pass: its magnitudes made on the
    card from the pass's wav as ``ops.audio.melspectrogram`` makes them, the
    kernel's mel equal in bits to the pass's file, within 2e-4 absolute of
    the plain version's (``phase_mel``'s tolerance), and the kernel, the
    plain version and ``torch.matmul(basis, mag)`` timed by CUDA events
    beside the bound over the bands (as in ``phase_mel``)."""
    import torch

    from rtvc_tpu_torch.config import preprocessing as pp
    from rtvc_tpu_torch.config import sp
    from rtvc_tpu_torch.ops import audio
    from rtvc_tpu_torch.ops import mel_project as mp

    mag = audio._stft_mag(torch.from_numpy(wav).to(dev), sp).contiguous()
    n_bins, T = mag.shape
    with torch.no_grad():
        got = mp.mel_project_normalize(mag, sp, pp)
        ref = mp.mel_project_normalize_plain(mag, sp, pp)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(err <= 2e-4, f"K6 at the audio pass's {T} frames differs from its plain version: {err}")
    check(got.cpu().numpy().T.tobytes() == saved_mel.tobytes(),
          f"the audio pass's mel of {T} frames is not K6's on the same magnitudes")
    basis = mp.mel_basis(sp, dev)
    bands = mp.mel_bands(basis.cpu().numpy())
    ms = cuda_ms(lambda: mp.mel_project_normalize(mag, sp, pp), reps=20)
    plain_ms = cuda_ms(lambda: mp.mel_project_normalize_plain(mag, sp, pp), reps=20)
    library_ms = cuda_ms(lambda: torch.matmul(basis, mag), reps=20)
    b = bound(nbytes(mag, got) + 4 * (len(bands.weights) + 4 * sp.num_mels),
              2 * T * int(bands.width.sum()))
    return {"T": T, "n_bins": n_bins, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": library_ms, "library": "torch.matmul(basis, mag)",
            "path": "synthesizer audio pass"}


def phase_preprocess(dev, card, syn):
    """The SV2TTS preprocessing passes at full width on the corpus of
    ``write_preprocess_corpus``, a corpus to the non-autoregressive
    trainers' inputs in the port alone. Encoder preprocessing on
    ``PRE_THREADS`` threads (one ``combined.npz`` a speaker, read back by
    ``SpeakerVerificationDataset``; a 4 x 4 x 160 x 40 partial batch through
    the installed encoder on the card within 1e-4 by ``rel_err`` of the same
    weights on the CPU). The audio pass on the card on one thread (one K6
    launch an utterance that reaches its mel, the one past
    ``max_mel_frames`` included, and no other launch) and on four (the files
    equal in bits), and on the CPU (K6's plain version: ``train.json`` and
    the wavs equal in bits, the mels within 2e-4); every kept utterance's
    K6 launch again on its magnitudes (``k6_pass_cell``). The embedding pass
    on the card on one thread (three K3 launches an utterance), on four
    (equal bits), and on the CPU (each embedding within 1e-4 by
    ``rel_err``); every K3 launch of a recorded run against its plain
    version (1e-4, ``phase_lstm``'s tolerance) and one cell a partial-batch
    size (``rnn_fwd_cell``). The alignment pass with the Tacotron ``syn``
    (as ``phase_align``), then ``SynthesizerDataset`` serves
    ``PRE_ELEMENTS`` for every kept utterance. Prints each pass's ms an
    utterance on one and four threads (each thread's first utterance apart)
    beside its device time by the profiler and K6's and K3's by CUDA events,
    and the host's share. Returns the launch counts and the kernel cells."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.config import preprocessing, sp
    from rtvc_tpu_torch.data import synthesizer_preprocess as tsp
    from rtvc_tpu_torch.data.encoder_preprocess import encoder_preprocess_dataset
    from rtvc_tpu_torch.data.ge2e_sampler import (SpeakerVerificationDataset,
                                                  speaker_batch_iterator)
    from rtvc_tpu_torch.data.synthesizer_dataset import SynthesizerDataset
    from rtvc_tpu_torch.inference import encoder as tenc
    from rtvc_tpu_torch.inference.attention import TacotronAligner
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops.lstm_seq import lstm_seq, lstm_seq_plain
    from rtvc_tpu_torch.train.checkpoints import save_checkpoint
    from rtvc_tpu_torch.utils import libav, mpeg

    work = _build.BUILD_DIR / "smoke_preprocess"
    shutil.rmtree(work, ignore_errors=True)
    installed = (tenc._model, tenc._model_cfg, tenc._data)
    codecs = {"flac": libav.libav_supported(),
              "mp3": mpeg.lame_supported() and (mpeg.mpeg_supported() or libav.libav_supported())}
    why = {"flac": libav.load_error().splitlines()[0] if not codecs["flac"] else "",
           "mp3": "" if codecs["mp3"] else
           f"libmp3lame {mpeg.lame_supported()}, libmpg123 {mpeg.mpeg_supported()}, "
           f"codec shim {libav.libav_supported()}"}
    print(f"{card}: preprocessing corpus codecs: " + ", ".join(
        f"{k} {'available' if v else 'not available (' + why[k] + ')'}"
        for k, v in codecs.items()))
    exts = [".wav"] + [f".{k}" for k, v in codecs.items() if v]
    laps = {}
    try:
        datasets = work / "datasets"
        kept = write_preprocess_corpus(datasets / "Smoke" / "speakers", codecs)
        n = len(kept)

        # encoder preprocessing, on the host
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        n_enc = encoder_preprocess_dataset(datasets, work / "encoder", ["Smoke/speakers"], "Smoke",
                                           extensions=exts, n_threads=PRE_THREADS)
        laps["encoder"] = ((time.perf_counter() - t0) * 1e3, n_enc)
        check(not _build.launch_counts, f"encoder preprocessing launched {_build.launch_counts}")
        npz = sorted(p.parent.name for p in (work / "encoder").glob("*/combined.npz"))
        check(npz == [f"spk{s}" for s in range(PRE_SPEAKERS)]
              and (work / "encoder" / "Log_Smoke.txt").is_file(),
              f"encoder preprocessing wrote {npz}")
        batch = next(speaker_batch_iterator(SpeakerVerificationDataset(work / "encoder"),
                                            PRE_SPEAKERS, 4, 160, prefetch=0, seed=5))
        check(batch.shape == (16, 160, 40) and np.isfinite(batch).all(),
              f"the GE2E partial batch is {batch.shape}")
        cpu_encoder = factories.init_encoder_model(seed=41, device="cpu")
        state = {k: v.clone() for k, v in cpu_encoder.state_dict().items()}
        tenc.load_state(state, device=dev)
        with torch.no_grad():
            want = cpu_encoder(torch.from_numpy(batch))
        got = torch.from_numpy(tenc.embed_frames_batch(batch))
        enc_err = rel_err(got, want)
        check(enc_err <= 1e-4, f"the encoder on the card differs from the CPU on the "
                               f"preprocessed partials: rel err {enc_err}")

        # the audio pass
        def audio(out, threads, device=dev):
            return tsp.synthesizer_preprocess_dataset(
                datasets, work / out, "Smoke", ["speakers"], exts, ".txt",
                n_processes=threads, device=device)

        a1, a4 = work / "syn1", work / "syn4"
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        with call_ms("rtvc_tpu_torch.data.synthesizer_preprocess", "process_utterance") as t1:
            (n1, ms1) = timed_ms(lambda: audio("syn1", 1))
        audio_counts = dict(_build.launch_counts)
        # one K6 launch an utterance that reaches its mel: the kept ones and
        # the one past max_mel_frames, dropped after its mel as in the JAX pass
        check(n1 == n and audio_counts == {"mel_project": n + 1},
              f"the audio pass kept {n1} of {n} utterances with launches {audio_counts}")
        meta = json.loads((a1 / "train.json").read_text())
        lines = {m.split("|")[0]: m.split("|") for v in meta.values() for m in v}
        check(sorted(lines) == sorted(kept) and all(
            lines[u][3] == kept[u][1] for u in kept), f"train.json holds {sorted(lines)}")
        with call_ms("rtvc_tpu_torch.data.synthesizer_preprocess", "process_utterance") as t4:
            (_, ms4) = timed_ms(lambda: audio("syn4", PRE_THREADS))
        check(all(same_files(a1, a4, d) for d in ("wav", "mels"))
              and (a1 / "train.json").read_bytes() == (a4 / "train.json").read_bytes(),
              f"the audio pass on {PRE_THREADS} threads differs from one thread in its bits")
        t_cpu = time.perf_counter()
        audio("syn_cpu", 2, "cpu")
        cpu_s = time.perf_counter() - t_cpu
        cpu_root = work / "syn_cpu"
        mel_err = max(float(np.abs(np.load(a1 / "mels" / f"mel-{u}.npy")
                                   - np.load(cpu_root / "mels" / f"mel-{u}.npy")).max())
                      for u in kept)
        check((a1 / "train.json").read_bytes() == (cpu_root / "train.json").read_bytes()
              and same_files(a1, cpu_root, "wav") and mel_err <= 2e-4,
              f"the audio pass on the card differs from its CPU route (mels {mel_err})")
        k6_cells = [k6_pass_cell(dev, np.load(a1 / "wav" / f"audio-{u}.npy"),
                                 np.load(a1 / "mels" / f"mel-{u}.npy"))
                    for u in sorted(kept, key=lambda u: int(lines[u][2]))]
        by_kernel1 = kernels_device_ms(lambda: audio("syn_prof", 1))

        # the embedding pass
        def embed(root, threads):
            return tsp.create_embeddings(root, None, n_processes=threads)

        shutil.copytree(a1, work / "emb4", ignore=shutil.ignore_patterns("embeds"))
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        with call_ms("rtvc_tpu_torch.inference.encoder", "embed_utterance") as e1:
            (m1, ems1) = timed_ms(lambda: embed(a1, 1))
        embed_counts = dict(_build.launch_counts)
        check(m1 == n and embed_counts == {"lstm_seq": 3 * n},
              f"the embedding pass embedded {m1} utterances with launches {embed_counts}")
        with call_ms("rtvc_tpu_torch.inference.encoder", "embed_utterance") as e4:
            (_, ems4) = timed_ms(lambda: embed(work / "emb4", PRE_THREADS))
        check(same_files(a1, work / "emb4", "embeds"),
              f"the embedding pass on {PRE_THREADS} threads differs from one thread")
        shutil.copytree(a1, work / "emb_rec", ignore=shutil.ignore_patterns("embeds"))
        with recorded_calls(PRE_KERNELS) as calls:
            embed(work / "emb_rec", 1)
        check(same_files(a1, work / "emb_rec", "embeds"), "a recorded embedding pass differs")
        k3_err = 0.0
        with torch.no_grad():
            for args, _, _ in calls["lstm_seq"]:
                k3_err = max(k3_err, max(float((a - b).abs().max())
                                         for a, b in zip(lstm_seq(*args), lstm_seq_plain(*args))))
        check(len(calls["lstm_seq"]) == 3 * n and k3_err <= 1e-4,
              f"{len(calls['lstm_seq'])} K3 launches of the embedding pass, max abs err "
              f"{k3_err} against the plain version")
        k3_cells = {}
        for layer, (args, _, _) in enumerate(calls["lstm_seq"]):
            B = args[0].shape[0]
            if layer % 3 == 1 and B not in k3_cells:  # a middle layer: 768 in, 768 out
                k3_cells[B] = {**rnn_fwd_cell("lstm_seq", args, 768),
                               "path": "embedding pass (partial batches)"}
                check(k3_cells[B]["max_abs_err"] <= 1e-4, f"K3 at B {B}: {k3_cells[B]}")
        k3_per_utt = float(np.mean([k3_cells[calls["lstm_seq"][3 * i][0][0].shape[0]]["ms"] * 3
                                    for i in range(n)]))
        by_kernel2 = kernels_device_ms(lambda: embed(work / "emb4", 1))
        tenc.load_state(state, device="cpu")
        shutil.copytree(a1, work / "emb_cpu", ignore=shutil.ignore_patterns("embeds"))
        embed(work / "emb_cpu", 2)
        emb_err = max(rel_err(torch.from_numpy(np.load(a1 / "embeds" / f"embed-{u}.npy")),
                              torch.from_numpy(np.load(work / "emb_cpu" / "embeds" /
                                                       f"embed-{u}.npy"))) for u in kept)
        check(emb_err <= 1e-4, f"the embedding pass on the card differs from the CPU: {emb_err}")

        # the alignment pass, then the trainers' dataset
        ckpt = work / "tacotron.pt"
        save_checkpoint(ckpt, syn.model, 5000, syn.model_type,
                        extras={"r": 1, "config": syn.config.asdict()})
        aligner = TacotronAligner(ckpt, device=dev)
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        (n3, ms3) = timed_ms(lambda: tsp.create_align_features(a1, aligner=aligner))
        align_counts = dict(_build.launch_counts)
        check(n3 == n and align_counts == {"tacotron_train_fwd": n, "gru_seq": 4 * n},
              f"the alignment pass aligned {n3} utterances with launches {align_counts}")
        dataset = SynthesizerDataset(a1, PRE_ELEMENTS)
        check(len(dataset) == n, f"SynthesizerDataset serves {len(dataset)} of {n} utterances")
        for i in range(n):
            item = dataset[i]
            frames, chars = item["mel"].shape[1], len(item["text"])
            check(set(PRE_ELEMENTS) <= set(item) and item["mel"].shape[0] == 80
                  and item["embed"].shape == (768,) and int(item["duration"].sum()) == frames
                  and item["duration"].shape == item["phoneme_pitch"].shape
                  == item["phoneme_energy"].shape == (chars,)
                  and all(np.isfinite(item[k]).all() for k in PRE_ELEMENTS),
                  f"SynthesizerDataset item {i}: " + ", ".join(
                      f"{k} {np.shape(item[k])}" for k in PRE_ELEMENTS))
    finally:
        tenc._model, tenc._model_cfg, tenc._data = installed
        shutil.rmtree(work, ignore_errors=True)

    frames = sorted(int(v[2]) for v in lines.values())
    k6_per_utt = float(np.mean([c["ms"] for c in k6_cells]))

    def rates(label, by_thread, wall_ms):
        first, rest, threads = first_apart(by_thread)
        return (f"{label}: {wall_ms / n:.2f} ms an utterance in the pass's wall time, the timed "
                f"call {rest:.2f} ms (the first call of each of {threads} threads {first:.2f} ms)")

    dev1 = by_kernel1["all"] / n
    dev2 = by_kernel2["all"] / n
    print(f"{card}: preprocessing, {n} kept utterances of {len(kept)} + 3 written "
          f"({min(PRE_SECONDS)}-{max(PRE_SECONDS)} s; {frames[0]}-{frames[-1]} frames): "
          f"encoder pass {laps['encoder'][0] / laps['encoder'][1]:.2f} ms an utterance on "
          f"{PRE_THREADS} threads ({laps['encoder'][1]} utterances kept, no launch), its "
          f"partials through the encoder on the card within {enc_err:.3e} (rel, tol 1e-4) of "
          f"the CPU; audio pass (process_utterance timed) "
          + rates("1 thread", t1, ms1) + "; " + rates(f"{PRE_THREADS} threads", t4, ms4)
          + f"; device {dev1:.3f} ms an utterance by the profiler (K6 "
          f"{by_kernel1.get('mel_project_kernel', 0.0) / n:.4f}), K6 {k6_per_utt:.4f} ms "
          f"by CUDA events, host share {1 - dev1 / (ms1 / n):.1%}; launches {audio_counts}; "
          f"{PRE_THREADS} threads equal to one in bits; the CPU route {cpu_s:.1f} s, "
          f"train.json and wavs equal in bits, mels within {mel_err:.3e} (tol 2e-4); "
          f"embedding pass (embed_utterance timed) " + rates("1 thread", e1, ems1) + "; "
          + rates(f"{PRE_THREADS} threads", e4, ems4)
          + f"; device {dev2:.3f} ms an utterance by the profiler (K3 "
          f"{by_kernel2.get('lstm_seq_kernel', 0.0) / n:.3f}), K3 {k3_per_utt:.3f} ms by "
          f"CUDA events, host share {1 - dev2 / (ems1 / n):.1%}; launches {embed_counts}, "
          f"each against its plain version max abs err {k3_err:.3e} (tol 1e-4); "
          f"{PRE_THREADS} threads equal to one in bits; the CPU encoder within "
          f"{emb_err:.3e} (rel, tol 1e-4); alignment pass {ms3 / n:.1f} ms an utterance, "
          f"launches {align_counts}; SynthesizerDataset serves {', '.join(PRE_ELEMENTS)} for "
          f"all {n}")
    for c in k6_cells + list(k3_cells.values()):
        shape = " x ".join(f"{k} {c[k]}" for k in ("B", "T", "H", "n_bins") if k in c)
        print(f"{card}: {'K6 mel_project' if 'n_bins' in c else 'K3 lstm_seq'} on the "
              f"{c['path']}, {shape}: kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
              f"{c['library']} {c['library_ms']:.4f} ms, bound {c['bound_ms']:.5f} ms by "
              f"{c['bound_by']}, max abs err {c['max_abs_err']:.3e}")
    return {"counts": {"mel_project": audio_counts.get("mel_project", 0),
                       "lstm_seq": embed_counts.get("lstm_seq", 0)},
            "n": n, "cells": {"mel_project": k6_cells, "lstm_seq": list(k3_cells.values())}}

# the trainers' kernel wrappers where LSTMSeqFn and GRUSeqFn look them up:
# K3's training halves and K4's, in f32 and in bf16
TRAIN_KERNELS = (("rtvc_tpu_torch.ops.lstm_seq", "lstm_seq_fwd_train"),
                 ("rtvc_tpu_torch.ops.lstm_seq", "lstm_seq_bwd"),
                 ("rtvc_tpu_torch.ops.gru_seq", "gru_seq_fwd"),
                 ("rtvc_tpu_torch.ops.gru_seq", "_bwd"))


def train_kernel_checks(calls, where):
    """Every K3 and K4 launch of a training step again on the inputs it was
    given, against its plain version (``held``: f32 outputs within 1e-4 of
    their largest entry, bf16 streams within ``BF16_TOL``). Returns a line
    of the shapes and worst errors."""
    import torch

    from rtvc_tpu_torch.ops.gru_seq import gru_seq_bwd_plain, gru_seq_fwd_plain
    from rtvc_tpu_torch.ops.lstm_seq import lstm_seq_bwd_plain, lstm_seq_fwd_train_plain

    plain = {"lstm_seq_fwd_train": lstm_seq_fwd_train_plain, "lstm_seq_bwd": lstm_seq_bwd_plain,
             "gru_seq_fwd": gru_seq_fwd_plain, "_bwd": gru_seq_bwd_plain}
    parts = []
    with torch.no_grad():
        for name, fn in plain.items():
            if not calls[name]:
                continue
            worst, worst_abs, shapes = 0.0, 0.0, []
            for args, _, out in calls[name]:
                got = out[:1] if name == "_bwd" else out
                want = fn(*args)
                want = (want,) if name == "_bwd" else want
                B, T, G = args[0].shape
                dt = str(args[0].dtype).replace("torch.", "")
                abs_err, rel = held(f"{name} at {where}'s B={B} T={T} width {G} in {dt}", got,
                                    want)
                worst, worst_abs = max(worst, rel), max(worst_abs, abs_err)
                shapes.append(f"{B}x{T}x{G} {dt}")
            parts.append(f"{name} ({len(calls[name])}: {', '.join(sorted(set(shapes)))}) "
                         f"rel {worst:.3e}, max |diff| {worst_abs:.3e}")
    return "; ".join(parts) or "none"


def nar_epochs():
    """``train_synthesizer``'s ``epoch_batches`` for ForwardTacotron's and
    FastPitch's first session (batch 16): ``synthetic_nar_batch`` at 160
    characters and 900 frames, repeated 12 times, the session's length."""
    from rtvc_tpu_torch.profile_train import synthetic_nar_batch

    batch = synthetic_nar_batch(16, 160, 900, seed=13)
    return lambda session, r: [batch] * 12


def phase_train_nar(dev, card, runs_dir):
    """The non-autoregressive trainers at full width (the configs'
    defaults), first session of the schedule (batch 16, lr 1e-3 falling), on
    one synthetic batch shaped like ``collate_synthesizer``'s (160
    characters, 900 frames, ``spec_lens`` 450-899, durations summing to each
    length, pitch and energy: ``profile_train.synthetic_nar_batch``):

    - ForwardTacotron, 3 steps then a resume for a 4th: finite losses, a
      falling loss on the repeated batch, the resume at step 3; K3 forward
      and backward twice a step, K4 forward and backward ten times; every K3
      and K4 launch of the first step held to its plain version on its own
      inputs (``train_kernel_checks``);
    - one ForwardTacotron step at the schedule's largest batch, 48: its wall
      time and peak memory;
    - FastPitch, 3 steps then a resume: finite, falling losses, none of the
      port's kernels launched.

    Returns ForwardTacotron's launch counts over its 3 steps, and each
    type's losses and ms per step."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.profile_train import nar_step
    from rtvc_tpu_torch.train.trainer import train_synthesizer

    epochs = nar_epochs()
    steps = 3
    kw = dict(save_every=0, device=dev, seed=0)
    out, runs = {}, {}
    for model_type in (factories.MODEL_TYPE_FORWARD_TACOTRON, factories.MODEL_TYPE_FASTPITCH):
        _build.launch_counts.clear()
        with recorded_calls(TRAIN_KERNELS) as calls:
            first = train_synthesizer(model_type, model_type, runs_dir, epochs, max_steps=1, **kw)
        rest = train_synthesizer(model_type, model_type, runs_dir, epochs, max_steps=steps, **kw)
        counts = dict(_build.launch_counts)
        resumed = train_synthesizer(model_type, model_type, runs_dir, epochs,
                                    max_steps=steps + 1, **kw)
        losses = first["losses"] + rest["losses"]
        step_ms = first["step_ms"] + rest["step_ms"]
        runs[model_type] = {"losses": losses, "step_ms": step_ms}
        print(f"launches in the {model_type} training run ({steps} steps): {counts}")
        check(rest["step"] == steps and len(losses) == steps,
              f"{model_type} run ended at step {rest['step']} with {len(losses)} losses")
        check(all(np.isfinite(losses)) and np.isfinite(rest["grad_norm"]),
              f"{model_type} loss or grad norm not finite: {losses}, {rest['grad_norm']}")
        check(losses[-1] < losses[0], f"{model_type} loss did not fall on a repeated batch: "
              f"{losses}")
        check(resumed["step"] == steps + 1 and len(resumed["losses"]) == 1
              and np.isfinite(resumed["losses"][0]) and resumed["lrs"][0] < rest["lrs"][-1],
              f"{model_type} resume did not start at step {steps}: {resumed['step']}, "
              f"{resumed['losses']}, lr {resumed['lrs']} after {rest['lrs']}")
        if model_type == factories.MODEL_TYPE_FORWARD_TACOTRON:
            want = {"lstm_seq": 2 * steps, "lstm_seq_bwd": 2 * steps, "gru_seq": 10 * steps,
                    "gru_seq_bwd": 10 * steps}
            n_calls = {k: len(v) for k, v in calls.items()}
            check(n_calls == {"lstm_seq_fwd_train": 2, "lstm_seq_bwd": 2, "gru_seq_fwd": 10,
                              "_bwd": 10}, f"the first ForwardTacotron step called {n_calls}")
            line = train_kernel_checks(calls, "the ForwardTacotron step")
            print(f"NAR training: the first ForwardTacotron step's K3 and K4 launches on their "
                  f"own inputs against their plain versions: {line}")
            out = counts
        else:
            want = {}
        calls.clear()
        check(counts == want, f"{model_type} training launched {counts}, want {want}")
        parts = ", ".join(f"{k} {rest[k]:.4f}" for k in ("m1", "m2", "dur", "pitch", "energy"))
        print(f"{card}: {model_type} training 16 x 900 frames x 160 chars: losses "
              f"{[round(v, 4) for v in losses]} then {[round(v, 4) for v in resumed['losses']]} "
              f"after the resume, grad norm {rest['grad_norm']:.4f} ({parts}); ms per step "
              f"{[round(m, 1) for m in step_ms]} (the first loads the model and its kernels), "
              f"after the resume {round(resumed['step_ms'][0], 1)}")
    step, big = nar_step(dev, factories.MODEL_TYPE_FORWARD_TACOTRON, 48)
    step(big)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats, ms = timed_ms(lambda: step(big))
    check(np.isfinite(float(stats["loss"])), f"the B 48 ForwardTacotron step's loss {stats}")
    print(f"{card}: forward-tacotron step at the schedule's largest batch, 48 x 900 frames x 160 "
          f"chars: {ms:.1f} ms (the second), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, loss {float(stats['loss']):.4f}")
    return out, runs


# ---------------------------------------------------------------------------
# The bf16 training policy (rtvc_tpu_torch/ops/precision.py)
# ---------------------------------------------------------------------------

# the bf16 instantiations' cells: K3 and K4 bf16 at every training shape
# the f32 cells hold (B, T, H, cuDNN's input width for K3; B, T, H for K4)
K3_BF16_SHAPES = ((640, 160, 768, 768, "GE2E training"),
                  (16, 900, 512, 1280, "forward-tacotron training"),
                  (48, 900, 512, 1280, "forward-tacotron training"))
K4_BF16_SHAPES = ((40, 1000, 256), (40, 1000, 512), (40, 1400, 256),
                  *((B, T, 64) for B, T in CBHG_SHAPES if B > 1), *NAR_TRAIN_GRU_SHAPES)
K3_REPLACES = ("rtvc_tpu/ops/pallas/lstm_train_kernel.py:115",
               "rtvc_tpu/ops/pallas/lstm_train_kernel.py:158")
K4_REPLACES = ("rtvc_tpu/ops/pallas/gru_train_kernel.py:71",
               "rtvc_tpu/ops/pallas/gru_train_kernel.py:111")


def bf16_entries(label, names, replaces, fwd, bwd):
    """The "kernels" line's two entries (forward, backward) of a bf16
    instantiation from its cells: the first cell's numbers, the others under
    ``shapes``; ``label`` names the first cell's source (K3's bf16 cells
    say by ``mode`` which design each ran)."""
    out = []
    for name, rep, cells in zip(names, replaces, (fwd, bwd)):
        cells = [{k: v for k, v in c.items() if k not in ("name", "source", "replaces")}
                 for c in cells]
        out.append({"name": name, "source": f"rtvc_tpu_torch/csrc/{label}.cu", "replaces": rep,
                    **cells[0], "shapes": cells[1:]})
    return out


# the bf16 instantiations' launch counters (each wrapper's key for bf16 streams)
BF16_KERNELS = ("lstm_seq_bf16", "lstm_seq_bwd_bf16", "gru_seq_bf16", "gru_seq_bwd_bf16")


def phase_bf16_train(dev, card, runs_dir, f32_runs):
    """The bf16 training policy on the card. First K3's and K4's bf16
    instantiations alone at every training shape the f32 cells hold
    (``k3_train_cell``, ``gru_shape`` with ``dtype`` bf16). Then three
    full-width bf16 steps of each trainer through its entry function, on
    the weights and batches of the f32 runs before it (``f32_runs``, by
    type: their losses and ms per step): GE2E 640 x 160 x 40, Tacotron r 7
    112 x 602 frames x 160 characters, ForwardTacotron and FastPitch 16 x
    900 x 160, WaveRNN runtimeracer 40 x 1000. Each run: finite losses,
    f32 master weights after it, its first loss within 5 % of the f32
    run's (the gate ``tests/test_learning.py`` holds the JAX package's bf16
    policy to), every product of its Linear and Conv1d layers in bf16
    (``precision.product_dtypes``: the policy took effect, FastPitch's run
    included, which launches none of the port's kernels), and exactly the
    launches of its path: the bf16 K3 and K4 instantiations, K5 (f32, its
    inputs widened around it) for Tacotron, no f32 K3 or K4 launch (a bf16
    tensor never reaches the f32 kernel). Then each run resumes for a
    fourth step whose every K3 and K4 launch is held to its plain bf16
    version on its own inputs (``train_kernel_checks``). Returns the
    "kernels" line's four bf16 entries and the launches of the five runs,
    in all and by run."""
    import collections

    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.ops import precision
    from rtvc_tpu_torch.train.trainer import train_encoder, train_synthesizer, train_vocoder

    bf16 = torch.bfloat16
    k3 = [k3_train_cell(dev, card, B, T, H, I, path, dtype=bf16)
          for B, T, H, I, path in K3_BF16_SHAPES]
    k4 = [[{"B": B, "T": T, "H": H, **e} for e in gru_shape(dev, B, T, H, dtype=bf16)]
          for B, T, H in K4_BF16_SHAPES]
    entries = (bf16_entries("lstm_seq_mma", BF16_KERNELS[:2], K3_REPLACES, *zip(*k3))
               + bf16_entries("gru_seq", BF16_KERNELS[2:], K4_REPLACES, *zip(*k4)))

    steps = 3
    kw = dict(save_every=0, device=dev, seed=0, compute_dtype="bf16")
    rr, ft = factories.MODEL_TYPE_RUNTIMERACER, factories.MODEL_TYPE_FORWARD_TACOTRON

    def encoder(n, partials):
        return train_encoder("encoder_bf16", partials, runs_dir, total_steps=n,
                             compute_dtype="bf16", **ge2e_kw(dev, steps))

    def synthesizer(model_type, epochs):
        return lambda n, _: train_synthesizer(f"{model_type}_bf16", model_type, runs_dir,
                                              epochs, max_steps=n, **kw)

    # label, run(steps, epochs), its epochs for the first three steps and for
    # the resumed fourth, its launches in three steps
    runs = {
        "ge2e": ("GE2E 640 x 160 x 40", encoder, ge2e_partials(6, steps), ge2e_partials(7, 1),
                 {"lstm_seq_bf16": 3 * steps, "lstm_seq_bwd_bf16": 3 * steps}),
        "tacotron": ("Tacotron r 7, 112 x 602 frames x 160 chars",
                     synthesizer(factories.MODEL_TYPE_TACOTRON, tacotron_epochs()), None, None,
                     {"gru_seq_bf16": 4 * steps, "gru_seq_bwd_bf16": 4 * steps,
                      "tacotron_train_fwd": steps, "tacotron_train_bwd": steps}),
        ft: ("forward-tacotron 16 x 900 frames x 160 chars", synthesizer(ft, nar_epochs()),
             None, None, {"lstm_seq_bf16": 2 * steps, "lstm_seq_bwd_bf16": 2 * steps,
                          "gru_seq_bf16": 10 * steps, "gru_seq_bwd_bf16": 10 * steps}),
        factories.MODEL_TYPE_FASTPITCH: (
            "fast-pitch 16 x 900 frames x 160 chars",
            synthesizer(factories.MODEL_TYPE_FASTPITCH, nar_epochs()), None, None, {}),
        rr: ("runtimeracer-wavernn 40 x 1000",
             lambda n, epochs: train_vocoder("vocoder_bf16", rr, runs_dir, epochs, max_steps=n,
                                             **kw),
             vocoder_epochs(rr, steps), vocoder_epochs(rr, steps + 1),
             {"gru_seq_bf16": 4 * steps, "gru_seq_bwd_bf16": 4 * steps}),
    }
    total, by_run = collections.Counter(), {}
    for key, (label, run, epochs, resume_epochs, want) in runs.items():
        _build.launch_counts.clear()
        with precision.product_dtypes() as products:
            out = run(steps, epochs)
        counts = dict(_build.launch_counts)
        check(counts == want, f"bf16 {label}: launched {counts}, want {want}")
        check(products[torch.bfloat16] > 0 and set(products) == {torch.bfloat16},
              f"bf16 {label}: its Linear and Conv1d layers returned {dict(products)}")
        total.update(counts)
        by_run[label] = counts
        losses, f32 = out["losses"], f32_runs[key]
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"bf16 {label}: losses {losses}")
        dtypes = {p.dtype for p in out["model"].parameters()}
        check(dtypes == {torch.float32}, f"bf16 {label}: master weights {dtypes}")
        rel = abs(losses[0] / f32["losses"][0] - 1)
        check(rel <= 0.05, f"bf16 {label}: first loss {losses[0]} against f32's "
              f"{f32['losses'][0]}: {rel:.3e} apart, past 5e-2")
        with recorded_calls(TRAIN_KERNELS) as calls:
            resumed = run(steps + 1, resume_epochs)
        check(resumed["step"] == steps + 1 and np.isfinite(resumed["losses"]).all(),
              f"bf16 {label}: the resumed step {resumed['step']}, losses {resumed['losses']}")
        n_calls = {name: len(v) for name, v in calls.items()}
        per_step = {name: want.get(key, 0) // steps for name, key in zip(n_calls, BF16_KERNELS)}
        check(n_calls == per_step, f"bf16 {label}: the resumed step called {n_calls}, want "
              f"{per_step}")
        line = train_kernel_checks(calls, f"the bf16 {label} step")
        calls.clear()
        print(f"{card}: bf16 {label}: losses {[round(v, 4) for v in losses]}, the first "
              f"{rel:.2e} from f32's {f32['losses'][0]:.4f} (limit 5e-2); ms per step bf16 "
              f"{[round(m, 1) for m in out['step_ms']]}, f32 "
              f"{[round(m, 1) for m in f32['step_ms'][:steps]]} (the first of each run loads "
              f"its model); Linear and Conv1d outputs {sum(products.values())}, all bf16; the "
              f"resumed fourth step's K3 and K4 launches against their plain versions: {line}")
    print(f"launches in the bf16 training runs: {dict(total)}")
    return entries, dict(total), by_run


def k3_train_candidates_ms(args, backward, dev):
    """K3's forward with residuals or its backward at one shape under each
    instantiation that fits (``ops/lstm_seq.py:candidates``), launched with
    that plan, timed in ``profile_gru.rounds_ms``: {units: ms}."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.ops.lstm_seq import Plan, candidates
    from rtvc_tpu_torch.profile_gru import rounds_ms

    lib, stream = _build.library(), _build.stream_handle(dev)
    if backward:
        dys, dhT, dcT, gates, cs, c0, w = args
        B, T, H = dys.shape
        outs = [torch.empty(B, T, 4 * H, device=dev), torch.empty(B, H, device=dev),
                torch.empty(B, H, device=dev)]
    else:
        xg, w, h0, c0 = args
        B, T, _ = xg.shape
        H = w.shape[1]
        outs = [torch.empty(B, T, H, device=dev), torch.empty(B, H, device=dev),
                torch.empty(B, H, device=dev), torch.empty(B, T, H, device=dev),
                torch.empty(B, T, 4 * H, device=dev)]
    runs = {}
    for p in candidates(B, H, *_build.device_limits(dev), backward=backward):
        if not isinstance(p, Plan):
            continue

        def run(p=p):
            sync = torch.zeros(32 * p.groups, device=dev, dtype=torch.int32)
            if backward:
                err = lib.rtvc_lstm_seq_bwd(*(t.data_ptr() for t in args),
                                            *(t.data_ptr() for t in outs), B, T, H,
                                            _build.int_array(p), sync.data_ptr(), stream)
            else:
                err = lib.rtvc_lstm_seq_fwd(*(t.data_ptr() for t in args),
                                            *(t.data_ptr() for t in outs), B, T, H,
                                            _build.int_array(p), sync.data_ptr(), stream)
            _build.check(err, "rtvc_lstm_seq_" + ("bwd" if backward else "fwd"))

        runs[p.units] = run
    return rounds_ms(runs)


def k3_bf16_designs(fwd_args, bwd_args, want_fwd, want_bwd, dev):
    """K3's two bf16 designs on the same inputs, each through an explicit
    plan (``ops/lstm_seq.py:launch_fwd`` / ``launch_bwd``, no launch
    counted): the tensor-core mode where an instantiation fits
    (``mma_plan``) and the CUDA-core design (``cuda_core_plan``). Each
    design's outputs are held to the plain versions (``held``), then all
    are timed in ``profile_gru.rounds_ms``. Returns {design: {"fwd_ms",
    "bwd_ms", "plan"}}."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.ops import lstm_seq as k3
    from rtvc_tpu_torch.profile_gru import rounds_ms

    xg, w = fwd_args[:2]
    B, T, _ = xg.shape
    H = w.shape[1]
    limits = _build.device_limits(dev)
    plans = {"cuda-core": (k3.cuda_core_plan(B, H, *limits, elem=2),
                           k3.cuda_core_plan(B, H, *limits, backward=True, elem=2))}
    mma = (k3.mma_plan(B, H, *limits), k3.mma_plan(B, H, *limits, backward=True))
    if all(mma):
        plans["tensor-core"] = mma
    bf, f32 = torch.bfloat16, torch.float32
    outs = [torch.empty(B, T, H, device=dev, dtype=bf), torch.empty(B, H, device=dev),
            torch.empty(B, H, device=dev), torch.empty(B, T, H, device=dev, dtype=bf),
            torch.empty(B, T, 4 * H, device=dev, dtype=bf)]
    grads = [torch.empty(B, T, 4 * H, device=dev, dtype=f32), torch.empty(B, H, device=dev),
             torch.empty(B, H, device=dev)]
    runs = {}
    for name, (pf, pb) in plans.items():
        k3.launch_fwd(pf, *fwd_args, *outs)
        k3.launch_bwd(pb, *bwd_args, *grads)
        torch.cuda.synchronize()
        held(f"K3 bf16 {name} forward at B {B} x T {T} x H {H}", outs, want_fwd)
        held(f"K3 bf16 {name} backward at B {B} x T {T} x H {H}", grads, want_bwd)
        runs[(name, "fwd")] = lambda pf=pf: k3.launch_fwd(pf, *fwd_args, *outs)
        runs[(name, "bwd")] = lambda pb=pb: k3.launch_bwd(pb, *bwd_args, *grads)
    ms = rounds_ms(runs)
    return {name: {"fwd_ms": ms[(name, "fwd")], "bwd_ms": ms[(name, "bwd")],
                   "plan": [list(pf), list(pb)]} for name, (pf, pb) in plans.items()}


def k3_train_cell(dev, card, B, T=900, H=512, I=1280, path="forward-tacotron training",
                  dtype=None):
    """K3's forward with residuals and its backward at a training shape (by
    default ForwardTacotron's BiLSTM, one direction from a zero state),
    seeded inputs: each against its plain version (``held``: 1e-4 of each
    f32 output's largest entry), the backward twice with equal bits; their
    times beside their bounds, the plain versions' and cuDNN's
    ``nn.LSTM(I, H)`` (input product included) forward and backward. In
    f32, every instantiation that fits the shape is timed too. With
    ``dtype`` bf16 the bf16 instantiation: bf16 xg, W_hh and dys with f32
    state, its bf16 streams within ``BF16_TOL``, the f32 kernel timed
    beside it on the same values, cuDNN in bf16, the plan at 2-byte weights
    (its design: the tensor-core mode or the CUDA-core one) and the bound
    at the bf16 peak; both bf16 designs are held and timed on the same
    inputs through explicit plans (``k3_bf16_designs``). Returns the
    forward's and the backward's cells."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.ops.lstm_seq import (
        lstm_seq_bwd,
        lstm_seq_bwd_plain,
        lstm_seq_fwd_train,
        lstm_seq_fwd_train_plain,
        mode,
        plan,
    )

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    tag, elem = (" bf16", 2) if bf16 else ("", 4)
    g = torch.Generator().manual_seed(B)
    xg = torch.randn(B, T, 4 * H, generator=g).to(dev, dtype)
    w = ((torch.rand(4 * H, H, generator=g) * 2 - 1) * H ** -0.5).to(dev, dtype)
    h0 = torch.zeros(B, H, device=dev)
    dys = torch.randn(B, T, H, generator=g).to(dev, dtype)
    got, want = lstm_seq_fwd_train(xg, w, h0, h0), lstm_seq_fwd_train_plain(xg, w, h0, h0)
    torch.cuda.synchronize()
    check([t.dtype for t in got] == [dtype, torch.float32, torch.float32, dtype, dtype],
          f"K3{tag} forward with residuals returned {[t.dtype for t in got]}")
    fwd_abs, fwd_err = held(f"K3{tag} forward with residuals at B {B} x T {T}", got, want)
    _, _, _, cs, gates = want
    args = (dys, torch.zeros_like(h0), torch.zeros_like(h0), gates, cs, h0, w)
    kb, pb = lstm_seq_bwd(*args), lstm_seq_bwd_plain(*args)
    torch.cuda.synchronize()
    check(kb[0].dtype == torch.float32, f"K3{tag} backward gave dxg in {kb[0].dtype}")
    bwd_abs, bwd_err = held(f"K3{tag} backward at B {B} x T {T}", kb, pb)
    check(all(torch.equal(a, b) for a, b in zip(kb, lstm_seq_bwd(*args))),
          f"K3{tag} backward at B {B} x T {T}: two runs differ in their bits")
    del got, kb
    fwd_ms = cuda_ms(lambda: lstm_seq_fwd_train(xg, w, h0, h0))
    fwd_plain = cuda_ms(lambda: lstm_seq_fwd_train_plain(xg, w, h0, h0), reps=1)
    bwd_ms = cuda_ms(lambda: lstm_seq_bwd(*args))
    bwd_plain = cuda_ms(lambda: lstm_seq_bwd_plain(*args), reps=1)
    lib_fwd, lib_bwd = rnn_ms(torch.nn.LSTM(I, H, batch_first=True), B, T, H, dev, dtype=dtype)
    flops, peak = 2 * B * T * 4 * H * H, BF16_FLOPS if bf16 else F32_FLOPS
    fwd_b = bound(nbytes(xg, w, h0, h0, *want), flops, peak)
    bwd_b = bound(nbytes(*args, *pb), flops, peak)
    limits = _build.device_limits(dev)
    p_f, p_b = plan(B, H, *limits, elem=elem), plan(B, H, *limits, backward=True, elem=elem)
    if bf16:  # the f32 kernel on the same values; both bf16 designs
        f32 = (xg.float(), w.float(), h0, h0)
        res = lstm_seq_fwd_train(*f32)
        f32_bwd = (dys.float(), *args[1:3], res[4], res[3], h0, f32[1])
        extra = ({"f32_kernel_ms": cuda_ms(lambda: lstm_seq_fwd_train(*f32))},
                 {"f32_kernel_ms": cuda_ms(lambda: lstm_seq_bwd(*f32_bwd))})
        del res
        designs = k3_bf16_designs((xg, w, h0, h0), args, want, pb, dev)
        for e, p, key in ((extra[0], p_f, "fwd_ms"), (extra[1], p_b, "bwd_ms")):
            e["mode"] = mode(p)
            e["designs_ms"] = {name: d[key] for name, d in designs.items()}
        sweep = [f", f32 kernel {e['f32_kernel_ms']:.3f} ms; by explicit plans "
                 + ", ".join(f"{name} {t:.3f} ms" + (" (the plan's)" if name == e["mode"] else "")
                             for name, t in e["designs_ms"].items()) for e in extra]
    else:
        fwd_c = k3_train_candidates_ms((xg, w, h0, h0), False, dev)
        bwd_c = k3_train_candidates_ms(args, True, dev)
        extra = ({"candidates_ms": fwd_c}, {"candidates_ms": bwd_c})
        sweep = [", every instantiation: " + ", ".join(
            f"{u} units a CTA {t:.3f} ms" + (" (plan)" if u == p.units else "")
            for u, t in c.items()) for c, p in ((fwd_c, p_f), (bwd_c, p_b))]
    print(f"{card}: K3{tag} at the {path} shape B={B} T={T} H={H}: forward with residuals "
          f"({k3_plan(B, H, dev, elem=elem)}) rel err {fwd_err:.3e}, max |diff| {fwd_abs:.3e}, "
          f"kernel {fwd_ms:.3f} ms ({fwd_ms / T * 1e3:.2f} us a step), plain {fwd_plain:.3f} ms, "
          f"nn.LSTM({I}, {H}){tag} {lib_fwd:.3f} ms, bound {fwd_b['bound_ms']:.4f} ms by "
          f"{fwd_b['bound_by']}{sweep[0]}; backward ({k3_plan(B, H, dev, True, elem)}) rel err "
          f"{bwd_err:.3e} (tol 1e-4), bits repeat, kernel {bwd_ms:.3f} ms "
          f"({bwd_ms / T * 1e3:.2f} us a step), plain {bwd_plain:.3f} ms, nn.LSTM backward "
          f"{lib_bwd:.3f} ms, bound {bwd_b['bound_ms']:.4f} ms by {bwd_b['bound_by']}{sweep[1]}")
    common = {"B": B, "T": T, "H": H, "path": path,
              "library": f"nn.LSTM({I}, {H}){tag}, input projection included"}
    return ({**common, "max_abs_err": fwd_abs, "ms": fwd_ms, "plain_ms": fwd_plain, **fwd_b,
             "library_ms": lib_fwd, "plan": list(p_f[:5]), **extra[0], "with_residuals": True},
            {**common, "max_abs_err": bwd_abs, "ms": bwd_ms, "plain_ms": bwd_plain, **bwd_b,
             "library_ms": lib_bwd, "plan": list(p_b[:5]), **extra[1]})


def phase_nar_train_kernels(dev, card):
    """K3 (``k3_train_cell`` at B 16 and 48), K4 forward and backward at
    ``NAR_TRAIN_GRU_SHAPES`` (``gru_shape``: against autograd through the
    plain forward, beside cuDNN's ``nn.GRU`` of the same width) and K5's
    forward at the alignment pass's longest shape (B 1, r 1, 1216
    iterations, 160 characters, zoneout 0: ``k5_fwd_cell``). Returns
    {kernel name: [cells]}."""
    import torch

    from rtvc_tpu_torch.ops import tacotron_train as tk

    out = {"lstm_seq": [], "lstm_seq_bwd": [], "gru_seq": [], "gru_seq_bwd": [],
           "tacotron_train_fwd": []}
    for B in (16, 48):
        fwd, bwd = k3_train_cell(dev, card, B)
        out["lstm_seq"].append(fwd)
        out["lstm_seq_bwd"].append(bwd)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "plan",
            "mode", "cooperative_ms", "library")
    for B, T, H in NAR_TRAIN_GRU_SHAPES:
        for name, e in zip(("gru_seq", "gru_seq_bwd"), gru_shape(dev, B, T, H)):
            out[name].append({"B": B, "T": T, "H": H, "path": "forward-tacotron training",
                              **{k: e[k] for k in keys}})
    T, D, L, E, KS = (K5_WIDTHS[k] for k in ("T", "D", "L", "E", "KS"))
    g = torch.Generator().manual_seed(17)

    def u(*shape, fan):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * fan ** -0.5).to(dev)

    w = tk.TrainWeights(
        gwh=u(D, 3 * D, fan=D), gbh=u(3 * D, fan=D), wq=u(D, D, fan=D), bq=u(D, fan=D),
        mloc=(torch.randn(KS, D, generator=g) * 0.1).to(dev), vv=u(D, fan=D),
        wri=u(E + D, L, fan=E + D), bri=u(L, fan=E + D), l1wi=u(L, 4 * L, fan=L),
        l1wh=u(L, 4 * L, fan=L), l1b=u(4 * L, fan=L), l2wi=u(L, 4 * L, fan=L),
        l2wh=u(L, 4 * L, fan=L), l2b=u(4 * L, fan=L), gwi_ctx=u(E, 3 * D, fan=E))
    x, _ = k5_case(g, dev, 1, 1216)
    x["zo1"].zero_()
    x["zo2"].zero_()
    cell, _ = k5_fwd_cell(dev, w, x)
    out["tacotron_train_fwd"].append({**cell, "path": "alignment pass"})
    return out


# The GTA pass's corpus: 16 utterances of 200-1200 frames (the last at
# max_mel_frames) with texts of 40-159 characters, longer texts with longer
# mels, so that its two batches of 8 are the shorter and the longer half
GTA_UTTS = 16
GTA_FRAMES = tuple(int(f) for f in np.linspace(200, 1200, GTA_UTTS))
GTA_CHARS = tuple(int(c) for c in np.linspace(40, 159, GTA_UTTS))
GTA_R = 2
GTA_TYPES = ("tacotron", "forward-tacotron", "fast-pitch")
# where the GTA pass and the hooks look the kernels' wrappers up: K5's
# forward (under taco_decoder_train), K4 (every layers.GRU), ForwardTacotron's
# K3, K2 (the Tacotron hook) and K1 (gen_testset's wavernn_generate)
GTA_KERNELS = (("rtvc_tpu_torch.ops.tacotron_train", "taco_train_fwd"),
               ("rtvc_tpu_torch.models.layers", "gru_seq_fwd"),
               ("rtvc_tpu_torch.models.forward_tacotron", "lstm_seq"))
HOOK_KERNELS = (("rtvc_tpu_torch.ops.tacotron_decode", "tacotron_decode"),
                ("rtvc_tpu_torch.models.layers", "gru_seq_fwd"),
                ("rtvc_tpu_torch.models.forward_tacotron", "lstm_seq"),
                ("rtvc_tpu_torch.models.wavernn", "wavernn_generate_core"))


def write_gta_root(root, seed=31):
    """A synthesizer root of the ``GTA_FRAMES`` utterances as the audio,
    embedding and alignment passes leave one: a voiced wav, a mel, a unit
    768-d embedding and a text as ``write_align_root`` makes them, and
    seeded durations summing to the mel's length over the text's
    characters, pitch and energy a character, attention and alignment
    scores. Returns {utterance id: frames}."""
    from rtvc_tpu_torch.config import preprocessing
    from rtvc_tpu_torch.text import text_to_sequence

    rng = np.random.default_rng(seed)
    for d in ("wav", "mels", "embeds", "duration", "attention", "alignment", "phoneme_pitch",
              "phoneme_energy"):
        (root / d).mkdir(parents=True, exist_ok=True)
    meta, utts = {}, {}
    for i, (frames, chars) in enumerate(zip(GTA_FRAMES, GTA_CHARS)):
        uid = f"gta{i:02d}"
        t = np.arange(frames * 200) / 16000
        f0 = 140 + 50 * np.sin(2 * np.pi * 0.6 * t + rng.uniform(0, 6.3))
        env = np.clip(np.sin(2 * np.pi * 2.5 * t + rng.uniform(0, 6.3)), 0, None)
        wav = (0.5 * env * np.sin(2 * np.pi * np.cumsum(f0) / 16000)
               + 0.003 * rng.standard_normal(len(t))).astype(np.float32)
        m, f = np.arange(80)[:, None], np.arange(frames)[None, :]
        mel = np.clip(-1.5 + 2 * np.sin(2 * np.pi * (f / 97 + m / 40) + rng.uniform(0, 6.3))
                      + 0.3 * rng.standard_normal((80, frames)), -4, 4).astype(np.float32)
        embed = rng.standard_normal(768).astype(np.float32)
        text = " ".join(rng.choice(ALIGN_WORDS, chars))[:chars].strip()
        text = text + "s" * (chars - len(text))
        n_tok = len(text_to_sequence(text, preprocessing.cleaner_names))
        cuts = np.sort(rng.integers(0, frames + 1, n_tok - 1))
        files = {"wav/audio": wav, "mels/mel": mel.T,
                 "embeds/embed": embed / np.linalg.norm(embed),
                 "duration/duration": np.diff(np.concatenate([[0], cuts, [frames]])),
                 "attention/attention": np.float32(0.9),
                 "alignment/alignment": np.float32(0.8),
                 "phoneme_pitch/phoneme-pitch": rng.uniform(80, 250, n_tok).astype(np.float32),
                 "phoneme_energy/phoneme-energy": rng.uniform(0, 2, n_tok).astype(np.float32)}
        for stem, a in files.items():
            np.save(root / f"{stem}-{uid}.npy", a)
        meta.setdefault(f"speaker{i % 2}", []).append(f"{uid}|{len(wav)}|{frames}|{text}")
        utts[uid] = frames
    (root / "train.json").write_text(json.dumps(meta))
    return utts


def gta_kernel_checks(calls, where):
    """Every K5, K4 and K3 launch of a GTA pass or a hook (``where``) again
    on the inputs it was given, against its plain version: each output within 1e-4 of its
    largest entry (K5: ``taco_train_fwd_plain``; K4 ``gru_seq_fwd_plain``;
    K3 ``lstm_seq_plain``, whose outputs are within 1e-4 absolute in the
    serve phase, held here relative as the training kernels are). Returns
    {wrapper: (launches, worst error, shapes)}."""
    import torch

    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops import tacotron_train as tk
    from rtvc_tpu_torch.ops.gru_seq import gru_seq_fwd_plain
    from rtvc_tpu_torch.ops.lstm_seq import lstm_seq_plain

    out = {}
    with torch.no_grad():
        for name, c in calls.items():
            worst, shapes = 0.0, set()
            for args, _, got in c:
                if name == "taco_train_fwd":
                    want = tk.taco_train_fwd_plain(*args)
                    got, want = (got[0], *got[1]), (want[0], *want[1])
                    n, B, _ = args[1].shape
                    shape = f"B {B} x {n} iterations x T {args[2].shape[1]}"
                else:
                    want = (gru_seq_fwd_plain if name == "gru_seq_fwd" else lstm_seq_plain)(*args)
                    B, T, G = args[0].shape
                    shape = f"B {B} x T {T} x H {G // (3 if name == 'gru_seq_fwd' else 4)}"
                err = max(rel_err(a, b) for a, b in zip(got, want))
                check(err <= 1e-4, f"{name} in the {where} at {shape}: rel err {err} from its "
                      f"plain version")
                worst = max(worst, err)
                shapes.add(shape)
            out[name] = (len(c), worst, sorted(shapes))
    return out


def phase_gta(dev, card, syn, work):
    """The GTA pass (``python -m rtvc_tpu_torch.vocoder_preprocess``'s
    ``main`` at ``--batch_size 8``) at full width on the ``GTA_FRAMES``
    corpus (``write_gta_root``) for each synthesizer type, each read from a
    checkpoint: the seeded Tacotron (r 2) and ForwardTacotron as port
    trainer files, FastPitch too. Each pass is two batches of 8. Checks the
    16 mels ((frames, 80), finite) and a ``synthesized.json`` of 16 lines;
    a second pass into a fresh directory equal in bits, its every K5 launch
    (one a Tacotron batch, B 8), every K4 launch (the CBHG BiGRUs) and
    ForwardTacotron's K3 launches (two a batch) recorded and held to their
    plain versions on their own inputs (``gta_kernel_checks``); a
    ``--skip_existing`` pass that writes nothing. Prints ms an utterance per
    type (the first pass, with the model's load, and the pass alone on the
    model in memory, with its longer batch's device time by kernel; neither
    recorded), K5's forward at the pass's two shapes and ForwardTacotron's
    K3 and K4 at the longer batch's (``k5_fwd_cell``, ``rnn_fwd_cell``).
    Returns the launch counts per type,
    the kernel cells, the Tacotron pass's vocoder directory and the NAR
    models."""
    import torch

    from rtvc_tpu_torch import _build, vocoder_preprocess
    from rtvc_tpu_torch.data.synthesizer_dataset import SynthesizerDataset, batch_iterator
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.train.checkpoints import save_checkpoint
    from rtvc_tpu_torch.train.gta import gta_forward, run_synthesis

    root = work / "syn"
    utts = write_gta_root(root)
    models = {"tacotron": syn,
              **{t: factories.init_syn_model(t, seed=0, device=dev) for t in GTA_TYPES[1:]}}
    want_counts = {"tacotron": {"tacotron_train_fwd": 2, "gru_seq": 8},
                   "forward-tacotron": {"lstm_seq": 4, "gru_seq": 20}, "fast-pitch": {}}
    counts, cells, parts = {}, {"tacotron_train_fwd": [], "lstm_seq": [], "gru_seq": []}, []
    for model_type in GTA_TYPES:
        bundle = models[model_type]
        ckpt = work / f"{model_type}.pt"
        r = GTA_R if model_type == "tacotron" else 1
        save_checkpoint(ckpt, bundle.model, 1000, model_type,
                        extras={"r": r, "config": bundle.config.asdict()})

        def run(out, *extra):
            return vocoder_preprocess.main([str(work), "-i", str(root), "-o", str(out), "-s",
                                            str(ckpt), "--batch_size", "8", "--device", str(dev),
                                            *extra])

        voc_dir = work / f"voc_{model_type}"
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        n, first_ms = timed_ms(lambda: run(voc_dir))
        counts[model_type] = dict(_build.launch_counts)
        check(n == GTA_UTTS and counts[model_type] == want_counts[model_type],
              f"the {model_type} GTA pass synthesized {n} utterances with launches "
              f"{counts[model_type]}, want {GTA_UTTS} and {want_counts[model_type]}")
        meta = json.loads((voc_dir / "synthesized.json").read_text())
        check(sorted(meta) == sorted(utts), f"{model_type} synthesized.json holds {sorted(meta)}")
        mels = {}
        for uid, frames in utts.items():
            mel = np.load(voc_dir / "mels_gta" / f"{uid}.npy")
            check(mel.shape == (frames, 80) and np.isfinite(mel).all(),
                  f"{model_type} GTA mel of {uid}: {mel.shape}, finite {np.isfinite(mel).all()}")
            mels[uid] = mel
        with recorded_calls(GTA_KERNELS) as calls:
            run(work / f"again_{model_type}")
        again = {p.stem: np.load(p) for p in (work / f"again_{model_type}" / "mels_gta").iterdir()}
        check(again.keys() == mels.keys() and all(again[u].tobytes() == mels[u].tobytes()
                                                  for u in mels),
              f"two {model_type} GTA passes differ in their bits")
        checked = gta_kernel_checks({k: v for k, v in calls.items() if v},
                                    f"{model_type} GTA pass")
        if model_type == "tacotron":
            for args, _, _ in calls["taco_train_fwd"]:
                x = dict(zip(("xg_pre", "enc_seq", "enc_proj", "char_mask", "zo1", "zo2"),
                             args[1:]))
                cell, _ = k5_fwd_cell(dev, args[0], x)
                cells["tacotron_train_fwd"].append(
                    {**cell, "path": f"GTA pass (tacotron, r {GTA_R})",
                     "launches_per_utterance": 1 / GTA_UTTS})
        elif model_type == "forward-tacotron":
            # the longer batch's launches, one a shape
            shapes = {}
            for name in ("lstm_seq", "gru_seq_fwd"):
                for args, _, _ in calls[name][len(calls[name]) // 2:]:
                    shapes.setdefault((name, tuple(args[0].shape)), args)
            for (name, shape), args in sorted(shapes.items(), key=lambda kv: kv[0]):
                # the BiLSTM takes the regulated frames and the speaker
                # embedding (1280); each BiGRU its highway's H
                I = 1280 if name == "lstm_seq" else shape[2] // 3
                cells["lstm_seq" if name == "lstm_seq" else "gru_seq"].append(
                    {**rnn_fwd_cell(name, args, I), "path": "GTA pass (forward-tacotron)"})
        calls.clear()
        stamps = {p: p.stat().st_mtime_ns for p in (voc_dir / "mels_gta").iterdir()}
        check(run(voc_dir, "--skip_existing") == 0
              and all(p.stat().st_mtime_ns == t for p, t in stamps.items()),
              f"the {model_type} --skip_existing pass wrote mels")
        # the pass alone on the model in memory, and the device time of its
        # longer batch's forward by kernel
        _, pass_ms = timed_ms(lambda: run_synthesis(root, work / f"mem_{model_type}", bundle,
                                                    r=r, batch_size=8))
        dataset = SynthesizerDataset(root, factories.get_model_train_elements(model_type))
        *_, batch = batch_iterator(dataset, 8, r, shuffle=False, drop_last=False, mel_bucket=2)
        with torch.no_grad():
            by_kernel = kernels_device_ms(lambda: gta_forward(bundle, batch, r))
            _, fwd_ms = timed_ms(lambda: gta_forward(bundle, batch, r))
        split = ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_kernel.items(),
                                                            key=lambda kv: -kv[1]))
        parts.append(f"{model_type} {first_ms / GTA_UTTS:.1f} ms an utterance (first pass, "
                     f"the checkpoint's load included), {pass_ms / GTA_UTTS:.1f} (the pass "
                     f"alone, the model in memory); the "
                     f"longer batch's forward {fwd_ms:.1f} ms, device ms {split}; "
                     f"launches {counts[model_type]}, each against its plain version: "
                     + ", ".join(f"{k} {n_} launches rel {e:.3e} ({'; '.join(s)})"
                                 for k, (n_, e, s) in checked.items()))
    print(f"{card}: GTA pass, {GTA_UTTS} utterances ({sum(GTA_FRAMES)} frames, "
          f"{min(GTA_FRAMES)}-{max(GTA_FRAMES)}), batch 8: " + "; ".join(parts)
          + "; two passes equal in bits, --skip_existing wrote nothing")
    for name, cs in cells.items():
        for c in cs:
            shape = " x ".join(f"{k} {c[k]}" for k in ("B", "n_iters", "T", "H") if k in c)
            print(f"{card}: {name} on the {c['path']}, {shape}: kernel {c['ms']:.3f} ms, plain "
                  f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms by {c['bound_by']}"
                  + (f", {c['library']} {c['library_ms']:.3f} ms" if c.get("library") else "")
                  + f", max abs err {c['max_abs_err']:.3e}")
    return {"counts": counts, "cells": cells, "voc_dir": work / "voc_tacotron",
            "models": models}


def phase_gta_train(dev, card, gta, work):
    """What follows the GTA pass: ``train_vocoder("runtimeracer-wavernn")``
    at full width for 3 steps on the Tacotron pass's mels and the corpus's
    wavs (batch 8, ``save_every`` 2, its ``gen_hook`` the entry point's
    ``vocoder_train.sample_hook`` with ``gen_at_checkpoint`` cut to 2 to
    bound the time: ``gen_testset`` fires at step 2, K1 once an item, each
    launch held greedily to its plain version on its own streams,
    ``k1_check``); then the Tacotron evaluation hook (K2 at B 1, up to 400
    frames, held to its plain version by ``k2_check``) and the
    ForwardTacotron and FastPitch hooks once each (ForwardTacotron's K3 and
    K4 launches held to their plain versions, ``nar_kernel_checks``).
    Checks the wavs exist and are finite, and that the PNGs exist exactly
    where matplotlib imports. Prints the time of each hook, and K1's and
    K2's at the shapes these paths gave them. Returns the launch counts by
    path and those kernel cells."""
    import torch
    from scipy.io import wavfile

    from rtvc_tpu_torch import _build, vocoder_train
    from rtvc_tpu_torch.config import synthesizer_paths
    from rtvc_tpu_torch.data.vocoder_dataset import VocoderDataset, batch_iterator
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.ops.tacotron_decode import tacotron_decode, tacotron_decode_plain
    from rtvc_tpu_torch.ops.wavernn_generate import (
        wavernn_generate_core,
        wavernn_generate_core_plain,
    )
    from rtvc_tpu_torch.train import eval_hooks
    from rtvc_tpu_torch.train.trainer import train_vocoder
    from rtvc_tpu_torch.utils import plots

    def wavs_ok(paths):
        for p in paths:
            check(p.exists(), f"{p.name} was not written")
            sr, wav = wavfile.read(p)
            check(sr == 16000 and len(wav) > 0 and np.isfinite(wav).all(),
                  f"{p.name}: {sr} Hz, {len(wav)} samples")

    def pngs_ok(paths):
        have = [p.exists() for p in paths]
        check(all(have) if plots.available() else not any(have),
              f"matplotlib {'imports' if plots.available() else 'is absent'}, PNGs written: "
              f"{[p.name for p, h in zip(paths, have) if h]}")

    model_type = factories.MODEL_TYPE_RUNTIMERACER
    cfg = factories.default_config(model_type).replace(gen_at_checkpoint=2)
    voc_dir, samples = gta["voc_dir"], work / "samples"
    dataset = VocoderDataset(voc_dir / synthesizer_paths.gta_metadata_file,
                             voc_dir / synthesizer_paths.gta_mel_dir,
                             work / "syn" / synthesizer_paths.wav_dir, cfg)
    hook = vocoder_train.sample_hook(model_type, cfg, dataset, samples)
    counts, parts = {}, []
    _build.launch_counts.clear()
    with recorded_calls(HOOK_KERNELS) as calls:
        out, train_ms = timed_ms(lambda: train_vocoder(
            "gta_voc", model_type, work / "runs",
            lambda session: batch_iterator(dataset, 8, cfg, seed=session), save_every=2,
            gen_hook=hook, gen_every=2, max_steps=3, override_hp=cfg, device=dev, seed=0))
    counts["vocoder training, 3 steps and its samples at step 2"] = dict(_build.launch_counts)
    k1 = "wavernn_generate_runtimeracer"
    check(out["step"] == 3 and all(np.isfinite(out["losses"]))
          and len(calls["wavernn_generate_core"]) == 2,
          f"vocoder training on the GTA mels: step {out['step']}, losses {out['losses']}, "
          f"{len(calls['wavernn_generate_core'])} calls of K1's wrapper")
    names = [samples / f"2_{i}_{k}.wav" for i in range(2)
             for k in ("target", "griffinlim", "generated")]
    wavs_ok(names)
    pngs_ok([samples / f"2_{i}_compare.png" for i in range(2)])
    voc_dims = factories.wavernn_dims(model_type, cfg)
    k1_parts, k1_errs = [], []
    for (w, streams, *_), _, _ in calls["wavernn_generate_core"]:
        got, err, sample_err, tol, flips = k1_check(voc_dims, w, streams)
        k1_errs.append(max(err, sample_err))
        k1_parts.append(f"{got.shape[0]} folds x {got.shape[1]} steps head inputs {err:.3e} "
                        f"samples {sample_err:.3e} (tol {tol:g}), {flips} near-ties")
    # K1 at the first item's shape, as gen_testset launches it (sampled)
    args, kwargs, samples_out = calls["wavernn_generate_core"][0]
    cells = {"wavernn_generate_runtimeracer": [{
        "B": samples_out.shape[0], "T": samples_out.shape[1], "path": "gen_testset",
        "max_abs_err": k1_errs[0],
        "ms": cuda_ms(lambda: wavernn_generate_core(*args, **kwargs)),
        "plain_ms": timed_ms(lambda: wavernn_generate_core_plain(*args, **kwargs))[1],
        **k1_bound(args[0], args[1], samples_out), "library_ms": None}]}
    parts.append(f"runtimeracer training on the GTA mels, batch 8: losses "
                 f"{[round(v, 4) for v in out['losses']]}, {train_ms:.0f} ms for 3 steps with "
                 f"gen_testset's 2 items at step 2; K1 against its plain version: "
                 + "; ".join(k1_parts))

    syn = gta["models"]["tacotron"]
    hooks = {"tacotron": eval_hooks.make_tacotron_eval_hook(work / "taco_samples"),
             **{t: eval_hooks.make_nar_eval_hook(work / f"{t}_samples", t)
                for t in GTA_TYPES[1:]}}
    for model_type, fire in hooks.items():
        model = gta["models"][model_type].model.train()
        _build.launch_counts.clear()
        with recorded_calls(HOOK_KERNELS) as calls:
            _, hook_ms = timed_ms(lambda: fire(7, model, GTA_R))
        check(model.training, f"the {model_type} hook left the model in eval mode")
        model.eval()
        counts[f"{model_type} eval hook"] = dict(_build.launch_counts)
        out_dir = work / ("taco_samples" if model_type == "tacotron" else f"{model_type}_samples")
        wavs_ok([out_dir / "eval_7.wav"])
        if model_type == "tacotron":
            [(k2_args, _, _)] = calls["tacotron_decode"]
            m, d, seq, proj, mask, _seed, r, max_steps = k2_args
            km, ka, ks, n_k, err_mel, err_attn = k2_check(m, d, seq, proj, mask, r, max_steps)
            checked = (f"K2 {n_k} iterations of {max_steps // r}: mel {err_mel:.3e}, attention "
                       f"{err_attn:.3e}")
            with torch.no_grad():
                cells["tacotron_decode"] = [{
                    "B": mask.shape[0], "T": mask.shape[1], "iters": n_k,
                    "path": "tacotron eval hook", "max_abs_err": max(err_mel, err_attn),
                    "ms": cuda_ms(lambda: tacotron_decode(*k2_args)),
                    "plain_ms": cuda_ms(lambda: tacotron_decode_plain(*k2_args), reps=1),
                    **k2_bound(m, d, r, n_k, *mask.shape, seq, proj, mask, km, ka, ks),
                    "library_ms": None}]
            pngs_ok([out_dir / "attention_7.png", out_dir / "mel_7.png"])
        else:
            checked = "; ".join(
                f"{k} {n_} launches rel {e:.3e} ({', '.join(s)})"
                for k, (n_, e, s) in gta_kernel_checks(
                    {k: v for k, v in calls.items() if v}, f"{model_type} hook").items()) \
                or "no kernel of ours"
            pngs_ok([out_dir / f"{k}_7.png" for k in ("mel", "pitch_sweep", "energy_sweep")])
        parts.append(f"{model_type} hook {hook_ms:.1f} ms, launches "
                     f"{counts[f'{model_type} eval hook']}, {checked}")
    # the hooks: K2 and the encoder's BiGRUs; seven ForwardTacotron
    # syntheses (the sample, then three pitch and three energy factors)
    want = {"vocoder training, 3 steps and its samples at step 2":
            {"gru_seq": 12, "gru_seq_bwd": 12, k1: 2},
            "tacotron eval hook": {"tacotron_decode": 1, "gru_seq": 2},
            "forward-tacotron eval hook": {"lstm_seq": 14, "gru_seq": 70},
            "fast-pitch eval hook": {}}
    check(counts == want, f"launches after the GTA pass {counts}, want {want}")
    print(f"{card}: after the GTA pass (matplotlib {'imports' if plots.available() else 'absent'}"
          f"): " + "; ".join(parts))
    for name, [c] in cells.items():
        print(f"{card}: {name} on the {c['path']} path, B {c['B']} x T {c['T']}: kernel "
              f"{c['ms']:.3f} ms, plain {c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms by "
              f"{c['bound_by']}")
    return counts, cells


# ---------------------------------------------------------------------------
# Multi-GPU: data-parallel training, the NCCL path, sharded generation, and
# the dataset tools
# ---------------------------------------------------------------------------

DP_STEPS = 2
DP_STAGES = ("ge2e", "runtimeracer", "tacotron")
# (atol, rtol) of a two-process run against one process on the same global
# batches, as the JAX package's DP tests hold theirs
DP_TOL = {"ge2e": (1e-5, 1e-4), "runtimeracer": (2e-4, 1e-3), "tacotron": (2e-4, 1e-3)}
# the share of Tacotron's and runtimeracer's entries that may part from one
# process beyond DP_TOL (Adam's sign flips): an H100 read 0.0019 % and 0.0091 %
DP_SHARE = 5e-4
# the runtimeracer runs prune from step 0, so that both steps prune
DP_PRUNE = dict(use_sparsification=True, start_prune=0, prune_steps=4)
DP_TIMEOUT = 420
K5_TRAIN_KERNELS = (("rtvc_tpu_torch.ops.tacotron_train", "taco_train_fwd"),
                    ("rtvc_tpu_torch.ops.tacotron_train", "taco_train_bwd"))
SCRIPT_UTTS = 3  # utterances a speaker of the ted_project tree, 2 speakers


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def k5_train_checks(calls, where):
    """Every K5 launch of a training step (``recorded_calls`` of
    ``K5_TRAIN_KERNELS``) again on the inputs it was given, against its
    plain version: every output within 1e-4 of its largest entry, as
    ``gta_kernel_checks`` and ``k5_bwd_cell`` hold them. Returns a line."""
    import torch

    from rtvc_tpu_torch.ops import rel_err
    from rtvc_tpu_torch.ops import tacotron_train as tk

    parts = []
    with torch.no_grad():
        for name, plain in (("taco_train_fwd", tk.taco_train_fwd_plain),
                            ("taco_train_bwd", tk.taco_train_bwd_plain)):
            worst, shapes = 0.0, set()
            for args, _, got in calls[name]:
                want = plain(*args)
                if name == "taco_train_fwd":
                    got, want = (got[0], *got[1]), (want[0], *want[1])
                n, B, _ = args[1 if name == "taco_train_fwd" else 7].shape
                err = max(rel_err(a, b) for a, b in zip(got, want))
                check(err <= 1e-4, f"{name} at {where}'s B {B} x {n} iterations: rel err "
                      f"{err} from its plain version")
                worst = max(worst, err)
                shapes.add(f"B {B} x {n}")
            parts.append(f"{name} ({len(calls[name])}: {', '.join(sorted(shapes))}) rel "
                         f"{worst:.3e}")
    return "; ".join(parts)


def dp_stage(stage, dev, runs_dir, rank=0, world=1, dp=None):
    """One trainer at full width for ``DP_STEPS`` steps on seeded global
    batches, through its entry function, on rank ``rank``'s rows of each
    (every row in one process): GE2E on 64 x 10 x 160 partials, runtimeracer
    on its schedule's batch of 40 x 1000 with pruning from step 0, Tacotron
    in its first session (B 112, r 7, 602 frames, 160 characters)."""
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.train.trainer import train_encoder, train_synthesizer, train_vocoder

    def mine(x):  # this rank's rows of a global batch
        n = x.shape[0] // world
        return x[rank * n:(rank + 1) * n]

    if stage == "ge2e":
        return train_encoder("encoder", (mine(b) for b in ge2e_partials(21, DP_STEPS)),
                             runs_dir, total_steps=DP_STEPS, dp=dp, **ge2e_kw(dev, DP_STEPS))
    if stage == "runtimeracer":
        model_type = factories.MODEL_TYPE_RUNTIMERACER
        epochs = vocoder_epochs(model_type, DP_STEPS)
        return train_vocoder(
            "vocoder", model_type, runs_dir,
            lambda s: [{k: mine(v) for k, v in b.items()} for b in epochs(s)],
            max_steps=DP_STEPS, save_every=0, device=dev, seed=0, dp=dp,
            override_hp=factories.default_config(model_type).replace(**DP_PRUNE))
    epochs = tacotron_epochs()
    return train_synthesizer(
        "synthesizer", factories.MODEL_TYPE_TACOTRON, runs_dir,
        lambda s, r: [{k: mine(v) for k, v in b.items()} for b in epochs(s, r)],
        max_steps=DP_STEPS, save_every=0, device=dev, seed=0, dp=dp)


def pruned_share(model_type, state):
    """The share of zeros among the weights pruning acts on."""
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.train.pruning import prunable_weights

    dims = factories.wavernn_dims(model_type, factories.default_config(model_type))
    names = [n for n, _ in prunable_weights(dims)]
    return sum(int((state[n] == 0).sum()) for n in names) / sum(state[n].numel()
                                                                for n in names)


def prune_swaps(got, want):
    """The prunable matrices' groups that one of two runtimeracer states
    pruned and the other kept, by matrix: a mask of their weights and their
    number. Each run must prune as many groups of a gate section as the
    other, and a group kept in one run but pruned in the other must be at
    its section's threshold there (its L1 norm within 1e-3 of the smallest
    kept group's): two groups swapped at a near-tie of their norms."""
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.train.pruning import prunable_weights

    model_type = factories.MODEL_TYPE_RUNTIMERACER
    cfg = factories.default_config(model_type)
    out = {}
    for name, splits in prunable_weights(factories.wavernn_dims(model_type, cfg)):
        a, b = got[name].cpu(), want[name].cpu()
        rows, cols = a.shape
        group = cfg.sparse_group if cols % cfg.sparse_group == 0 else 1
        shape = (splits, rows // splits, cols // group, group)
        ga, gb = a.abs().reshape(shape), b.abs().reshape(shape)
        za, zb = (ga == 0).all(-1), (gb == 0).all(-1)
        swapped = za ^ zb
        if not bool(swapped.any()):
            continue
        for sec in range(splits):
            check(int(za[sec].sum()) == int(zb[sec].sum()),
                  f"{name} section {sec}: {int(za[sec].sum())} groups pruned under DP, "
                  f"{int(zb[sec].sum())} in one process")
            for norms, zero, other in ((ga[sec].sum(-1), za[sec], zb[sec]),
                                       (gb[sec].sum(-1), zb[sec], za[sec])):
                kept = ~zero & other
                if bool(kept.any()):
                    floor = float(norms[~zero].min())
                    check(float(norms[kept].max()) <= floor * (1 + 1e-3),
                          f"{name} section {sec}: a group kept in one run and pruned in the "
                          f"other has the norm {float(norms[kept].max())}, the section's "
                          f"threshold {floor}")
        mask = swapped[..., None].expand(shape).reshape(rows, cols)
        out[name] = (mask, int(swapped.sum()) // 2)
    return out


def dp_against_one(stage, got, one):
    """A DP run's final state ``got`` against the one-process run ``one``
    on the same global batches. GE2E: every entry within ``DP_TOL``.
    Tacotron and runtimeracer: their Adam updates are ±lr wherever a
    gradient is well above Adam's ε, and a gradient that is a difference of
    near-equal sums (the convolutions ahead of a BatchNorm) can change sign
    with the order of summation (the one-step parity tests hold such
    updates to lr, ``test_torch_taco_train.py``): an entry may part from one
    process beyond ``DP_TOL`` by at most two learning rates a step, for at
    most ``DP_SHARE`` of the entries; runtimeracer's pruning may swap two
    groups at a near-tie (``prune_swaps``). Returns a line."""
    from rtvc_tpu_torch.models import factories

    atol, rtol = DP_TOL[stage]
    want = {k: v.detach().cpu() for k, v in one["model"].state_dict().items()}
    if stage == "runtimeracer":
        lr_sum = DP_STEPS * factories.default_config(
            factories.MODEL_TYPE_RUNTIMERACER).voc_tts_schedule[0][1]
    else:
        lr_sum = sum(one.get("lrs", ()))
    flip = 2.02 * lr_sum
    swaps = prune_swaps(got, want) if stage == "runtimeracer" else {}
    beyond, total, worst, where = 0, 0, 0.0, ""
    for name, v in want.items():
        diff = (got[name] - v).abs()
        out = diff > atol + rtol * v.abs()
        if name in swaps:
            out &= ~swaps[name][0]
        total += v.numel()
        n = int(out.sum())
        if n:
            check(stage != "ge2e", f"ge2e under DP: {name} is {float(diff[out].max())} from the "
                  f"one process's (atol {atol}, rtol {rtol})")
            check(float(diff[out].max()) <= flip, f"{stage} under DP: {name} is "
                  f"{float(diff[out].max())} from the one process's, beyond Adam's sign flips "
                  f"({flip})")
            beyond += n
        if name not in swaps and float(diff.max()) >= worst:
            worst, where = float(diff.max()), name
    check(beyond <= DP_SHARE * total, f"{stage} under DP: {beyond} of {total} entries beyond "
          f"atol {atol}, rtol {rtol} from one process (at most {DP_SHARE * total:.0f})")
    return (f"largest difference {worst:.3e} ({where}); {beyond} of {total} entries beyond atol "
            f"{atol}, rtol {rtol}" + (f", each within two learning rates a step ({flip:.2e})"
                                      if beyond else "")
            + (f"; pruning groups swapped at a near-tie: "
               f"{ {k: n for k, (_, n) in swaps.items()} }" if swaps else ""))


def dp_worker(argv):
    """One rank of ``phase_dp`` (``chip_smoke.py --dp-worker <rank> <world>
    <port> <dir> <device>``): joins the group over gloo on the one card, runs each
    ``dp_stage`` on its rows, holds the K3, K4 and K5 launches of its first
    step to their plain versions, and writes its final state, step times,
    losses and launch counts to ``<dir>/<stage>_<rank>.pt``."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.parallel import distributed

    rank, world, port, out = int(argv[0]), int(argv[1]), int(argv[2]), Path(argv[3])
    dev = torch.device(argv[4])
    # NCCL refuses two ranks on one card: these two meet over gloo
    group = distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                                   device=dev)
    if dev.type == "cuda":
        _build.library()
    try:
        for stage in DP_STAGES:
            _build.launch_counts.clear()
            with recorded_calls(TRAIN_KERNELS + K5_TRAIN_KERNELS, limit=4) as calls:
                res = dp_stage(stage, dev, out / f"rank{rank}", rank, world, group)
            counts = dict(_build.launch_counts)
            where = f"rank {rank}'s {stage} step under DP"
            line = train_kernel_checks(calls, where)
            if calls["taco_train_fwd"]:
                line += "; " + k5_train_checks(calls, where)
            torch.save({"state": {k: v.detach().cpu() for k, v in
                                  res["model"].state_dict().items()},
                        "step_ms": res["step_ms"], "losses": res["losses"], "counts": counts,
                        "held": line}, out / f"{stage}_{rank}.pt")
            print(f"rank {rank} {stage}: launches {counts}; first step's launches held to "
                  f"their plain versions: {line}", flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_dp(dev, card, work):
    """Data-parallel training (``parallel/distributed.py``) in two processes
    sharing the one card over gloo (NCCL refuses two ranks on one device):
    ``train_encoder`` (64 x 10 x 160 global, 32 speakers a rank: the GE2E
    loss over the all-gathered embeddings), ``train_vocoder`` runtimeracer
    (its global batch of 40, 20 a rank, pruning from step 0) and
    ``train_synthesizer`` Tacotron (B 112 global, 56 a rank, its first
    session), ``DP_STEPS`` steps each, beside the same trainers in this
    process on the same global batches. The ranks end bitwise equal, equal
    to the one process within ``DP_TOL``; only rank 0 writes a checkpoint;
    each rank's K3, K4 and K5 launches of its first step are held to their
    plain versions (``train_kernel_checks``, ``k5_train_checks``). Step times
    are those of two processes sharing one card, not a multi-GPU speed.
    Returns the one-process runs and the ranks' launches by path."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.models import factories

    single = {}
    for stage in DP_STAGES:
        _build.launch_counts.clear()
        single[stage] = dp_stage(stage, dev, work / "single")
        single[stage]["counts"] = dict(_build.launch_counts)
    out = work / "dp"
    out.mkdir(parents=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the card's memory is the two ranks' now
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-worker",
                               str(rank), "2", str(port), str(out), str(dev)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_TIMEOUT)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for rank, (p, log) in enumerate(zip(procs, logs)):
        for line in log.splitlines():
            if line.startswith("rank "):
                print(line)
        check(p.returncode == 0, f"DP rank {rank} exited {p.returncode}:\n{log[-4000:]}")
    print(f"{card}: two processes on one card over gloo ran the three trainers in {wall:.1f} s "
          "of wall time, their start-up included")
    by_path = {}
    for stage in DP_STAGES:
        ranks = [torch.load(out / f"{stage}_{r}.pt", weights_only=False) for r in (0, 1)]
        state0, state1 = ranks[0]["state"], ranks[1]["state"]
        for name in state0:
            check(torch.equal(state0[name], state1[name]),
                  f"{stage} under DP: {name} differs between the ranks")
        check(ranks[0]["losses"] == ranks[1]["losses"],
              f"{stage} under DP: the ranks' losses differ: {[r['losses'] for r in ranks]}")
        np.testing.assert_allclose(ranks[0]["losses"], single[stage]["losses"], rtol=1e-4,
                                   err_msg=f"{stage} under DP: losses")
        line = dp_against_one(stage, state0, single[stage])
        share = ""
        if stage == "runtimeracer":
            want = single[stage]["model"].state_dict()
            got = pruned_share(factories.MODEL_TYPE_RUNTIMERACER, state0)
            one = pruned_share(factories.MODEL_TYPE_RUNTIMERACER, want)
            check(got == one and got > 0.1, f"runtimeracer under DP pruned {got} of its "
                  f"prunable weights, one process {one}")
            share = f", pruned share {got:.4f} on both ranks and in one process"
        print(f"{stage} under DP: ranks bitwise equal; against one process: {line}{share}; "
              f"losses {[round(v, 5) for v in ranks[0]['losses']]}, one process "
              f"{[round(v, 5) for v in single[stage]['losses']]}")
        print(f"{card}: {stage} ms per step, two processes sharing one card (not a multi-GPU "
              f"speed): rank 0 {[round(m, 1) for m in ranks[0]['step_ms']]}, rank 1 "
              f"{[round(m, 1) for m in ranks[1]['step_ms']]}; one process on the card "
              f"{[round(m, 1) for m in single[stage]['step_ms']]}")
        for r, res in enumerate(ranks):
            for name, n in res["counts"].items():
                by_path.setdefault(name, {})[
                    f"{stage} training under DP, rank {r} ({DP_STEPS} steps, 2 processes on one "
                    f"card)"] = n
    check((work / "dp" / "rank0" / "encoder" / "encoder.pt").exists()
          and not (work / "dp" / "rank1" / "encoder" / "encoder.pt").exists(),
          "the DP encoder run's checkpoint must be rank 0's alone")
    for name in ("lstm_seq", "lstm_seq_bwd", "gru_seq", "gru_seq_bwd", "tacotron_train_fwd",
                 "tacotron_train_bwd"):
        check(any(n > 0 for n in by_path.get(name, {}).values()),
              f"{name} was launched no time under DP")
    return {"single": single, "by_path": by_path, "cells": dp_kernel_cells(dev, card)}


def dp_kernel_cells(dev, card):
    """K3, K4 and K5 alone at a DP rank's shapes, the card to themselves:
    K3 at GE2E's 32 speakers (B 320 x 160 x 768, ``k3_train_cell``), K4 at
    runtimeracer's 20 rows (B 20 x 1000 x 256) and the Tacotron CBHG's 56
    (B 56 x 602 x 64, ``gru_shape``), K5 both ways at B 56 x 86
    (``k5_fwd_cell``, ``k5_bwd_cell``): each against its plain version,
    timed beside its bound, its plain version and cuDNN where there is one.
    Returns the cells by kernel name."""
    import torch

    path = "a DP rank of 2"
    cells = {}
    for c in k3_train_cell(dev, card, 320, T=160, H=768, I=768, path=f"GE2E training, {path}"):
        name = "lstm_seq" if c.pop("with_residuals", False) else "lstm_seq_bwd"
        cells.setdefault(name, []).append(c)
    for B, T, H, label in ((20, 1000, 256, "runtimeracer"), (56, 602, 64, "tacotron CBHG")):
        for c in gru_shape(dev, B, T, H):
            name = c.pop("name")
            del c["source"], c["replaces"]
            cells.setdefault(name, []).append({"B": B, "T": T, "H": H, **c,
                                               "path": f"{label} training, {path}"})
    g = torch.Generator().manual_seed(56)
    w = k5_weights(g, dev)
    x, cots = k5_case(g, dev, 56, 86)
    fwd, p_res = k5_fwd_cell(dev, w, x)
    bwd = k5_bwd_cell(dev, w, x, cots, p_res)
    for name, c in (("tacotron_train_fwd", fwd), ("tacotron_train_bwd", bwd)):
        cells.setdefault(name, []).append({"B": 56, "n_iters": 86, **c, "library_ms": None,
                                           "path": f"tacotron training, {path}"})
    return cells


def phase_dp_nccl(dev, work, want):
    """The NCCL path: one process joins a group of one through
    ``setup_from_args`` with ``RTVC_NUM_PROCESSES=1`` (NCCL, since its device
    is the card) and takes ``DP_STEPS`` GE2E steps, so the NCCL group, its
    all-reduce and its all-gather run on the card; the result equals
    ``want`` (the one-process run of ``phase_dp``) within ``DP_TOL``.
    Returns the launches."""
    import argparse
    import os

    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.parallel import distributed

    env = {distributed.COORD_ENV: f"127.0.0.1:{free_port()}", distributed.NPROC_ENV: "1",
           distributed.PID_ENV: "0"}
    os.environ.update(env)
    try:
        args = argparse.Namespace(coordinator=None, num_processes=None, process_id=None,
                                  device="cuda")
        group = distributed.setup_from_args(args)
        check(group is not None and torch.distributed.get_backend(group) == "nccl",
              "setup_from_args did not make an NCCL group on the card")
        rank_dev = distributed.process_device(args.device)
        check(rank_dev == dev, f"rank 0's device is {rank_dev}")
        _build.launch_counts.clear()
        res = dp_stage("ge2e", rank_dev, work / "nccl", dp=group)
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for name in env:
            os.environ.pop(name, None)
    atol, rtol = DP_TOL["ge2e"]
    got, one = res["model"].state_dict(), want["model"].state_dict()
    worst = max(float((got[k] - v).abs().max()) for k, v in one.items())
    for k, v in one.items():
        check(bool(((got[k] - v).abs() <= atol + rtol * v.abs()).all()),
              f"GE2E over NCCL: {k} differs from the one-process run")
    bitwise = all(torch.equal(got[k], v) for k, v in one.items())
    print(f"GE2E over an NCCL group of one ({DP_STEPS} steps): launches {counts}; largest "
          f"difference from the run without a group {worst:.3e} ("
          + ("bit for bit" if bitwise else f"atol {atol}, rtol {rtol}") + "); losses "
          f"{[round(v, 5) for v in res['losses']]}, ms per step "
          f"{[round(m, 1) for m in res['step_ms']]}")
    return counts


def phase_sharded_generation(dev, card, voc):
    """K1 through ``parallel/generation.py:generate_sharded`` at the clone's
    13 folds x 8000 steps (a 400-frame mel in its 448-frame bucket,
    runtimeracer f32, its 6000 / 1000 window, greedy) over ``[cuda:0]`` (one
    launch of 13 folds) and ``[cuda:0, cuda:0]`` (two launches of 7, one
    after the other on the card's stream), each against one launch of
    ``generate_core`` over the 13 folds: samples within 1e-6, or each fold
    that parts does so at a near-tie of its two top classes, printed. Each
    sharded launch is also held to its plain version over its first 512
    steps (``k1_check``). Returns the launches by path and the cells."""
    import torch
    import torch.nn.functional as F

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.models import wavernn as wrn
    from rtvc_tpu_torch.ops.wavernn_generate import wavernn_generate_core
    from rtvc_tpu_torch.parallel.generation import generate_sharded

    d, model = voc.dims, voc.model
    target, overlap = voc.config.gen_target, voc.config.gen_overlap
    kw = dict(variant=d.variant, head=d.head)
    rng = np.random.default_rng(17)
    mel = wrn.bucket_pad(torch.as_tensor(rng.uniform(0, 1, (1, d.feat_dims, CLONE_FRAMES)),
                                         dtype=torch.float32, device=dev))
    with torch.no_grad():
        mels_up, aux, _ = wrn.upsample_forward(model, d, F.pad(mel, (d.pad, d.pad)))
        mu_f, n_folds = wrn.fold_with_overlap(mels_up, target, overlap)
        aux_f, _ = wrn.fold_with_overlap(aux, target, overlap)
        w = wrn.step_weights(model, d)
        streams = {k: v.contiguous() for k, v in wrn.hoist_aux(model, d, mu_f, aux_f).items()}
        ref, ref_logits = wavernn_generate_core(w, streams, 0, argmax=True, return_logits=True,
                                                **kw)
        ref_wave = wrn.xfade_and_unfold(ref, target, overlap)
        one_ms = cuda_ms(lambda: wavernn_generate_core(w, streams, 0, argmax=True, **kw), reps=2)
    T = mu_f.shape[1]
    check(n_folds == 13 and T == target + 2 * overlap, f"the clone's mel gave {n_folds} folds of "
          f"{T} steps")
    by_path, cells = {}, []
    for n_dev in (1, 2):
        devices = [dev] * n_dev
        label = f"generate_sharded over [{', '.join([str(dev)] * n_dev)}]"
        _build.launch_counts.clear()
        with recorded_calls((("rtvc_tpu_torch.models.wavernn", "wavernn_generate_core"),)) \
                as calls:
            got = generate_sharded(model, d, mel, 0, devices, target, overlap, argmax=True)
            torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        launches = counts.get("wavernn_generate_runtimeracer", 0)
        check(launches == n_dev, f"{label}: {launches} K1 launches, want {n_dev}")
        by_path[f"{label} (the clone's 13 folds)"] = launches
        shards = [c[2] for c in calls["wavernn_generate_core"]]
        per = shards[0].shape[0]
        check(per == -(-n_folds // n_dev), f"{label}: shards of {per} folds")
        folded = torch.cat(shards)[:n_folds]
        diff = float((got - ref_wave).abs().max())
        ties = []
        if diff > 1e-6:
            C = d.n_classes
            labels = [torch.round((x + 1) * (C - 1) / 2) for x in (folded, ref)]
            for b in range(n_folds):
                idx = torch.nonzero(labels[0][b] != labels[1][b])
                if not len(idx):
                    continue
                t = int(idx[0])
                (sw, ss, seed, *_), _, _ = calls["wavernn_generate_core"][b // per]
                with torch.no_grad():
                    _, s_logits = wavernn_generate_core(sw, ss, seed, argmax=True,
                                                        return_logits=True, **kw)
                noise = float((s_logits[b % per, t] - ref_logits[b, t]).abs().max())
                top2 = torch.topk(ref_logits[b, t], 2).values
                gap = float(top2[0] - top2[1])
                check(gap <= 2 * noise, f"{label}: fold {b} parts from one launch at step {t} "
                      f"with a top-2 gap of {gap}, above twice the head input difference {noise}")
                ties.append(f"fold {b} at step {t} (gap {gap:.2e}, head inputs {noise:.2e} apart)")
            check(ties, f"{label}: samples {diff} from one launch's with equal labels")
        held = []
        for (sw, ss, *_), _, _ in calls["wavernn_generate_core"]:
            short = {k: v[:, :512].contiguous() for k, v in ss.items()}
            _, e_head, e_samples, _, flips = k1_check(d, sw, short)
            held.append(f"head {e_head:.2e}, samples {e_samples:.2e}, {flips} near-ties")
        with torch.no_grad():
            ms = cuda_ms(lambda: generate_sharded(model, d, mel, 0, devices, target, overlap,
                                                  argmax=True), reps=2)
        (sw, ss, *_), _, out = calls["wavernn_generate_core"][0]
        cells.append({"path": label, "folds": per, "steps": T, "launches": n_dev, "ms": ms,
                      "one_launch_ms": one_ms, "max_abs_err_vs_one_launch": diff,
                      **k1_bound(sw, ss, out)})
        print(f"{card}: K1 through {label}: {n_dev} launch(es) of {per} folds x {T} steps, "
              f"samples {diff:.3e} from one launch of {n_folds} folds"
              + (f" (parted at near-ties: {'; '.join(ties)})" if ties else " (tol 1e-6)")
              + f"; {ms:.3f} ms for the whole call against one launch's {one_ms:.3f} ms; each "
              f"launch held to its plain version over 512 steps: {' | '.join(held)}")
    return {"by_path": by_path, "cells": cells}


def phase_scripts(dev, card, work):
    """The dataset tools' counterparts (``rtvc_tpu_torch/scripts``):
    ``ted_project`` on a synthetic tree of 2 speakers x 3 utterances of 3-5 s
    with the encoder's random weights on the card (K3 three times an
    utterance, every launch held to its plain version by
    ``held_kernel_launches``; the embeddings within 1e-4 of the same encoder's
    on the CPU), then ``project_2d`` (finite points) and the plot, which
    raises the port's ImportError naming matplotlib where it does not
    import and writes the PNG where it does. Returns the launches."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.inference import encoder as enc
    from rtvc_tpu_torch.scripts import ted_project
    from rtvc_tpu_torch.utils import plots
    from rtvc_tpu_torch.utils.io import save_wav_float
    from rtvc_tpu_torch.utils.projection import project_2d

    rng = np.random.default_rng(51)
    root = work / "speakers"
    for s, f0 in enumerate((120.0, 210.0)):
        for u in range(SCRIPT_UTTS):
            path = root / f"spk{s}" / f"utt{u}.wav"
            path.parent.mkdir(parents=True, exist_ok=True)
            save_wav_float(smoke_voice(3.0 + u, 16000, f0 * (1 + 0.05 * u), rng), path, 16000)
    saved = (enc._model, enc._model_cfg, enc._data)
    try:
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        with recorded_calls((("rtvc_tpu_torch.models.layers", "lstm_seq"),)) as calls:
            embeds, speakers = ted_project.embed_speakers(root, device=dev)
            torch.cuda.synchronize()
        embed_s = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
        n = 2 * SCRIPT_UTTS
        layers = enc._model_cfg.model_num_layers
        check(embeds.shape == (n, enc._model_cfg.model_embedding_size)
              and np.isfinite(embeds).all() and len(speakers) == n,
              f"ted_project embeddings {embeds.shape}, {len(speakers)} speakers")
        check(counts.get("lstm_seq", 0) == layers * n == len(calls["lstm_seq"]),
              f"ted_project launched K3 {counts.get('lstm_seq', 0)} times for {n} utterances")
        line = held_kernel_launches({"lstm_seq": calls["lstm_seq"], "gru_seq_fwd": [],
                                     "tacotron_decode": [], "wavernn_generate_core": []}, None)
        # the first layer's launch of the utterance with the most partials
        args = max((c[0] for c in calls["lstm_seq"][::layers]), key=lambda a: a[0].shape[0])
        cell = {**rnn_fwd_cell("lstm_seq", args, enc._data.mel_n_channels),
                "path": f"ted_project ({n} utterances)"}
        cpu_embeds, _ = ted_project.embed_speakers(root, device="cpu")
        cpu_err = float(np.abs(embeds - cpu_embeds).max())
        check(cpu_err <= 1e-4, f"ted_project: the card's embeddings are {cpu_err} from the CPU's")
        pts = project_2d(embeds)
        check(pts.shape == (n, 2) and np.isfinite(pts).all(), f"ted_project points {pts.shape}")
        png = work / "projections.png"
        try:
            ted_project.save_projection(pts, speakers, png)
            plot = "the PNG written"
            check(plots.available() and png.exists(), "ted_project wrote a PNG without matplotlib")
        except ImportError as e:
            check("matplotlib" in str(e) and not plots.available() and not png.exists(),
                  f"ted_project's plot raised {e!r}")
            plot = f"the plot raised ImportError ({e})"
    finally:
        enc._model, enc._model_cfg, enc._data = saved
    print(f"{card}: ted_project embedded {n} utterances of 2 speakers in {embed_s:.2f} s (K3 "
          f"{counts.get('lstm_seq', 0)} launches; {line}); the CPU's embeddings within "
          f"{cpu_err:.2e}; {plot}; K3 at its B {cell['B']} x T {cell['T']}: {cell['ms']:.3f} ms, "
          f"plain {cell['plain_ms']:.3f} ms, {cell['library']} {cell['library_ms']:.3f} ms, "
          f"bound {cell['bound_ms']:.4f} ms by {cell['bound_by']}")
    return counts, cell


# ---------------------------------------------------------------------------
# The DeepMind dual-softmax WaveRNN (rtvc_tpu_torch/models/wavernn_deepmind.py)
# ---------------------------------------------------------------------------

DM_B, DM_T = 40, 1000  # the training batch: 40 rows of 1001 labels, 1000 K4 steps
DM_STEPS = 3
DM_SAMPLES = 16000  # a second of 16 kHz audio a generated row
DM_BATCHES = (1, 4)
DM_EAGER_SAMPLES = 2048  # the loop launch by launch, without its CUDA graph
DM_LOGIT_GAP = 1e-3


def dm_labels(dev, B, n, seed=24):
    """(coarse, fine) labels (B, n) of a seeded harmonic waveform: three
    harmonics of an f0 of 100-300 Hz a row at 16 kHz, through the port's
    ``encode_16bits`` and ``split_signal``."""
    import torch

    from rtvc_tpu_torch.ops.audio import encode_16bits, split_signal

    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = rng.uniform(100, 300, (B, 1))
    wav = sum(0.5 / k * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.3, (B, 1)))
              for k in (1, 2, 3))
    return split_signal(encode_16bits(torch.from_numpy(wav.astype(np.float32))).to(dev))


def phase_deepmind(dev, card):
    """The DeepMind WaveRNN at full width (hidden 896, quantisation 256) with
    seeded weights:

    - K4 alone at its training shape, B 40 x T 1000 x H 896 (the cooperative
      plan: 112 slices of 8 units, one batch group), forward and backward
      held to the plain versions and timed beside cuDNN's ``nn.GRU(3, 896)``
      (``gru_shape``; with the coarse input's weights zero where a coarse
      gate would see the current sample, the same function);
    - three Adam steps (lr 3e-3) of ``deepmind_loss`` on 40 x 1001 labels of
      a harmonic waveform: finite losses, the third below the first, K4 once
      each way a step, every K4 launch of the first step held to its plain
      version on its own inputs (``train_kernel_checks``);
    - ``generate`` at batch 1 and 4 x 16,000 samples: the same seed the same
      waveform, and the drawn labels teacher-forced through
      ``deepmind_forward`` (K4) reproduce the logits they were drawn from
      within ``DM_LOGIT_GAP``; ms per 1000 samples and kHz, beside the
      loop launched step by step without its CUDA graph over the first
      ``DM_EAGER_SAMPLES`` samples, which must equal the graph's in bits.

    Returns (K4's cells at this shape, K4's launches in the training run)."""
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.models import wavernn_deepmind as dm

    d = dm.DeepMindDims()
    cells = {e["name"]: [{"B": DM_B, "T": DM_T, "H": d.hidden, "path": "deepmind training",
                          **{k: e[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "plan", "mode",
                                               "library")}}]
             for e in gru_shape(dev, DM_B, DM_T, d.hidden, library_in=3)}

    model = factories.init_deepmind(d, seed=0, device=dev).train()
    coarse, fine = dm_labels(dev, DM_B, DM_T + 1)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = dm.deepmind_loss(model, d, coarse, fine)
        loss.backward()
        opt.step()
        return float(loss.detach())

    losses, step_ms = [], []
    _build.launch_counts.clear()
    for i in range(DM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            with recorded_calls(TRAIN_KERNELS) as calls:
                losses.append(step())
        else:
            losses.append(step())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = dict(_build.launch_counts)
    n_calls = {k: len(v) for k, v in calls.items()}
    check(n_calls == {"lstm_seq_fwd_train": 0, "lstm_seq_bwd": 0, "gru_seq_fwd": 1, "_bwd": 1},
          f"the first DeepMind step called {n_calls}")
    line = train_kernel_checks(calls, "the DeepMind step")
    check(counts == {"gru_seq": DM_STEPS, "gru_seq_bwd": DM_STEPS},
          f"{DM_STEPS} DeepMind steps launched {counts}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"DeepMind losses not finite or not falling: {losses}")
    print(f"{card}: DeepMind WaveRNN training {DM_B} x {DM_T + 1} labels, Adam 3e-3: losses "
          f"{[round(v, 4) for v in losses]}; ms per step {[round(m, 1) for m in step_ms]} (the "
          f"first loads the model and records its launches); the first step's K4 launches on "
          f"their own inputs against their plain versions: {line}")

    model.eval()
    for batch in DM_BATCHES:
        wav, cs, fs, lcs, lfs = dm.generate(model, d, 11, DM_SAMPLES, batch=batch,
                                            return_logits=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = dm.generate(model, d, 11, DM_SAMPLES, batch=batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.equal(a, b) for a, b in zip((wav, cs, fs), again)),
              f"DeepMind generate at batch {batch}: the same seed gave another waveform")
        t0 = time.perf_counter()
        eager = dm.deepmind_generate(model, d, DM_EAGER_SAMPLES, batch,
                                     torch.Generator(device=dev).manual_seed(11),
                                     cuda_graph=False)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.equal(a, b[:, :DM_EAGER_SAMPLES]) for a, b in zip(eager, again)),
              f"DeepMind generate at batch {batch}: the loop without its CUDA graph drew "
              f"other samples")
        check(wav.shape == (batch, DM_SAMPLES) and bool(torch.isfinite(wav).all())
              and float(wav.abs().max()) <= 1.0, f"DeepMind generate at batch {batch}: "
              f"{tuple(wav.shape)}, largest |sample| {float(wav.abs().max())}")
        zero = torch.zeros((batch, 1), dtype=cs.dtype, device=dev)
        before = _build.launch_counts["gru_seq"]
        with torch.no_grad():
            lc, lf = dm.deepmind_forward(model, d, torch.cat([zero, cs], 1),
                                         torch.cat([zero, fs], 1))
        torch.cuda.synchronize()
        check(_build.launch_counts["gru_seq"] == before + 1,
              "the teacher-forced pass did not launch K4")
        gap = max(float((lc - lcs).abs().max()), float((lf - lfs).abs().max()))
        check(gap <= DM_LOGIT_GAP, f"DeepMind generate at batch {batch}: the teacher-forced "
              f"logits are {gap} from those the labels were drawn from (tol {DM_LOGIT_GAP})")
        print(f"{card}: DeepMind generate batch {batch} x {DM_SAMPLES} samples: {ms:.1f} ms, "
              f"{ms / DM_SAMPLES * 1000:.2f} ms per 1000 samples a row, "
              f"{DM_SAMPLES / ms:.3f} kHz a row, {batch * DM_SAMPLES / ms:.3f} kHz in all "
              f"(CUDA graphs of {dm.STEP_BLOCK} steps, their capture included); without the "
              f"graphs {eager_ms / DM_EAGER_SAMPLES * 1000:.2f} ms per 1000 samples a row over "
              f"{DM_EAGER_SAMPLES}, equal in bits; same seed same waveform; the drawn labels "
              f"teacher-forced through K4 give the logits within {gap:.3e} (tol {DM_LOGIT_GAP})")
    return cells, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.models import factories

    # wall seconds of each part of the script, printed before the kernels line
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    t0 = time.perf_counter()
    path = _build.library_path()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s -> {path.name}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    syn_cfg = factories.default_config(factories.MODEL_TYPE_TACOTRON).replace(
        max_decoder_steps=400)
    syn = factories.init_syn_model(factories.MODEL_TYPE_TACOTRON, seed=0,
                                   override_hp=syn_cfg, device=dev)
    voc = factories.init_voc_model(factories.MODEL_TYPE_RUNTIMERACER, seed=0, device=dev)
    lap("build and models")

    # first, so that warmup and the first request pay for the first launches
    phase_serve(dev, card, syn, voc)
    phase_barrier(dev)
    lap("serve")
    toolbox = phase_toolbox(dev, card, syn, voc)
    lap("toolbox")
    kernels = [phase_lstm(dev), phase_tacotron(dev, syn), phase_tacotron_chunks(dev, syn),
               *phase_wavernn(dev), phase_mel(dev)]
    lap("inference kernels")
    option_kernels, option_counts, _ = phase_vocoder_options(dev, card, syn, voc)
    kernels += option_kernels
    lap("vocoder options")
    counts = phase_clone(dev, syn, voc)
    stream_counts, _ = phase_stream(dev, card, syn, voc)
    lap("clone and stream")
    nar = phase_nar(dev, card, voc)
    lap("nar")
    align_counts = phase_align(dev, card, syn)
    lap("align")
    pre = phase_preprocess(dev, card, syn)
    lap("preprocess")
    kernels += [phase_lstm_train(dev), *phase_gru(dev), *phase_taco_train_kernel(dev)]
    lap("training kernels")
    nar_train_cells = phase_nar_train_kernels(dev, card)
    lap("nar training kernels")
    runs_dir = _build.BUILD_DIR / "smoke_runs"
    shutil.rmtree(runs_dir, ignore_errors=True)
    try:
        enc_counts, enc_run = phase_train_encoder(dev, runs_dir)
        dashboard_check(runs_dir / "encoder")
        lap("train encoder")
        voc_counts, voc_run = phase_train_vocoder(dev, runs_dir)
        phase_train_vocoder(dev, runs_dir, factories.MODEL_TYPE_FATCHORD, steps=3)
        phase_train_vocoder(dev, runs_dir, factories.MODEL_TYPE_GENEING, steps=3)
        lap("train vocoders")
        syn_counts, syn_run = phase_train_synthesizer(dev, runs_dir)
        lap("train tacotron")
        nar_train_counts, nar_runs = phase_train_nar(dev, card, runs_dir)
        lap("train nar")
        dm_cells, dm_counts = phase_deepmind(dev, card)
        lap("deepmind")
        bf16_kernels, bf16_counts, bf16_by_run = phase_bf16_train(
            dev, card, runs_dir, {"ge2e": enc_run, factories.MODEL_TYPE_RUNTIMERACER: voc_run,
                                  factories.MODEL_TYPE_TACOTRON: syn_run, **nar_runs})
        kernels += bf16_kernels
        lap("train bf16")
    finally:
        shutil.rmtree(runs_dir, ignore_errors=True)
    gta_work = _build.BUILD_DIR / "smoke_gta"
    shutil.rmtree(gta_work, ignore_errors=True)
    gta_work.mkdir(parents=True)
    try:
        gta = phase_gta(dev, card, syn, gta_work)
        lap("gta")
        hook_counts, hook_cells = phase_gta_train(dev, card, gta, gta_work)
        lap("gta train")
    finally:
        shutil.rmtree(gta_work, ignore_errors=True)
    multi_work = _build.BUILD_DIR / "smoke_multi"
    shutil.rmtree(multi_work, ignore_errors=True)
    multi_work.mkdir(parents=True)
    try:
        dp = phase_dp(dev, card, multi_work)
        lap("data parallel (2 processes on one card)")
        nccl_counts = phase_dp_nccl(dev, multi_work, dp["single"]["ge2e"])
        lap("nccl")
        sharded = phase_sharded_generation(dev, card, voc)
        lap("sharded generation")
        script_counts, script_cell = phase_scripts(dev, card, multi_work)
        lap("scripts")
    finally:
        shutil.rmtree(multi_work, ignore_errors=True)
    check("jax" not in sys.modules, "the port imported jax")
    # each kernel's launches on the path that runs it: the clone path for the
    # inference kernels, the trainers for the training ones
    path_counts = {**counts, "tacotron_decode_chunk": stream_counts["tacotron_decode_chunk"],
                   "lstm_seq_bwd": enc_counts["lstm_seq_bwd"],
                   "gru_seq": voc_counts["gru_seq"], "gru_seq_bwd": voc_counts["gru_seq_bwd"],
                   "tacotron_train_fwd": syn_counts["tacotron_train_fwd"],
                   "tacotron_train_bwd": syn_counts["tacotron_train_bwd"],
                   # the bf16 instantiations' path: the five bf16 training runs
                   **{name: bf16_counts[name] for name in BF16_KERNELS},
                   # K1's bf16 pairs: the clone's vocode stage under the options
                   **option_counts}
    # K4 runs on three paths: the vocoder trainer's count is its "launches"
    by_path = {name: {"clone (5 requests)": counts.get(name, 0),
                      "runtimeracer training (5 steps)": voc_counts[name],
                      "tacotron training (3 steps)": syn_counts[name]}
               for name in ("gru_seq", "gru_seq_bwd")}
    # the stream (one, with its prompt's embedding) runs K3, K4 and K1 too
    for name in ("lstm_seq", "gru_seq", "wavernn_generate_runtimeracer"):
        by_path.setdefault(name, {"clone (5 requests)": counts.get(name, 0)})
        by_path[name]["stream (1, its embedding included)"] = stream_counts[name]
        # the NAR clones (embeddings included) and the NAR stream (without)
        for model_type, nar_counts in nar["counts"].items():
            by_path[name][f"{model_type} clone (5 requests)"] = nar_counts.get(name, 0)
        by_path[name]["forward-tacotron stream (1)"] = nar["stream_counts"].get(name, 0)
    # the training kernels on the non-autoregressive paths: ForwardTacotron's
    # trainer (K3 and K4 both ways) and the alignment pass (K5's forward)
    by_path["lstm_seq_bwd"] = {"encoder training (3 steps)": enc_counts["lstm_seq_bwd"]}
    for name in ("lstm_seq", "lstm_seq_bwd", "gru_seq", "gru_seq_bwd"):
        by_path[name]["forward-tacotron training (3 steps)"] = nar_train_counts[name]
    for name in ("gru_seq", "gru_seq_bwd"):
        by_path[name][f"deepmind training ({DM_STEPS} steps)"] = dm_counts[name]
    # the bf16 instantiations' launches by bf16 training run
    for name in BF16_KERNELS:
        by_path[name] = {f"bf16 {label} training (3 steps)": c.get(name, 0)
                         for label, c in bf16_by_run.items()}
    by_path["tacotron_train_fwd"] = {
        "tacotron training (3 steps)": syn_counts["tacotron_train_fwd"],
        "alignment pass (5 utterances)": align_counts["tacotron_train_fwd"]}
    # the GTA pass and what follows it: the vocoder trained on its mels with
    # checkpoint samples, the evaluation hooks
    by_path["tacotron_decode"] = {"clone (5 requests)": counts["tacotron_decode"]}
    for model_type, c in gta["counts"].items():
        for name, n in c.items():
            by_path.setdefault(name, {})[f"GTA pass, {model_type} (16 utterances, B 8)"] = n
    for path, c in hook_counts.items():
        for name, n in c.items():
            by_path.setdefault(name, {})[path] = n
    # the preprocessing passes: K6 once an utterance in the audio pass, K3
    # three times an utterance in the embedding pass
    # the browser toolbox's requests: two loads, two syntheses, an autotune
    # and a stream
    for name, n in toolbox["counts"].items():
        by_path.setdefault(name, {})[
            f"toolbox (2 /api/load, 2 /api/synthesize, /api/autotune of {TOOLBOX_SEEDS} seeds, "
            f"/api/stream)"] = n
    # multi-GPU: each DP rank's training launches, the NCCL group's GE2E
    # steps, generate_sharded's K1 launches and ted_project's K3 launches
    for name, c in dp["by_path"].items():
        by_path.setdefault(name, {}).update(c)
    for name in ("lstm_seq", "lstm_seq_bwd"):
        by_path[name][f"ge2e training over an NCCL group of one ({DP_STEPS} steps)"] = \
            nccl_counts.get(name, 0)
    by_path["wavernn_generate_runtimeracer"].update(sharded["by_path"])
    by_path["lstm_seq"][f"ted_project ({2 * SCRIPT_UTTS} utterances)"] = \
        script_counts.get("lstm_seq", 0)
    by_path.setdefault("mel_project", {"clone (5 requests)": counts.get("mel_project", 0)})
    for name, label in (("mel_project", "synthesizer audio pass"), ("lstm_seq", "embedding pass")):
        by_path[name][f"{label} ({pre['n']} utterances kept, 1 thread)"] = pre["counts"][name]
    for k in kernels:
        # K6's cells at the audio pass's shapes, K3's at the embedding pass's
        if k["name"] in pre["cells"]:
            k.setdefault("shapes", []).extend(pre["cells"][k["name"]])
        # K3's, K4's and K5's cells at the GTA pass's shapes, K1's and K2's
        # at gen_testset's and the Tacotron hook's
        for cells in (gta["cells"], hook_cells):
            if k["name"] in cells:
                k.setdefault("shapes", []).extend(cells[k["name"]])
        # K3's, K4's and K5's cells at the NAR trainer's and the alignment pass's shapes
        if k["name"] in nar_train_cells:
            k.setdefault("shapes", []).extend(nar_train_cells[k["name"]])
        # K3's and K4's cells at ForwardTacotron's shapes
        if k["name"] in nar["cells"]:
            k.setdefault("shapes", []).extend(nar["cells"][k["name"]])
        # K4's cells at the DeepMind WaveRNN's H 896
        k.setdefault("shapes", []).extend(dm_cells.get(k["name"], []))
        # K1's cells through generate_sharded, K3's, K4's and K5's at a DP
        # rank's shapes, K3's in ted_project
        if k["name"] == "wavernn_generate_runtimeracer":
            k.setdefault("shapes", []).extend(sharded["cells"])
        k.setdefault("shapes", []).extend(dp["cells"].get(k["name"], []))
        if k["name"] == "lstm_seq":
            k["shapes"].append(script_cell)
        k["route"] = "cuda"
        k["launches"] = path_counts[k["name"]]
        check(k["launches"] > 0, f"{k['name']} was launched no time on its path")
        if k["name"] in by_path:
            k["launches_by_path"] = by_path[k["name"]]
    print(f"wall seconds by part: {json.dumps(laps)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2:]))
    sys.exit(main())
