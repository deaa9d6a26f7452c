#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rtvc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``rtvc_tpu_torch/csrc`` (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes of the clone path, and times both with CUDA events:
   K3 LSTM sequence (8 x 160 x 768), K2 Tacotron decoder (full width, 2
   texts, prenet dropout off, then seeded dropout), K1 WaveRNN loop
   (runtimeracer, 8 folds x 512 steps, greedy; then sampled from fixed
   logits against a chi-square test).
3. Serves three clone requests through the public API at the default widths
   with seeded random weights: preprocess_wav → embed_utterance →
   synthesize_spectrograms → infer_waveform, and checks the outputs and
   that every kernel of the path was launched.

Prints the card, each phase, one JSON line describing the kernels, and as
its last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, without a CUDA device or if any phase fails.
"""
import json
import subprocess
import sys
import time

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
    print(f"K3 lstm_seq B={B} T={T} H={H}: max_abs_err {err:.3e} (tol 1e-4), "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"name": "lstm_seq", "source": "rtvc_tpu_torch/csrc/lstm_seq.cu",
            "replaces": "rtvc_tpu/ops/pallas/lstm_train_kernel.py:300",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_tacotron(dev, syn):
    import torch

    from rtvc_tpu_torch.models import tacotron as taco
    from rtvc_tpu_torch.ops.tacotron_decode import tacotron_decode, tacotron_decode_plain

    d, model = syn.dims, syn.model
    r, max_steps = 2, (syn.config.max_decoder_steps // 2) * 2
    g = torch.Generator().manual_seed(1)
    chars = torch.randint(1, d.num_chars, (2, 32), generator=g)
    chars[0, 24:] = 0  # 24 characters in the 32 bucket
    chars[1, 20:] = 0
    spk = torch.randn(2, d.speaker_embedding_size, generator=g)
    spk = spk / spk.norm(dim=1, keepdim=True)
    with torch.no_grad():
        seq, proj = taco.encode(model, chars.to(dev), spk.to(dev), prenet_dropout=False)
        seq, proj = seq.contiguous(), proj.contiguous()
        mask = (chars != 0).float().to(dev)

        def kernel(seed=0, dropout=False):
            return tacotron_decode(model, d, seq, proj, mask, seed, r, max_steps, dropout)

        def plain():
            return tacotron_decode_plain(model, d, seq, proj, mask, 0, r, max_steps, False)

        km, ka, ks = kernel()
        pm, pa, ps = plain()
        torch.cuda.synchronize()
        n_k, n_p = taco.stop_iterations(ks, r), taco.stop_iterations(ps, r)
        err_mel = float((km - pm).abs().max())
        err_attn = float((ka - pa).abs().max())
        per_iter = (km - pm).abs().amax(dim=(0, 1)).reshape(-1, r).amax(dim=1)
        bad = torch.nonzero(per_iter > 1e-4)
        print(f"K2 tacotron_decode B=2 T=32 iters={n_k}/{ks.shape[1]}: mel err "
              f"{err_mel:.3e} (tol 1e-4), attn err {err_attn:.3e} (tol 1e-5); first "
              f"iteration over tol: {int(bad[0]) if len(bad) else None}")
        check(n_k == n_p, f"K2 stop iteration {n_k} != plain {n_p}")
        check(err_mel <= 1e-4, f"K2 mel differs from its plain version: {err_mel}")
        check(err_attn <= 1e-5, f"K2 attention differs from its plain version: {err_attn}")
        a1, a2, b1 = kernel(1, True)[0], kernel(1, True)[0], kernel(2, True)[0]
        check(torch.equal(a1, a2), "K2 dropout: one seed does not repeat")
        check(not torch.equal(a1, b1), "K2 dropout: two seeds give the same mel")
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, reps=2)
    print(f"K2 dropout seeded: repeat ok, seeds differ; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms for {ks.shape[1]} iterations")
    return {"name": "tacotron_decode", "source": "rtvc_tpu_torch/csrc/tacotron_decode.cu",
            "replaces": "rtvc_tpu/ops/pallas/tacotron_kernel.py:427",
            "max_abs_err": max(err_mel, err_attn), "ms": ms, "plain_ms": plain_ms}


def phase_wavernn(dev, voc):
    import torch
    from scipy import stats

    from rtvc_tpu_torch.models import wavernn as wrn
    from rtvc_tpu_torch.ops.wavernn_generate import (
        wavernn_generate_core,
        wavernn_generate_core_plain,
    )

    d, model = voc.dims, voc.model
    B, T = 8, 512
    g = torch.Generator().manual_seed(2)
    mels_up = (torch.rand(B, T, d.feat_dims, generator=g) * 2 - 1).to(dev)
    aux = (torch.randn(B, T, d.res_out_dims, generator=g) * 0.5).to(dev)
    with torch.no_grad():
        streams = {k: v.contiguous() for k, v in wrn.hoist_aux(model, d, mels_up, aux).items()}
        w = wrn.step_weights(model, d)
        got, k_logits = wavernn_generate_core(w, streams, 0, argmax=True,
                                              return_logits=True)
        ref, p_logits = wavernn_generate_core_plain(w, streams, 0, argmax=True,
                                                    return_logits=True)
        torch.cuda.synchronize()
        C = d.n_classes
        # Samples are compared as class labels: the label → [-1, 1] division
        # may round differently by one ulp in the two versions.
        k_lab = torch.round((got + 1) * (C - 1) / 2)
        p_lab = torch.round((ref + 1) * (C - 1) / 2)
        err, sample_err, flips = 0.0, 0.0, 0
        for b in range(B):
            idx = torch.nonzero(k_lab[b] != p_lab[b])
            t_end = int(idx[0]) if len(idx) else T
            if t_end < T:
                # a near-tie: the plain version's top-2 gap is within the
                # two versions' logit disagreement at that step
                top2 = torch.topk(p_logits[b, t_end], 2).values
                gap = float(top2[0] - top2[1])
                noise = float((k_logits[b, t_end] - p_logits[b, t_end]).abs().max())
                print(f"K1 fold {b}: labels differ first at step {t_end}, top-2 logit gap "
                      f"{gap:.3e}, logit difference {noise:.3e}")
                check(gap <= 2 * noise, f"K1 greedy decode differs at fold {b} step {t_end} "
                      f"with a logit gap of {gap}, above twice the logit difference {noise}")
                flips += 1
            t_cmp = min(t_end + 1, T)
            err = max(err, float((k_logits[b, :t_cmp] - p_logits[b, :t_cmp]).abs().max()))
            if t_end:
                sample_err = max(sample_err, float((got[b, :t_end] - ref[b, :t_end]).abs().max()))
        check(err <= 1e-4, f"K1 logits differ from the plain version's: {err}")
        check(sample_err <= 1e-6, f"K1 greedy samples differ: {sample_err}")
        ms = cuda_ms(lambda: wavernn_generate_core(w, streams, 0, argmax=True))
        plain_ms = cuda_ms(lambda: wavernn_generate_core_plain(w, streams, 0, argmax=True),
                           reps=1)
        print(f"K1 wavernn_generate greedy {B} folds x {T} steps: labels equal "
              f"({flips} folds cut at a near-tie), logit max_abs_err {err:.3e} (tol 1e-4), "
              f"sample err {sample_err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")

        bias = torch.randn(C, generator=torch.Generator().manual_seed(3)) * 1.5
        w_fixed = dict(w, fc5_w=torch.zeros_like(w["fc5_w"]), fc5_b=bias.to(dev))
        long_streams = {k: v.repeat(1, 4, 1).contiguous() for k, v in streams.items()}
        samples = wavernn_generate_core(w_fixed, long_streams, 2024)
        labels = torch.round((samples.reshape(-1) + 1) * (C - 1) / 2).long().cpu().numpy()
    p = torch.softmax(bias.double(), 0).numpy()
    expected = p * labels.size
    counts = np.bincount(labels, minlength=C)
    keep = expected >= 5
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(expected[keep], expected[~keep].sum())
    pvalue = float(stats.chisquare(obs, exp).pvalue)
    print(f"K1 sampled from fixed logits: {labels.size} draws, {keep.sum() + 1} bins, "
          f"chi-square p = {pvalue:.4f} (need > 1e-3)")
    check(pvalue > 1e-3, f"K1 sampler fails the chi-square test: p = {pvalue}")
    return {"name": "wavernn_generate", "source": "rtvc_tpu_torch/csrc/wavernn_generate.cu",
            "replaces": "rtvc_tpu/ops/pallas/wavernn_kernel.py:309",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def prompt(seed, seconds=3.0, sr=16000):
    """A voiced-sounding test prompt: harmonics under a syllable envelope."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 110 + 40 * seed + 15 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voice = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * 3.1 * t + rng.uniform(0, 6)), 0, None) ** 0.5
    return (0.2 * voice * env + 0.003 * rng.standard_normal(t.size)).astype(np.float32)


def phase_clone(dev, syn, voc):
    import torch

    from rtvc_tpu_torch import _build
    from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder

    encoder.init_random_model(seed=0, device=dev)
    synth = synthesizer.Synthesizer()
    synth.load_bundle(syn, r=2)
    vocoder.load_bundle(voc)
    vocoder.set_seed(0)
    texts = ["The quick brown fox jumps over the lazy dog.",
             "Voice cloning on a single graphics card.",
             "Hello there, this is a test of the clone path."]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1000.0

    _build.launch_counts.clear()
    for i, text in enumerate(texts):
        wav = prompt(i)
        pre, t_pre = timed(lambda: encoder.preprocess_wav(wav))
        embed, t_emb = timed(lambda: encoder.embed_utterance(pre))
        specs, t_syn = timed(lambda: synth.synthesize_spectrograms([text], [embed]))
        mel = specs[0]
        out, t_voc = timed(lambda: vocoder.infer_waveform(mel))
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
    counts = dict(_build.launch_counts)
    print(f"launches in the clone run: {counts}")
    for name in ("lstm_seq", "tacotron_decode", "wavernn_generate"):
        check(counts.get(name, 0) > 0, f"{name} was not launched by the clone path")
    return counts


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

    kernels = [phase_lstm(dev), phase_tacotron(dev, syn), phase_wavernn(dev, voc)]
    counts = phase_clone(dev, syn, voc)
    check("jax" not in sys.modules, "the port imported jax")
    for k in kernels:
        k["route"] = "cuda"
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
