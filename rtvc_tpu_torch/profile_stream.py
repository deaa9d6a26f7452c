"""Where a streamed clone's time goes on the card (the port's counterpart of
``bench_streaming.py``'s ``_measure`` and ``_device_ttfa_tacotron``).

    python -m rtvc_tpu_torch.profile_stream [--runs 5] [--first 16]
        [--synthesizer {tacotron,forward-tacotron,fast-pitch}]

Seeded random weights at the default widths (the GE2E encoder, the Tacotron
with ``max_decoder_steps`` 400 as ``demo_cli`` caps it, so that the decoder
runs its 200 iterations, and the runtimeracer WaveRNN), the 3 s voiced
prompt of ``serve.voiced_prompt``. After one warm-up stream it gives, for
each run of ``stream_clone`` (first chunk ``--first`` frames, then 48):
the time to the first audio (TTFA: the call to the first chunk ready), each
chunk's emit time, the real-time factor (seconds of audio over the stream's
wall seconds) and the chunk cadence's (a steady chunk's audio over the
median gap between chunks). Then the first chunk's chain alone, timed with
CUDA events around each stage: encode, decode (K2 over the first chunk's
iterations), postnet (the CBHG, K4) and vocode (the generate path, K1).
With ``--synthesizer forward-tacotron`` or ``fast-pitch`` (their duration
head set to 6 frames a character, as ``chip_smoke.py`` sets it) the stream
is the batch mel through ``stream_vocode``, and the first chunk's split is
the whole synthesize stage and the first chunk's vocode (host clock, each
ended by a device sync). It raises without a card.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

TEXT = "The quick brown fox jumps over the lazy dog."


def measure(synth, voc, text: str, embed: np.ndarray, runs: int, **stream_kwargs) -> list:
    """``runs`` streams of ``text``, each a dict: ``ttfa_ms``, ``emit_ms``
    (each chunk's, from the call), ``frames``, ``samples``, ``total_ms``,
    ``rtf`` and ``cadence_rtf`` (None with fewer than three chunks)."""
    from rtvc_tpu_torch.inference.streaming import stream_clone

    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        chunks = list(stream_clone(synth, voc, text, embed, **stream_kwargs))
        out.append(stats(chunks, t0, time.perf_counter(), voc.dims.hop_length,
                         synth.sample_rate))
    return out


def stats(chunks: list, t0: float, t_end: float, hop: int, sr: int) -> dict:
    """One stream's timings (``measure``) from its chunks, the call's start
    and its end."""
    total = t_end - t0
    stamps = [c.t_emitted - t0 for c in chunks]
    samples = sum(len(c.wav) for c in chunks)
    cadence = None
    if len(chunks) > 2:
        gap = float(np.median(np.diff(stamps[1:])))
        cadence = float(np.median([c.frames for c in chunks[1:-1]])) * hop / sr / gap
    return {"ttfa_ms": stamps[0] * 1e3, "emit_ms": [t * 1e3 for t in stamps],
            "frames": sum(c.frames for c in chunks), "samples": samples,
            "total_ms": total * 1e3, "rtf": samples / sr / total, "cadence_rtf": cadence}


@torch.no_grad()
def first_chunk_split(synth, voc, text: str, embed: np.ndarray, first_chunk_frames: int = 16,
                      post_ctx: int = 32, voc_ctx: int = 12, voc_target: int = 400,
                      voc_overlap: int = 160, reps: int = 5) -> dict:
    """Device ms of the first chunk's stages (CUDA events, the mean of
    ``reps`` after a warm-up): encode, decode, postnet, vocode, and all."""
    from rtvc_tpu_torch.config import sp
    from rtvc_tpu_torch.inference import streaming as st
    from rtvc_tpu_torch.inference.synthesizer import text_ids
    from rtvc_tpu_torch.models import tacotron as taco
    from rtvc_tpu_torch.ops.tacotron_decode import tacotron_decode_chunk

    bundle, r = synth._bundle, synth._r
    d, model = bundle.dims, bundle.model
    dev = model.post_proj.weight.device
    chars = text_ids([text])
    pad = -float(sp.max_abs_value)
    n_iters = -(-first_chunk_frames // r)
    stages = ("encode", "decode", "postnet", "vocode")
    total = dict.fromkeys(stages, 0.0)
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        seq, proj, mask = synth.encode(chars, np.asarray(embed, np.float32)[None], 0)
        ev[1].record()
        out = tacotron_decode_chunk(model, d, seq, proj, mask, 0, r,
                                    taco.init_decoder_carry(d, 1, chars.shape[1], device=dev),
                                    torch.zeros((1, d.n_mels), device=dev),
                                    torch.zeros((), dtype=torch.int32, device=dev), 0, n_iters,
                                    0, pad)
        ev[2].record()
        post = st._ChunkPost(model, voc, post_ctx, voc_ctx, pad, d.n_mels, dev, voc_target,
                             voc_overlap)
        post_chunk = post.postnet(out.mel, n_iters * r)
        ev[3].record()
        post.vocode(post_chunk, st.chunk_seed(0, 0))
        ev[4].record()
        torch.cuda.synchronize()
        if rep:
            for i, name in enumerate(stages):
                total[name] += ev[i].elapsed_time(ev[i + 1]) / reps
    total["all"] = sum(total.values())
    return total


@torch.no_grad()
def nar_first_chunk_split(synth, voc, text: str, embed: np.ndarray, first_chunk_frames: int = 16,
                          reps: int = 5) -> dict:
    """A NAR stream's way to its first chunk, host ms after a device sync
    (the mean of ``reps`` after a warm-up): the whole synthesize stage, then
    the first chunk of ``stream_vocode`` over its mel, and both."""
    from rtvc_tpu_torch.inference.streaming import stream_vocode

    total = {"synthesize": 0.0, "first chunk's vocode": 0.0}
    for rep in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = synth.synthesize_spectrograms([text], [embed])[0]
        t1 = time.perf_counter()
        next(stream_vocode(voc, mel, 0, first_chunk_frames=first_chunk_frames))
        t2 = time.perf_counter()
        if rep:
            total["synthesize"] += (t1 - t0) * 1e3 / reps
            total["first chunk's vocode"] += (t2 - t1) * 1e3 / reps
    total["all"] = sum(total.values())
    return total


def nar_synthesizer(model_type: str, dev, seed: int = 0, frames_per_char: float = 6.0):
    """A ``Synthesizer`` holding a seeded default-width ForwardTacotron or
    FastPitch whose duration head predicts ``frames_per_char`` frames for
    every character (weight 0, that bias): random predictors give near-zero
    durations, which the guard turns into 2 frames a character."""
    from rtvc_tpu_torch.inference import synthesizer
    from rtvc_tpu_torch.models import factories

    bundle = factories.init_syn_model(model_type, seed=seed, device=dev)
    with torch.no_grad():
        bundle.model.dur_pred.lin.weight.zero_()
        bundle.model.dur_pred.lin.bias.fill_(frames_per_char)
    synth = synthesizer.Synthesizer()
    synth.load_bundle(bundle)
    return synth


def models(dev, seed: int = 0, model_type: str = "tacotron"):
    """(synthesizer, vocoder bundle, embedding of the voiced prompt) at the
    default widths with seeded random weights; the encoder installed."""
    from rtvc_tpu_torch.inference import encoder, synthesizer
    from rtvc_tpu_torch.models import factories
    from rtvc_tpu_torch.serve import voiced_prompt

    encoder.init_random_model(seed=seed, device=dev)
    if model_type == factories.MODEL_TYPE_TACOTRON:
        cfg = factories.default_config(model_type).replace(max_decoder_steps=400)
        synth = synthesizer.Synthesizer()
        synth.load_bundle(factories.init_syn_model(model_type, seed=seed, override_hp=cfg,
                                                   device=dev), r=2)
    else:
        synth = nar_synthesizer(model_type, dev, seed)
    voc = factories.init_voc_model(factories.MODEL_TYPE_RUNTIMERACER, seed=seed, device=dev)
    embed = encoder.embed_utterance(encoder.preprocess_wav(voiced_prompt(0)))
    return synth, voc, embed


def line(run: dict) -> str:
    cadence = run["cadence_rtf"]
    return (f"TTFA {run['ttfa_ms']:.1f} ms, {len(run['emit_ms'])} chunks emitted at "
            + ", ".join(f"{t:.1f}" for t in run["emit_ms"]) + f" ms; {run['frames']} frames, "
            f"{run['samples']} samples in {run['total_ms']:.1f} ms: RTF {run['rtf']:.2f}, "
            f"chunk cadence RTF {'n/a' if cadence is None else f'{cadence:.2f}'}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--first", type=int, default=16,
                        help="first_chunk_frames of the stream (0: the steady 48)")
    parser.add_argument("--synthesizer", default="tacotron",
                        choices=("tacotron", "forward-tacotron", "fast-pitch"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_stream needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    synth, voc, embed = models(dev, model_type=args.synthesizer)
    kw = {"first_chunk_frames": args.first or None}
    measure(synth, voc, TEXT, embed, 1, **kw)
    for i, run in enumerate(measure(synth, voc, TEXT, embed, args.runs, **kw)):
        print(f"{card}: stream {i}: {line(run)}")
    if args.synthesizer == "tacotron":
        split = first_chunk_split(synth, voc, TEXT, embed, args.first or 48)
        kind = "device ms by stage"
    else:
        split = nar_first_chunk_split(synth, voc, TEXT, embed, args.first or 48)
        kind = f"{args.synthesizer}, host ms by stage"
    print(f"{card}: the first chunk ({args.first or 48} frames) alone, {kind}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
