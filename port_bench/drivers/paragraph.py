"""Long-form text, one paragraph at a time from one client (closed loop):
a prompt's ``preprocess_wav`` → ``embed_utterance``, then every sentence of
the paragraph in one ``synthesize_spectrograms`` call and every mel in one
``infer_waveforms`` call (one launch of the sample loop over all their
folds). Reports the seconds of speech returned over every completed
request divided by the window's wall time (``audio_s_per_s``): the speech of
each sentence's own characters, the durations the synthesizer returned for
its non-pad characters. The frames its pad characters take (every row is as
long as the batch's 32-character bucket allows) are work the program does
and no user asked for, and are not counted.

Traffic parameters: ``prompt_seconds``, ``sentences``, ``text_chars`` (each
sentence's), ``greedy_every``, ``pool``, ``check_requests``.
"""
from __future__ import annotations

import sys
import time
import traceback

import numpy as np

from port_bench.counts import flops
from port_bench.harness.warmup import bucket_lengths, prompt_lengths
from port_bench.harness import checks, system
from port_bench.harness.traffic import Traffic, sentence, voiced_prompt
from port_bench.reference import encoder as ref_enc
from port_bench.reference import text as ref_text



def setup(run):
    W = system.make_weights(run.config, run.seed, run.device)
    run.mark("weights made")
    synth = system.install(run.config, W, run.device, run.seed)
    run.mark("models installed")
    rec = system.record()
    traffic = Traffic(run.traffic, run.seed)
    warm(run, synth, traffic)
    run.mark("warmed")
    return {"W": W, "synth": synth, "rec": rec, "traffic": traffic, "served": [],
            "sizes": [], "audio_s": 0.0}


def warm(run, synth, traffic) -> None:
    """Every (sentences, character bucket) the pool can ask for through the
    synthesizer once, every count of partials through the encoder once, two
    whole paragraphs through the vocoder (sampled and greedy)."""
    from rtvc_tpu_torch.inference import encoder, vocoder

    rng = np.random.default_rng(12345)
    embeds = [encoder.embed_utterance(encoder.preprocess_wav(voiced_prompt(rng, s, 140.0)))
              for s in prompt_lengths(traffic)]
    counts = sorted({int(n) for n in traffic.all_sizes("sentences")})
    for n in counts:
        for chars in bucket_lengths(traffic):
            texts = [sentence(rng, chars)] * n
            mels = synth.synthesize_spectrograms(texts, [embeds[0]] * n)
    for greedy in (False, True):
        vocoder.infer_waveforms(mels, argmax=greedy)
    run.sync()


def window(run, st) -> None:
    from rtvc_tpu_torch.inference import encoder, vocoder

    synth, rec = st["synth"], st["rec"]
    i = 0
    while not run.deadline_passed():
        req = st["traffic"].request(i)
        i += 1
        run.attempted += 1
        t0 = time.perf_counter()
        try:
            with run.span("request"):
                with run.span("preprocess"):
                    wav = encoder.preprocess_wav(req.prompt)
                with run.span("embed"):
                    embed = encoder.embed_utterance(wav)
                with run.span("synthesize"):
                    mels, durs = synth.synthesize_spectrograms(
                        req.texts, [embed] * len(req.texts), return_alignments=True)
                with run.span("vocode"):
                    waves = vocoder.infer_waveforms(mels, argmax=req.greedy)
        except Exception:  # a request that fails counts, and the run goes on
            run.failed += 1
            print(f"request {req.index} failed:", file=sys.stderr)
            traceback.print_exc()
            continue
        run.latencies_s.append(time.perf_counter() - t0)
        st["audio_s"] += speech_seconds(run.config, req.texts, durs)
        samples = rec["samples"].last
        st["sizes"].append((len(wav), req.texts, [m.shape[1] for m in mels],
                            tuple(samples.shape)))
        if req.greedy:
            st["served"].append({"prompt": req.prompt, "texts": req.texts, "embed": embed,
                                 "mels": mels, "durations": np.stack(durs),
                                 "samples": samples, "waves": waves})


def end_to_end(run, st) -> dict:
    run.counters["model_flops"] = sum(request_flops(run.config, *s) for s in st["sizes"])
    run.counters["k1_launches"] = [s[3] for s in st["sizes"]]
    run.counters["audio_s"] = st["audio_s"]
    return {"audio_s_per_s": st["audio_s"] / run.window_s}


def speech_seconds(cfg: dict, texts, durations) -> float:
    """The seconds of speech of the texts' own characters (EOS included, pad
    characters left out), by the durations the synthesizer returned."""
    own = (ref_text.batch_ids(texts) != 0).sum(axis=1)
    frames = sum(float(np.sum(np.asarray(d)[:n])) for d, n in zip(durations, own))
    sig = cfg["signal"]
    return frames * sig["hop"] / sig["sample_rate"]


def request_flops(cfg, n_wav, texts, frames, k1_shape) -> float:
    partials = len(ref_enc.partial_slices(n_wav))
    T = ref_text.batch_ids(texts).shape[1]
    L = max(frames)
    padded = -(-L // 64) * 64
    return (flops.encoder(cfg["encoder"], partials)
            + flops.forward_tacotron_generate(cfg["synthesizer"], len(texts), T, L)
            + flops.wavernn_generate(cfg["vocoder"], padded, *k1_shape))


def release(run, st) -> dict:
    system.uninstall()
    return {"W": st["W"], "served": st["served"]}


def items(run, record) -> list:
    """The greedy requests the check compares: the longest and others drawn
    from the seed."""
    return checks.pick(run.seed, record["served"], int(run.traffic.get("check_requests", 1)),
                       lambda it: sum(m.shape[1] for m in it["mels"]))


def numbers(run, record, item, stages=checks.ALL) -> dict:
    return checks.paragraph_numbers(record["W"], run.config, item, stages)


def control_item(run, record, item) -> dict:
    """The item served by the reference at TF32 in the program's place."""
    return checks.control_paragraph(record["W"], run.config, item)


def faults(run) -> dict:
    return checks.faults(run.config)


def check(run, record) -> None:
    checks.report_worst(run, [numbers(run, record, it) for it in items(run, record)])
