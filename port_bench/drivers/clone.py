"""A voice clone, one request at a time from one client (closed loop): a
prompt's ``preprocess_wav`` → ``embed_utterance`` → the synthesizer's
``synthesize_spectrograms`` → ``infer_waveform``, ending in a host
waveform. Reports the 90th percentile of the clone's wall time over every
request the window completed (``clone_p90_ms``).

Tacotron's decoder stops where a trained one would: after
``stop_frames_per_char`` frames a character of the text (the
configuration's), at most ``max_decoder_steps``. The random decoder's own
stop token never fires (its bias at ``stop_proj_bias``), so each request
installs its text's cap as the synthesizer's ``max_decoder_steps`` before it
starts, outside its timing.

Traffic parameters (the traffic file): ``prompt_seconds``, ``text_chars``,
``greedy_every``, ``pool``, ``check_requests`` (how many greedy requests the
check compares, the one with the longest text among them).
"""
from __future__ import annotations

import math
import sys
import time
import traceback

import numpy as np

from port_bench.counts import flops
from port_bench.harness.warmup import bucket_lengths, prompt_lengths
from port_bench.harness import checks, system
from port_bench.harness.runner import percentile
from port_bench.harness.traffic import Traffic, sentence, voiced_prompt
from port_bench.reference import encoder as ref_enc
from port_bench.reference import text as ref_text


def setup(run):
    from rtvc_tpu_torch.inference import encoder, vocoder

    W = system.make_weights(run.config, run.seed, run.device)
    run.mark("weights made")
    synth = system.install(run.config, W, run.device, run.seed)
    run.mark("models installed")
    rec = system.record()
    traffic = Traffic(run.traffic, run.seed)
    stop = Stop(run.config, synth)
    warm(run, synth, traffic, stop)
    run.mark("warmed")
    return {"W": W, "synth": synth, "rec": rec, "traffic": traffic, "encoder": encoder,
            "vocoder": vocoder, "served": [], "sizes": [], "stop": stop}


class Stop:
    """Where Tacotron's decoder stops for a text: ``stop_frames_per_char``
    frames a character, rounded up to the reduction factor, at most
    ``max_decoder_steps`` (no cap for the other synthesizers)."""

    def __init__(self, cfg: dict, synth):
        syn = cfg["synthesizer"]
        self.rate = syn.get("stop_frames_per_char")
        self.top, self.r = syn.get("max_decoder_steps"), syn.get("r", 2)
        self.synth, self.base = synth, synth._bundle

    def frames(self, text: str) -> int:
        n = self.r * max(1, math.ceil(len(text) * self.rate / self.r))
        return min(n, self.top)

    def set(self, frames: int) -> None:
        b = self.base
        self.synth.load_bundle(b._replace(config=b.config.replace(max_decoder_steps=frames)),
                               r=self.r)

    def set_for(self, text: str) -> None:
        if self.rate is not None:
            self.set(self.frames(text))


def warm(run, synth, traffic, stop) -> None:
    """Every character bucket and every count of partials the pool's texts
    and prompts can take, each through the synthesizer at every postnet
    bucket its decoder can stop in (sampled and greedy in turn), the encoder
    once, and whole vocodes of the shortest and the longest mel (sampled and
    greedy)."""
    from rtvc_tpu_torch.inference import encoder, vocoder

    rng = np.random.default_rng(12345)
    embeds = [encoder.embed_utterance(encoder.preprocess_wav(voiced_prompt(rng, s, 140.0)))
              for s in prompt_lengths(traffic)]
    run.mark("encoder warmed")
    caps = [None]
    if stop.rate is not None:
        shortest = max(int(round(traffic.all_sizes("text_chars")[0])), 3)
        lo, hi = stop.frames("x" * shortest), stop.top
        caps = sorted({min(max(lo, 128 * k), hi) for k in range(1, -(-hi // 128) + 1)} | {lo})
    mels, i = {}, 0
    for chars in bucket_lengths(traffic):
        for cap in caps:
            if cap is not None:
                stop.set(cap)
            greedy = i % 2 == 1
            mel = synth.synthesize_spectrograms([sentence(rng, chars)], [embeds[0]], seed=i,
                                                prenet_dropout=not greedy)[0]
            mels.setdefault(mel.shape[1], mel)
            i += 1
    run.mark("synthesizer warmed")
    for n in sorted({min(mels), max(mels)}):
        for greedy in (False, True):
            vocoder.infer_waveform(mels[n], argmax=greedy)
    run.mark("vocoder warmed")
    run.sync()


def window(run, st) -> None:
    encoder, vocoder, synth, rec = st["encoder"], st["vocoder"], st["synth"], st["rec"]
    nar = run.config["synthesizer"]["type"] != "tacotron"
    i = 0
    while not run.deadline_passed():
        req = st["traffic"].request(i)
        i += 1
        run.attempted += 1
        st["stop"].set_for(req.texts[0])
        t0 = time.perf_counter()
        try:
            with run.span("request"):
                with run.span("preprocess"):
                    wav = encoder.preprocess_wav(req.prompt)
                with run.span("embed"):
                    embed = encoder.embed_utterance(wav)
                with run.span("synthesize"):
                    if nar:
                        [mel], durs = synth.synthesize_spectrograms(req.texts, [embed],
                                                                    return_alignments=True)
                    else:
                        [mel] = synth.synthesize_spectrograms(req.texts, [embed], seed=req.seed,
                                                              prenet_dropout=not req.greedy)
                with run.span("vocode"):
                    out = vocoder.infer_waveform(mel, argmax=req.greedy)
        except Exception:  # a request that fails counts, and the run goes on
            run.failed += 1
            print(f"request {req.index} failed:", file=sys.stderr)
            traceback.print_exc()
            continue
        run.latencies_s.append(time.perf_counter() - t0)
        samples = rec["samples"].last
        if nar:
            st["sizes"].append((len(wav), req.texts[0], mel.shape[1], tuple(samples.shape), 0))
            item = {"texts": req.texts, "mels": [mel], "durations": np.stack(durs),
                    "waves": [out]}
        else:
            frames, _, stops = rec["decode"].last
            st["sizes"].append((len(wav), req.texts[0], mel.shape[1], tuple(samples.shape),
                                frames.shape[2]))
            item = {"text": req.texts[0], "frames": frames, "stops": stops, "mel": mel,
                    "wave": out}
        if req.greedy:
            st["served"].append({"prompt": req.prompt, "embed": embed, "samples": samples,
                                 **item})


def end_to_end(run, st) -> dict:
    lat = [s * 1e3 for s in run.latencies_s]
    slow = sorted(range(len(lat)), key=lambda i: -lat[i])[:4]
    print("latency ms: min %.1f, p10 %.1f, p50 %.1f, p90 %.1f, max %.1f; slowest: %s" % (
        min(lat), percentile(lat, 10), percentile(lat, 50), percentile(lat, 90), max(lat),
        ", ".join(f"#{i} {lat[i]:.1f} ({len(st['sizes'][i][1])} chars, "
                  f"{st['sizes'][i][0] / 16000:.2f} s trimmed)" for i in slow)),
        file=sys.stderr)
    spans = {}
    for name, t0, t1 in run.spans:
        spans.setdefault(name, []).append((t1 - t0) * 1e3)
    print("span ms p50 / p90: " + ", ".join(
        f"{k} {percentile(v, 50):.1f} / {percentile(v, 90):.1f}" for k, v in spans.items()),
        file=sys.stderr)
    run.counters["model_flops"] = sum(request_flops(run.config, *s) for s in st["sizes"])
    run.counters["k1_launches"] = [s[3] for s in st["sizes"]]
    return {"clone_p90_ms": percentile(lat, 90)}


def request_flops(cfg, n_wav, text, n_mel, k1_shape, decoder_frames) -> float:
    syn, v = cfg["synthesizer"], cfg["vocoder"]
    partials = len(ref_enc.partial_slices(n_wav))
    T = len(ref_text.batch_ids([text])[0])
    padded = -(-n_mel // 64) * 64
    if syn["type"] == "tacotron":
        r = syn["r"]
        post = -(-decoder_frames // 128) * 128
        synth = flops.tacotron_generate(syn, 1, T, decoder_frames // r, r, post)
    else:
        synth = flops.forward_tacotron_generate(syn, 1, T, n_mel)
    return flops.encoder(cfg["encoder"], partials) + synth + flops.wavernn_generate(v, padded,
                                                                                    *k1_shape)


def release(run, st) -> dict:
    st["stop"].synth = st["stop"].base = None  # the program's model goes before the check
    system.uninstall()
    return {"W": st["W"], "served": st["served"]}


def items(run, record) -> list:
    """The greedy requests the check compares."""
    return checks.pick(run.seed, record["served"], int(run.traffic.get("check_requests", 2)),
                       lambda it: sum(len(t) for t in it.get("texts", [it.get("text", "")])))


def numbers(run, record, item, stages=checks.ALL) -> dict:
    if "frames" in item:
        return checks.clone_numbers(record["W"], run.config, item, stages)
    return checks.paragraph_numbers(record["W"], run.config, item, stages)


def control_item(run, record, item) -> dict:
    """The item served by the reference at TF32 in the program's place."""
    if "frames" in item:
        return checks.control_served(record["W"], run.config, item)
    return checks.control_paragraph(record["W"], run.config, item)


def faults(run) -> dict:
    return checks.faults(run.config)


def check(run, record) -> None:
    checks.report_worst(run, [numbers(run, record, it) for it in items(run, record)])
