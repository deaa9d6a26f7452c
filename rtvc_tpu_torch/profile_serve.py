"""Where a served ``/clone`` spends the time that the same clone in process
does not.

    python -m rtvc_tpu_torch.profile_serve

Installs the full-width seeded models of ``chip_smoke.py``'s serve phase
(encoder, Tacotron at its default ``max_decoder_steps``, runtimeracer
vocoder), warms them with ``vocoder.warmup`` and one clone, then times, five
times each, the clone of the 3 s prompt: in process on the main thread, on
a new thread each time and on one worker thread that takes every clone,
each with its stages' medians; and through ``serve.create_server`` on a
loopback port (its model thread warmed by ``warm_clone`` first), as the
client sees it and inside the handler's ``do_POST``, with the handler as it
is and with Nagle's algorithm off on its socket. Also times the wav codec on
one clone. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import http.client
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from rtvc_tpu_torch import serve
from rtvc_tpu_torch.inference import encoder, synthesizer, vocoder
from rtvc_tpu_torch.models import factories

TEXT = "The quick brown fox jumps over the lazy dog."
REPS = 5
STAGES = ("preprocess", "embed", "synthesize", "vocode")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def clone(synth, body):
    """The served clone's work in process: (wav, ms by stage)."""
    x, sr = serve._parse_wav(body)
    pre, t_pre = timed(lambda: encoder.preprocess_wav(x, source_sr=sr))
    embed, t_emb = timed(lambda: encoder.embed_utterance(pre))
    [mel], t_syn = timed(lambda: synth.synthesize_spectrograms([TEXT], [embed]))
    wav, t_voc = timed(lambda: vocoder.infer_waveform(mel))
    return wav, (t_pre, t_emb, t_syn, t_voc)


def in_threads(fn, reuse: bool):
    """REPS runs of ``fn`` (returning ms by stage), each on a new thread or
    all on one worker thread."""
    out = []
    runs = [lambda: out.extend(fn() for _ in range(REPS))] if reuse else \
        [lambda: out.append(fn()) for _ in range(REPS)]
    for run in runs:
        worker = threading.Thread(target=run)
        worker.start()
        worker.join()
    return out


def served(synth, body, nodelay: bool):
    """(client ms, handler ms) of REPS requests."""
    server = serve.create_server("127.0.0.1", 0, synth=synth)
    server.warm_clone()
    handler = server.RequestHandlerClass
    handler.disable_nagle_algorithm = nodelay
    inside = []
    do_post = handler.do_POST

    def timed_post(self):
        t0 = time.perf_counter()
        do_post(self)
        inside.append((time.perf_counter() - t0) * 1e3)

    handler.do_POST = timed_post
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    client = []
    try:
        for _ in range(REPS):
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
            t0 = time.perf_counter()
            conn.request("POST", "/clone?text=" + TEXT.replace(" ", "%20"), body=body)
            resp = conn.getresponse()
            data = resp.read()
            client.append((time.perf_counter() - t0) * 1e3)
            conn.close()
            if resp.status != 200:
                raise RuntimeError(f"/clone answered {resp.status}: {data[:200]}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    return client, inside


def line(name, ms):
    each = ", ".join(f"{t:.1f}" for t in ms)
    return f"{name}: median {float(np.median(ms)):.1f} ms ({each})"


def stage_line(name, runs):
    """Each run's total and the stages' medians."""
    split = np.median(np.array(runs), axis=0)
    return line(name, [sum(r) for r in runs]) + "; stage medians " + ", ".join(
        f"{s} {t:.1f}" for s, t in zip(STAGES, split))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    encoder.init_random_model(seed=0, device=dev)
    synth = synthesizer.Synthesizer()
    synth.load_bundle(factories.init_syn_model(factories.MODEL_TYPE_TACOTRON, seed=0,
                                               device=dev), r=2)
    vocoder.load_bundle(factories.init_voc_model(factories.MODEL_TYPE_RUNTIMERACER, seed=0,
                                                 device=dev))
    vocoder.warmup()
    body = serve._wav_bytes(serve.voiced_prompt(), 16000)
    wav, first = clone(synth, body)
    print(f"{card}: {len(wav)} samples a clone; the first clone {sum(first):.1f} ms")

    def run():
        return clone(synth, body)[1]

    print(f"{card}: " + stage_line("in process, main thread", [run() for _ in range(REPS)]))
    print(f"{card}: " + stage_line("in process, a new thread each", in_threads(run, False)))
    print(f"{card}: " + stage_line("in process, one worker thread", in_threads(run, True)))
    for nodelay in (False, True):
        client, inside = served(synth, body, nodelay)
        label = "Nagle off" if nodelay else "the handler as it is"
        print(f"{card}: served, {label}: " + line("client", client) + "; "
              + line("inside do_POST", inside))
    out, t_enc = timed(lambda: serve._wav_bytes(wav, 16000))
    _, t_dec = timed(lambda: serve._parse_wav(out))
    print(f"{card}: wav codec on one clone ({len(out)} bytes): _wav_bytes {t_enc:.2f} ms, "
          f"_parse_wav {t_dec:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
