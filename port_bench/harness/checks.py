"""The numbers that decide ``correct`` for the inference drivers: what the
timed path served for a greedy request, held to the plain reference.

Each stage is judged on the input the program's stage received, each
input having been judged itself: the embedding against the reference's own
from the prompt; the decoder teacher-forced on the program's frames (so an
error cannot compound through fed-back frames), its stop step, the postnet
on the program's frames; the vocoder's sample loop teacher-forced on the
program's samples and conditioned on the served mel (the widest gap by
which a served label's logit lies below the reference's best); the
waveform rebuilt from the program's fold samples.

``served`` is what the program produced; :func:`control_served` puts the
reference at TF32 (``Prec("tf32")``) in the program's place on the same
prompts and tokens, the comparison's control.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from port_bench.reference import encoder as ref_enc
from port_bench.reference import forward_tacotron as ref_ft
from port_bench.reference import tacotron as ref_taco
from port_bench.reference import text as ref_text
from port_bench.reference import wavernn as ref_voc
from port_bench.reference.nn import Prec

INF = 1e30  # a number that fails every limit (JSON has no infinity)
ALL = ("embed", "synth", "logit", "wave")  # the stages a check compares


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| over max |b| (inf where the shapes differ)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return INF
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-12))


def _t(x, dev):
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def vocoder_numbers(P: Prec, W, cfg: dict, mels: List[np.ndarray], samples: torch.Tensor,
                    waves: List[np.ndarray], labels=None, stages=ALL) -> Dict[str, float]:
    """The sample loop's logit gap over every fold of one launch (stage
    ``logit``) and the waveforms rebuilt from the fold samples (``wave``)."""
    v, sig = cfg["vocoder"], cfg["signal"]
    t, o = v["gen_target"], v["gen_overlap"]
    up, aux, folds = ref_voc.conditioning(P, W["vocoder"], v, mels, t, o, sig["max_abs_value"])
    out = {}
    if tuple(up.shape[:2]) != tuple(samples.shape):
        return {"logit_gap": INF, "wave_err": INF}
    if "logit" in stages:
        out["logit_gap"] = float(ref_voc.logit_gaps(P, W["vocoder"], v, up, aux, samples,
                                                    labels=labels).max())
    if "wave" in stages:
        err, at = 0.0, 0
        for m, n, wave in zip(mels, folds, waves):
            ref = ref_voc.waveform(samples[at:at + n], t, o, m.shape[1], sig["hop"], v["bits"],
                                   sig["preemphasis"])
            err = max(err, _rel(wave, ref))
            at += n
        out["wave_err"] = err
    return out


def clone_numbers(W, cfg: dict, item: dict, stages=ALL) -> Dict[str, float]:
    """One greedy clone (Tacotron): ``item`` holds ``prompt``, ``text`` and
    the served ``embed``, ``frames`` (1, n_mels, steps), ``stops`` (1,
    iterations), ``mel`` (n_mels, n), ``samples`` (folds, T), ``wave``.
    ``stages``: which of the embedding, the synthesizer (decoder, stop,
    postnet), the sample loop's logits and the waveform to compare."""
    P = Prec("f32")
    syn, sig = cfg["synthesizer"], cfg["signal"]
    dev = W["vocoder"]["I.weight"].device
    out = {}
    if "embed" in stages:
        out["embed_err"] = _rel(item["embed"], ref_enc.embed_utterance(P, W["encoder"],
                                                                         cfg["encoder"],
                                                                         item["prompt"]))
    if "synth" in stages:
        r = syn["r"]
        chars = torch.as_tensor(ref_text.batch_ids([item["text"]]), device=dev)
        emb = _t(item["embed"], dev)[None]
        frames = item["frames"].float()
        ref_frames, ref_stops = ref_taco.decode_teacher_forced(P, W["synthesizer"], syn, chars,
                                                               emb, frames, r)
        n_prog = ref_taco.stop_iterations(item["stops"], r) * r
        n_ref = ref_taco.stop_iterations(ref_stops, r) * r
        out["frames_mismatch"] = float(abs(n_prog - n_ref))
        n = min(n_prog, n_ref)
        out["decoder_err"] = _rel(frames[:, :, :n].cpu().numpy(),
                                  ref_frames[:, :, :n].cpu().numpy())
        ref_mel = ref_taco.served_mel(syn, frames[0], n_prog, P, W["synthesizer"],
                                      sig["max_abs_value"])
        out["postnet_err"] = _rel(item["mel"], ref_mel.cpu().numpy())
    out.update(vocoder_numbers(P, W, cfg, item.get("voc_mels", [item["mel"]]), item["samples"],
                               [item["wave"]], item.get("labels"), stages))
    return out


@torch.no_grad()
def control_served(W, cfg: dict, item: dict) -> dict:
    """The same request served by the reference at TF32: its embedding of
    the prompt; its decoder frames and stops teacher-forced on the program's
    frames; its postnet of the program's frames; its best label at every
    step of the sample loop teacher-forced on the program's samples. The
    waveform is the program's, and the vocoder's conditioning the program's
    mel (``voc_mels``)."""
    P = Prec("tf32")
    syn, sig, v = cfg["synthesizer"], cfg["signal"], cfg["vocoder"]
    dev = W["vocoder"]["I.weight"].device
    out = dict(item)
    out["voc_mels"] = item["mels"] if "mels" in item else [item["mel"]]
    out["embed"] = ref_enc.embed_utterance(P, W["encoder"], cfg["encoder"], item["prompt"])
    if "frames" in item:
        chars = torch.as_tensor(ref_text.batch_ids([item["text"]]), device=dev)
        frames, stops = ref_taco.decode_teacher_forced(P, W["synthesizer"], syn, chars,
                                                       _t(item["embed"], dev)[None],
                                                       item["frames"].float(), syn["r"])
        out["frames"], out["stops"] = frames, stops
        n = ref_taco.stop_iterations(item["stops"], syn["r"]) * syn["r"]
        out["mel"] = ref_taco.served_mel(syn, item["frames"][0].float(), n, P,
                                         W["synthesizer"], sig["max_abs_value"]).cpu().numpy()
    up, aux, _ = ref_voc.conditioning(P, W["vocoder"], v, out["voc_mels"], v["gen_target"],
                                      v["gen_overlap"], sig["max_abs_value"])
    _, best = ref_voc.logit_gaps(P, W["vocoder"], v, up, aux, item["samples"],
                                 return_argmax=True)
    out["labels"] = best
    return out


def paragraph_numbers(W, cfg: dict, item: dict, stages=ALL) -> Dict[str, float]:
    """One greedy paragraph (ForwardTacotron): ``item`` holds ``prompt``,
    ``texts`` and the served ``embed``, ``mels`` (one (n_mels, n_i) per
    sentence), ``durations`` (rows, T), ``samples`` (all folds, T),
    ``waves``. ``stages`` as in :func:`clone_numbers`."""
    P = Prec("f32")
    syn = cfg["synthesizer"]
    dev = W["vocoder"]["I.weight"].device
    out = {}
    if "embed" in stages:
        out["embed_err"] = _rel(item["embed"], ref_enc.embed_utterance(P, W["encoder"],
                                                                         cfg["encoder"],
                                                                         item["prompt"]))
    if "synth" in stages:
        chars = torch.as_tensor(ref_text.batch_ids(item["texts"]), device=dev)
        emb = _t(item["embed"], dev)[None].expand(len(item["texts"]), -1)
        mel, durs = ref_ft.generate(P, W["synthesizer"], syn, chars, emb)
        mel = mel.cpu().numpy()
        served_d = np.asarray(item["durations"])
        out["durations_mismatch"] = (float(np.sum(served_d != durs))
                                     if served_d.shape == durs.shape else INF)
        out["mel_err"] = max(_rel(m, mel[b, :, :max(int(durs[b].sum()), 1)])
                             for b, m in enumerate(item["mels"]))
    out.update(vocoder_numbers(P, W, cfg, item.get("voc_mels", item["mels"]), item["samples"],
                               item["waves"], item.get("labels"), stages))
    return out


@torch.no_grad()
def control_paragraph(W, cfg: dict, item: dict) -> dict:
    """The paragraph served by the reference at TF32 in the program's place
    (its embedding, its mels and durations from the served embedding, its
    best labels teacher-forced on the program's samples)."""
    P = Prec("tf32")
    syn = cfg["synthesizer"]
    dev = W["vocoder"]["I.weight"].device
    out = control_served(W, cfg, item)
    chars = torch.as_tensor(ref_text.batch_ids(item["texts"]), device=dev)
    emb = _t(item["embed"], dev)[None].expand(len(item["texts"]), -1)
    mel, durs = ref_ft.generate(P, W["synthesizer"], syn, chars, emb)
    mel = mel.cpu().numpy()
    out["durations"] = durs
    out["mels"] = [mel[b, :, :max(int(durs[b].sum()), 1)] for b in range(len(item["texts"]))]
    return out


def pick(seed: int, served: list, n: int, key) -> list:
    """The greedy requests the check compares: the longest by ``key``, and
    others drawn from the seed, ``n`` in all."""
    import random

    if not served:
        return []
    order = sorted(range(len(served)), key=lambda i: -key(served[i]))
    rest = order[1:]
    random.Random(seed).shuffle(rest)
    return [served[i] for i in [order[0]] + rest[:n - 1]]


def report_worst(run, numbers: list) -> None:
    """Each number's worst over the compared requests, beside its limit."""
    if not numbers:
        run.check("greedy_requests_compared", 0.0, -1.0)
        return
    for k in numbers[0]:
        run.check(k, max(n[k] for n in numbers))


# ---------------------------------------------------------------------------
# Planted faults: an answer altered where it is produced
# ---------------------------------------------------------------------------


def _alter_sample(samples: torch.Tensor, classes: int) -> torch.Tensor:
    """One fold's sample in the middle of the loop moved 64 labels away."""
    s = samples.clone()
    B, T = s.shape
    label = int(round((float(s[B // 2, T // 2]) + 1.0) * (classes - 1) / 2.0))
    label = label + 64 if label < classes // 2 else label - 64
    s[B // 2, T // 2] = 2.0 * label / (classes - 1) - 1.0
    return s


def faults(cfg: dict) -> dict:
    """name → (a function of a served item that alters one answer where the
    program produces it, the stages of the check it reaches): the embedding,
    a decoder frame, a stop token that fires early, the served mel, the
    durations, a sample of the loop, the waveform."""
    classes = 2 ** cfg["vocoder"]["bits"]

    def embed(it):
        e = np.array(it["embed"], np.float64)
        e[0] += 0.05
        return {**it, "embed": e / np.linalg.norm(e)}

    def frames(it):
        f = it["frames"].clone()
        f[0, 0, f.shape[2] // 3] += 0.5
        return {**it, "frames": f}

    def mel(it):
        if "mel" in it:
            m = np.array(it["mel"])
            m[0, m.shape[1] // 3] += 0.5
            return {**it, "mel": m, "voc_mels": [it["mel"]]}
        ms = [np.array(m) for m in it["mels"]]
        ms[0][0, ms[0].shape[1] // 3] += 0.5
        return {**it, "mels": ms, "voc_mels": it["mels"]}

    def durations(it):
        d = np.array(it["durations"])
        d[0, 0] += 1
        return {**it, "durations": d}

    def sample(it):
        return {**it, "samples": _alter_sample(it["samples"], classes)}

    def wave(it):
        if "wave" in it:
            w = np.array(it["wave"])
            w[len(w) // 2] += 0.1
            return {**it, "wave": w}
        ws = [np.array(w) for w in it["waves"]]
        ws[0][len(ws[0]) // 2] += 0.1
        return {**it, "waves": ws}

    def stop(it):
        s = it["stops"].clone()
        s[:, max(6, s.shape[1] // 2)] = 0.9  # fires half way (past frame 10)
        return {**it, "stops": s}

    out = {"embed": (embed, ("embed",)), "mel": (mel, ("synth",)),
           "sample": (sample, ("logit",)), "wave": (wave, ("wave",))}
    if cfg["synthesizer"]["type"] == "tacotron":
        out.update(frames=(frames, ("synth",)), stop=(stop, ("synth",)))
    else:
        out["durations"] = (durations, ("synth",))
    return out
