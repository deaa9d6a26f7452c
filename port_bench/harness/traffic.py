"""The one traffic generator: a cell's traffic parameters (its traffic
file) and a seed → the requests of a run.

Every size a request takes (prompt seconds, characters of a text, sentences
of a paragraph) comes from a fixed pool of ``pool`` values, the quantiles
(i + ½) / pool of the parameter's distribution, in one fixed order (each
parameter by a permutation of its own, the same for every seed): every seed
gets the same sizes in the same order, so a window of a given length does
the same work whatever the seed. The seed draws only the prompts' voices and
noise and the texts' words. A run cycles through the pool. Every
``greedy_every``-th request is greedy (the program's sampling and dropout
off), and only those are compared with the reference.

Distributions: ``{"uniform": [a, b]}``, ``{"uniform_int": [a, b]}`` (both
ends included), ``{"lognormal": {"median": m, "sigma": s}}``,
``{"triangular": {"min": a, "mean": m, "max": b}}`` (the triangle whose
mode is 3m - a - b, the one distribution a corpus's published least, mean
and greatest length fix); each may add ``"clip": [a, b]``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import List

import numpy as np

ORDER_SEED = 20240  # the pool's one order, the same for every run

WORDS = (Path(__file__).resolve().parent.parent / "traffic" / "words.txt").read_text().split()


def quantiles(dist: dict, n: int) -> List[float]:
    """The pool of ``n`` values of a distribution, ascending."""
    qs = [(i + 0.5) / n for i in range(n)]
    if "uniform" in dist:
        a, b = dist["uniform"]
        vals = [a + q * (b - a) for q in qs]
    elif "uniform_int" in dist:
        a, b = dist["uniform_int"]
        vals = [float(a + min(int(q * (b - a + 1)), b - a)) for q in qs]
    elif "lognormal" in dist:
        p = dist["lognormal"]
        vals = [p["median"] * math.exp(p["sigma"] * NormalDist().inv_cdf(q)) for q in qs]
    elif "triangular" in dist:
        p = dist["triangular"]
        a, b = p["min"], p["max"]
        c = 3 * p["mean"] - a - b
        if not a <= c <= b:
            raise ValueError(f"no triangle has the mean of {dist}")
        cut = (c - a) / (b - a)
        vals = [a + math.sqrt(q * (b - a) * (c - a)) if q < cut
                else b - math.sqrt((1 - q) * (b - a) * (b - c)) for q in qs]
    else:
        raise ValueError(f"unknown distribution {dist}")
    if "clip" in dist:
        lo, hi = dist["clip"]
        vals = [min(max(v, lo), hi) for v in vals]
    return vals


def voiced_prompt(rng: np.random.Generator, seconds: float, f0: float,
                  sr: int = 16000) -> np.ndarray:
    """A voiced-sounding prompt: seven harmonics of a gliding f0 under a
    syllable envelope, with a little noise."""
    t = np.arange(int(seconds * sr)) / sr
    f = f0 + 15 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f) / sr
    voice = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * 3.1 * t + rng.uniform(0, 6)), 0, None) ** 0.5
    return (0.2 * voice * env + 0.003 * rng.standard_normal(t.size)).astype(np.float32)


def _word_of(rng: np.random.Generator, letters: int) -> str:
    pool = [w for w in WORDS if len(w) == letters]
    return pool[int(rng.integers(len(pool)))]


def sentence(rng: np.random.Generator, chars: int) -> str:
    """Words from the list, ``chars`` characters long exactly (the full stop
    included; at least 3), capitalised, with a comma now and then: the seed
    picks the words, never the length."""
    target = max(int(chars) - 1, 2)  # the characters before the full stop
    parts: List[str] = []
    n = 0
    while True:
        room = target - n - (1 if parts else 0)  # what the next word may take
        if room <= 7:
            parts.append(_word_of(rng, room))
            break
        w = WORDS[int(rng.integers(len(WORDS)))]
        if room - len(w) < 3:  # leave a space and a word of two letters at least
            w = _word_of(rng, min(7, room - 3))
        if len(parts) > 2 and room - len(w) >= 4 and rng.random() < 0.08:
            w += ","
        parts.append(w)
        n += len(w) + (1 if len(parts) > 1 else 0)
    text = " ".join(parts)
    return text[0].upper() + text[1:] + "."


@dataclass
class Request:
    index: int
    prompt: np.ndarray
    texts: List[str]
    greedy: bool
    seed: int


class Traffic:
    def __init__(self, params: dict, seed: int):
        self.p = params
        self.seed = seed
        self.pool = int(params.get("pool", 32))
        self._content = np.random.default_rng(np.random.SeedSequence(seed % (2 ** 63)))
        self.sizes = {}
        for n, key in enumerate(("prompt_seconds", "text_chars", "sentences")):
            if key in params:
                pool = quantiles(params[key], self.pool)
                order = np.random.default_rng(ORDER_SEED + n).permutation(self.pool)
                self.sizes[key] = [pool[i] for i in order]

    def all_sizes(self, key: str) -> List[float]:
        return sorted(self.sizes.get(key, []))

    def request(self, i: int) -> Request:
        """The i-th request of the run."""
        rng = self._content
        k = i % self.pool
        seconds = self.sizes["prompt_seconds"][k]
        f0 = float(rng.uniform(*self.p.get("f0_hz", [90.0, 210.0])))
        prompt = voiced_prompt(rng, seconds, f0)
        n_sent = int(self.sizes["sentences"][k]) if "sentences" in self.sizes else 1
        texts = []
        for j in range(n_sent):
            base = self.sizes["text_chars"][(k + 7 * j) % self.pool]
            texts.append(sentence(rng, int(round(base))))
        every = int(self.p.get("greedy_every", 0))
        greedy = bool(every) and i % every == every - 1
        return Request(i, prompt, texts, greedy, int(rng.integers(2 ** 31)))
