"""The traffic generator repeats by seed, and gives every seed the same
sizes in the same order."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from port_bench.harness.traffic import Traffic, quantiles, sentence

MIXES = sorted(p.stem for p in (Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))


def params(name):
    path = Path(__file__).resolve().parents[1] / "traffic" / f"{name}.json"
    return json.loads(path.read_text())["params"]


@pytest.mark.parametrize("name", [m for m in MIXES if "prompt_seconds" in params(m)])
def test_repeats_by_seed(name):
    a, b = Traffic(params(name), 2 ** 31 + 5), Traffic(params(name), 2 ** 31 + 5)
    for i in range(6):
        ra, rb = a.request(i), b.request(i)
        assert ra.texts == rb.texts and ra.greedy == rb.greedy and ra.seed == rb.seed
        np.testing.assert_array_equal(ra.prompt, rb.prompt)
    c = Traffic(params(name), 2 ** 31 + 6)
    assert [c.request(i).texts for i in range(3)] != [Traffic(params(name), 2 ** 31 + 5)
                                                      .request(i).texts for i in range(3)]


@pytest.mark.parametrize("name", [m for m in MIXES if "prompt_seconds" in params(m)])
def test_same_sizes_every_seed(name):
    """The same sizes in the same order: a window of a given length does the
    same work whatever the seed; the order still mixes short and long."""
    sizes = [Traffic(params(name), s).sizes for s in (1, 7, 2 ** 31 + 9)]
    assert sizes[0] == sizes[1] == sizes[2]
    for key, pool in sizes[0].items():
        if len(set(pool)) > 1:
            assert pool != sorted(pool) and pool != sorted(pool, reverse=True), key


@pytest.mark.parametrize("name", [m for m in MIXES if "prompt_seconds" in params(m)])
def test_texts_and_prompts_in_range(name):
    p = params(name)
    t = Traffic(p, 11)
    chars, secs = t.all_sizes("text_chars"), t.all_sizes("prompt_seconds")
    for i in range(2 * t.pool):
        r = t.request(i)
        assert all(round(chars[0]) <= len(x) <= round(chars[-1]) for x in r.texts)
        assert secs[0] - 1 / 16000 <= len(r.prompt) / 16000 <= secs[-1]
        assert r.greedy == (i % p["greedy_every"] == p["greedy_every"] - 1)


@pytest.mark.parametrize("name", [m for m in MIXES if "prompt_seconds" in params(m)])
def test_same_lengths_every_seed(name):
    """Seeds pick other words and voices, never other lengths."""
    a, b = Traffic(params(name), 3), Traffic(params(name), 2 ** 31 + 3)
    for i in range(a.pool):
        ra, rb = a.request(i), b.request(i)
        assert [len(t) for t in ra.texts] == [len(t) for t in rb.texts]
        assert len(ra.prompt) == len(rb.prompt) and ra.texts != rb.texts


def test_sentence_length_is_exact():
    rng = np.random.default_rng(4)
    for chars in list(range(3, 40)) + [99, 154]:
        for _ in range(20):
            text = sentence(rng, chars)
            assert len(text) == chars and text.endswith(".") and "  " not in text, text


def test_quantiles():
    assert quantiles({"uniform_int": [3, 8]}, 6) == [3, 4, 5, 6, 7, 8]
    q = quantiles({"lognormal": {"median": 60, "sigma": 0.6}, "clip": [20, 160]}, 5)
    assert q[2] == pytest.approx(60) and q[0] >= 20 and q[-1] <= 160
    # the triangle fixed by a least, a mean and a greatest: mode 3 * 6 - 1 - 10 = 7
    q = quantiles({"triangular": {"min": 1.0, "mean": 6.0, "max": 10.0}}, 2000)
    assert np.mean(q) == pytest.approx(6.0, abs=1e-3) and 1.0 < q[0] < q[-1] < 10.0
    # mode 3 * 1 - 0 - 3 = 0: the quartiles 3 - sqrt(0.75 * 9) and 3 - sqrt(0.25 * 9)
    assert quantiles({"triangular": {"min": 0.0, "mean": 1.0, "max": 3.0}}, 2) == \
        pytest.approx([3 - 6.75 ** 0.5, 1.5])
    with pytest.raises(ValueError):
        quantiles({"triangular": {"min": 0.0, "mean": 2.9, "max": 3.0}}, 4)
