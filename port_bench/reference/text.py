"""Text to character ids, as the fork's synthesizers read them: the symbol
set (pad, EOS, ASCII letters, punctuation and space), the English cleaner's
effect on text of plain lowercase words (lowercase, whitespace collapsed),
an EOS id at the end, and a batch padded with 0 to a multiple of 32.

The benchmark's texts hold letters, spaces, commas and full stops only, so
the cleaner's number, abbreviation and transliteration rules never apply;
:func:`ids` refuses any other character rather than guess.
"""
from __future__ import annotations

import re
from typing import List

import numpy as np

SYMBOLS = ["_", "~"] + list("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz") \
    + list("!'\"(),-.:;? ")
_ID = {s: i for i, s in enumerate(SYMBOLS)}
CHAR_BUCKET = 32


def ids(text: str) -> List[int]:
    if not re.fullmatch(r"[A-Za-z ,.]*", text):
        raise ValueError(f"text outside the benchmark's alphabet: {text!r}")
    text = re.sub(r"\s+", " ", text.strip().lower())
    return [_ID[ch] for ch in text] + [_ID["~"]]


def batch_ids(texts: List[str]) -> np.ndarray:
    seqs = [ids(t) for t in texts]
    n = -(-max(len(s) for s in seqs) // CHAR_BUCKET) * CHAR_BUCKET
    return np.stack([np.pad(s, (0, n - len(s))) for s in seqs]).astype(np.int64)
