"""Text cleaners (ref: synthesizer/utils/cleaners.py).

ASCII transliteration is a dependency-free rebuild of unidecode's common path:
NFKD decomposition + combining-mark strip, plus a table for the frequent
non-decomposable Latin letters.

This package's own copy of ``rtvc_tpu/text/cleaners.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import re
import unicodedata

from rtvc_tpu_torch.text.numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile("\\b%s\\." % x[0], re.IGNORECASE), x[1])
    for x in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
        ("mk", "mark"),
        ("jan", "january"),
        ("feb", "february"),
        ("mar", "march"),
        ("apr", "april"),
        ("aug", "august"),
        ("sept", "september"),
        ("oct", "october"),
        ("nov", "november"),
        ("dec", "december"),
    ]
]

# Non-decomposable Latin characters NFKD cannot reduce.
_TRANSLIT = {
    "ß": "ss", "æ": "ae", "Æ": "AE", "ø": "o", "Ø": "O", "œ": "oe",
    "Œ": "OE", "ð": "d", "Ð": "D", "þ": "th", "Þ": "Th", "ł": "l",
    "Ł": "L", "đ": "d", "Đ": "D", "ħ": "h", "Ħ": "H", "ı": "i",
    "ĸ": "k", "ŋ": "ng", "Ŋ": "NG", "ŧ": "t", "Ŧ": "T",
    "«": '"', "»": '"', "“": '"', "”": '"', "‘": "'", "’": "'",
    "—": "-", "–": "-", "…": "...", "¡": "!", "¿": "?",
}


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def no_cleaners(text: str) -> str:
    return text


def convert_to_ascii(text: str) -> str:
    text = "".join(_TRANSLIT.get(c, c) for c in text)
    decomposed = unicodedata.normalize("NFKD", text)
    return decomposed.encode("ascii", "ignore").decode("ascii")


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration for non-English text."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    """Full English pipeline: ASCII → lowercase → numbers → abbreviations →
    whitespace."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


class Cleaner:
    """Configured cleaner object (ref: cleaners.py:119-153)."""

    def __init__(self, cleaner_name: str, use_phonemes: bool = False, lang: str = "en-us"):
        if cleaner_name == "english_cleaners":
            self.clean_func = english_cleaners
        elif cleaner_name == "no_cleaners":
            self.clean_func = no_cleaners
        else:
            raise ValueError(
                f"Cleaner not supported: {cleaner_name}! "
                f"Currently supported: ['english_cleaners', 'no_cleaners']"
            )
        self.use_phonemes = use_phonemes
        self.lang = lang

    def __call__(self, text: str) -> str:
        text = self.clean_func(text)
        text = collapse_whitespace(text)
        return text.strip()
