"""Text frontend: symbols, cleaners, number expansion, sequence codec
(ref: synthesizer/utils/{symbols,cleaners,numbers,text}.py).

This package's own copy of ``rtvc_tpu/text/__init__.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import re
from typing import List, Sequence

from rtvc_tpu_torch.text import cleaners as _cleaners
from rtvc_tpu_torch.text.symbols import silent_phonemes_indices, symbols

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}

# Text in curly braces is treated as ARPAbet (ref: text.py:10-11).
_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def text_to_sequence(text: str, cleaner_names: Sequence[str]) -> List[int]:
    """Text → symbol-ID list, EOS-terminated (ref: text.py:23-50)."""
    sequence: List[int] = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)
    sequence.append(_symbol_to_id["~"])
    return sequence


def sequence_to_text(sequence: Sequence[int]) -> str:
    """Symbol-ID list → text (ref: text.py:53-65)."""
    result = ""
    for symbol_id in sequence:
        if symbol_id in _id_to_symbol:
            s = _id_to_symbol[symbol_id]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            result += s
    return result.replace("}{", " ")


def _clean_text(text: str, cleaner_names: Sequence[str]) -> str:
    for name in cleaner_names:
        cleaner = getattr(_cleaners, name, None)
        if cleaner is None:
            raise Exception("Unknown cleaner: %s" % name)
        text = cleaner(text)
    return text


def _symbols_to_sequence(syms: Sequence[str]) -> List[int]:
    return [_symbol_to_id[s] for s in syms if _should_keep_symbol(s)]


def _arpabet_to_sequence(text: str) -> List[int]:
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep_symbol(s: str) -> bool:
    return s in _symbol_to_id and s not in ("_", "~")


__all__ = [
    "symbols",
    "silent_phonemes_indices",
    "text_to_sequence",
    "sequence_to_text",
]
