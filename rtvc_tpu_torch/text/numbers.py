"""Number → words expansion for English text normalization.

Behavior-compatible rebuild of the reference's inflect-based pipeline (ref:
synthesizer/utils/numbers.py) without the inflect dependency: comma/currency/
decimal/ordinal/cardinal handling, the year-style two-digit grouping for
1000 < n < 3000, and inflect's comma placement between thousand-groups.

This package's own copy of ``rtvc_tpu/text/numbers.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10**15, "quadrillion"),
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    return _TENS[tens] + ("-" + _UNITS[unit] if unit else "")


def _three_digits(n: int, andword: str) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_UNITS[hundreds] + " hundred")
    if rest:
        if hundreds and andword:
            parts.append(andword)
        parts.append(_two_digits(rest))
    return " ".join(parts)


def number_to_words(
    n: int, andword: str = "and", zero: str = "zero", group: int = 0
) -> str:
    """Cardinal words with inflect-compatible output shape: thousand-groups
    joined by ", "; ``group=2`` renders digit pairs (year style)."""
    if n == 0:
        return zero
    if group == 2:
        digits = str(n)
        if len(digits) % 2 == 1:
            digits = "0" + digits
        pairs = [digits[i : i + 2] for i in range(0, len(digits), 2)]
        words = []
        for p in pairs:
            v = int(p)
            if v == 0:
                words.append(f"{zero} {zero}")
            elif v < 10 and p[0] == "0":
                words.append(f"{zero} {_UNITS[v]}")
            else:
                words.append(_two_digits(v))
        return ", ".join(words)

    groups = []
    remaining = n
    for scale_value, scale_name in _SCALES:
        count, remaining = divmod(remaining, scale_value)
        if count:
            # the top group can itself exceed 999 for numbers beyond the
            # scales table (e.g. 10^18): recurse like inflect does rather
            # than index out of the units table
            count_words = (
                number_to_words(count, andword)
                if count >= 1000 else _three_digits(count, andword)
            )
            groups.append(count_words + " " + scale_name)
    if remaining:
        groups.append(_three_digits(remaining, andword))
    return ", ".join(groups)


def ordinalize_words(words: str) -> str:
    """'twenty-one' → 'twenty-first', 'thirty' → 'thirtieth', 'one hundred' →
    'one hundredth'."""
    tokens = words.split(" ")
    last = tokens[-1]
    hyphen_parts = last.split("-")
    tail = hyphen_parts[-1]
    if tail in _ORDINAL_IRREGULAR:
        tail = _ORDINAL_IRREGULAR[tail]
    elif tail.endswith("y"):
        tail = tail[:-1] + "ieth"
    else:
        tail = tail + "th"
    hyphen_parts[-1] = tail
    tokens[-1] = "-".join(hyphen_parts)
    return " ".join(tokens)


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(",", "")


def _expand_decimal_point(m: re.Match) -> str:
    return m.group(1).replace(".", " point ")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"  # unexpected format
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return "%s %s, %s %s" % (dollars, dollar_unit, cents, cent_unit)
    elif dollars:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        return "%s %s" % (dollars, dollar_unit)
    elif cents:
        cent_unit = "cent" if cents == 1 else "cents"
        return "%s %s" % (cents, cent_unit)
    return "zero dollars"


def _expand_ordinal(m: re.Match) -> str:
    n = int(re.sub(r"[^0-9]", "", m.group(0)))
    return ordinalize_words(number_to_words(n, andword=""))


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        elif 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100, andword="")
        elif num % 100 == 0:
            return number_to_words(num // 100, andword="") + " hundred"
        else:
            return number_to_words(num, andword="", zero="oh", group=2).replace(
                ", ", " "
            )
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
