"""The lengths the inference drivers' warm-up covers."""
from __future__ import annotations

from port_bench.reference import text as ref_text


def bucket_lengths(traffic) -> list:
    """A text length inside each 32-character bucket (EOS included) that the
    pool's texts fall in (a text of a pool size n holds n characters)."""
    b = ref_text.CHAR_BUCKET
    used = {-(-(max(int(round(n)), 3) + 1) // b) for n in traffic.all_sizes("text_chars")}
    return [b * k - 2 for k in sorted(used)]


def prompt_lengths(traffic) -> list:
    """Prompt lengths every half second from 1 s to the longest the pool
    holds: every count of partials a trimmed prompt can give."""
    top = traffic.all_sizes("prompt_seconds")[-1]
    return [1.0 + 0.5 * k for k in range(int((top - 1.0) / 0.5) + 2)]
