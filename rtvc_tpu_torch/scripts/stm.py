"""NIST STM transcript parser (ref: scripts/stm.py — same public API:
``STMSegment`` + ``parse_stm_file``), used by the TED-LIUM adapters.

STM line: <filename> <channel> <speaker_id> <start> <stop> <labels> <text...>
Transcripts are NFKD-normalized and reduced to ASCII like the reference.

The port's copy of ``scripts/stm.py``: its source but for the imports, which
name ``rtvc_tpu_torch``.
"""
from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import List


class STMSegment:
    """One STM segment (ref: scripts/stm.py:4-51)."""

    def __init__(self, stm_line: str):
        tokens = stm_line.split()
        self.filename = tokens[0]
        self.channel = tokens[1]
        self.speaker_id = tokens[2]
        self.start_time = float(tokens[3])
        self.stop_time = float(tokens[4])
        self.labels = tokens[5]
        transcript = " ".join(tokens[6:])
        self.transcript = (
            unicodedata.normalize("NFKD", transcript.strip())
            .encode("ascii", "ignore")
            .decode("ascii", "ignore")
        )


def parse_stm_file(stm_file) -> List[STMSegment]:
    """Parse ``stm_file`` into segments, dropping unscored ones
    (ref: scripts/stm.py:53-63)."""
    segments: List[STMSegment] = []
    for line in Path(stm_file).read_text(encoding="utf-8",
                                         errors="ignore").splitlines():
        if not line.strip() or line.startswith(";;"):
            continue
        seg = STMSegment(line)
        if seg.transcript != "ignore_time_segment_in_scoring":
            segments.append(seg)
    return segments
