"""Multilingual TEDx: cut per-cue utterances from flac/wav talks using their
WebVTT caption timings, one speaker per talk (ref adapter:
scripts/tedx_speakers.py, which uses the webvtt + sox packages; here the VTT
cues are parsed directly and audio is cut in-process).

Layout: <root>/wav/*.flac|*.wav + <root>/vtt/<talk>*.vtt →
<out>/<talk>/<talk>_<i:04d>.wav.

The port's copy of ``scripts/tedx_speakers.py``, run as ``python -m
rtvc_tpu_torch.scripts.tedx_speakers``: its source but for the imports,
which name ``rtvc_tpu_torch``.
"""
import argparse
import random
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_TS = re.compile(
    r"(?:(\d+):)?(\d{2}):(\d{2})[.,](\d{3})\s*-->\s*(?:(\d+):)?(\d{2}):(\d{2})[.,](\d{3})"
)


def parse_vtt(path: Path):
    """Minimal WebVTT cue parser → list of (start_s, end_s, text)."""
    cues = []
    text_lines = []
    start = end = None

    def flush():
        nonlocal start, end, text_lines
        if start is not None:
            cues.append((start, end, " ".join(text_lines).strip()))
        start = end = None
        text_lines = []

    for raw in path.read_text(encoding="utf8", errors="ignore").splitlines():
        line = raw.strip()
        m = _TS.search(line)
        if m:
            flush()
            h1, m1, s1, ms1, h2, m2, s2, ms2 = m.groups()
            start = (int(h1 or 0) * 3600 + int(m1) * 60 + int(s1)
                     + int(ms1) / 1000.0)
            end = (int(h2 or 0) * 3600 + int(m2) * 60 + int(s2)
                   + int(ms2) / 1000.0)
        elif not line:
            flush()
        elif start is not None and not line.startswith(("WEBVTT", "NOTE")):
            text_lines.append(line)
    flush()
    return cues


def process_file(file: Path, vtt_dir: Path, out_dir: Path,
                 min_files: int, max_files: int, seed: int) -> int:
    from rtvc_tpu_torch.utils.io import load_wav, save_wav_float

    matches = sorted(vtt_dir.glob(f"{file.stem}*.vtt"))
    if not matches:
        print(f"No VTT for {file.name}, skipping")
        return 0
    cues = parse_vtt(matches[0])
    if len(cues) < min_files:
        print(f"Skipping speaker {file.stem}: too few recordings")
        return 0
    if len(cues) > max_files:
        rng = random.Random(seed)
        rng.shuffle(cues)
        cues = cues[:max_files]

    out_path = out_dir / file.stem
    out_path.mkdir(parents=True, exist_ok=True)
    wav, sr = load_wav(file)
    n = 0
    for si, (t0, t1, text) in enumerate(cues):
        out_file = out_path / f"{file.stem}_{si:04d}.wav"
        if out_file.exists():
            continue
        cut = wav[int(t0 * sr): int(t1 * sr)]
        if not len(cut):
            continue
        save_wav_float(cut.astype(np.float32), out_file, sr)
        if text:
            out_file.with_suffix(".txt").write_text(text, encoding="utf8")
        n += 1
    return n


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Process Multilingual TEDx into a speakers layout.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("datasets_root", type=Path,
                        help="Directory containing wav/ and vtt/ subdirs")
    parser.add_argument("-o", "--out_dir", type=Path, default=None)
    parser.add_argument("--min", type=int, default=5,
                        help="Minimum number of files per speaker")
    parser.add_argument("--max", type=int, default=40,
                        help="Maximum number of files per speaker")
    parser.add_argument("-t", "--threads", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    wav_dir = args.datasets_root / "wav"
    vtt_dir = args.datasets_root / "vtt"
    out_dir = args.out_dir or args.datasets_root / "speakers"

    files = sorted(
        f for f in list(wav_dir.glob("*.flac")) + list(wav_dir.glob("*.wav"))
        if f.is_file()
    )
    with ThreadPoolExecutor(args.threads) as pool:
        total = sum(
            pool.map(
                lambda f: process_file(f, vtt_dir, out_dir, args.min,
                                       args.max, args.seed),
                files,
            )
        )
    print(f"Wrote {total} utterances from {len(files)} talks into {out_dir}")
