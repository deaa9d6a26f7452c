"""Normalize TED-LIUM v3 into the speakers layout (ref adapter:
scripts/tedlium.py).

TED-LIUM ships ``.sph`` audio + ``.stm`` transcripts per talk. This parses
the STM segments and emits per-segment ``.txt`` transcripts plus segment cut
lists; SPH decoding needs sox/ffmpeg, so when a matching pre-converted
``<talk>.wav`` exists the segments are cut directly, otherwise the exact
ffmpeg commands are printed.

The port's copy of ``scripts/tedlium.py``, run as ``python -m
rtvc_tpu_torch.scripts.tedlium``: its source but for the imports, which name
``rtvc_tpu_torch``.
"""
import argparse
from pathlib import Path

import numpy as np


def parse_stm(path: Path):
    """STM line: <talk> <channel> <speaker> <t0> <t1> <label> transcript"""
    segments = []
    for line in path.read_text(errors="ignore").splitlines():
        parts = line.split(None, 6)
        if len(parts) < 7 or parts[0].startswith(";;"):
            continue
        talk, _, speaker, t0, t1, _, text = parts
        text = text.replace("<unk>", "").strip()
        if not text or "ignore_time_segment" in text:
            continue
        segments.append((speaker, float(t0), float(t1), text))
    return segments


if __name__ == "__main__":
    from rtvc_tpu_torch.utils.io import load_wav, save_wav_float

    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("tedlium_root", type=Path,
                        help="TEDLIUM_release-3 directory (contains legacy/ or data/)")
    parser.add_argument("-o", "--out", type=Path, default=None)
    parser.add_argument("--sr", type=int, default=16000)
    args = parser.parse_args()

    out = args.out or args.tedlium_root / "speakers"
    stm_files = sorted(args.tedlium_root.glob("**/*.stm"))
    n = needs_ffmpeg = 0
    for stm in stm_files:
        segments = parse_stm(stm)
        if not segments:
            continue
        wav_path = stm.with_suffix(".wav")
        sph_path = stm.with_suffix(".sph")
        if not wav_path.exists():
            if sph_path.exists():
                print(f"ffmpeg -i '{sph_path}' -ar {args.sr} -ac 1 '{wav_path}'")
                needs_ffmpeg += 1
            continue
        wav, sr = load_wav(wav_path, target_sr=args.sr)
        speaker = segments[0][0].split("_")[0]
        spk_dir = out / speaker
        spk_dir.mkdir(parents=True, exist_ok=True)
        for i, (_, t0, t1, text) in enumerate(segments):
            seg = wav[int(t0 * sr) : int(t1 * sr)]
            if len(seg) < sr // 2:
                continue
            stem = f"{stm.stem}_{i:04d}"
            save_wav_float(seg.astype(np.float32), spk_dir / f"{stem}.wav", sr)
            (spk_dir / f"{stem}.txt").write_text(text)
            n += 1
    print("Wrote %d segments (%d talks need ffmpeg first) into %s"
          % (n, needs_ffmpeg, out))
