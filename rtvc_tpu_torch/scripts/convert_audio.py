"""Batch audio conversion/resampling to 16 kHz mono WAV (ref helper:
scripts/convert.sh, which shells out to ffmpeg).

All inputs decode in-process: WAV via scipy, mp3 via libmpg123, everything
else (flac/m4a/ogg/opus/NIST sph) through the native FFmpeg shim
(rtvc_tpu_torch.utils.libav). If a decoder is genuinely unavailable the script
prints the exact ffmpeg command lines to run elsewhere instead of failing
silently.

The port's copy of ``scripts/convert_audio.py``, run as ``python -m
rtvc_tpu_torch.scripts.convert_audio``: its source but for the imports,
which name ``rtvc_tpu_torch``.
"""
import argparse
from pathlib import Path

import numpy as np

from rtvc_tpu_torch.ops.resample import resample
from rtvc_tpu_torch.utils.io import UnsupportedAudioFormat, load_wav, save_wav_float

if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("root", type=Path)
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--suffix", type=str, default=".wav")
    parser.add_argument("--out_suffix", type=str, default=".16k.wav")
    args = parser.parse_args()

    n = skipped = 0
    for f in sorted(args.root.glob(f"**/*{args.suffix}")):
        out = f.with_suffix(args.out_suffix)
        if out.exists():
            continue
        try:
            wav, sr = load_wav(f, target_sr=args.sr)
            save_wav_float(wav, out, args.sr)
            n += 1
        except UnsupportedAudioFormat:
            print(f"# no decoder here — run elsewhere:")
            print(f"ffmpeg -i '{f}' -ar {args.sr} -ac 1 '{out}'")
            skipped += 1
    print("Converted %d files (%d need ffmpeg) under %s" % (n, skipped, args.root))
