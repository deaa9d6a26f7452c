"""Normalize TIMIT into the speakers layout (ref adapter: scripts/timit.py).

TIMIT ships ``TRAIN/DR<region>/<speaker>/<utt>.{WAV,TXT}`` where .WAV is
NIST SPHERE with a 1024-byte header and .TXT lines are
"<start> <end> transcript". Emits ``<out>/speakers/<speaker>/<utt>.{wav,txt}``.

The port's copy of ``scripts/timit.py``, run as ``python -m
rtvc_tpu_torch.scripts.timit``: its source but for the imports, which name
``rtvc_tpu_torch``.
"""
import argparse
import struct
from pathlib import Path

import numpy as np

from rtvc_tpu_torch.utils.io import save_wav_float


def read_sphere(path: Path):
    """Minimal NIST SPHERE reader (16-bit PCM)."""
    raw = path.read_bytes()
    if raw[:7] != b"NIST_1A":
        return None, None
    header = raw[:1024].decode("ascii", errors="ignore")
    sr = 16000
    for line in header.splitlines():
        if line.startswith("sample_rate"):
            sr = int(line.split()[-1])
    data = np.frombuffer(raw[1024:], dtype="<i2").astype(np.float32) / 32768.0
    return data, sr


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("timit_root", type=Path, help="TIMIT directory (has TRAIN/)")
    parser.add_argument("-o", "--out", type=Path, default=None)
    args = parser.parse_args()

    out = args.out or args.timit_root / "speakers"
    n = 0
    for wav_path in sorted(args.timit_root.glob("TRAIN/**/*.WAV")) + sorted(
        args.timit_root.glob("TRAIN/**/*.wav")
    ):
        txt_path = wav_path.with_suffix(".TXT")
        if not txt_path.exists():
            txt_path = wav_path.with_suffix(".txt")
            if not txt_path.exists():
                continue
        wav, sr = read_sphere(wav_path)
        if wav is None:
            continue
        # TXT format: "<start_sample> <end_sample> transcript"
        parts = txt_path.read_text().strip().split(None, 2)
        text = parts[2] if len(parts) == 3 else " ".join(parts)
        speaker = wav_path.parent.name
        spk_dir = out / speaker
        spk_dir.mkdir(parents=True, exist_ok=True)
        stem = wav_path.stem
        save_wav_float(wav, spk_dir / f"{stem}.wav", sr)
        (spk_dir / f"{stem}.txt").write_text(text)
        n += 1
    print("Wrote %d utterances into %s" % (n, out))
