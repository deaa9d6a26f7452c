"""TED-LIUM v3: cut per-segment wavs + transcripts from sph/stm pairs into a
``speakers/<speaker>/`` layout (ref adapter: scripts/tedlium_transcript.py,
which shells out to sox; here the NIST sph is decoded in-process by the
native FFmpeg shim).

Layout: <root>/sph/*.sph + <root>/stm/*.stm → <out>/<speaker>/
``<talk>_<i:04d>.wav`` + ``.txt`` (speaker = talk stem up to the first '_',
like the reference).

The port's copy of ``scripts/tedlium_transcript.py``, run as ``python -m
rtvc_tpu_torch.scripts.tedlium_transcript``: its source but for the imports,
which name ``rtvc_tpu_torch``.
"""
import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from rtvc_tpu_torch.scripts.stm import parse_stm_file


def process_file(sph: Path, stm_dir: Path, out_dir: Path, sr: int) -> int:
    from rtvc_tpu_torch.utils.io import load_wav, save_wav_float

    stm_path = stm_dir / f"{sph.stem}.stm"
    if not stm_path.exists():
        print(f"No STM for {sph.name}, skipping")
        return 0
    segments = parse_stm_file(stm_path)
    if not segments:
        return 0

    speaker = sph.stem.split("_")[0]
    out_path = out_dir / speaker
    out_path.mkdir(parents=True, exist_ok=True)

    wav, wav_sr = load_wav(sph, target_sr=sr)
    n = 0
    for si, seg in enumerate(segments):
        stem = f"{sph.stem}_{si:04d}"
        txt = out_path / f"{stem}.txt"
        audio = out_path / f"{stem}.wav"
        transcript = seg.transcript.replace("<unk>", "").strip()
        if not txt.exists():
            txt.write_text(transcript, encoding="utf8")
        if not audio.exists():
            cut = wav[int(seg.start_time * wav_sr): int(seg.stop_time * wav_sr)]
            if len(cut):
                save_wav_float(cut.astype(np.float32), audio, wav_sr)
                n += 1
    return n


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Cut TED-LIUM v3 sph/stm into a speakers layout.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("datasets_root", type=Path,
                        help="Directory containing sph/ and stm/ subdirs")
    parser.add_argument("-o", "--out_dir", type=Path, default=None)
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("-t", "--threads", type=int, default=8)
    args = parser.parse_args()

    sph_dir = args.datasets_root / "sph"
    stm_dir = args.datasets_root / "stm"
    out_dir = args.out_dir or args.datasets_root / "speakers"

    files = sorted(f for f in sph_dir.glob("*.sph") if f.is_file())
    with ThreadPoolExecutor(args.threads) as pool:
        total = sum(
            pool.map(lambda f: process_file(f, stm_dir, out_dir, args.sr),
                     files)
        )
    print(f"Wrote {total} segments from {len(files)} talks into {out_dir}")
