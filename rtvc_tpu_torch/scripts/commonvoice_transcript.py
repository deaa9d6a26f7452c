"""CommonVoice → speakers layout with per-utterance transcripts AND audio
conversion mp3 → flac at a target rate (ref adapter:
scripts/commonvoice_transcript.py, which shells out to ffmpeg; here the
decode/encode runs in-process through the native FFmpeg shim).

Single language: pass the language dir with --lang. All languages: pass the
CommonVoice root and every subdir is processed.

Output: <out>/speakers/<client_id>/<clip>.flac + <clip>.txt.

The port's copy of ``scripts/commonvoice_transcript.py``, run as ``python -m
rtvc_tpu_torch.scripts.commonvoice_transcript``: its source but for the
imports, which name ``rtvc_tpu_torch``.
"""
import argparse
import csv
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def parse_speaker_data(lang_dir: Path, lang: str):
    """validated.tsv → {client_id: [row, ...]} (ref
    commonvoice_transcript.py:13-28)."""
    print(f"Reading validated.tsv for language {lang}...")
    speakers = {}
    with (lang_dir / "validated.tsv").open(newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            speakers.setdefault(row["client_id"], []).append(row)
    print(f"  - Found {len(speakers)} total speakers for language {lang}.")
    return speakers


def process_speaker(client_id, rows, clips_dir: Path, out_dir: Path,
                    audio_rate: int) -> int:
    from rtvc_tpu_torch.utils.io import load_wav, save_audio

    dest = out_dir / "speakers" / client_id
    dest.mkdir(parents=True, exist_ok=True)
    n = 0
    for row in rows:
        stem = Path(row["path"]).stem
        txt = dest / f"{stem}.txt"
        if not txt.exists():
            txt.write_text(row["sentence"], encoding="utf8")
        flac = dest / f"{stem}.flac"
        if flac.exists():
            continue
        src = clips_dir / row["path"]
        if not src.exists():
            continue
        wav, sr = load_wav(src, target_sr=audio_rate)
        save_audio(wav, flac, sr)
        n += 1
    return n


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Process CommonVoice dataset(s) into a speakers layout.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("datasets_root", type=Path,
                        help="CommonVoice root (or a language dir with --lang)")
    parser.add_argument("-o", "--out_dir", type=Path, default=None)
    parser.add_argument("-ar", "--audio_rate", type=int, default=16000)
    parser.add_argument("--lang", type=str, default=None,
                        help="Single language to process")
    parser.add_argument("-t", "--threads", type=int, default=8)
    args = parser.parse_args()

    if args.lang is not None:
        lang_dirs = [(args.datasets_root / args.lang, args.lang)]
    else:
        lang_dirs = [
            (d, d.name) for d in sorted(args.datasets_root.iterdir())
            if d.is_dir() and (d / "validated.tsv").exists()
        ]

    total_utts = total_speakers = 0
    for lang_dir, lang in lang_dirs:
        speakers = parse_speaker_data(lang_dir, lang)
        clips_dir = lang_dir / "clips"
        out_dir = args.out_dir or lang_dir
        with ThreadPoolExecutor(args.threads) as pool:
            counts = pool.map(
                lambda item: process_speaker(
                    item[0], item[1], clips_dir, out_dir, args.audio_rate
                ),
                sorted(speakers.items()),
            )
            total_utts += sum(counts)
        total_speakers += len(speakers)
    print(
        f"Converted {total_utts} utterances across {total_speakers} speakers "
        f"in {len(lang_dirs)} language(s)."
    )
