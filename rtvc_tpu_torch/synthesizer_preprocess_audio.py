"""The synthesizer's audio pass on one GPU:

    python -m rtvc_tpu_torch.synthesizer_preprocess_audio <datasets_root> \\
        [-o out_dir] [-n 4] [-s] [-d LibriTTS] [--device cuda]

Writes each utterance's trimmed wav and normalised mel (K6 once an
utterance on the card) and ``train.json`` (``data.synthesizer_preprocess.
synthesizer_preprocess_dataset``) under ``<datasets_root>/SV2TTS/
synthesizer`` unless ``-o`` names another directory. The arguments are
those of the JAX package's ``synthesizer_preprocess_audio.py`` (corpus
names from ``config/datasets.py:synthesizer_datasets``; ``-n`` threads),
plus ``--device`` (``cpu`` to rehearse without a card).
"""
from __future__ import annotations

import argparse
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("datasets_root", type=Path)
    parser.add_argument("-o", "--out_dir", type=Path, default=None)
    parser.add_argument("-n", "--n_processes", type=int, default=4,
                        help="Threads, each taking one speaker at a time.")
    parser.add_argument("-s", "--skip_existing", action="store_true")
    parser.add_argument("-d", "--datasets", type=str, default="LibriTTS",
                        help="Comma-separated corpus names (see synthesizer_datasets in "
                             "rtvc_tpu_torch/config/datasets.py).")
    parser.add_argument("--device", default="cuda", help="The torch device of the mels.")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    """Returns the number of utterances in ``train.json`` after the last
    corpus named."""
    from rtvc_tpu_torch.config.datasets import synthesizer_datasets
    from rtvc_tpu_torch.data.synthesizer_preprocess import synthesizer_preprocess_dataset

    args = parse_args(argv)
    out_dir = args.out_dir or args.datasets_root / "SV2TTS" / "synthesizer"
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for name in args.datasets.split(","):
        name = name.strip()
        if name not in synthesizer_datasets:
            print("Unknown dataset %r — known: %s" % (name, sorted(synthesizer_datasets)))
            continue
        spec = synthesizer_datasets[name]
        n = synthesizer_preprocess_dataset(
            args.datasets_root, out_dir, name, spec["directories"], spec["audio_extensions"],
            spec["transcript_extension"], n_processes=args.n_processes,
            skip_existing=args.skip_existing, device=args.device)
    return n


if __name__ == "__main__":
    main()
