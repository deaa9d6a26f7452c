"""Speaker-encoder preprocessing of named datasets:

    python -m rtvc_tpu_torch.encoder_preprocess <datasets_root> [-o out_dir] \\
        [-d librispeech_other,voxceleb1,voxceleb2] [-s] [-t 4] [--device cuda]

Writes one ``combined.npz`` and ``_sources.txt`` a speaker and
``Log_<dataset>.txt`` a dataset (``data.encoder_preprocess``) under
``<datasets_root>/SV2TTS/encoder`` unless ``-o`` names another directory:
the input of ``encoder_train``. The arguments are those of the JAX
package's ``encoder_preprocess.py``, dataset names included
(``config/datasets.py``). The pass runs on the host (the encoder frontend
launches no kernel), so unlike the synthesizer's audio and embedding
passes it takes no ``--device`` and needs no card.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List


def dataset_paths() -> Dict[str, List[str]]:
    """Each ``--datasets`` name → its corpus paths under the datasets root."""
    from rtvc_tpu_torch.config import datasets as registry

    return {
        "librispeech_clean": registry.librispeech_datasets["train"]["clean"],
        "librispeech_other": registry.librispeech_datasets["train"]["other"],
        "libritts_clean": registry.libritts_datasets["train"]["clean"],
        "libritts_other": registry.libritts_datasets["train"]["other"],
        "voxceleb1": registry.voxceleb_datasets["voxceleb1"]["train"],
        "voxceleb2": registry.voxceleb_datasets["voxceleb2"]["train"],
        "vctk": registry.other_datasets["VCTK"],
        "nasjonalbank": registry.other_datasets["nasjonalbank"],
        **registry.slr_datasets_wav,
        **registry.slr_datasets_flac,
        "commonvoice-7-all": registry.commonvoice_datasets["commonvoice-7"]["all"],
        "commonvoice-7-en": registry.commonvoice_datasets["commonvoice-7"]["en"],
    }


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Preprocesses audio files from datasets into mel spectrograms for "
                    "speaker-encoder training.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("datasets_root", type=Path)
    parser.add_argument("-o", "--out_dir", type=Path, default=None)
    parser.add_argument("-d", "--datasets", type=str,
                        default="librispeech_other,voxceleb1,voxceleb2",
                        help="Comma-separated list of dataset names (see "
                             "rtvc_tpu_torch/config/datasets.py).")
    parser.add_argument("-s", "--skip_existing", action="store_true")
    parser.add_argument("-t", "--threads", type=int, default=4)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    """Returns the number of utterances kept over every dataset named."""
    from rtvc_tpu_torch.data.encoder_preprocess import encoder_preprocess_dataset

    args = parse_args(argv)
    out_dir = args.out_dir or args.datasets_root / "SV2TTS" / "encoder"
    out_dir.mkdir(parents=True, exist_ok=True)
    name_map = dataset_paths()
    kept = 0
    for name in args.datasets.split(","):
        name = name.strip()
        if name not in name_map:
            print("Unknown dataset %r — known: %s" % (name, sorted(name_map)))
            continue
        kept += encoder_preprocess_dataset(args.datasets_root, out_dir, name_map[name], name,
                                           skip_existing=args.skip_existing,
                                           n_threads=args.threads)
    return kept


if __name__ == "__main__":
    main()
