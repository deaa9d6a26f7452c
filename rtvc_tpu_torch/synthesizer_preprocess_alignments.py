"""The alignment pass on one GPU, or split over several (one process per
card, each aligning every N-th utterance):

    python -m rtvc_tpu_torch.synthesizer_preprocess_alignments <synthesizer_root> \\
        -m <tacotron checkpoint> [-s] [--device cuda]
        [--coordinator HOST:PORT --num_processes N --process_id K]

Writes each utterance's durations, attention and alignment scores, and pitch
and energy per character (``data.synthesizer_preprocess.
create_align_features``) from a trained Tacotron in any checkpoint format
``train.checkpoints.read_model`` reads: the inputs of ``synthesizer_train
forward-tacotron | fast-pitch``. The arguments are those of the JAX
package's ``synthesizer_preprocess_alignments.py``, plus ``--device``
(``cpu`` to rehearse without a card).
"""
from __future__ import annotations

import argparse
from pathlib import Path

from rtvc_tpu_torch.parallel import distributed


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("synthesizer_root", type=Path)
    parser.add_argument("-m", "--synthesizer_model_fpath", type=Path,
                        default=Path("saved_models/default/synthesizer.pt"),
                        help="Trained Tacotron checkpoint used for attention extraction.")
    parser.add_argument("-s", "--skip_existing", action="store_true")
    parser.add_argument("--device", default="cuda", help="The torch device to align on.")
    distributed.add_launch_args(parser)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    from rtvc_tpu_torch.data.synthesizer_preprocess import create_align_features

    args = parse_args(argv)
    distributed.setup_from_args(args)  # splits the utterances by process
    return create_align_features(args.synthesizer_root, args.synthesizer_model_fpath,
                                 skip_existing=args.skip_existing,
                                 device=distributed.process_device(args.device))


if __name__ == "__main__":
    main()
