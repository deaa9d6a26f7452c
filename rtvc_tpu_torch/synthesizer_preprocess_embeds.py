"""The synthesizer's embedding pass on one GPU:

    python -m rtvc_tpu_torch.synthesizer_preprocess_embeds <synthesizer_root> \\
        [-e encoder checkpoint] [-n 4] [-s] [--device cuda]

Writes each utterance's speaker embedding (``data.synthesizer_preprocess.
create_embeddings``: the encoder's LSTMs through K3 on the card) into
``<synthesizer_root>/embeds``, from an encoder checkpoint in any format
``train.checkpoints.read_model`` reads. The arguments are those of the JAX
package's ``synthesizer_preprocess_embeds.py`` (``-n`` threads), plus
``--device`` (``cpu`` to rehearse without a card).
"""
from __future__ import annotations

import argparse
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("synthesizer_root", type=Path)
    parser.add_argument("-e", "--encoder_model_fpath", type=Path,
                        default=Path("saved_models/default/encoder.ckpt"))
    parser.add_argument("-n", "--n_processes", type=int, default=4,
                        help="Threads, each taking one utterance at a time.")
    parser.add_argument("-s", "--skip_existing", action="store_true")
    parser.add_argument("--device", default="cuda", help="The torch device of the encoder.")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    """Returns the number of utterances embedded."""
    from rtvc_tpu_torch.data.synthesizer_preprocess import create_embeddings

    args = parse_args(argv)
    return create_embeddings(args.synthesizer_root, args.encoder_model_fpath,
                             skip_existing=args.skip_existing, n_processes=args.n_processes,
                             device=args.device)


if __name__ == "__main__":
    main()
