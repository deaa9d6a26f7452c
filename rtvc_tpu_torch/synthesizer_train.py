"""Train a synthesizer on one GPU:

    python -m rtvc_tpu_torch.synthesizer_train <run_id> [model_type] <syn_dir> [options]

The arguments are those of the JAX package's ``synthesizer_train.py`` except
its dashboard, multi-process launch and ``--compute_dtype`` options (the
port trains in f32; bf16 is a later slice), plus ``--device`` and
``--seed``. ``model_type`` is ``tacotron`` (the default),
``forward-tacotron`` or ``fast-pitch``. ``syn_dir`` is the directory the
synthesizer preprocessing writes (``train.json``, ``mels/``, ``embeds/``;
for the non-autoregressive synthesizers also the alignment pass's
``duration/``, ``attention/``, ``alignment/``, ``phoneme_pitch/`` and
``phoneme_energy/``, from ``python -m
rtvc_tpu_torch.synthesizer_preprocess_alignments``), read through
``rtvc_tpu_torch.data.synthesizer_dataset``. The checkpoint-time evaluation
samples are not ported yet.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from rtvc_tpu_torch.models import factories


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("run_id", type=str)
    parser.add_argument("model_type", type=str, nargs="?", default=factories.MODEL_TYPE_TACOTRON,
                        choices=list(factories.SYN_MODEL_TYPES))
    parser.add_argument("syn_dir", type=Path)
    parser.add_argument("-m", "--models_dir", type=Path, default=Path("saved_models"))
    parser.add_argument("-s", "--save_every", type=int, default=1000)
    parser.add_argument("-b", "--backup_every", type=int, default=25000)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("-f", "--force_restart", action="store_true",
                        help="Ignore any saved model for this run_id and restart from scratch.")
    parser.add_argument("--device", default="cuda", help="The torch device to train on.")
    parser.add_argument("--seed", type=int, default=0, help="Seed of the initial weights.")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from rtvc_tpu_torch.data.synthesizer_dataset import SynthesizerDataset, batch_iterator
    from rtvc_tpu_torch.train.trainer import sessions, train_synthesizer

    elements = factories.get_model_train_elements(args.model_type)
    cfg = factories.default_config(args.model_type)
    dataset = SynthesizerDataset(args.syn_dir, elements)
    print(dataset.get_logs())

    schedule = sessions(args.model_type, cfg.tts_schedule)

    def epoch_batches(session_idx, r):
        return batch_iterator(dataset, batch_size=schedule[session_idx][2], r=r, seed=session_idx)

    return train_synthesizer(
        args.run_id, args.model_type, args.models_dir, epoch_batches,
        save_every=args.save_every, backup_every=args.backup_every, max_steps=args.max_steps,
        resume=not args.force_restart, device=args.device, seed=args.seed,
    )


if __name__ == "__main__":
    main()
