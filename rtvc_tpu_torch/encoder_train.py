"""Train the GE2E speaker encoder on one GPU, or data-parallel on several
(one process per card):

    python -m rtvc_tpu_torch.encoder_train <run_id> <clean_data_root> [options]
        [--coordinator HOST:PORT --num_processes N --process_id K]

The arguments are those of the JAX package's ``encoder_train.py``, plus
``--device`` and ``--seed``. Under the launch options (or the ``RTVC_*``
environment, ``parallel.distributed``) each process reads its own share of
the speakers, samples speakers_per_batch / N of them a step with its own
seed, and the GE2E loss is the global batch's. The
dataset is the one ``encoder_preprocess.py`` writes, read through
``rtvc_tpu_torch.data.ge2e_sampler``. A run of the JAX package's trainer
(``<run_id>.ckpt`` in ``<models_dir>/<run_id>``) is taken up where the
port's own checkpoint is missing.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from rtvc_tpu_torch.config.encoder import encoder_model
from rtvc_tpu_torch.parallel import distributed


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("run_id", type=str)
    parser.add_argument("clean_data_root", type=Path,
                        help="Preprocessed encoder dataset root.")
    parser.add_argument("-m", "--models_dir", type=Path, default=Path("saved_models"))
    parser.add_argument("--save_every", type=int, default=500)
    parser.add_argument("--backup_every", type=int, default=7500)
    parser.add_argument("--total_steps", type=int, default=None)
    parser.add_argument("-e", "--end_after", type=int, default=None,
                        help="Stop after this many additional steps (relative).")
    parser.add_argument("--learning_rate", type=float, default=encoder_model.learning_rate_init)
    parser.add_argument("--speakers_per_batch", type=int,
                        default=encoder_model.speakers_per_batch)
    parser.add_argument("--utterances_per_speaker", type=int,
                        default=encoder_model.utterances_per_speaker)
    parser.add_argument("-f", "--force_restart", action="store_true",
                        help="Ignore any saved model for this run_id and restart from scratch.")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--compute_dtype", choices=["auto", "f32", "bf16"], default="auto",
                        help="auto = f32 on the card (the JAX package picks bf16 only "
                             "on a TPU); bf16 = the mixed-precision policy "
                             "(ops/precision.py): bf16 parameters and "
                             "activations in the forward, f32 master weights, "
                             "optimizer state, losses and softmaxes.")
    parser.add_argument("--dashboard", type=int, default=None, metavar="PORT",
                        help="Serve a live metrics dashboard on this port "
                             "(visdom replacement; 8097 = visdom default)")
    parser.add_argument("--device", default="cuda", help="The torch device to train on.")
    parser.add_argument("--seed", type=int, default=0, help="Seed of the initial weights.")
    distributed.add_launch_args(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.dashboard is not None:
        from rtvc_tpu_torch.utils.dashboard import serve as _serve_dashboard

        _serve_dashboard(args.models_dir / args.run_id, port=args.dashboard, background=True)
        print(f"Dashboard: http://localhost:{args.dashboard}")
    from rtvc_tpu_torch.data.ge2e_sampler import SpeakerVerificationDataset, speaker_batch_iterator
    from rtvc_tpu_torch.ops import precision
    from rtvc_tpu_torch.train.trainer import train_encoder

    precision.resolve(args.compute_dtype)
    dp = distributed.setup_from_args(args)
    # each process samples its own speakers (a disjoint share of the list,
    # so no speaker sits in one global batch twice) with its own seed
    pidx, nproc = distributed.process_index(), distributed.process_count()
    if args.speakers_per_batch % nproc:
        raise SystemExit(f"speakers_per_batch={args.speakers_per_batch} must divide by the "
                         f"number of processes ({nproc})")
    dataset = SpeakerVerificationDataset(args.clean_data_root, process_index=pidx,
                                         process_count=nproc)
    it = speaker_batch_iterator(dataset, args.speakers_per_batch // nproc,
                                args.utterances_per_speaker, n_frames=160,
                                seed=None if nproc == 1 else 1234 + pidx)
    return train_encoder(
        args.run_id, it, args.models_dir,
        speakers_per_batch=args.speakers_per_batch,
        utterances_per_speaker=args.utterances_per_speaker,
        learning_rate=args.learning_rate, total_steps=args.total_steps,
        end_after=args.end_after, save_every=args.save_every,
        backup_every=args.backup_every, profile=args.profile,
        resume=not args.force_restart, compute_dtype=args.compute_dtype,
        device=distributed.process_device(args.device), seed=args.seed, dp=dp,
    )


if __name__ == "__main__":
    main()
