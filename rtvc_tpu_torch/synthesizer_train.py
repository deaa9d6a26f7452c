"""Train a synthesizer on one GPU:

    python -m rtvc_tpu_torch.synthesizer_train <run_id> [model_type] <syn_dir> [options]

The arguments are those of the JAX package's ``synthesizer_train.py`` except
its multi-process launch options, plus ``--device`` and
``--seed``; ``--compute_dtype bf16`` trains under the bf16 policy
(``ops/precision.py``), and ``auto`` is f32 on the card. ``model_type`` is
``tacotron`` (the default), ``forward-tacotron`` or ``fast-pitch``. ``syn_dir`` is the directory the
synthesizer preprocessing writes (``train.json``, ``mels/``, ``embeds/``;
for the non-autoregressive synthesizers also the alignment pass's
``duration/``, ``attention/``, ``alignment/``, ``phoneme_pitch/`` and
``phoneme_energy/``, from ``python -m
rtvc_tpu_torch.synthesizer_preprocess_alignments``), read through
``rtvc_tpu_torch.data.synthesizer_dataset``. Every ``eval_interval`` steps
of the type's config the type's evaluation hook (``train.eval_hooks``)
writes a sample into ``<models_dir>/<run_id>/samples``: its wav, and its
plots where matplotlib imports. A run of the JAX package's trainer
(``<run_id>.ckpt`` in ``<models_dir>/<run_id>``) is taken up where the
port's own checkpoint is missing.
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
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.dashboard is not None:
        from rtvc_tpu_torch.utils.dashboard import serve as _serve_dashboard

        _serve_dashboard(args.models_dir / args.run_id, port=args.dashboard, background=True)
        print(f"Dashboard: http://localhost:{args.dashboard}")
    from rtvc_tpu_torch.data.synthesizer_dataset import SynthesizerDataset, batch_iterator
    from rtvc_tpu_torch.train.eval_hooks import make_synthesizer_eval_hook
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
        eval_hook=make_synthesizer_eval_hook(args.models_dir / args.run_id / "samples",
                                             args.model_type),
        eval_interval=cfg.eval_interval, compute_dtype=args.compute_dtype,
    )


if __name__ == "__main__":
    main()
