"""Train a WaveRNN vocoder on one GPU:

    python -m rtvc_tpu_torch.vocoder_train <run_id> [model_type] <datasets_root> [options]

The arguments are those of the JAX package's ``vocoder_train.py`` except
its multi-process launch options, plus ``--device`` and
``--seed``. The model type is ``fatchord-wavernn``, ``geneing-wavernn`` or
``runtimeracer-wavernn`` (the default here), each in its config's mode. The
dataset is the one the vocoder preprocessing writes (GTA mels, or ground-truth mels with
``-g``), read through ``rtvc_tpu_torch.data.vocoder_dataset``; ``python -m
rtvc_tpu_torch.vocoder_preprocess`` writes the GTA mels. At every save
(``--save_every``) ``train.gen_testset`` writes the config's
``gen_at_checkpoint`` samples into ``<models_dir>/<run_id>/samples``. A run
of the JAX package's trainer (``<run_id>.ckpt``) is taken up where the
port's own checkpoint is missing.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from rtvc_tpu_torch.config import synthesizer_paths
from rtvc_tpu_torch.config import vocoder as voc_cfg
from rtvc_tpu_torch.models.wavernn import VOC_FATCHORD, VOC_GENEING, VOC_RUNTIMERACER

CONFIGS = {
    VOC_FATCHORD: voc_cfg.wavernn_fatchord,
    VOC_GENEING: voc_cfg.wavernn_geneing,
    VOC_RUNTIMERACER: voc_cfg.wavernn_runtimeracer,
}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("run_id", type=str)
    parser.add_argument("model_type", type=str, nargs="?", default=VOC_RUNTIMERACER,
                        choices=list(CONFIGS))
    parser.add_argument("datasets_root", type=Path)
    parser.add_argument("--syn_dir", type=Path, default=None)
    parser.add_argument("--voc_dir", type=Path, default=None)
    parser.add_argument("-m", "--models_dir", type=Path, default=Path("saved_models"))
    parser.add_argument("-g", "--ground_truth", action="store_true",
                        help="Train on ground-truth mels instead of GTA mels.")
    parser.add_argument("-s", "--save_every", type=int, default=1000)
    parser.add_argument("-b", "--backup_every", type=int, default=25000)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--compute_dtype", choices=["auto", "f32", "bf16"], default="auto",
                        help="auto = f32 on the card (the JAX package picks bf16 only "
                             "on a TPU); bf16 = the mixed-precision policy "
                             "(ops/precision.py): bf16 parameters and "
                             "activations in the forward, f32 master weights, "
                             "optimizer state, losses and softmaxes.")
    parser.add_argument("-f", "--force_restart", action="store_true",
                        help="Ignore any saved model for this run_id and restart from scratch.")
    parser.add_argument("--dashboard", type=int, default=None, metavar="PORT",
                        help="Serve a live metrics dashboard on this port "
                             "(visdom replacement; 8097 = visdom default)")
    parser.add_argument("--device", default="cuda", help="The torch device to train on.")
    parser.add_argument("--seed", type=int, default=0, help="Seed of the initial weights.")
    return parser.parse_args(argv)


def sample_hook(model_type: str, cfg, dataset, sample_dir):
    """The trainer's ``gen_hook(step, model)``: ``gen_testset`` of the
    config's ``gen_at_checkpoint`` items of ``dataset`` into ``sample_dir``."""
    from rtvc_tpu_torch.models.factories import wavernn_dims
    from rtvc_tpu_torch.train.gen_testset import gen_testset

    dims = wavernn_dims(model_type, cfg)

    def gen_hook(step, model):
        gen_testset(model, dims, cfg, dataset, sample_dir, step, samples=cfg.gen_at_checkpoint)

    return gen_hook


def main(argv=None):
    args = parse_args(argv)
    if args.dashboard is not None:
        from rtvc_tpu_torch.utils.dashboard import serve as _serve_dashboard

        _serve_dashboard(args.models_dir / args.run_id, port=args.dashboard, background=True)
        print(f"Dashboard: http://localhost:{args.dashboard}")
    from rtvc_tpu_torch.data.vocoder_dataset import VocoderDataset, batch_iterator
    from rtvc_tpu_torch.ops import precision
    from rtvc_tpu_torch.train.trainer import train_vocoder

    cfg = CONFIGS[args.model_type]
    precision.resolve(args.compute_dtype)
    syn_dir = args.syn_dir or args.datasets_root / "SV2TTS" / "synthesizer"
    voc_dir = args.voc_dir or args.datasets_root / "SV2TTS" / "vocoder"
    if args.ground_truth:
        metadata = syn_dir / synthesizer_paths.metadata_file
        mel_dir = syn_dir / synthesizer_paths.mel_dir
    else:
        metadata = voc_dir / synthesizer_paths.gta_metadata_file
        mel_dir = voc_dir / synthesizer_paths.gta_mel_dir
    dataset = VocoderDataset(metadata, mel_dir, syn_dir / synthesizer_paths.wav_dir, cfg)
    print(dataset.get_logs())

    def epoch_batches(session_idx):
        batch_size = int(cfg.voc_tts_schedule[session_idx][3])
        return batch_iterator(dataset, batch_size, cfg, seed=session_idx,
                              process_index=0, process_count=1)

    return train_vocoder(
        args.run_id, args.model_type, args.models_dir, epoch_batches,
        save_every=args.save_every, backup_every=args.backup_every,
        max_steps=args.max_steps, resume=not args.force_restart,
        gen_hook=sample_hook(args.model_type, cfg, dataset,
                             args.models_dir / args.run_id / "samples"),
        gen_every=args.save_every,
        compute_dtype=args.compute_dtype, device=args.device, seed=args.seed,
    )


if __name__ == "__main__":
    main()
