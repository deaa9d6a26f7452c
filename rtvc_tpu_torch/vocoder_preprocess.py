"""The GTA pass on one GPU: a trained synthesizer's teacher-forced mels for
vocoder training.

    python -m rtvc_tpu_torch.vocoder_preprocess <datasets_root> [-i <syn_dir>] \\
        [-o <voc_dir>] [-s <synthesizer checkpoint>] [--batch_size 8] [--skip_existing]

Reads the synthesizer dataset (``<datasets_root>/SV2TTS/synthesizer`` unless
``-i`` names another) and writes ``mels_gta/`` and ``synthesized.json``
into the vocoder's (``<datasets_root>/SV2TTS/vocoder`` unless ``-o``):
the inputs of ``python -m rtvc_tpu_torch.vocoder_train``
(``train.gta.run_synthesis``). The model is read in any format
``train.checkpoints.read_model`` reads, with the reduction factor its file
names. The arguments are those of the JAX package's
``vocoder_preprocess.py``, plus ``--device`` (``cpu`` to rehearse without a
card).
"""
from __future__ import annotations

import argparse
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("datasets_root", type=Path)
    parser.add_argument("-i", "--in_dir", type=Path, default=None,
                        help="Synthesizer dataset dir (default <root>/SV2TTS/synthesizer)")
    parser.add_argument("-o", "--out_dir", type=Path, default=None,
                        help="Vocoder dataset dir (default <root>/SV2TTS/vocoder)")
    parser.add_argument("-s", "--syn_model_fpath", type=Path,
                        default=Path("saved_models/default/synthesizer.ckpt"))
    parser.add_argument("--ground_truth", action="store_true",
                        help="Skip GTA; train the vocoder on ground-truth mels.")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--skip_existing", action="store_true")
    parser.add_argument("--device", default="cuda", help="The torch device to synthesize on.")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    """Returns the number of utterances synthesized (0 with
    ``--ground_truth``)."""
    from rtvc_tpu_torch.inference.synthesizer import Synthesizer
    from rtvc_tpu_torch.parallel import distributed
    from rtvc_tpu_torch.train.gta import run_synthesis

    args = parse_args(argv)
    in_dir = args.in_dir or args.datasets_root / "SV2TTS" / "synthesizer"
    out_dir = args.out_dir or args.datasets_root / "SV2TTS" / "vocoder"
    if args.ground_truth:
        print("--ground_truth set: vocoder will read mels straight from %s" % in_dir)
        return 0
    # no launch flags, as in the JAX package: the pass splits its batches
    # over the processes of a group the RTVC_* environment names
    distributed.maybe_initialize_from_env(args.device)
    synth = Synthesizer(args.syn_model_fpath, device=distributed.process_device(args.device))
    synth.load()
    return run_synthesis(in_dir, out_dir, synth._bundle, r=synth._r,
                         batch_size=args.batch_size, skip_existing=args.skip_existing)


if __name__ == "__main__":
    main()
