"""Convert a vocoder checkpoint to the native engine's RTVCNAT1 file
(counterpart of the JAX package's ``vocoder_convert_model.py``):

    python -m rtvc_tpu_torch.vocoder_convert_model <checkpoint> [-o out.bin]
        [--model_type T] [--hp k=v,...]

The checkpoint may be in any format ``train/checkpoints.py:read_model``
reads; its variant and widths come from the file (``--model_type`` and
``--hp`` override them, for a file that predates the config it carries).
The engine loads the result with ``inference.vocoder.load_model(out,
voc_type="libwavernn")`` or ``native.libwavernn.Vocoder``.
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.native.convert import export_wavernn
from rtvc_tpu_torch.train.checkpoints import read_model


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("checkpoint", type=Path)
    parser.add_argument("-o", "--out", type=Path, default=None)
    parser.add_argument("--model_type", type=str, default=None,
                        help="Override the checkpoint's model_type.")
    parser.add_argument("--hp", type=str, default="",
                        help="Hyper-parameter overrides as 'k=v,...' (needed only when the "
                             "checkpoint was trained with non-default dims and carries no "
                             "config).")
    args = parser.parse_args(argv)

    ckpt = read_model(args.checkpoint, "vocoder")
    model_type = args.model_type or ckpt.model_type or factories.MODEL_TYPE_FATCHORD
    config = factories.config_from_dict(model_type, ckpt.config)
    if args.hp:
        config = config.parse(args.hp)
    ckpt = dataclasses.replace(ckpt, model_type=model_type, config=config.asdict())
    bundle = factories.from_checkpoint(ckpt, "vocoder", "cpu")

    out = args.out or args.checkpoint.with_suffix(".bin")
    export_wavernn(bundle.model, bundle.dims, out)
    print("Exported %s (%s) -> %s" % (args.checkpoint, model_type, out))
    return out


if __name__ == "__main__":
    main()
