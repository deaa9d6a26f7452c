"""Check the native vocoder engine end to end: a mel ``.npy`` → a wav
(counterpart of the JAX package's ``vocoder_check_libwavernn.py``):

    python -m rtvc_tpu_torch.vocoder_check_libwavernn <weights.bin> <mel.npy>
        [-o out.wav] [--model_type T] [--seed N]

``weights.bin`` is an RTVCNAT1 file (``python -m
rtvc_tpu_torch.vocoder_convert_model``); the mel is (80, T) or (T, 80) in
the synthesizer's format. The engine is built from ``native/src`` on first
use (``_build.build_wavernn_engine``) and runs on the host's CPU cores.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from rtvc_tpu_torch.config import sp
from rtvc_tpu_torch.native import libwavernn
from rtvc_tpu_torch.utils.io import save_wav


def main(argv=None) -> np.ndarray:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("weights", type=Path, help="Native .bin weights")
    parser.add_argument("mel", type=Path, help="Mel spectrogram .npy (T, 80) or (80, T)")
    parser.add_argument("-o", "--out", type=Path, default=Path("libwavernn_check.wav"))
    parser.add_argument("--model_type", type=str, default="runtimeracer-wavernn")
    parser.add_argument("--seed", type=int, default=1337)
    args = parser.parse_args(argv)

    mel = np.load(args.mel).astype(np.float32)
    if mel.shape[0] != sp.num_mels:
        mel = mel.T
    print("Mel: %s" % (mel.shape,))

    voc = libwavernn.Vocoder(args.weights, args.model_type)
    voc.load()
    voc.setRandomSeed(args.seed)
    wav = voc.vocode_mel(mel)
    save_wav(wav, args.out, sp.sample_rate)
    print("Wrote %d samples (%.2f s) to %s"
          % (len(wav), len(wav) / sp.sample_rate, args.out))
    return wav


if __name__ == "__main__":
    main()
