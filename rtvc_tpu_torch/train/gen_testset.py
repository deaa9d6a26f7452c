"""The vocoder trainer's checkpoint-time samples (counterpart of
``rtvc_tpu/train/gen_testset.py``): a few utterances of the dataset three
ways, so that training is audible without a metric — the target's decode,
a Griffin-Lim inversion of its mel, and the WaveRNN being trained (K1 on
the card) — plus a plot of the three where matplotlib imports.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from rtvc_tpu_torch.config import sp
from rtvc_tpu_torch.config.vocoder import MODE_MOL, WaveRNNParams
from rtvc_tpu_torch.models.wavernn import WaveRNN, WaveRNNDims, wavernn_generate
from rtvc_tpu_torch.ops.audio import decode_mu_law, label_2_float
from rtvc_tpu_torch.train.eval_hooks import eval_mode, griffin_lim_wav
from rtvc_tpu_torch.utils.io import save_wav
from rtvc_tpu_torch.utils.plots import save_wave_comparison

GRIFFIN_LIM_ITERS = 30


def target_wave(quant: np.ndarray, cfg: WaveRNNParams) -> np.ndarray:
    """A dataset item's quantised target → float samples: the mu-law
    decode, or the linear one (MOL's 16-bit labels; ``mu_law`` off)."""
    bits = 16 if cfg.mode == MODE_MOL else cfg.bits
    q = torch.as_tensor(np.asarray(quant), dtype=torch.float32)
    if cfg.mu_law and cfg.mode != MODE_MOL:
        return decode_mu_law(q, 2 ** bits, True).numpy()
    return label_2_float(q, bits).numpy()


def gen_testset(model: WaveRNN, dims: WaveRNNDims, cfg: WaveRNNParams, dataset, save_dir,
                step: int, samples: int = 2, batched: bool = True, seed: int = 0) -> None:
    """For each of the first ``samples`` items of ``dataset`` (a
    ``VocoderDataset``): ``{step}_{i}_target.wav``,
    ``{step}_{i}_griffinlim.wav`` (``GRIFFIN_LIM_ITERS`` iterations from a
    phase of ``seed``), ``{step}_{i}_generated.wav`` (``wavernn_generate`` at
    ``cfg.gen_target`` / ``cfg.gen_overlap``, seed ``seed + i``) and
    ``{step}_{i}_compare.png`` where matplotlib imports. ``model`` may be the
    one a trainer is training: its parameters and running statistics are
    read, not written, no gradient is taken, its mode is restored, and no
    generator of the caller's is drawn from."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    dev = model.I.weight.device
    with eval_mode(model):
        for i in range(min(samples, len(dataset))):
            mel, quant, _ = dataset[i]
            gt = target_wave(quant, cfg)
            save_wav(gt, save_dir / f"{step}_{i}_target.wav", sp.sample_rate)

            gl = griffin_lim_wav(torch.as_tensor(mel * sp.max_abs_value, device=dev),
                                 GRIFFIN_LIM_ITERS, seed)
            save_wav(gl, save_dir / f"{step}_{i}_griffinlim.wav", sp.sample_rate)

            gen = wavernn_generate(model, dims, mel, seed + i, batched=batched,
                                   target=cfg.gen_target, overlap=cfg.gen_overlap,
                                   mu_law=cfg.mu_law, apply_preemphasis=sp.preemphasize)
            save_wav(gen, save_dir / f"{step}_{i}_generated.wav", sp.sample_rate)

            n = min(len(gt), len(gl), len(gen))
            save_wave_comparison([gt[:n], gl[:n], gen[:n]], ["target", "griffin-lim",
                                                               "generated"],
                                 save_dir / f"{step}_{i}_compare")
