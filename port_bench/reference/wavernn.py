"""Plain WaveRNN of the runtimeracer variant (RAW head, mu-law): the mel
upsampler (MelResNet, stretch and smoothing convs), the fold into
overlapping windows, the sample loop's layers teacher-forced on a given
sequence of samples, and the cross-fade, mu-law decode, de-emphasis and
fade-out that make the waveform.

The sample loop of the runtimeracer variant: x = I([prev, mel, aux₀]); for
each of rnn1..rnn4, x += GRU(x ‖ aux₁ for rnn3); fc1(x ‖ aux₂), fc2 + ReLU,
fc3(· ‖ aux₃), fc4 + ReLU, fc5 → the 2^bits logits of the next label.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import lfilter

from port_bench.reference.nn import Prec, Weights, batch_norm_eval, gru_cell

Tensor = torch.Tensor

FRAME_BUCKET = 64


def upsample(P: Prec, W: Weights, c: dict, mels: Tensor) -> Tuple[Tensor, Tensor]:
    """mels (B, n_mels, n) padded by ``pad`` frames both sides → (mels_up
    (B, T, n_mels), aux (B, T, res_out)) with T = (n - 2·pad)·hop."""
    u = "upsample.resnet."
    h = P.conv1d(mels, W[u + "conv_in.weight"]).transpose(1, 2)
    h = torch.relu(batch_norm_eval(W, u + "batch_norm.", h))
    for i in range(c["res_blocks"]):
        q = f"{u}layers.{i}."
        y = torch.relu(batch_norm_eval(W, q + "batch_norm1.",
                                       P.mm(h, W[q + "conv1.weight"][:, :, 0].t())))
        y = batch_norm_eval(W, q + "batch_norm2.", P.mm(y, W[q + "conv2.weight"][:, :, 0].t()))
        h = h + y
    aux = P.mm(h, W[u + "conv_out.weight"][:, :, 0].t()) + W[u + "conv_out.bias"]
    scale = int(np.prod(c["upsample_factors"]))
    aux = aux.repeat_interleave(scale, dim=1)
    m = mels[:, None]
    for i, s in enumerate(c["upsample_factors"]):
        m = m.repeat_interleave(s, dim=3)
        m = P.conv2d(m, W[f"upsample.up_layers.{2 * i + 1}.weight"], padding=(0, s))
    m = m[:, 0].transpose(1, 2)
    indent = c["pad"] * scale
    return m[:, indent:-indent], aux


def fold(x: Tensor, target: int, overlap: int) -> Tensor:
    """(T, C) → (folds, target + 2·overlap, C), the tail padded with zeros."""
    total = x.shape[0]
    n = (total - overlap) // (target + overlap)
    if total != n * (target + overlap) + overlap:
        n += 1
    need = n * (target + overlap) + overlap
    x = F.pad(x, (0, 0, 0, need - total))
    return torch.stack([x[i * (target + overlap): i * (target + overlap) + target + 2 * overlap]
                        for i in range(n)])


def conditioning(P: Prec, W: Weights, c: dict, mels: List[np.ndarray], target: int,
                 overlap: int, normalize: float) -> Tuple[Tensor, Tensor, List[int]]:
    """Mels as a batch vocode call gets them (each (n_mels, n_i), divided by
    ``normalize``; all padded with -1 to one 64-frame bucket, the longest's,
    then by ``pad`` frames each side) → every utterance's folds of (mels_up,
    aux) stacked, and the folds each utterance takes."""
    dev = W["I.weight"].device
    n_max = max(m.shape[1] for m in mels)
    bucket = -(-n_max // FRAME_BUCKET) * FRAME_BUCKET
    stack = torch.full((len(mels), c["n_mels"], bucket), -1.0, device=dev)
    for i, m in enumerate(mels):
        stack[i, :, :m.shape[1]] = torch.as_tensor(np.asarray(m, np.float32) / normalize,
                                                   device=dev)
    up, aux = upsample(P, W, c, F.pad(stack, (c["pad"], c["pad"])))
    mf = [fold(up[i], target, overlap) for i in range(len(mels))]
    af = [fold(aux[i], target, overlap) for i in range(len(mels))]
    return torch.cat(mf), torch.cat(af), [f.shape[0] for f in mf]


def sample_labels(samples: Tensor, classes: int) -> Tensor:
    """Samples in [-1, 1] → the labels they encode; -1 where a sample is no
    label's value."""
    labels = torch.round((samples + 1.0) * (classes - 1) / 2.0)
    exact = (2.0 * labels / (classes - 1) - 1.0 - samples).abs() <= 1e-5
    ok = exact & (labels >= 0) & (labels < classes)
    return torch.where(ok, labels, -1.0).long()


@torch.no_grad()
def logit_gaps(P: Prec, W: Weights, c: dict, mels_up: Tensor, aux: Tensor, samples: Tensor,
               chunk: int = 1000, labels=None, return_argmax: bool = False):
    """Teacher-forced sample loop: the input before step t is the sample the
    program produced (``samples`` (B, T) in [-1, 1], the first input 0).
    → per fold the widest gap by which the logit of the chosen label (the
    produced one, unless ``labels`` (B, T) names others) lies below the best
    logit of this reference, (B,); with ``return_argmax`` also this
    reference's best label at every step (B, T)."""
    B, T = samples.shape
    A = c["res_out_dims"] // 4
    C = 2 ** c["bits"]
    if labels is None:
        labels = sample_labels(samples, C)
    prev = torch.cat([samples.new_zeros((B, 1)), samples[:, :-1]], dim=1)
    splits = [aux[:, :, A * i:A * (i + 1)] for i in range(4)]
    x = P.linear(torch.cat([prev[:, :, None], mels_up, splits[0][:, :, :-1]], dim=2),
                 W["I.weight"], W["I.bias"])
    for k in range(1, 5):
        p = f"rnn{k}."
        inp = torch.cat([x, splits[1]], dim=2) if k == 3 else x
        xg = P.linear(inp, W[p + "weight_ih_l0"], W[p + "bias_ih_l0"])
        h = x.new_zeros((B, W[p + "weight_hh_l0"].shape[1]))
        hs = []
        for t in range(T):
            h = gru_cell(P, xg[:, t], h, W[p + "weight_hh_l0"], W[p + "bias_hh_l0"])
            hs.append(h)
        x = x + torch.stack(hs, dim=1)
    gap = samples.new_full((B,), -math.inf)
    best = torch.empty((B, T), dtype=torch.long, device=samples.device) if return_argmax else None
    for t0 in range(0, T, chunk):
        sl = slice(t0, min(t0 + chunk, T))
        f = P.linear(torch.cat([x[:, sl], splits[2][:, sl]], dim=2), W["fc1.weight"],
                     W["fc1.bias"])
        f = torch.relu(P.linear(f, W["fc2.weight"], W["fc2.bias"]))
        f = P.linear(torch.cat([f, splits[3][:, sl]], dim=2), W["fc3.weight"], W["fc3.bias"])
        f = torch.relu(P.linear(f, W["fc4.weight"], W["fc4.bias"]))
        logits = P.linear(f, W["fc5.weight"], W["fc5.bias"])
        top, arg = logits.max(dim=-1)
        lab = labels[:, sl]
        chosen = logits.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
        chosen = torch.where(lab >= 0, chosen, torch.full_like(chosen, -1e30))
        gap = torch.maximum(gap, (top - chosen).max(dim=1).values)
        if best is not None:
            best[:, sl] = arg
    return (gap, best) if return_argmax else gap


def waveform(samples: Tensor, target: int, overlap: int, n_frames: int, hop: int, bits: int,
             preemphasis: float = 0.97) -> np.ndarray:
    """The program's fold samples of one utterance (folds, target +
    2·overlap) → its waveform: equal-power cross-fade over the overlaps and
    unfold, mu-law decode, de-emphasis, the first (n_frames - 1)·hop samples,
    a linear fade-out over the last 20 hops. float64."""
    y = samples.double().cpu().numpy()
    folds, length = y.shape
    silence = overlap // 2
    fade = overlap - silence
    t = np.linspace(-1.0, 1.0, fade)
    fade_in = np.concatenate([np.zeros(silence), np.sqrt(0.5 * (1.0 + t))])
    fade_out = np.concatenate([np.sqrt(0.5 * (1.0 - t)), np.zeros(silence)])
    y = y.copy()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out
    out = np.zeros(folds * (target + overlap) + overlap)
    for i in range(folds):
        out[i * (target + overlap): i * (target + overlap) + length] += y[i]
    mu = 2 ** bits - 1
    out = np.sign(out) / mu * ((1.0 + mu) ** np.abs(out) - 1.0)
    out = lfilter([1.0], [1.0, -preemphasis], out)  # de-emphasis: y[n] = x[n] + k·y[n-1]
    out = out[:(n_frames - 1) * hop].copy()
    k = min(20 * hop, len(out))
    out[-k:] *= np.linspace(1.0, 0.0, k)
    return out
