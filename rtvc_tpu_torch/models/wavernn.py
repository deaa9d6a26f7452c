"""WaveRNN vocoder, runtimeracer variant with the RAW categorical head
(counterpart of ``rtvc_tpu/models/wavernn.py``).

Generation: upsample the mel (MelResNet + Stretch2d + smoothing convs),
fold the conditioning into overlapping windows that form the batch, hoist
every conditioning projection into full-sequence matmuls, run the
autoregressive sample loop through the K1 kernel (``ops.wavernn_generate``),
then cross-fade the folds back together, mu-law decode and de-emphasise.

Training: ``wavernn_forward`` is the teacher-forced forward over the
previous samples; its four GRUs run through the K4 kernels
(``ops.gru_seq.GRUSeqFn``), and its BatchNorms use batch statistics and
return the updated running statistics.

The fatchord and geneing variants and the MoL and beta heads belong to a
later slice and raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtvc_tpu_torch.config.vocoder import MODE_MOL, MODE_RAW, WaveRNNParams
from rtvc_tpu_torch.models.layers import GRU, BatchNorm1d, Linear
from rtvc_tpu_torch.ops import audio as audio_ops
from rtvc_tpu_torch.ops.gru_seq import GRUSeqFn
from rtvc_tpu_torch.ops.wavernn_generate import wavernn_generate_core

Tensor = torch.Tensor

VOC_FATCHORD = "fatchord-wavernn"
VOC_GENEING = "geneing-wavernn"
VOC_RUNTIMERACER = "runtimeracer-wavernn"

_FRAME_BUCKET = 64


class WaveRNNDims(NamedTuple):
    variant: str
    mode: str
    rnn_dims: int
    fc_dims: int
    bits: int
    pad: int
    upsample_factors: Tuple[int, ...]
    feat_dims: int
    compute_dims: int
    res_out_dims: int
    res_blocks: int
    hop_length: int
    sample_rate: int

    @classmethod
    def from_config(cls, variant: str, cfg: WaveRNNParams, feat_dims: int,
                    hop: int, sr: int) -> "WaveRNNDims":
        if int(np.prod(cfg.upsample_factors)) != hop:
            raise ValueError("upsample factors must factorise hop_length")
        return cls(variant=variant, mode=cfg.mode, rnn_dims=cfg.rnn_dims,
                   fc_dims=cfg.fc_dims, bits=cfg.bits, pad=cfg.pad,
                   upsample_factors=tuple(cfg.upsample_factors),
                   feat_dims=feat_dims, compute_dims=cfg.compute_dims,
                   res_out_dims=cfg.res_out_dims, res_blocks=cfg.res_blocks,
                   hop_length=hop, sample_rate=sr)

    @property
    def n_aux_splits(self) -> int:
        return 2 if self.variant == VOC_GENEING else 4

    @property
    def aux_dims(self) -> int:
        return self.res_out_dims // self.n_aux_splits

    @property
    def n_classes(self) -> int:
        if self.mode == MODE_RAW:
            return 2 if self.variant == VOC_GENEING else 2 ** self.bits
        if self.mode == MODE_MOL:
            return 30
        return 2 ** self.bits

    @property
    def total_scale(self) -> int:
        return int(np.prod(self.upsample_factors))


def check_supported(d: WaveRNNDims) -> None:
    if d.variant != VOC_RUNTIMERACER or d.mode != MODE_RAW:
        raise NotImplementedError(
            f"{d.variant} / {d.mode}: only runtimeracer-wavernn with the RAW "
            f"head is ported; the other variants and heads are a later slice")


# ---------------------------------------------------------------------------
# Modules (reference state-dict names)
# ---------------------------------------------------------------------------


class ResBlock(nn.Module):
    def __init__(self, dims: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv1d(dims, dims, 1, bias=False, device=device)
        self.conv2 = nn.Conv1d(dims, dims, 1, bias=False, device=device)
        self.batch_norm1 = BatchNorm1d(dims, device=device)
        self.batch_norm2 = BatchNorm1d(dims, device=device)


class MelResNet(nn.Module):
    def __init__(self, d: WaveRNNDims, device=None):
        super().__init__()
        self.conv_in = nn.Conv1d(d.feat_dims, d.compute_dims, 2 * d.pad + 1,
                                 bias=False, device=device)
        self.batch_norm = BatchNorm1d(d.compute_dims, device=device)
        self.layers = nn.ModuleList(ResBlock(d.compute_dims, device=device)
                                    for _ in range(d.res_blocks))
        self.conv_out = nn.Conv1d(d.compute_dims, d.res_out_dims, 1, device=device)


class Stretch2d(nn.Module):
    """Nearest-neighbour stretch (no parameters; holds its index in
    ``up_layers`` so the smoothing convs keep the reference's names)."""

    def __init__(self, x_scale: int):
        super().__init__()
        self.x_scale = x_scale


class UpsampleNetwork(nn.Module):
    def __init__(self, d: WaveRNNDims, device=None):
        super().__init__()
        self.resnet = MelResNet(d, device=device)
        layers = []
        for s in d.upsample_factors:
            layers.append(Stretch2d(s))
            layers.append(nn.Conv2d(1, 1, (1, 2 * s + 1), padding=(0, s),
                                    bias=False, device=device))
        self.up_layers = nn.ModuleList(layers)


class WaveRNN(nn.Module):
    """runtimeracer: 4 GRUs of rnn_dims + 5 FCs."""

    def __init__(self, d: WaveRNNDims, device=None):
        super().__init__()
        check_supported(d)
        self.dims = d
        R, Fd, A = d.rnn_dims, d.fc_dims, d.aux_dims
        self.upsample = UpsampleNetwork(d, device=device)
        self.I = Linear(d.feat_dims + A, R, device=device)
        self.rnn1 = GRU(R, R, device=device)
        self.rnn2 = GRU(R, R, device=device)
        self.rnn3 = GRU(R + A, R, device=device)
        self.rnn4 = GRU(R, R, device=device)
        self.fc1 = Linear(R + A, Fd, device=device)
        self.fc2 = Linear(Fd, Fd, device=device)
        self.fc3 = Linear(Fd + A, Fd, device=device)
        self.fc4 = Linear(Fd, Fd, device=device)
        self.fc5 = Linear(Fd, d.n_classes, device=device)


# ---------------------------------------------------------------------------
# Upsampling and folding
# ---------------------------------------------------------------------------


def upsample_forward(model: WaveRNN, d: WaveRNNDims, mels: Tensor, train: bool = False
                     ) -> Tuple[Tensor, Tensor, Dict[str, Tensor]]:
    """mels (B, n_mels, n_frames) → (mels_up (B, T, feat), aux (B, T, res_out),
    new_stats) with T = (n_frames - 2·pad)·total_scale. With ``train`` the
    BatchNorms use batch statistics and ``new_stats`` maps each running
    statistic's state-dict name to its update; otherwise it is empty."""
    up = model.upsample
    rn = up.resnet
    new_stats: Dict[str, Tensor] = {}

    def bn(norm: BatchNorm1d, name: str, v: Tensor) -> Tensor:
        if not train:
            return norm(v)
        v, stats = norm.forward_train(v)
        new_stats.update({f"upsample.resnet.{name}.{k}": s for k, s in stats.items()})
        return v

    x = mels.transpose(1, 2)  # (B, n_frames, n_mels)
    h = F.conv1d(mels, rn.conv_in.weight).transpose(1, 2)
    h = torch.relu(bn(rn.batch_norm, "batch_norm", h))
    for i, layer in enumerate(rn.layers):
        residual = h
        y = torch.relu(bn(layer.batch_norm1, f"layers.{i}.batch_norm1",
                          h @ layer.conv1.weight[:, :, 0].t()))
        y = bn(layer.batch_norm2, f"layers.{i}.batch_norm2",
               y @ layer.conv2.weight[:, :, 0].t())
        h = y + residual
    aux = h @ rn.conv_out.weight[:, :, 0].t() + rn.conv_out.bias
    aux = aux.repeat_interleave(d.total_scale, dim=1)

    m = x.transpose(1, 2)[:, None]  # (B, 1, n_mels, n_frames)
    for i, scale in enumerate(d.upsample_factors):
        m = m.repeat_interleave(scale, dim=3)
        m = F.conv2d(m, up.up_layers[2 * i + 1].weight, padding=(0, scale))
    m = m[:, 0].transpose(1, 2)
    indent = d.pad * d.total_scale
    return m[:, indent:-indent, :], aux, new_stats


# ---------------------------------------------------------------------------
# Teacher-forced forward (training)
# ---------------------------------------------------------------------------


def gru_seq(gru: GRU, x: Tensor) -> Tensor:
    """A single-layer GRU module over (B, T, I) from a zero state, through K4:
    the input projection is one matmul, the recurrence ``GRUSeqFn``."""
    xg = x @ gru.weight_ih_l0.t() + gru.bias_ih_l0
    return GRUSeqFn.apply(xg.contiguous(), gru.weight_hh_l0.contiguous(),
                          gru.bias_hh_l0.contiguous())


def wavernn_forward(model: WaveRNN, d: WaveRNNDims, x: Tensor, mels: Tensor
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Teacher-forced runtimeracer forward: x (B, T) previous samples in
    [-1, 1], mels (B, n_mels, T / hop + 2·pad) → (logits (B, T, n_classes),
    new_stats) with the BatchNorms on batch statistics
    (``rtvc_tpu/models/wavernn.py:wavernn_forward``)."""
    check_supported(d)
    A = d.aux_dims
    mels_up, aux, new_stats = upsample_forward(model, d, mels, train=True)
    splits = [aux[:, :, A * i:A * (i + 1)] for i in range(d.n_aux_splits)]
    h = model.I(torch.cat([x[:, :, None], mels_up, splits[0][:, :, :-1]], dim=2))
    h = gru_seq(model.rnn1, h) + h
    h = gru_seq(model.rnn2, h) + h
    h = gru_seq(model.rnn3, torch.cat([h, splits[1]], dim=2)) + h
    h = gru_seq(model.rnn4, h) + h
    h = model.fc1(torch.cat([h, splits[2]], dim=2))
    h = torch.relu(model.fc2(h))
    h = model.fc3(torch.cat([h, splits[3]], dim=2))
    h = torch.relu(model.fc4(h))
    return model.fc5(h), new_stats


def fold_with_overlap(x: Tensor, target: int, overlap: int) -> Tuple[Tensor, int]:
    """(1, T, C) → (num_folds, target + 2·overlap, C)."""
    _, total_len, _ = x.shape
    num_folds = (total_len - overlap) // (target + overlap)
    extended_len = num_folds * (overlap + target) + overlap
    remaining = total_len - extended_len
    if remaining != 0:
        num_folds += 1
        padding = target + 2 * overlap - remaining
        x = F.pad(x, (0, 0, 0, padding))
    starts = torch.arange(num_folds, device=x.device) * (target + overlap)
    idx = starts[:, None] + torch.arange(target + 2 * overlap, device=x.device)[None, :]
    return x[0][idx], num_folds


def xfade_and_unfold(y: Tensor, target: int, overlap: int) -> Tensor:
    """(num_folds, target + 2·overlap) → (total_len,) with an equal-power
    cross-fade over each overlap."""
    num_folds, length = y.shape
    target = length - 2 * overlap
    total_len = num_folds * (target + overlap) + overlap
    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = torch.linspace(-1.0, 1.0, fade_len, dtype=y.dtype, device=y.device)
    zeros = torch.zeros(silence_len, dtype=y.dtype, device=y.device)
    fade_in = torch.cat([zeros, torch.sqrt(0.5 * (1.0 + t))])
    fade_out = torch.cat([torch.sqrt(0.5 * (1.0 - t)), zeros])
    y = y.clone()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out
    starts = torch.arange(num_folds, device=y.device) * (target + overlap)
    idx = starts[:, None] + torch.arange(length, device=y.device)[None, :]
    out = torch.zeros(total_len, dtype=y.dtype, device=y.device)
    return out.index_add_(0, idx.reshape(-1), y.reshape(-1))


# ---------------------------------------------------------------------------
# Autoregressive generation
# ---------------------------------------------------------------------------


def hoist_aux(model: WaveRNN, d: WaveRNNDims, mels_up: Tensor, aux: Tensor
              ) -> Dict[str, Tensor]:
    """Every projection of the conditioning as full-sequence matmuls: the
    per-step streams the sample loop reads, each (B, T, width)."""
    R, Fd, A = d.rnn_dims, d.fc_dims, d.aux_dims
    splits = [aux[:, :, A * i:A * (i + 1)] for i in range(d.n_aux_splits)]
    w_I = model.I.weight  # (R, 1 + feat + A - 1): column 0 is the previous sample
    cond = torch.cat([mels_up, splits[0][:, :, :-1]], dim=2)
    w3 = model.rnn3.weight_ih_l0
    return {
        "i_cond": cond @ w_I[:, 1:].t() + model.I.bias,
        "rnn3_aux": splits[1] @ w3[:, R:].t() + model.rnn3.bias_ih_l0,
        "fc1_aux": splits[2] @ model.fc1.weight[:, R:].t() + model.fc1.bias,
        "fc3_aux": splits[3] @ model.fc3.weight[:, Fd:].t() + model.fc3.bias,
    }


def step_weights(model: WaveRNN, d: WaveRNNDims) -> Dict[str, Tensor]:
    """The weights the sample loop reads every step, contiguous, torch
    layout (out, in). Inputs that concatenate the state with an aux split
    keep only the state columns; the aux columns went into the streams."""
    R, Fd = d.rnn_dims, d.fc_dims
    w: Dict[str, Tensor] = {"i_col": model.I.weight[:, 0]}
    for name in ("rnn1", "rnn2", "rnn4"):
        g = getattr(model, name)
        w[f"{name}_wih"] = g.weight_ih_l0
        w[f"{name}_bih"] = g.bias_ih_l0
    w["rnn3_wx"] = model.rnn3.weight_ih_l0[:, :R]
    for name in ("rnn1", "rnn2", "rnn3", "rnn4"):
        g = getattr(model, name)
        w[f"{name}_whh"] = g.weight_hh_l0
        w[f"{name}_bhh"] = g.bias_hh_l0
    w["fc1_wx"] = model.fc1.weight[:, :R]
    w["fc3_wx"] = model.fc3.weight[:, :Fd]
    for name in ("fc2", "fc4", "fc5"):
        w[f"{name}_w"] = getattr(model, name).weight
        w[f"{name}_b"] = getattr(model, name).bias
    return {k: v.detach().contiguous() for k, v in w.items()}


def generate_core(model: WaveRNN, d: WaveRNNDims, mels_up: Tensor, aux: Tensor,
                  seed: int, argmax: bool = False) -> Tensor:
    """Autoregressive sample loop over upsampled conditioning (B, T, ·) →
    samples (B, T) in [-1, 1]. ``argmax=True`` is the deterministic (greedy)
    test hook."""
    check_supported(d)
    streams = {k: v.contiguous() for k, v in hoist_aux(model, d, mels_up, aux).items()}
    return wavernn_generate_core(step_weights(model, d), streams, seed, argmax)


@torch.no_grad()
def wavernn_generate(model: WaveRNN, d: WaveRNNDims, mels, seed: int,
                     batched: bool = True, target: int = 6000,
                     overlap: int = 1000, mu_law: bool = True,
                     apply_preemphasis: bool = True, argmax: bool = False,
                     fade_out: bool = True) -> np.ndarray:
    """pad → upsample → fold → AR loop → cross-fade/unfold → mu-law decode →
    de-emphasis → fade-out. ``mels`` (n_mels, n) or (1, n_mels, n); returns
    a float64 numpy waveform of (n - 1)·hop samples.

    The frame count is padded to a multiple of 64 with -1.0 (the JAX
    package's compile bucket); the pad changes the upsampled tail and the
    fold count, so it is kept for parity and trimmed off at the end."""
    check_supported(d)
    dev = model.I.weight.device
    mels = torch.as_tensor(np.asarray(mels, dtype=np.float32), device=dev)
    if mels.ndim == 2:
        mels = mels[None]
    n_frames = mels.shape[-1]
    if n_frames < 2:
        raise ValueError(f"Need at least 2 mel frames to generate audio, got {n_frames}")
    if mels.shape[1] != d.feat_dims:
        raise ValueError(f"Expected {d.feat_dims} mel bins, got {mels.shape[1]} — "
                         f"is the mel transposed?")
    wave_len = (n_frames - 1) * d.hop_length
    bucket = -(-n_frames // _FRAME_BUCKET) * _FRAME_BUCKET
    mels = F.pad(mels, (0, bucket - n_frames), value=-1.0)
    mels = F.pad(mels, (d.pad, d.pad))
    mels_up, aux, _ = upsample_forward(model, d, mels)
    if batched:
        mels_up, _ = fold_with_overlap(mels_up, target, overlap)
        aux, _ = fold_with_overlap(aux, target, overlap)
    samples = generate_core(model, d, mels_up, aux, seed, argmax)
    output = xfade_and_unfold(samples, target, overlap) if batched else samples[0]
    if mu_law:
        output = audio_ops.decode_mu_law(output, d.n_classes, from_labels=False)
    if apply_preemphasis:
        output = audio_ops.de_emphasis(output, 0.97)
    output = output[:wave_len].cpu().double().numpy().copy()
    if fade_out:
        fade_len = min(20 * d.hop_length, len(output))
        output[-fade_len:] *= np.linspace(1.0, 0.0, fade_len)
    return output
