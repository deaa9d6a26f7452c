"""WaveRNN vocoder (counterpart of ``rtvc_tpu/models/wavernn.py``): the
fatchord (2 GRUs, 3 FCs), geneing (1 GRU, 2 FCs) and runtimeracer (4 GRUs,
5 FCs) variants, each with the categorical head (RAW, or BITS on geneing),
the mixture-of-logistics head (MOL) or, for geneing's RAW mode, the
two-parameter beta head.

Generation: upsample the mel (MelResNet + Stretch2d + smoothing convs),
fold the conditioning into overlapping windows that form the batch, hoist
every conditioning projection into full-sequence matmuls, run the
autoregressive sample loop through the K1 kernel (``ops.wavernn_generate``),
then cross-fade the folds back together, mu-law decode and de-emphasise.
``wavernn_generate_batch`` vocodes several utterances in one launch of the
loop: every utterance's folds share the batch axis. The generate functions
take the JAX package's two dtype knobs: ``compute_dtype`` (the loop's
weights and carried state) and ``stream_dtype`` (its conditioning streams),
each ``"f32"`` (the default) or ``"bf16"`` or a torch dtype
(``ops.precision.resolve``); they pick K1's instantiation.

Training: ``wavernn_forward`` is the teacher-forced forward over the
previous samples; its GRUs run through the K4 kernels
(``layers.GRU.sequence``), and its BatchNorms use batch statistics and
return the updated running statistics.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtvc_tpu_torch.config.vocoder import MODE_BITS, MODE_MOL, MODE_RAW, WaveRNNParams
from rtvc_tpu_torch.models.layers import GRU, BatchNorm1d, Linear
from rtvc_tpu_torch.ops import audio as audio_ops
from rtvc_tpu_torch.ops import precision
from rtvc_tpu_torch.ops.wavernn_generate import (  # noqa: F401  (VOC_* are re-exported)
    HEAD_BETA,
    HEAD_CATEGORICAL,
    HEAD_MOL,
    LAYERS,
    VOC_FATCHORD,
    VOC_GENEING,
    VOC_RUNTIMERACER,
    wavernn_generate_core,
)
from rtvc_tpu_torch.utils.profiler import span

Tensor = torch.Tensor

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

    @property
    def head(self) -> str:
        """The sampling head of the sample loop (``ops.wavernn_generate``)."""
        if self.mode == MODE_MOL:
            return HEAD_MOL
        if self.mode == MODE_RAW and self.variant == VOC_GENEING:
            return HEAD_BETA
        return HEAD_CATEGORICAL


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
    """The upsampler, the input layer ``I``, and the variant's GRUs of
    rnn_dims and FCs under the reference's names: fatchord ``rnn1``,
    ``rnn2``, ``fc1``-``fc3``; geneing ``rnn1``, ``fc1``, ``fc3``;
    runtimeracer ``rnn1``-``rnn4``, ``fc1``-``fc5``. A layer that
    ``ops.wavernn_generate.LAYERS`` marks ``aux`` takes an aux split of the
    conditioning beside its input; the last FC gives the head's inputs."""

    def __init__(self, d: WaveRNNDims, device=None):
        super().__init__()
        if d.variant not in LAYERS:
            raise ValueError(f"Unknown WaveRNN variant {d.variant}")
        self.dims = d
        R, Fd, A = d.rnn_dims, d.fc_dims, d.aux_dims
        layers = LAYERS[d.variant]
        self.upsample = UpsampleNetwork(d, device=device)
        self.I = Linear(d.feat_dims + A, R, device=device)
        for rnn in layers.rnns:
            setattr(self, rnn.name, GRU(R + A if rnn.aux else R, R, device=device))
        n_in = R
        for k, fc in enumerate(layers.fcs):
            n_out = d.n_classes if k == len(layers.fcs) - 1 else Fd
            setattr(self, fc.name, Linear(n_in + A if fc.aux else n_in, n_out, device=device))
            n_in = n_out


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


def _aux_splits(d: WaveRNNDims, aux: Tensor) -> List[Tensor]:
    """The aux conditioning cut into the variant's equal splits: the first
    goes to ``I``, the others to the layers marked ``aux``, in order."""
    A = d.aux_dims
    return [aux[:, :, A * i:A * (i + 1)] for i in range(d.n_aux_splits)]


def wavernn_forward(model: WaveRNN, d: WaveRNNDims, x: Tensor, mels: Tensor
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Teacher-forced forward of any variant: x (B, T) previous samples in
    [-1, 1], mels (B, n_mels, T / hop + 2·pad) → (head output
    (B, T, n_classes), new_stats) with the BatchNorms on batch statistics
    (``rtvc_tpu/models/wavernn.py:wavernn_forward``). geneing in BITS mode
    returns log-probabilities (its reference forward ends in a
    log-softmax); every other cell returns the last FC's output."""
    layers = LAYERS[d.variant]
    mels_up, aux, new_stats = upsample_forward(model, d, mels, train=True)
    splits = _aux_splits(d, aux)
    rest = iter(splits[1:])
    h = model.I(torch.cat([x[:, :, None], mels_up, splits[0][:, :, :-1]], dim=2))
    for rnn in layers.rnns:
        inp = torch.cat([h, next(rest)], dim=2) if rnn.aux else h
        h = getattr(model, rnn.name).sequence(inp) + h
    for fc in layers.fcs:
        inp = torch.cat([h, next(rest)], dim=2) if fc.aux else h
        h = getattr(model, fc.name)(inp)
        if fc.relu:
            h = torch.relu(h)
    if d.variant == VOC_GENEING and d.mode == MODE_BITS:
        h = F.log_softmax(h.float(), dim=-1)
    return h, new_stats


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
    per-step streams the sample loop reads, each (B, T, width). A layer that
    takes an aux split gets the product of the split with the aux columns
    of its input matrix, with its input-side bias folded in."""
    A = d.aux_dims
    layers = LAYERS[d.variant]
    splits = _aux_splits(d, aux)
    rest = iter(splits[1:])
    w_I = model.I.weight  # (R, 1 + feat + A - 1): column 0 is the previous sample
    cond = torch.cat([mels_up, splits[0][:, :, :-1]], dim=2)
    pre = {"i_cond": cond @ w_I[:, 1:].t() + model.I.bias}
    for rnn in layers.rnns:
        if rnn.aux:
            g = getattr(model, rnn.name)
            pre[f"{rnn.name}_aux"] = next(rest) @ g.weight_ih_l0[:, -A:].t() + g.bias_ih_l0
    for fc in layers.fcs:
        if fc.aux:
            lin = getattr(model, fc.name)
            pre[f"{fc.name}_aux"] = next(rest) @ lin.weight[:, -A:].t() + lin.bias
    return pre


def step_weights(model: WaveRNN, d: WaveRNNDims) -> Dict[str, Tensor]:
    """The weights the sample loop reads every step, contiguous, torch
    layout (out, in). Inputs that concatenate the state with an aux split
    keep only the state columns; the aux columns went into the streams."""
    A = d.aux_dims
    layers = LAYERS[d.variant]
    w: Dict[str, Tensor] = {"i_col": model.I.weight[:, 0]}
    for rnn in layers.rnns:
        g = getattr(model, rnn.name)
        if rnn.aux:
            w[f"{rnn.name}_wx"] = g.weight_ih_l0[:, :-A]
        else:
            w[f"{rnn.name}_wih"] = g.weight_ih_l0
            w[f"{rnn.name}_bih"] = g.bias_ih_l0
        w[f"{rnn.name}_whh"] = g.weight_hh_l0
        w[f"{rnn.name}_bhh"] = g.bias_hh_l0
    for fc in layers.fcs:
        lin = getattr(model, fc.name)
        if fc.aux:
            w[f"{fc.name}_wx"] = lin.weight[:, :-A]
        else:
            w[f"{fc.name}_w"] = lin.weight
            w[f"{fc.name}_b"] = lin.bias
    return {k: v.detach().contiguous() for k, v in w.items()}


def generate_core(model: WaveRNN, d: WaveRNNDims, mels_up: Tensor, aux: Tensor,
                  seed: int, argmax: bool = False, compute_dtype=None,
                  stream_dtype=None) -> Tensor:
    """Autoregressive sample loop over upsampled conditioning (B, T, ·) →
    f32 samples (B, T) in [-1, 1]. ``argmax=True`` is the deterministic
    (greedy) test hook: the most likely class, the most likely mixture
    component's clipped mean, or the beta's mode (its mean where it has
    none). The f32 streams are cast to ``stream_dtype`` and the step weights
    to ``compute_dtype`` once a call, before the launch (f32 for None)."""
    sdt, cdt = precision.resolve(stream_dtype), precision.resolve(compute_dtype)
    with span("rtvc.vocoder.prepare"):
        streams = {k: v.to(sdt).contiguous()
                   for k, v in hoist_aux(model, d, mels_up, aux).items()}
        weights = {k: v.to(cdt) for k, v in step_weights(model, d).items()}
    return wavernn_generate_core(weights, streams, seed, argmax, variant=d.variant, head=d.head)


def _check_mels(d: WaveRNNDims, n_frames: int, n_mels: int) -> None:
    if n_frames < 2:
        raise ValueError(f"Need at least 2 mel frames to generate audio, got {n_frames}")
    if n_mels != d.feat_dims:
        raise ValueError(f"Expected {d.feat_dims} mel bins, got {n_mels} — "
                         f"is the mel transposed?")


def _decode(d: WaveRNNDims, output: Tensor, mu_law: bool, apply_preemphasis: bool) -> Tensor:
    """Unfolded samples → waveform samples: mu-law decode, de-emphasis."""
    if mu_law:
        output = audio_ops.decode_mu_law(output, d.n_classes, from_labels=False)
    if apply_preemphasis:
        output = audio_ops.de_emphasis(output, 0.97)
    return output


def _finish(d: WaveRNNDims, output: Tensor, wave_len: int, fade_out: bool) -> np.ndarray:
    """A decoded waveform → the utterance's: trim to ``wave_len``, fade-out
    over the last 20 hops."""
    output = output[:wave_len].cpu().double().numpy().copy()
    if fade_out:
        fade_len = min(20 * d.hop_length, len(output))
        output[-fade_len:] *= np.linspace(1.0, 0.0, fade_len)
    return output


@torch.no_grad()
def generate_pipeline(model: WaveRNN, d: WaveRNNDims, mels: Tensor, seed: int,
                      batched: bool = True, target: int = 6000, overlap: int = 1000,
                      mu_law: bool = True, apply_preemphasis: bool = True,
                      argmax: bool = False, compute_dtype=None,
                      stream_dtype=None) -> Tensor:
    """The generate path on the model's device, as the JAX package's
    ``_generate_pipeline``: mels (1, n_mels, n) → pad → upsample → fold → AR
    loop (at ``compute_dtype`` / ``stream_dtype``, :func:`generate_core`) →
    cross-fade/unfold → mu-law decode (RAW only) → de-emphasis. The samples
    stay on the device, untrimmed: the first (n - 1)·hop are the
    waveform's."""
    mu_law = mu_law if d.mode == MODE_RAW else False
    with span("rtvc.vocoder.upsample"):
        mels = F.pad(mels, (d.pad, d.pad))
        mels_up, aux, _ = upsample_forward(model, d, mels)
    if batched:
        with span("rtvc.vocoder.fold"):
            mels_up, _ = fold_with_overlap(mels_up, target, overlap)
            aux, _ = fold_with_overlap(aux, target, overlap)
    samples = generate_core(model, d, mels_up, aux, seed, argmax, compute_dtype, stream_dtype)
    with span("rtvc.vocoder.unfold"):
        output = xfade_and_unfold(samples, target, overlap) if batched else samples[0]
        return _decode(d, output, mu_law, apply_preemphasis)


@torch.no_grad()
def wavernn_generate(model: WaveRNN, d: WaveRNNDims, mels, seed: int,
                     batched: bool = True, target: int = 6000,
                     overlap: int = 1000, mu_law: bool = True,
                     apply_preemphasis: bool = True, argmax: bool = False,
                     fade_out: bool = True, compute_dtype=None,
                     stream_dtype=None) -> np.ndarray:
    """pad → upsample → fold → AR loop → cross-fade/unfold → mu-law decode →
    de-emphasis → fade-out. ``mels`` (n_mels, n) or (1, n_mels, n); returns
    a float64 numpy waveform of (n - 1)·hop samples. ``mu_law`` applies to
    the RAW mode only: the BITS and MOL heads emit linear samples.
    ``compute_dtype`` / ``stream_dtype``: :func:`generate_core`.

    The frame count is padded to a 64-frame bucket (:func:`bucket_pad`) and
    the pad trimmed off at the end."""
    dev = model.I.weight.device
    with span("rtvc.vocoder.upsample"):
        mels = torch.as_tensor(np.asarray(mels, dtype=np.float32), device=dev)
        if mels.ndim == 2:
            mels = mels[None]
        n_frames = mels.shape[-1]
        _check_mels(d, n_frames, mels.shape[1])
        mels = bucket_pad(mels)
    output = generate_pipeline(model, d, mels, seed, batched, target, overlap,
                               mu_law, apply_preemphasis, argmax, compute_dtype, stream_dtype)
    with span("rtvc.vocoder.finish"):
        return _finish(d, output, (n_frames - 1) * d.hop_length, fade_out)


def bucket_pad(mels: Tensor) -> Tensor:
    """(·, n_mels, n) → the frame count padded to a multiple of 64 with -1.0
    (the JAX package's compile bucket, kept for parity: the pad changes the
    upsampled tail and the fold count)."""
    n_frames = mels.shape[-1]
    return F.pad(mels, (0, -(-n_frames // _FRAME_BUCKET) * _FRAME_BUCKET - n_frames), value=-1.0)


@torch.no_grad()
def wavernn_generate_batch(model: WaveRNN, d: WaveRNNDims, mels_list: Sequence, seed: int,
                           target: int = 1000, overlap: int = 400, mu_law: bool = True,
                           apply_preemphasis: bool = True, argmax: bool = False,
                           compute_dtype=None, stream_dtype=None) -> List[np.ndarray]:
    """Vocode several utterances in one launch of the sample loop: all are
    padded with -1.0 to one 64-frame bucket (the longest's), each is folded
    with the same geometry, and every utterance's folds share the batch
    axis, so short utterances ride along with long ones.

    ``mels_list``: (n_mels, T_i) normalised mels. Returns one float64
    waveform per utterance, trimmed to its own (T_i - 1)·hop samples, with
    the fade-out. ``compute_dtype`` / ``stream_dtype``: :func:`generate_core`."""
    mu_law = mu_law if d.mode == MODE_RAW else False
    dev = model.I.weight.device
    frames = [int(np.shape(m)[-1]) for m in mels_list]
    for m, n in zip(mels_list, frames):
        _check_mels(d, n, np.shape(m)[-2])
    with span("rtvc.vocoder.upsample"):
        bucket = -(-max(frames) // _FRAME_BUCKET) * _FRAME_BUCKET
        stack = np.full((len(frames), d.feat_dims, bucket), -1.0, np.float32)
        for i, m in enumerate(mels_list):
            stack[i, :, :frames[i]] = np.asarray(m, np.float32)
        mels = F.pad(torch.as_tensor(stack, device=dev), (d.pad, d.pad))
        mels_up, aux, _ = upsample_forward(model, d, mels)
    with span("rtvc.vocoder.fold"):
        folded = [(fold_with_overlap(mels_up[i:i + 1], target, overlap)[0],
                   fold_with_overlap(aux[i:i + 1], target, overlap)[0])
                  for i in range(len(frames))]
        n_folds = folded[0][0].shape[0]
        mels_up = torch.cat([m for m, _ in folded])
        aux = torch.cat([a for _, a in folded])
    samples = generate_core(model, d, mels_up, aux, seed, argmax, compute_dtype, stream_dtype)
    with span("rtvc.vocoder.unfold"):
        outputs = [_decode(d, xfade_and_unfold(samples[i * n_folds:(i + 1) * n_folds],
                                               target, overlap), mu_law, apply_preemphasis)
                   for i in range(len(frames))]
    with span("rtvc.vocoder.finish"):
        return [_finish(d, out, (n - 1) * d.hop_length, fade_out=True)
                for out, n in zip(outputs, frames)]
