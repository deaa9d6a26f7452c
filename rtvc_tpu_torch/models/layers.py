"""Shared layers (counterpart of ``rtvc_tpu/models/layers.py``).

Sequence tensors are (B, T, C) at every public function, as in the JAX
package, so the two compare like with like; convolutions transpose to
PyTorch's (B, C, T) inside. Parameters carry the reference's torch
state-dict names (``weight_ih_l0``, ``conv1d_bank.3.bnorm.running_var``, ...).

Recurrences: :class:`LSTM` hoists the input projection for the whole
sequence into one ``torch.matmul`` and runs the recurrence through K3, whose
kernels keep W_hh in the shared memory of the SMs for all time steps
(``ops.lstm_seq``): the inference kernel (``lstm_seq``) under no grad, and
``LSTMSeqFn`` (forward with residuals, backward kernel) when a gradient is
needed. On a card the hidden width is bounded by what its shared memory
holds (``ops.lstm_seq.plan``: 1320 on an H100). :class:`GRU` does the same
through K4 (``ops.gru_seq``: ``gru_seq_fwd`` under no grad, ``GRUSeqFn``
with a gradient; 1056 on an H100): the Tacotron CBHGs' BiGRUs at hidden
width 64, where the JAX package scans because its TPU kernel wants a
multiple of 128, ForwardTacotron's five BiGRUs, and the WaveRNN trainer's
GRUs. :func:`length_regulate` is the non-autoregressive synthesizers'
length regulator.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rtvc_tpu_torch.ops.gru_seq import GRUSeqFn, gru_seq_fwd
from rtvc_tpu_torch.ops.lstm_seq import LSTMSeqFn, lstm_seq

Tensor = torch.Tensor

Linear = nn.Linear
Embedding = nn.Embedding


def always_dropout(x: Tensor, p: float, generator: Optional[torch.Generator]) -> Tensor:
    """Always-on dropout drawn from an explicit generator: keep with
    probability 1 - p and scale kept units by 1 / (1 - p)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Recurrent cells (torch layout: LSTM gates [i, f, g, o], GRU gates [r, z, n])
# ---------------------------------------------------------------------------


def lstm_cell_step(cell: nn.LSTMCell, x: Tensor, h: Tensor, c: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """One torch-layout LSTMCell step."""
    gates = (x @ cell.weight_ih.t() + h @ cell.weight_hh.t()
             + cell.bias_ih + cell.bias_hh)
    i, f, g, o = gates.split(cell.hidden_size, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def gru_step(xg_t: Tensor, h: Tensor, w_hh: Tensor, b_hh: Tensor) -> Tensor:
    """One GRU step given the input projection ``xg_t`` (b_ih included).
    torch semantics: b_hn sits inside the reset-gate product."""
    H = h.shape[-1]
    hg = h @ w_hh.t() + b_hh
    r = torch.sigmoid(xg_t[..., :H] + hg[..., :H])
    z = torch.sigmoid(xg_t[..., H:2 * H] + hg[..., H:2 * H])
    n = torch.tanh(xg_t[..., 2 * H:] + r * hg[..., 2 * H:])
    return (1.0 - z) * n + z * h


class LSTM(nn.Module):
    """Multi-layer unidirectional LSTM over (B, T, I) → (B, T, H), with
    ``torch.nn.LSTM(batch_first=True)``'s parameter names."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        H = hidden_size
        for k in range(num_layers):
            I = input_size if k == 0 else H
            for name, shape in (("weight_ih", (4 * H, I)), ("weight_hh", (4 * H, H)),
                                ("bias_ih", (4 * H,)), ("bias_hh", (4 * H,))):
                self.register_parameter(
                    f"{name}_l{k}", nn.Parameter(torch.empty(shape, device=device)))

    def forward(self, x: Tensor) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
        """Zero initial state → (ys, (h_T, c_T) stacked over layers)."""
        h0 = x.new_zeros((x.shape[0], self.hidden_size))
        seq = LSTMSeqFn.apply if torch.is_grad_enabled() else lstm_seq
        h_last, c_last = [], []
        for k in range(self.num_layers):
            w_ih = getattr(self, f"weight_ih_l{k}")
            w_hh = getattr(self, f"weight_hh_l{k}")
            b = getattr(self, f"bias_ih_l{k}") + getattr(self, f"bias_hh_l{k}")
            xg = x @ w_ih.t() + b  # (B, T, 4H), hoisted out of the recurrence
            x, h_T, c_T = seq(xg.contiguous(), w_hh.contiguous(), h0, h0)
            h_last.append(h_T)
            c_last.append(c_T)
        return x, (torch.stack(h_last), torch.stack(c_last))


class GRU(nn.Module):
    """Single-layer (optionally bidirectional) GRU over (B, T, I) with
    ``torch.nn.GRU(batch_first=True)``'s parameter names. Each direction is
    one input projection for the whole sequence and one K4 sequence from a
    zero state.

    ``lengths`` (B,) makes the recurrence length-exact: pad frames neither
    advance the carry nor emit output, so the backward direction starts from
    a zero state at each sequence's true last frame. K4 knows no mask: pad
    frames come after a row's valid ones, so the forward direction runs over
    all T frames and zeroes the pads' outputs; the backward direction reverses
    each row's valid frames in place (frame t < len to len - 1 - t, pads
    where they are) with one gather before the kernel and the same gather
    after it.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 bidirectional: bool = False, device=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.bidirectional = bidirectional
        H = hidden_size
        for sfx in ("", "_reverse") if bidirectional else ("",):
            for name, shape in (("weight_ih", (3 * H, input_size)),
                                ("weight_hh", (3 * H, H)),
                                ("bias_ih", (3 * H,)), ("bias_hh", (3 * H,))):
                self.register_parameter(
                    f"{name}_l0{sfx}", nn.Parameter(torch.empty(shape, device=device)))

    def sequence(self, seq: Tensor, sfx: str = "") -> Tensor:
        """One direction over (B, T, I) from a zero state → ys (B, T, H):
        the hoisted input product, then K4 (its plain version for a CPU
        tensor)."""
        xg = (seq @ getattr(self, f"weight_ih_l0{sfx}").t()
              + getattr(self, f"bias_ih_l0{sfx}")).contiguous()
        w_hh = getattr(self, f"weight_hh_l0{sfx}").contiguous()
        b_hh = getattr(self, f"bias_hh_l0{sfx}").contiguous()
        if torch.is_grad_enabled():
            return GRUSeqFn.apply(xg, w_hh, b_hh)
        return gru_seq_fwd(xg, w_hh, b_hh)[0]

    def forward(self, x: Tensor, lengths: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        """Zero initial state → (ys, h_T); bidirectional ys concatenate the
        forward and backward outputs, h_T stacks their final states."""
        if lengths is None:
            fwd = self.sequence(x)
            if not self.bidirectional:
                return fwd, fwd[:, -1]
            bwd = self.sequence(x.flip(1), "_reverse")
            return torch.cat([fwd, bwd.flip(1)], dim=-1), torch.stack([fwd[:, -1], bwd[:, -1]])
        lengths = lengths.to(device=x.device, dtype=torch.long)
        t = torch.arange(x.shape[1], device=x.device)[None, :]
        mask = (t < lengths[:, None]).to(x.dtype)[..., None]
        last = (lengths - 1).clamp(min=0)[:, None, None].expand(-1, 1, self.hidden_size)
        has_frames = (lengths > 0).to(x.dtype)[:, None]
        fwd = self.sequence(x) * mask
        h_fwd = fwd.gather(1, last)[:, 0] * has_frames
        if not self.bidirectional:
            return fwd, h_fwd
        # its own inverse: valid frames reversed per row, pads in place
        rev = torch.where(t < lengths[:, None], lengths[:, None] - 1 - t, t)[..., None]
        bwd = self.sequence(x.gather(1, rev.expand(-1, -1, x.shape[2])), "_reverse")
        h_bwd = bwd.gather(1, last)[:, 0] * has_frames
        bwd = bwd.gather(1, rev.expand(-1, -1, self.hidden_size)) * mask
        return torch.cat([fwd, bwd], dim=-1), torch.stack([h_fwd, h_bwd])


# ---------------------------------------------------------------------------
# Convolution / normalisation
# ---------------------------------------------------------------------------


class Conv1d(nn.Conv1d):
    """``torch.nn.Conv1d`` applied to (B, T, C) sequences."""

    def forward(self, x: Tensor) -> Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class BatchNorm1d(nn.Module):
    """BatchNorm over the channel (last) axis of (B, T, C), with running
    statistics as buffers. ``forward`` normalises with the running
    statistics; ``forward_train`` with the batch's, and returns the updated
    running statistics instead of writing them (the training step installs
    them), as ``rtvc_tpu/models/wavernn.py:_bn`` does."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean", torch.empty(features, device=device))
        self.register_buffer("running_var", torch.empty(features, device=device))

    def forward(self, x: Tensor) -> Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * inv * self.weight + self.bias

    def forward_train(self, x: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Batch statistics in f32 → (y, {"running_mean", "running_var"})
        with momentum 0.1; the running variance takes the unbiased batch
        variance n/(n-1)."""
        xf = x.float()
        axes = tuple(range(x.ndim - 1))
        mean = xf.mean(dim=axes)
        var = xf.var(dim=axes, unbiased=False)
        n = x.numel() / x.shape[-1]
        m = 0.1
        with torch.no_grad():
            new = {"running_mean": (1 - m) * self.running_mean + m * mean,
                   "running_var": (1 - m) * self.running_var + m * var * n / max(n - 1, 1)}
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype), new


# ---------------------------------------------------------------------------
# Tacotron building blocks
# ---------------------------------------------------------------------------


class HighwayNetwork(nn.Module):
    """y = g·relu(W1 x) + (1-g)·x."""

    def __init__(self, size: int, device=None):
        super().__init__()
        self.W1 = Linear(size, size, device=device)
        self.W2 = Linear(size, size, device=device)

    def forward(self, x: Tensor) -> Tensor:
        g = torch.sigmoid(self.W2(x))
        return g * torch.relu(self.W1(x)) + (1.0 - g) * x


class PreNet(nn.Module):
    """Two ReLU layers, each followed by dropout that stays on at inference
    (the Tacotron 2 convention). ``dropout=False`` is the deterministic test
    hook."""

    def __init__(self, in_dims: int, fc1_dims: int = 256, fc2_dims: int = 128,
                 p: float = 0.5, device=None):
        super().__init__()
        self.p = p
        self.fc1 = Linear(in_dims, fc1_dims, device=device)
        self.fc2 = Linear(fc1_dims, fc2_dims, device=device)

    def forward(self, x: Tensor, generator: Optional[torch.Generator] = None,
                dropout: bool = True) -> Tensor:
        x = torch.relu(self.fc1(x))
        if dropout:
            x = always_dropout(x, self.p, generator)
        x = torch.relu(self.fc2(x))
        if dropout:
            x = always_dropout(x, self.p, generator)
        return x


class BatchNormConv(nn.Module):
    """Conv1d (no bias, torch ``padding=k//2``) → optional ReLU → BatchNorm.
    An even kernel yields one extra frame; callers trim it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 relu: bool = True, device=None):
        super().__init__()
        self.relu = relu
        self.conv = Conv1d(in_channels, out_channels, kernel_size,
                           padding=kernel_size // 2, bias=False, device=device)
        self.bnorm = BatchNorm1d(out_channels, device=device)

    def forward(self, x: Tensor, new_stats: Optional[Dict[str, Tensor]] = None,
                prefix: str = "") -> Tensor:
        """With ``new_stats`` (training) the BatchNorm uses the batch's
        statistics and leaves its new running statistics there, under
        ``prefix`` + the buffers' names."""
        x = self.conv(x)
        if self.relu:
            x = torch.relu(x)
        if new_stats is None:
            return self.bnorm(x)
        x, stats = self.bnorm.forward_train(x)
        new_stats.update({f"{prefix}bnorm.{k}": v for k, v in stats.items()})
        return x


class CBHG(nn.Module):
    """Conv bank + highways + BiGRU on (B, T, C). Two variants, as in the
    JAX package:

    * Tacotron's (the default): BiGRU hidden = channels // 2, no dropout,
      ``pre_highway`` only when the projection width differs from the
      highway width;
    * ForwardTacotron's (``forward_variant=True``): BiGRU hidden = channels
      (output 2 · channels), ``pre_highway`` always, and dropout of rate
      ``dropout`` after the max-pool and after ``conv_project1``, in
      training only (``new_stats`` given)."""

    def __init__(self, K: int, in_channels: int, channels: int,
                 proj_channels: Sequence[int], num_highways: int,
                 forward_variant: bool = False, dropout: float = 0.5, device=None):
        super().__init__()
        self.dropout = dropout if forward_variant else 0.0
        self.conv1d_bank = nn.ModuleList(
            BatchNormConv(in_channels, channels, k, device=device)
            for k in range(1, K + 1))
        self.conv_project1 = BatchNormConv(K * channels, proj_channels[0], 3,
                                           device=device)
        self.conv_project2 = BatchNormConv(proj_channels[0], proj_channels[1], 3,
                                           relu=False, device=device)
        if forward_variant or proj_channels[-1] != channels:
            self.pre_highway = Linear(proj_channels[-1], channels, bias=False,
                                      device=device)
        else:
            self.pre_highway = None
        self.highways = nn.ModuleList(
            HighwayNetwork(channels, device=device) for _ in range(num_highways))
        self.rnn = GRU(channels, channels if forward_variant else channels // 2,
                       bidirectional=True, device=device)

    def forward(self, x: Tensor, lengths: Optional[Tensor] = None,
                new_stats: Optional[Dict[str, Tensor]] = None, prefix: str = "",
                generator: Optional[torch.Generator] = None) -> Tensor:
        # ``lengths`` (B,): every stage re-zeroes pad frames and the BiGRU
        # masks its carries, so padded input gives each sequence's unpadded
        # result. ``new_stats`` (training): every BatchNorm uses the batch's
        # statistics and leaves its new running statistics there under
        # ``prefix`` + the buffers' names; the step installs them. The
        # forward variant's dropout draws from ``generator`` then.
        if lengths is not None:
            fmask = (torch.arange(x.shape[1], device=x.device)[None, :]
                     < lengths[:, None]).to(x.dtype)[..., None]

            def remask(v):
                return v * fmask
        else:
            def remask(v):
                return v

        def drop(v):
            if new_stats is None or not self.dropout:
                return v
            return always_dropout(v, self.dropout, generator)

        x = remask(x)
        residual = x
        seq_len = x.shape[1]
        bank = torch.cat(
            [remask(conv(x, new_stats, f"{prefix}conv1d_bank.{i}.")[:, :seq_len])
             for i, conv in enumerate(self.conv1d_bank)], dim=-1)
        # MaxPool1d(2, stride 1, padding 1) trimmed to seq_len: max over [t-1, t]
        pooled = F.max_pool1d(bank.transpose(1, 2), 2, stride=1, padding=1)
        pooled = drop(remask(pooled[:, :, :seq_len].transpose(1, 2)))
        x = drop(remask(self.conv_project1(pooled, new_stats, f"{prefix}conv_project1.")))
        x = remask(self.conv_project2(x, new_stats, f"{prefix}conv_project2."))
        x = x + residual
        if self.pre_highway is not None:
            x = self.pre_highway(x)
        for highway in self.highways:
            x = highway(x)
        out, _ = self.rnn(remask(x), lengths=lengths)
        return out


def length_regulate(x: Tensor, durations: Tensor, max_len: int) -> Tensor:
    """Repeat each step of x (B, T, C) by its duration (B, T), integers
    ≥ 0, into (B, max_len, C): frame l takes the step whose cumulative
    duration first exceeds l (a search over the cumulative durations).
    Frames past a row's total take step T − 1; the caller masks or zeroes
    them."""
    cum = durations.to(device=x.device, dtype=torch.long).cumsum(1)
    positions = torch.arange(max_len, device=x.device).expand(x.shape[0], -1).contiguous()
    idx = torch.searchsorted(cum, positions, right=True).clamp(max=x.shape[1] - 1)
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[2]))
