"""Plain PyTorch building blocks of the reference models.

Every block reads its parameters from one flat ``dict`` of tensors under the
models' published state-dict names (``W``) and a prefix. Every matrix product
and convolution goes through :class:`Prec`: at ``"f32"`` it is a float32
product with TF32 off; at ``"tf32"`` both operands are first rounded to
TF32's 10-bit mantissa and then multiplied in float32, which is what a
tensor core does with TF32 inputs (round the inputs, accumulate in f32).
The TF32 mode is the comparison's control: the nearest precision below the
float32 that the configurations state.

Recurrences are step loops; nothing here calls a fused kernel of the
program, and nothing imports it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Weights = Dict[str, Tensor]


def strict_f32() -> None:
    """Float32 products everywhere: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: Tensor) -> Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), to nearest,
    ties to even; the result is float32. Under autograd the gradient passes
    through the rounding unchanged (the backward's products take the
    rounded operands, not rounded cotangents)."""
    bits = x.detach().float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


class Prec:
    """The precision of every product: ``"f32"`` or ``"tf32"``."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self._rounded: Dict[int, Tensor] = {}
        strict_f32()

    def _r(self, x: Tensor) -> Tensor:
        return round_tf32(x) if self.mode == "tf32" else x

    def weight(self, w: Tensor) -> Tensor:
        """A weight as the products take it: at TF32 rounded once and kept
        (weights without a gradient do not change during a check)."""
        if self.mode != "tf32" or w.requires_grad:
            return self._r(w)
        key = id(w)
        if key not in self._rounded:
            self._rounded[key] = (w, round_tf32(w))
        return self._rounded[key][1]

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        """``a @ b`` (broadcasting as ``torch.matmul``)."""
        return torch.matmul(self._r(a), self._r(b))

    def linear(self, x: Tensor, w: Tensor, b: Optional[Tensor] = None) -> Tensor:
        if b is not None and x.dim() == 2:
            return torch.addmm(b, self._r(x), self.weight(w).t())
        y = torch.matmul(self._r(x), self.weight(w).t())
        return y if b is None else y + b

    def conv1d(self, x: Tensor, w: Tensor, b: Optional[Tensor] = None, padding: int = 0
               ) -> Tensor:
        """x (B, C, T) → (B, O, T')."""
        return F.conv1d(self._r(x), self._r(w), b, padding=padding)

    def conv2d(self, x: Tensor, w: Tensor, padding=0) -> Tensor:
        return F.conv2d(self._r(x), self._r(w), padding=padding)


# ---------------------------------------------------------------------------
# Layers over (B, T, C) sequences
# ---------------------------------------------------------------------------


def batch_norm_eval(W: Weights, p: str, x: Tensor, eps: float = 1e-5) -> Tensor:
    """BatchNorm over the last axis with the running statistics."""
    inv = torch.rsqrt(W[p + "running_var"] + eps)
    return (x - W[p + "running_mean"]) * inv * W[p + "weight"] + W[p + "bias"]


def batch_norm_train(W: Weights, p: str, x: Tensor, stats: Dict[str, Tensor],
                     eps: float = 1e-5, momentum: float = 0.1) -> Tensor:
    """BatchNorm over the last axis with the batch's statistics; the new
    running statistics (unbiased variance) go into ``stats`` under ``p``."""
    axes = tuple(range(x.ndim - 1))
    mean = x.mean(dim=axes)
    var = x.var(dim=axes, unbiased=False)
    n = x.numel() / x.shape[-1]
    with torch.no_grad():
        stats[p + "running_mean"] = (1 - momentum) * W[p + "running_mean"] + momentum * mean
        stats[p + "running_var"] = ((1 - momentum) * W[p + "running_var"]
                                    + momentum * var * n / max(n - 1, 1))
    return (x - mean) * torch.rsqrt(var + eps) * W[p + "weight"] + W[p + "bias"]


def conv_seq(P: Prec, W: Weights, p: str, x: Tensor, padding: int, bias: bool = True
             ) -> Tensor:
    """Conv1d on a (B, T, C) sequence → (B, T', O)."""
    y = P.conv1d(x.transpose(1, 2), W[p + "weight"], W.get(p + "bias") if bias else None,
                 padding)
    return y.transpose(1, 2)


def dropout(x: Tensor, p: float, u: Tensor) -> Tensor:
    """Dropout from uniform draws ``u`` of x's shape: keep where u >= p."""
    return torch.where(u >= p, x / (1.0 - p), torch.zeros_like(x))


def gru_cell(P: Prec, xg: Tensor, h: Tensor, w_hh: Tensor, b_hh: Tensor) -> Tensor:
    """One GRU step (gates [r, z, n], b_hn inside the reset product) given the
    input projection ``xg`` (b_ih included): h' = (1 - z)·n + z·h."""
    H = h.shape[-1]
    hg = P.linear(h, w_hh, b_hh)
    rz = torch.sigmoid(xg[..., :2 * H] + hg[..., :2 * H])
    n = torch.tanh(torch.addcmul(xg[..., 2 * H:], rz[..., :H], hg[..., 2 * H:]))
    return torch.lerp(n, h, rz[..., H:])


def lstm_cell(P: Prec, xg: Tensor, h: Tensor, c: Tensor, w_hh: Tensor):
    """One LSTM step (gates [i, f, g, o]) given ``xg`` (B, 4H) with both
    biases: c' = σ(f)·c + σ(i)·tanh(g), h' = σ(o)·tanh(c')."""
    H = h.shape[-1]
    g = torch.addmm(xg, P._r(h), P.weight(w_hh).t())
    s = torch.sigmoid(g)
    c = torch.addcmul(s[..., H:2 * H] * c, s[..., :H], torch.tanh(g[..., 2 * H:3 * H]))
    return s[..., 3 * H:] * torch.tanh(c), c


def gru_seq(P: Prec, W: Weights, p: str, sfx: str, x: Tensor) -> Tensor:
    """One GRU direction over (B, T, I) from a zero state → (B, T, H)."""
    xg = P.linear(x, W[f"{p}weight_ih_l0{sfx}"], W[f"{p}bias_ih_l0{sfx}"])
    w_hh, b_hh = W[f"{p}weight_hh_l0{sfx}"], W[f"{p}bias_hh_l0{sfx}"]
    h = x.new_zeros((x.shape[0], w_hh.shape[1]))
    out = []
    for t in range(x.shape[1]):
        h = gru_cell(P, xg[:, t], h, w_hh, b_hh)
        out.append(h)
    return torch.stack(out, dim=1)


def reverse_valid(x: Tensor, lengths: Tensor) -> Tensor:
    """Each row's first ``lengths[b]`` frames reversed, the rest in place."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    idx = torch.where(t < lengths[:, None], lengths[:, None] - 1 - t, t)
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[2]))


def bigru(P: Prec, W: Weights, p: str, x: Tensor, lengths: Optional[Tensor] = None
          ) -> Tensor:
    """Bidirectional GRU → (B, T, 2H). With ``lengths`` the backward
    direction starts at each row's last valid frame and pad frames give 0."""
    if lengths is None:
        fwd = gru_seq(P, W, p, "", x)
        bwd = gru_seq(P, W, p, "_reverse", x.flip(1)).flip(1)
        return torch.cat([fwd, bwd], dim=-1)
    lengths = lengths.to(device=x.device, dtype=torch.long)
    mask = (torch.arange(x.shape[1], device=x.device)[None, :]
            < lengths[:, None]).to(x.dtype)[..., None]
    fwd = gru_seq(P, W, p, "", x) * mask
    bwd = reverse_valid(gru_seq(P, W, p, "_reverse", reverse_valid(x, lengths)), lengths)
    return torch.cat([fwd, bwd * mask], dim=-1)


def lstm_seq(P: Prec, W: Weights, p: str, sfx: str, x: Tensor) -> Tensor:
    """One LSTM direction over (B, T, I) from a zero state → (B, T, H)."""
    xg = P.linear(x, W[f"{p}weight_ih_l0{sfx}"], None) + (W[f"{p}bias_ih_l0{sfx}"]
                                                          + W[f"{p}bias_hh_l0{sfx}"])
    w_hh = W[f"{p}weight_hh_l0{sfx}"]
    h = x.new_zeros((x.shape[0], w_hh.shape[1]))
    c = torch.zeros_like(h)
    out = []
    for t in range(x.shape[1]):
        h, c = lstm_cell(P, xg[:, t], h, c, w_hh)
        out.append(h)
    return torch.stack(out, dim=1)


def highway(P: Prec, W: Weights, p: str, x: Tensor) -> Tensor:
    g = torch.sigmoid(P.linear(x, W[p + "W2.weight"], W[p + "W2.bias"]))
    return g * torch.relu(P.linear(x, W[p + "W1.weight"], W[p + "W1.bias"])) + (1.0 - g) * x


def cbhg(P: Prec, W: Weights, p: str, x: Tensor, K: int, num_highways: int,
         lengths: Optional[Tensor] = None, stats: Optional[Dict[str, Tensor]] = None
         ) -> Tensor:
    """Conv bank (k = 1..K, each conv → ReLU → BatchNorm), max-pool over
    [t-1, t], two projections (the second without ReLU), the residual, an
    optional pre-highway projection, highways, the BiGRU. With ``lengths``
    pad frames are zeroed after every stage and the BiGRU is length-exact.
    With ``stats`` the BatchNorms take the batch's statistics (training)."""
    if lengths is not None:
        fmask = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < lengths[:, None]).to(x.dtype)[..., None]
    else:
        fmask = None

    def remask(v):
        return v if fmask is None else v * fmask

    def bn_conv(q, v, k, relu=True):
        y = conv_seq(P, W, q + "conv.", v, k // 2, bias=False)
        if relu:
            y = torch.relu(y)
        if stats is None:
            return batch_norm_eval(W, q + "bnorm.", y)
        return batch_norm_train(W, q + "bnorm.", y, stats)

    x = remask(x)
    T = x.shape[1]
    bank = torch.cat([remask(bn_conv(f"{p}conv1d_bank.{k - 1}.", x, k)[:, :T])
                      for k in range(1, K + 1)], dim=-1)
    prev = torch.cat([bank[:, :1], bank[:, :-1]], dim=1)
    pooled = remask(torch.maximum(bank, prev))
    y = remask(bn_conv(p + "conv_project1.", pooled, 3))
    y = remask(bn_conv(p + "conv_project2.", y, 3, relu=False))
    y = y + x
    if p + "pre_highway.weight" in W:
        y = P.linear(y, W[p + "pre_highway.weight"])
    for i in range(num_highways):
        y = highway(P, W, f"{p}highways.{i}.", y)
    return bigru(P, W, p + "rnn.", remask(y), lengths)
