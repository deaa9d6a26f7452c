"""K3: an LSTM sequence over hoisted input gates, forward and backward.

Replaces ``rtvc_tpu/ops/pallas/lstm_train_kernel.py:lstm_seq_fused``. The
CUDA kernels are in ``csrc/lstm_seq.cu``. Each wrapper launches its kernel
for CUDA tensors and runs its plain PyTorch version for CPU tensors:

- ``lstm_seq``: the inference forward (no residuals);
- ``lstm_seq_fwd_train``: the forward that also returns the residuals the
  backward reads (the cell sequence and the activated gates);
- ``lstm_seq_bwd``: the reverse (dh, dc) chain → ``dxg``, ``dh0``, ``dc0``;
- ``LSTMSeqFn``: the two training halves as a ``torch.autograd.Function``;
  ``dW_hh = Σ_t h_{t-1}ᵀ · dxg_t`` is one matmul over the flattened (B·T)
  axis outside the kernels, as in the JAX package.

Gate order is torch's [i, f, g, o]; both biases are folded into ``xg``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from rtvc_tpu_torch import _build

Tensor = torch.Tensor


def _lstm_plain(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor, residuals: bool):
    H = w_hh.shape[1]
    w_t = w_hh.t()
    h, c = h0, c0
    ys, cs, gates = [], [], []
    for t in range(xg.shape[1]):
        i, f, g, o = (xg[:, t] + h @ w_t).split(H, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        if residuals:
            cs.append(c)
            gates.append(torch.cat([i, f, g, o], dim=-1))
    out = (torch.stack(ys, dim=1), h, c)
    if residuals:
        out += (torch.stack(cs, dim=1), torch.stack(gates, dim=1))
    return out


def lstm_seq_plain(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """xg (B, T, 4H) with both biases folded in, w_hh (4H, H) torch layout,
    h0/c0 (B, H) → (ys (B, T, H), h_T, c_T)."""
    return _lstm_plain(xg, w_hh, h0, c0, residuals=False)


def lstm_seq_fwd_train_plain(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor
                             ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """As :func:`lstm_seq_plain`, plus the residuals cs (B, T, H) and gates
    (B, T, 4H) = [i, f, g, o] after their nonlinearities."""
    return _lstm_plain(xg, w_hh, h0, c0, residuals=True)


def lstm_seq_bwd_plain(dys: Tensor, dhT: Tensor, dcT: Tensor, gates: Tensor,
                       cs: Tensor, c0: Tensor, w_hh: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """The reverse (dh, dc) chain (lstm_train_kernel.py:172-191): cotangents
    of ys (B, T, H), h_T and c_T, the forward's residuals, c0 and w_hh (4H, H)
    → (dxg (B, T, 4H), dh0, dc0). c_{t-1} is cs one step back, c0 at t = 0."""
    H = w_hh.shape[1]
    dh, dc = dhT, dcT
    dxg = []
    for t in range(dys.shape[1] - 1, -1, -1):
        i, f, g, o = gates[:, t].split(H, dim=-1)
        c = cs[:, t]
        c_prev = cs[:, t - 1] if t > 0 else c0
        tanhc = torch.tanh(c)
        dh = dys[:, t] + dh
        do = dh * tanhc * o * (1.0 - o)
        dc = dc + dh * o * (1.0 - tanhc * tanhc)
        di = dc * g * i * (1.0 - i)
        df = dc * c_prev * f * (1.0 - f)
        dg = dc * i * (1.0 - g * g)
        d = torch.cat([di, df, dg, do], dim=-1)
        dxg.append(d)
        dc = dc * f
        dh = d @ w_hh
    return torch.stack(dxg[::-1], dim=1), dh, dc


def _fwd_kernel(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor, residuals: bool):
    B, T, _ = xg.shape
    H = w_hh.shape[1]
    _build.check_tensors("lstm_seq", xg.device, xg=(xg, (B, T, 4 * H)),
                         w_hh=(w_hh, (4 * H, H)), h0=(h0, (B, H)), c0=(c0, (B, H)))
    lib = _build.library()
    empty = lambda *shape: torch.empty(shape, device=xg.device, dtype=torch.float32)  # noqa: E731
    ys, hT, cT = empty(B, T, H), empty(B, H), empty(B, H)
    cs, gates = (empty(B, T, H), empty(B, T, 4 * H)) if residuals else (None, None)
    err = lib.rtvc_lstm_seq_fwd(
        xg.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        ys.data_ptr(), hT.data_ptr(), cT.data_ptr(),
        cs.data_ptr() if residuals else None, gates.data_ptr() if residuals else None,
        B, T, H, _build.stream_handle(xg.device),
    )
    _build.check(err, "rtvc_lstm_seq_fwd")
    _build.launch_counts["lstm_seq"] += 1
    return (ys, hT, cT, cs, gates) if residuals else (ys, hT, cT)


def lstm_seq(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Same contract as :func:`lstm_seq_plain`; CUDA tensors go through the
    kernel (f32, contiguous), CPU tensors through the plain version."""
    if not xg.is_cuda:
        return lstm_seq_plain(xg, w_hh, h0, c0)
    return _fwd_kernel(xg, w_hh, h0, c0, residuals=False)


def lstm_seq_fwd_train(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Same contract as :func:`lstm_seq_fwd_train_plain`; CUDA tensors go
    through the kernel, CPU tensors through the plain version."""
    if not xg.is_cuda:
        return lstm_seq_fwd_train_plain(xg, w_hh, h0, c0)
    return _fwd_kernel(xg, w_hh, h0, c0, residuals=True)


def lstm_seq_bwd(dys: Tensor, dhT: Tensor, dcT: Tensor, gates: Tensor, cs: Tensor,
                 c0: Tensor, w_hh: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Same contract as :func:`lstm_seq_bwd_plain`; CUDA tensors go through
    the kernel, CPU tensors through the plain version."""
    if not dys.is_cuda:
        return lstm_seq_bwd_plain(dys, dhT, dcT, gates, cs, c0, w_hh)
    B, T, H = dys.shape
    w_hh_t = w_hh.t().contiguous()  # the kernel streams rows of W_hhᵀ
    _build.check_tensors("lstm_seq_bwd", dys.device, dys=(dys, (B, T, H)),
                         dhT=(dhT, (B, H)), dcT=(dcT, (B, H)),
                         gates=(gates, (B, T, 4 * H)), cs=(cs, (B, T, H)),
                         c0=(c0, (B, H)), w_hh_t=(w_hh_t, (H, 4 * H)))
    lib = _build.library()
    dxg = torch.empty((B, T, 4 * H), device=dys.device, dtype=torch.float32)
    dh0 = torch.empty((B, H), device=dys.device, dtype=torch.float32)
    dc0 = torch.empty((B, H), device=dys.device, dtype=torch.float32)
    err = lib.rtvc_lstm_seq_bwd(
        dys.data_ptr(), dhT.data_ptr(), dcT.data_ptr(), gates.data_ptr(), cs.data_ptr(),
        c0.data_ptr(), w_hh_t.data_ptr(), dxg.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        B, T, H, _build.stream_handle(dys.device),
    )
    _build.check(err, "rtvc_lstm_seq_bwd")
    _build.launch_counts["lstm_seq_bwd"] += 1
    return dxg, dh0, dc0


class LSTMSeqFn(torch.autograd.Function):
    """Differentiable LSTM sequence: (xg, w_hh, h0, c0) → (ys, h_T, c_T).
    Both halves are K3 kernels for CUDA tensors and plain PyTorch for CPU
    tensors."""

    @staticmethod
    def forward(ctx, xg, w_hh, h0, c0):
        ys, hT, cT, cs, gates = lstm_seq_fwd_train(xg, w_hh, h0, c0)
        ctx.save_for_backward(w_hh, h0, c0, ys, cs, gates)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        w_hh, h0, c0, ys, cs, gates = ctx.saved_tensors
        dxg, dh0, dc0 = lstm_seq_bwd(dys.contiguous(), dhT.contiguous(), dcT.contiguous(),
                                     gates, cs, c0, w_hh)
        H = w_hh.shape[1]
        h_prev = torch.cat([h0[:, None], ys[:, :-1]], dim=1)
        dw_hh = dxg.reshape(-1, 4 * H).t() @ h_prev.reshape(-1, H)
        return dxg, dw_hh, dh0, dc0
