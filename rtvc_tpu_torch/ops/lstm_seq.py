"""K3 forward: an LSTM sequence over hoisted input gates.

``lstm_seq`` launches the CUDA kernel in ``csrc/lstm_seq.cu`` for CUDA
tensors and runs ``lstm_seq_plain`` for CPU tensors. It replaces the forward
half of ``rtvc_tpu/ops/pallas/lstm_train_kernel.py:lstm_seq_fused``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from rtvc_tpu_torch import _build

Tensor = torch.Tensor


def lstm_seq_plain(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """xg (B, T, 4H) with both biases folded in, w_hh (4H, H) torch layout,
    h0/c0 (B, H) → (ys (B, T, H), h_T, c_T). Gate order [i, f, g, o]."""
    H = w_hh.shape[1]
    w_t = w_hh.t()
    h, c = h0, c0
    ys = []
    for t in range(xg.shape[1]):
        gates = xg[:, t] + h @ w_t
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), h, c


def lstm_seq(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Same contract as :func:`lstm_seq_plain`; CUDA tensors go through the
    kernel (f32, contiguous), CPU tensors through the plain version."""
    if not xg.is_cuda:
        return lstm_seq_plain(xg, w_hh, h0, c0)
    B, T, G = xg.shape
    H = w_hh.shape[1]
    tensors = (xg, w_hh, h0, c0)
    for name, t, shape in zip(("xg", "w_hh", "h0", "c0"), tensors,
                              ((B, T, 4 * H), (4 * H, H), (B, H), (B, H))):
        if t.device != xg.device or t.dtype != torch.float32:
            raise ValueError(f"lstm_seq: {name} must be f32 on {xg.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"lstm_seq: {name} must be contiguous {shape}, "
                             f"got {tuple(t.shape)}")
    lib = _build.library()
    ys = torch.empty((B, T, H), device=xg.device, dtype=torch.float32)
    hT = torch.empty((B, H), device=xg.device, dtype=torch.float32)
    cT = torch.empty((B, H), device=xg.device, dtype=torch.float32)
    err = lib.rtvc_lstm_seq_fwd(
        xg.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        ys.data_ptr(), hT.data_ptr(), cT.data_ptr(), B, T, H,
        _build.stream_handle(xg.device),
    )
    _build.check(err, "rtvc_lstm_seq_fwd")
    _build.launch_counts["lstm_seq"] += 1
    return ys, hT, cT
