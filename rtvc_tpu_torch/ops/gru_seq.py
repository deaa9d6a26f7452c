"""K4: a GRU sequence over hoisted input gates from a zero state, forward
and backward (torch semantics: ``b_hn`` sits inside the reset product).

Replaces ``rtvc_tpu/ops/pallas/gru_train_kernel.py:gru_seq_fused``. The CUDA
kernels are in ``csrc/gru_seq.cu``. Each wrapper launches its kernel for
CUDA tensors and runs its plain PyTorch version for CPU tensors:

- ``gru_seq_fwd``: ``xg`` (B, T, 3H) with ``b_ih`` folded in, ``w_hh``
  (3H, H), ``b_hh`` (3H) → ``ys`` (B, T, H) and the residuals
  ``gates`` (B, T, 4H) = [r, z, n, hn];
- ``gru_seq_bwd``: the reverse dh chain → ``dxg`` (B, T, 3H);
- ``GRUSeqFn``: both halves as a ``torch.autograd.Function``. ``dW_hh`` and
  ``db_hh`` are reductions over the flattened (B·T) axis outside the
  kernels, as in the JAX package (gru_train_kernel.py:329-343).
"""
from __future__ import annotations

from typing import Tuple

import torch

from rtvc_tpu_torch import _build

Tensor = torch.Tensor


def gru_seq_fwd_plain(xg: Tensor, w_hh: Tensor, b_hh: Tensor) -> Tuple[Tensor, Tensor]:
    """xg (B, T, 3H), w_hh (3H, H), b_hh (3H) → (ys (B, T, H), gates
    (B, T, 4H) = [r, z, n, hn]) from a zero initial state."""
    B, T, _ = xg.shape
    H = w_hh.shape[1]
    h = xg.new_zeros((B, H))
    w_t = w_hh.t()
    ys, gates = [], []
    for t in range(T):
        hg = h @ w_t + b_hh
        x_r, x_z, x_n = xg[:, t].split(H, dim=-1)
        r = torch.sigmoid(x_r + hg[:, :H])
        z = torch.sigmoid(x_z + hg[:, H:2 * H])
        hn = hg[:, 2 * H:]
        n = torch.tanh(x_n + r * hn)
        h = (1.0 - z) * n + z * h
        ys.append(h)
        gates.append(torch.cat([r, z, n, hn], dim=-1))
    return torch.stack(ys, dim=1), torch.stack(gates, dim=1)


def gru_seq_bwd_plain(dys: Tensor, gates: Tensor, ys: Tensor, w_hh: Tensor) -> Tensor:
    """The reverse dh chain (gru_train_kernel.py:122-142): cotangent of ys,
    the forward's gates and ys, w_hh (3H, H) → dxg (B, T, 3H), the cotangent
    of the input gates [r, z, n]. h_{t-1} is ys one step back, zero at
    t = 0."""
    H = w_hh.shape[1]
    dh = torch.zeros_like(dys[:, 0])
    dxg = []
    for t in range(dys.shape[1] - 1, -1, -1):
        r, z, n, hn = gates[:, t].split(H, dim=-1)
        h_prev = ys[:, t - 1] if t > 0 else torch.zeros_like(dh)
        dh = dys[:, t] + dh
        dz = dh * (h_prev - n) * z * (1.0 - z)
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dr = dn * hn * r * (1.0 - r)
        dxg.append(torch.cat([dr, dz, dn], dim=-1))
        dh = dh * z + torch.cat([dr, dz, dn * r], dim=-1) @ w_hh
    return torch.stack(dxg[::-1], dim=1)


def gru_seq_fwd(xg: Tensor, w_hh: Tensor, b_hh: Tensor) -> Tuple[Tensor, Tensor]:
    """Same contract as :func:`gru_seq_fwd_plain`; CUDA tensors go through
    the kernel (f32, contiguous), CPU tensors through the plain version."""
    if not xg.is_cuda:
        return gru_seq_fwd_plain(xg, w_hh, b_hh)
    B, T, _ = xg.shape
    H = w_hh.shape[1]
    _build.check_tensors("gru_seq", xg.device, xg=(xg, (B, T, 3 * H)),
                         w_hh=(w_hh, (3 * H, H)), b_hh=(b_hh, (3 * H,)))
    lib = _build.library()
    ys = torch.empty((B, T, H), device=xg.device, dtype=torch.float32)
    gates = torch.empty((B, T, 4 * H), device=xg.device, dtype=torch.float32)
    err = lib.rtvc_gru_seq_fwd(xg.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                               ys.data_ptr(), gates.data_ptr(), B, T, H,
                               _build.stream_handle(xg.device))
    _build.check(err, "rtvc_gru_seq_fwd")
    _build.launch_counts["gru_seq"] += 1
    return ys, gates


def gru_seq_bwd(dys: Tensor, gates: Tensor, ys: Tensor, w_hh: Tensor) -> Tensor:
    """Same contract as :func:`gru_seq_bwd_plain`; CUDA tensors go through
    the kernel, CPU tensors through the plain version."""
    if not dys.is_cuda:
        return gru_seq_bwd_plain(dys, gates, ys, w_hh)
    B, T, H = dys.shape
    w_hh_t = w_hh.t().contiguous()  # the kernel streams rows of W_hhᵀ
    _build.check_tensors("gru_seq_bwd", dys.device, dys=(dys, (B, T, H)),
                         gates=(gates, (B, T, 4 * H)), ys=(ys, (B, T, H)),
                         w_hh_t=(w_hh_t, (H, 3 * H)))
    lib = _build.library()
    dxg = torch.empty((B, T, 3 * H), device=dys.device, dtype=torch.float32)
    err = lib.rtvc_gru_seq_bwd(dys.data_ptr(), gates.data_ptr(), ys.data_ptr(),
                               w_hh_t.data_ptr(), dxg.data_ptr(), B, T, H,
                               _build.stream_handle(dys.device))
    _build.check(err, "rtvc_gru_seq_bwd")
    _build.launch_counts["gru_seq_bwd"] += 1
    return dxg


class GRUSeqFn(torch.autograd.Function):
    """Differentiable GRU sequence: (xg, w_hh, b_hh) → ys. Both halves are K4
    kernels for CUDA tensors and plain PyTorch for CPU tensors."""

    @staticmethod
    def forward(ctx, xg, w_hh, b_hh):
        ys, gates = gru_seq_fwd(xg, w_hh, b_hh)
        ctx.save_for_backward(w_hh, ys, gates)
        return ys

    @staticmethod
    def backward(ctx, dys):
        w_hh, ys, gates = ctx.saved_tensors
        H = w_hh.shape[1]
        dxg = gru_seq_bwd(dys.contiguous(), gates, ys, w_hh)
        # hidden-side pre-activation cotangent: the n slice regains its ·r
        dhg = torch.cat([dxg[..., :2 * H], dxg[..., 2 * H:] * gates[..., :H]], dim=-1)
        h_prev = torch.cat([torch.zeros_like(ys[:, :1]), ys[:, :-1]], dim=1)
        dw_hh = dhg.reshape(-1, 3 * H).t() @ h_prev.reshape(-1, H)
        return dxg, dw_hh, dhg.sum(dim=(0, 1))
