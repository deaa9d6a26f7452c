"""K3: an LSTM sequence over hoisted input gates, forward and backward.

Replaces ``rtvc_tpu/ops/pallas/lstm_train_kernel.py:lstm_seq_fused``. The
CUDA kernels are in ``csrc/lstm_seq.cu``: W_hh stays in the shared memory of
the SMs for the whole sequence, each CTA owning a slice of the hidden units
and a group of batch rows, with a grid-wide barrier between time steps.
:func:`plan` cuts a shape into that grid. Each wrapper launches its kernel
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

from typing import NamedTuple, Tuple

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


WARPS = 8  # warps of a CTA (csrc/lstm_seq.cu:kThreads / 32)

# The kernels' instantiations: (hidden units a CTA owns, batch rows a warp
# takes at a time), in order of preference. The forward keeps 4 · units rows
# of W_hh (H long) in shared memory and units · 4 · rows sums in a lane's
# registers; the backward units columns (4H long) and units · rows sums, so
# it can take wider slices and more rows. A group of at most WARPS rows takes
# one row a warp.
FWD_SLICES = ((6, 4), (10, 2))
BWD_SLICES = ((12, 8), (10, 8))


class Plan(NamedTuple):
    """How a launch is cut over the card: ``groups`` x ``slices`` CTAs; a CTA
    owns ``units`` hidden units (the last slice may be ragged) of ``rows``
    batch rows (the last group may be short), its warps take ``nb`` rows at a
    time, and it needs ``smem`` bytes of shared memory."""
    groups: int
    slices: int
    units: int
    nb: int
    rows: int
    smem: int


def plan(B: int, H: int, sm_count: int, smem_limit: int, backward: bool = False) -> Plan:
    """The partition of a (B, T, H) sequence for a card with ``sm_count`` SMs
    whose blocks may take ``smem_limit`` bytes of shared memory: the first
    instantiation whose slices fit the SMs (all CTAs must be resident at
    once: one a SM) and whose weights fit the shared memory. SMs that the
    slices leave over go to further batch groups, each with a barrier of its
    own, as long as a group keeps every warp busy. Raises ValueError for a
    hidden width past what the card can hold."""
    if B < 1 or H < 1 or sm_count < 1:
        raise ValueError(f"lstm_seq: B {B}, H {H} and the SM count {sm_count} must be positive")
    widest = 0
    for units, nb_many in BWD_SLICES if backward else FWD_SLICES:
        slices = -(-H // units)
        groups = max(1, min(sm_count // max(slices, 1), -(-B // (WARPS * nb_many))))
        rows = -(-B // groups)
        groups = -(-B // rows)
        nb = nb_many if rows > WARPS else 1
        # weights: forward 4·units rows of H (padded to 4), backward units rows of 4H
        w_rows, ld = (units, 4 * H) if backward else (4 * units, -(-H // 4) * 4)
        scratch = WARPS * (-(-w_rows * nb // 32) * 32)
        smem = 4 * (w_rows * ld + scratch)
        if slices <= sm_count and smem <= smem_limit:
            return Plan(groups, slices, units, nb, rows, smem)
        # the widest H this instantiation takes: 16 · units bytes of weights
        # per unit of H, the forward's H padded to a multiple of 4
        fits = max(0, smem_limit - 4 * scratch) // (16 * units)
        widest = max(widest, min(units * sm_count, fits if backward else fits // 4 * 4))
    raise ValueError(
        f"lstm_seq: hidden width {H} is past the limit of {widest} for {sm_count} SMs with "
        f"{smem_limit} bytes of shared memory each (W_hh must fit the card's shared memory)")


def _plan_args(B: int, H: int, device, backward: bool):
    """The plan for this device as the C entry points take it, and the
    zeroed barrier counters (one 128-byte line a group)."""
    p = plan(B, H, *_build.device_limits(device), backward=backward)
    return _build.int_array(p), torch.zeros(32 * p.groups, device=device, dtype=torch.int32)


def grid_barrier_steps(ctas: int, steps: int, device) -> None:
    """A launch of ``steps`` grid barriers over ``ctas`` CTAs and nothing
    else: the cost a step of the recurrence pays before any work."""
    sync = torch.zeros(1, device=device, dtype=torch.int32)
    err = _build.library().rtvc_grid_barrier_steps(sync.data_ptr(), ctas, steps,
                                                   _build.stream_handle(device))
    _build.check(err, "rtvc_grid_barrier_steps")
    _build.launch_counts["grid_barrier_steps"] += 1


def _fwd_kernel(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor, residuals: bool):
    B, T, _ = xg.shape
    H = w_hh.shape[1]
    _build.check_tensors("lstm_seq", xg.device, xg=(xg, (B, T, 4 * H)),
                         w_hh=(w_hh, (4 * H, H)), h0=(h0, (B, H)), c0=(c0, (B, H)))
    if B < 1 or T < 1:
        raise ValueError(f"lstm_seq: B and T must be at least 1, got {B} and {T}")
    lib = _build.library()
    plan_v, sync = _plan_args(B, H, xg.device, backward=False)
    empty = lambda *shape: torch.empty(shape, device=xg.device, dtype=torch.float32)  # noqa: E731
    ys, hT, cT = empty(B, T, H), empty(B, H), empty(B, H)
    cs, gates = (empty(B, T, H), empty(B, T, 4 * H)) if residuals else (None, None)
    err = lib.rtvc_lstm_seq_fwd(
        xg.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        ys.data_ptr(), hT.data_ptr(), cT.data_ptr(),
        cs.data_ptr() if residuals else None, gates.data_ptr() if residuals else None,
        B, T, H, plan_v, sync.data_ptr(), _build.stream_handle(xg.device),
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
    _build.check_tensors("lstm_seq_bwd", dys.device, dys=(dys, (B, T, H)),
                         dhT=(dhT, (B, H)), dcT=(dcT, (B, H)),
                         gates=(gates, (B, T, 4 * H)), cs=(cs, (B, T, H)),
                         c0=(c0, (B, H)), w_hh=(w_hh, (4 * H, H)))
    if B < 1 or T < 1:
        raise ValueError(f"lstm_seq_bwd: B and T must be at least 1, got {B} and {T}")
    lib = _build.library()
    plan_v, sync = _plan_args(B, H, dys.device, backward=True)
    dxg = torch.empty((B, T, 4 * H), device=dys.device, dtype=torch.float32)
    dh0 = torch.empty((B, H), device=dys.device, dtype=torch.float32)
    dc0 = torch.empty((B, H), device=dys.device, dtype=torch.float32)
    err = lib.rtvc_lstm_seq_bwd(
        dys.data_ptr(), dhT.data_ptr(), dcT.data_ptr(), gates.data_ptr(), cs.data_ptr(),
        c0.data_ptr(), w_hh.data_ptr(), dxg.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        B, T, H, plan_v, sync.data_ptr(), _build.stream_handle(dys.device),
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
