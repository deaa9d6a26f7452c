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

Each kernel has an f32 and a bf16 instantiation, picked by the streams'
dtype (xg, W_hh, ys, the residuals, dys): the bf16 one is the JAX kernel's
contract under the bf16 training policy (``ops.precision``), with f32
arithmetic, an f32 carried state (h0, c0, h_T, c_T, dh0, dc0 stay f32), an
f32 dxg, and W_hh resident in shared memory at two bytes a weight, which
the plan counts. A bf16 CUDA tensor reaches the bf16 kernel or raises.

Gate order is torch's [i, f, g, o]; both biases are folded into ``xg``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.ops.precision import widen

Tensor = torch.Tensor


def _lstm_plain(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor, residuals: bool):
    dt = xg.dtype
    H = w_hh.shape[1]
    xg, w_t = widen(xg), widen(w_hh).t()
    h, c = widen(h0), widen(c0)
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
    out = (torch.stack(ys, dim=1).to(dt), h, c)
    if residuals:
        out += (torch.stack(cs, dim=1).to(dt), torch.stack(gates, dim=1).to(dt))
    return out


def lstm_seq_plain(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """xg (B, T, 4H) with both biases folded in, w_hh (4H, H) torch layout,
    h0/c0 (B, H) → (ys (B, T, H), h_T, c_T). The streams (xg, w_hh, ys) are
    f32 or bf16; the arithmetic, the carried state, h0, c0, h_T and c_T are
    f32 in both (bf16 is the JAX kernel's contract under the bf16 policy:
    values are rounded where they are stored, never in the recurrence)."""
    return _lstm_plain(xg, w_hh, h0, c0, residuals=False)


def lstm_seq_fwd_train_plain(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor
                             ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """As :func:`lstm_seq_plain`, plus the residuals cs (B, T, H) and gates
    (B, T, 4H) = [i, f, g, o] after their nonlinearities, in the streams'
    dtype."""
    return _lstm_plain(xg, w_hh, h0, c0, residuals=True)


def lstm_seq_bwd_plain(dys: Tensor, dhT: Tensor, dcT: Tensor, gates: Tensor,
                       cs: Tensor, c0: Tensor, w_hh: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """The reverse (dh, dc) chain (lstm_train_kernel.py:172-191): cotangents
    of ys (B, T, H), h_T and c_T, the forward's residuals, c0 and w_hh (4H, H)
    → (dxg (B, T, 4H), dh0, dc0). c_{t-1} is cs one step back, c0 (rounded to
    cs's dtype, as the JAX package stacks it with cs) at t = 0. With bf16
    streams (dys, gates, cs, w_hh) the chain runs in f32 on the widened
    residuals, and dxg comes back f32, as the JAX kernel writes it (the
    weight gradient is taken from it unrounded); dhT, dcT, c0, dh0 and dc0
    are f32."""
    H = w_hh.shape[1]
    w = widen(w_hh)
    dh, dc = widen(dhT), widen(dcT)
    c0 = widen(c0.to(cs.dtype))
    dxg = []
    for t in range(dys.shape[1] - 1, -1, -1):
        i, f, g, o = widen(gates[:, t]).split(H, dim=-1)
        c = widen(cs[:, t])
        c_prev = widen(cs[:, t - 1]) if t > 0 else c0
        tanhc = torch.tanh(c)
        dh = widen(dys[:, t]) + dh
        do = dh * tanhc * o * (1.0 - o)
        dc = dc + dh * o * (1.0 - tanhc * tanhc)
        di = dc * g * i * (1.0 - i)
        df = dc * c_prev * f * (1.0 - f)
        dg = dc * i * (1.0 - g * g)
        d = torch.cat([di, df, dg, do], dim=-1)
        dxg.append(d)
        dc = dc * f
        dh = d @ w
    return torch.stack(dxg[::-1], dim=1), dh, dc


WARPS = 8  # warps of a CTA (csrc/lstm_seq.cu:kThreads / 32)

# The kernels' instantiations: (hidden units a CTA owns, batch rows a warp
# takes at a time), in order of preference (see :func:`plan`). The
# forward keeps 4 · units rows of W_hh (H long) in shared memory and units ·
# 4 · rows sums in a lane's registers; the backward units columns (4H long)
# and units · rows sums, so it can take wider slices and more rows, and
# narrow ones (4 units, 2 rows a warp) where a small batch would leave most
# SMs and warps idle under the wide ones (B 16 x H 512: 128 CTAs against 43).
# A group of at most WARPS rows takes one row a warp.
FWD_SLICES = ((6, 4), (10, 2))
BWD_SLICES = ((12, 8), (10, 8), (4, 2))


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


def candidates(B: int, H: int, sm_count: int, smem_limit: int, backward: bool = False,
               elem: int = 4):
    """Each instantiation's partition of a (B, T, H) sequence for a card with
    ``sm_count`` SMs whose blocks may take ``smem_limit`` bytes of shared
    memory, with W_hh held at ``elem`` bytes a weight (4 for f32 streams, 2
    for bf16), in order of preference: a Plan where the instantiation's
    slices fit the SMs (all CTAs must be resident at once: one a SM) and its
    weights fit the shared memory, else the widest H it would take there.
    SMs that the slices leave over go to further batch groups, each with a
    barrier of its own, as long as a group keeps every warp busy."""
    if B < 1 or H < 1 or sm_count < 1:
        raise ValueError(f"lstm_seq: B {B}, H {H} and the SM count {sm_count} must be positive")
    out = []
    for units, nb_many in BWD_SLICES if backward else FWD_SLICES:
        slices = -(-H // units)
        groups = max(1, min(sm_count // max(slices, 1), -(-B // (WARPS * nb_many))))
        rows = -(-B // groups)
        groups = -(-B // rows)
        nb = nb_many if rows > WARPS else 1
        # weights: forward 4·units rows of H (padded to 4), backward units rows of 4H
        w_rows, ld = (units, 4 * H) if backward else (4 * units, -(-H // 4) * 4)
        scratch = WARPS * (-(-w_rows * nb // 32) * 32)
        smem = elem * w_rows * ld + 4 * scratch
        if slices <= sm_count and smem <= smem_limit:
            out.append(Plan(groups, slices, units, nb, rows, smem))
        else:
            # the widest H this instantiation takes: 4 · elem · units bytes of
            # weights per unit of H, the forward's H padded to a multiple of 4
            fits = max(0, smem_limit - 4 * scratch) // (4 * elem * units)
            out.append(min(units * sm_count, fits if backward else fits // 4 * 4))
    return out


def plan(B: int, H: int, sm_count: int, smem_limit: int, backward: bool = False,
         elem: int = 4) -> Plan:
    """The forward's first plan of :func:`candidates`; the backward's with
    the most CTAs, the first of them on a tie (at every backward shape
    timed, more CTAs ran faster; the forward's second instantiation in two
    groups lost to its first at B 48: PERF.md section 6). Raises ValueError
    for a hidden width past what the card can hold."""
    made = candidates(B, H, sm_count, smem_limit, backward, elem)
    fits = [p for p in made if isinstance(p, Plan)]
    if fits and backward:
        return max(fits, key=lambda p: p.groups * p.slices)  # max keeps the first of equals
    if fits:
        return fits[0]
    raise ValueError(
        f"lstm_seq: hidden width {H} is past the limit of {max(made)} for {sm_count} SMs with "
        f"{smem_limit} bytes of shared memory each (W_hh must fit the card's shared memory)")


def _plan_args(B: int, H: int, device, backward: bool, dtype: torch.dtype):
    """The plan for this device and stream dtype as the C entry points take
    it, and the zeroed barrier counters (one 128-byte line a group)."""
    p = plan(B, H, *_build.device_limits(device), backward=backward,
             elem=_build.elem_bytes(dtype))
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
    dt, dev = xg.dtype, xg.device
    _build.check_tensors("lstm_seq", dev, xg=(xg, (B, T, 4 * H), dt),
                         w_hh=(w_hh, (4 * H, H), dt), h0=(h0, (B, H)), c0=(c0, (B, H)))
    if B < 1 or T < 1:
        raise ValueError(f"lstm_seq: B and T must be at least 1, got {B} and {T}")
    lib = _build.library()
    plan_v, sync = _plan_args(B, H, dev, backward=False, dtype=dt)
    f32 = lambda *shape: torch.empty(shape, device=dev, dtype=torch.float32)  # noqa: E731
    stream = lambda *shape: torch.empty(shape, device=dev, dtype=dt)  # noqa: E731
    ys, hT, cT = stream(B, T, H), f32(B, H), f32(B, H)
    cs, gates = (stream(B, T, H), stream(B, T, 4 * H)) if residuals else (None, None)
    ptrs = [xg.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            ys.data_ptr(), hT.data_ptr(), cT.data_ptr(),
            cs.data_ptr() if residuals else None, gates.data_ptr() if residuals else None]
    if dt == torch.float32:
        name = "rtvc_lstm_seq_fwd"
    else:  # the bf16 instantiation carries h through an f32 exchange
        name = "rtvc_lstm_seq_fwd_bf16"
        ptrs.append(f32(2, B, H).data_ptr())
    err = getattr(lib, name)(*ptrs, B, T, H, plan_v, sync.data_ptr(),
                             _build.stream_handle(dev))
    _build.check(err, name)
    _build.launch_counts["lstm_seq" if dt == torch.float32 else "lstm_seq_bf16"] += 1
    return (ys, hT, cT, cs, gates) if residuals else (ys, hT, cT)


def lstm_seq(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Same contract as :func:`lstm_seq_plain`; CUDA tensors go through the
    kernel (contiguous; f32 streams the f32 instantiation, bf16 streams the
    bf16 one), CPU tensors through the plain version."""
    if not xg.is_cuda:
        return lstm_seq_plain(xg, w_hh, h0, c0)
    return _fwd_kernel(xg, w_hh, h0, c0, residuals=False)


def lstm_seq_fwd_train(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Same contract as :func:`lstm_seq_fwd_train_plain`; CUDA tensors go
    through the kernel of their dtype, CPU tensors through the plain
    version."""
    if not xg.is_cuda:
        return lstm_seq_fwd_train_plain(xg, w_hh, h0, c0)
    return _fwd_kernel(xg, w_hh, h0, c0, residuals=True)


def lstm_seq_bwd(dys: Tensor, dhT: Tensor, dcT: Tensor, gates: Tensor, cs: Tensor,
                 c0: Tensor, w_hh: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Same contract as :func:`lstm_seq_bwd_plain`; CUDA tensors go through
    the kernel of their dtype, CPU tensors through the plain version."""
    if not dys.is_cuda:
        return lstm_seq_bwd_plain(dys, dhT, dcT, gates, cs, c0, w_hh)
    B, T, H = dys.shape
    dt, dev = dys.dtype, dys.device
    _build.check_tensors("lstm_seq_bwd", dev, dys=(dys, (B, T, H), dt),
                         dhT=(dhT, (B, H)), dcT=(dcT, (B, H)),
                         gates=(gates, (B, T, 4 * H), dt), cs=(cs, (B, T, H), dt),
                         c0=(c0, (B, H)), w_hh=(w_hh, (4 * H, H), dt))
    if B < 1 or T < 1:
        raise ValueError(f"lstm_seq_bwd: B and T must be at least 1, got {B} and {T}")
    lib = _build.library()
    plan_v, sync = _plan_args(B, H, dev, backward=True, dtype=dt)
    dxg = torch.empty((B, T, 4 * H), device=dev, dtype=torch.float32)
    dh0 = torch.empty((B, H), device=dev, dtype=torch.float32)
    dc0 = torch.empty((B, H), device=dev, dtype=torch.float32)
    name = "rtvc_lstm_seq_bwd" if dt == torch.float32 else "rtvc_lstm_seq_bwd_bf16"
    err = getattr(lib, name)(
        dys.data_ptr(), dhT.data_ptr(), dcT.data_ptr(), gates.data_ptr(), cs.data_ptr(),
        c0.data_ptr(), w_hh.data_ptr(), dxg.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        B, T, H, plan_v, sync.data_ptr(), _build.stream_handle(dev))
    _build.check(err, name)
    _build.launch_counts["lstm_seq_bwd" if dt == torch.float32 else "lstm_seq_bwd_bf16"] += 1
    return dxg, dh0, dc0


class LSTMSeqFn(torch.autograd.Function):
    """Differentiable LSTM sequence: (xg, w_hh, h0, c0) → (ys, h_T, c_T).
    Both halves are K3 kernels for CUDA tensors and plain PyTorch for CPU
    tensors. With bf16 streams h0 and c0 stay f32, and the backward's f32
    dxg gives ``dW_hh`` in f32 before both are rounded to their inputs'
    dtype, as in the JAX package."""

    @staticmethod
    def forward(ctx, xg, w_hh, h0, c0):
        ys, hT, cT, cs, gates = lstm_seq_fwd_train(xg, w_hh, h0, c0)
        ctx.save_for_backward(w_hh, h0, c0, ys, cs, gates)
        ctx.xg_dtype = xg.dtype
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        w_hh, h0, c0, ys, cs, gates = ctx.saved_tensors
        dxg, dh0, dc0 = lstm_seq_bwd(dys.contiguous(), dhT.contiguous(), dcT.contiguous(),
                                     gates, cs, c0, w_hh)
        H = w_hh.shape[1]
        h_prev = widen(torch.cat([h0.to(ys.dtype)[:, None], ys[:, :-1]], dim=1))
        dw_hh = dxg.reshape(-1, 4 * H).t() @ h_prev.reshape(-1, H)
        return dxg.to(ctx.xg_dtype), dw_hh.to(w_hh.dtype), dh0, dc0
