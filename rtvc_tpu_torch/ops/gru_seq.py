"""K4: a GRU sequence over hoisted input gates from a zero state, forward
and backward (torch semantics: ``b_hn`` sits inside the reset product).

Replaces ``rtvc_tpu/ops/pallas/gru_train_kernel.py:gru_seq_fused``. The CUDA
kernels are in ``csrc/gru_seq.cu``: W_hh stays in the shared memory of the
SMs for the whole sequence, each CTA owning a slice of the hidden units and a
group of batch rows, with a grid-wide barrier between time steps, as K3's
(``ops/lstm_seq.py``). :func:`plan` cuts a shape into that grid. Each
wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors:

- ``gru_seq_fwd``: ``xg`` (B, T, 3H) with ``b_ih`` folded in, ``w_hh``
  (3H, H), ``b_hh`` (3H) → ``ys`` (B, T, H) and the residuals
  ``gates`` (B, T, 4H) = [r, z, n, hn];
- ``gru_seq_bwd``: the reverse dh chain → ``dxg`` (B, T, 3H);
- ``GRUSeqFn``: both halves as a ``torch.autograd.Function``. ``dW_hh`` and
  ``db_hh`` are reductions over the flattened (B·T) axis outside the
  kernels, as in the JAX package (gru_train_kernel.py:329-343).

Each kernel has an f32 and a bf16 instantiation, picked by the streams'
dtype: the bf16 one is the JAX kernel's contract under the bf16 training
policy (``ops.precision``), with f32 arithmetic, an f32 carried h, f32
cotangents out of the backward, and W_hh resident at two bytes a weight,
which the plan counts. A bf16 CUDA tensor reaches the bf16 kernel or
raises.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.ops.precision import widen

Tensor = torch.Tensor


def gru_seq_fwd_plain(xg: Tensor, w_hh: Tensor, b_hh: Tensor) -> Tuple[Tensor, Tensor]:
    """xg (B, T, 3H), w_hh (3H, H), b_hh (3H) → (ys (B, T, H), gates
    (B, T, 4H) = [r, z, n, hn]) from a zero initial state. All f32, or all
    bf16: then the arithmetic and the carried h stay f32 and ys and the
    gates are rounded where they are stored (the JAX kernel's contract under
    the bf16 policy)."""
    dt = xg.dtype
    B, T, _ = xg.shape
    H = w_hh.shape[1]
    xg, w_t, b_hh = widen(xg), widen(w_hh).t(), widen(b_hh)
    h = xg.new_zeros((B, H))
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
    return torch.stack(ys, dim=1).to(dt), torch.stack(gates, dim=1).to(dt)


def gru_seq_bwd_plain(dys: Tensor, gates: Tensor, ys: Tensor, w_hh: Tensor) -> Tensor:
    """The reverse dh chain (gru_train_kernel.py:122-142): cotangent of ys,
    the forward's gates and ys, w_hh (3H, H) → dxg (B, T, 3H), the cotangent
    of the input gates [r, z, n]. h_{t-1} is ys one step back, zero at
    t = 0. All f32, or all bf16: then the chain runs in f32 on the widened
    residuals and dxg comes back f32, as the JAX kernel writes it (the
    weight gradients are taken from it unrounded)."""
    H = w_hh.shape[1]
    w = widen(w_hh)
    dh = widen(dys.new_zeros(dys[:, 0].shape))
    dxg = []
    for t in range(dys.shape[1] - 1, -1, -1):
        r, z, n, hn = widen(gates[:, t]).split(H, dim=-1)
        h_prev = widen(ys[:, t - 1]) if t > 0 else torch.zeros_like(dh)
        dh = widen(dys[:, t]) + dh
        dz = dh * (h_prev - n) * z * (1.0 - z)
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dr = dn * hn * r * (1.0 - r)
        dxg.append(torch.cat([dr, dz, dn], dim=-1))
        dh = dh * z + torch.cat([dr, dz, dn * r], dim=-1) @ w
    return torch.stack(dxg[::-1], dim=1)


WARPS = 8  # warps of a CTA (csrc/common.cuh:kRecWarps)

# The kernels' instantiations: hidden units a CTA owns → the batch rows a warp
# may take at a time (csrc/gru_seq.cu). The forward keeps 3 · units rows of
# W_hh (H long) in shared memory and 3 · units · nb sums in a lane's
# registers; the backward units columns (3H long) and units · nb sums.
FWD_SLICES = {1: (1, 3, 5), 2: (1, 3, 5), 4: (1, 3, 5), 8: (1, 3)}
BWD_SLICES = {2: (1, 3, 5), 4: (1, 3, 5), 8: (1, 3, 5)}

# The cost model that ranks the plans of a shape, in an SM's cycles a step,
# fitted to every candidate's time at the three WaveRNN training shapes on an
# H100 (PERF.md, PR 6): the busiest warp's passes, each a round trip to L2 for
# every 128 floats of the reduction axis (one piece ahead hides the next) and
# its FMAs at one every two cycles (two warps share a scheduler), against the
# rows the CTA reads from L2 (h in the forward, the 3H-wide dhg in the
# backward) at 16 bytes a cycle.
L2_PIECE_CYCLES = 400
FMA_CYCLES = 2
L2_BYTES_PER_CYCLE = 16
# A forward instantiation whose warp computes fewer than SMALL_PASS_SUMS sums a
# pass (3 · units · nb) ran ≈ 3.7 µs a step slower at B 1 on an H100, every
# candidate timed at H 64, 128 and 256 (PERF.md, PR 14): 5.7-6.1 µs a step
# against 2.0-3.5 for the others, with no spill. Those passes cost
# SMALL_PASS_CYCLES more.
SMALL_PASS_SUMS = 12
SMALL_PASS_CYCLES = 6500


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


def _weights(H: int, units: int, backward: bool) -> Tuple[int, int]:
    """(rows, row length in floats) of the weights a CTA keeps."""
    return (units, 3 * H) if backward else (3 * units, -(-H // 4) * 4)


def _smem(H: int, units: int, nb: int, backward: bool, elem: int = 4) -> int:
    """Bytes of shared memory a CTA takes: W_hh at ``elem`` bytes a weight,
    then f32 sums (and the forward's f32 biases)."""
    w_rows, ld = _weights(H, units, backward)
    scratch = WARPS * (-(-w_rows * nb // 32) * 32)
    return elem * w_rows * ld + 4 * (scratch + (0 if backward else w_rows))


def cost(p: Plan, H: int, backward: bool) -> float:
    """The plan's modelled cycles a step (see ``L2_PIECE_CYCLES``)."""
    w_rows, ld = _weights(H, p.units, backward)
    n = 3 * H if backward else H
    passes = -(-(-(-p.rows // p.nb)) // WARPS)  # passes of the busiest warp
    small = 0 if backward or w_rows * p.nb >= SMALL_PASS_SUMS else SMALL_PASS_CYCLES
    warp = passes * (-(-n // 128) * L2_PIECE_CYCLES + w_rows * p.nb * ld / 32 * FMA_CYCLES
                     + small)
    return max(warp, p.rows * n * 4 / L2_BYTES_PER_CYCLE)


def candidates(B: int, H: int, sm_count: int, smem_limit: int, backward: bool = False,
               elem: int = 4):
    """Every plan of a (B, T, H) sequence that the kernels have an
    instantiation for and the card can hold: its slices and groups resident
    at once (one CTA a SM) and its weights, at ``elem`` bytes each (4 for
    f32 streams, 2 for bf16), in one SM's shared memory."""
    if B < 1 or H < 1 or sm_count < 1:
        raise ValueError(f"gru_seq: B {B}, H {H} and the SM count {sm_count} must be positive")
    out = []
    for units, nbs in (BWD_SLICES if backward else FWD_SLICES).items():
        slices = -(-H // units)
        if slices > sm_count:
            continue
        for groups in range(1, min(sm_count // slices, B) + 1):
            rows = -(-B // groups)
            if -(-B // rows) != groups:
                continue
            for nb in nbs:
                smem = _smem(H, units, nb, backward, elem)
                if smem <= smem_limit:
                    out.append(Plan(groups, slices, units, nb, rows, smem))
    return out


def plan(B: int, H: int, sm_count: int, smem_limit: int, backward: bool = False,
         elem: int = 4) -> Plan:
    """The partition of a (B, T, H) sequence for a card with ``sm_count`` SMs
    whose blocks may take ``smem_limit`` bytes of shared memory: of the
    :func:`candidates`, the one of least :func:`cost`; on a tie the fewer
    rows a group, then the more rows a warp pass. Raises ValueError, naming the
    widest H the card takes, for a hidden width past it."""
    found = candidates(B, H, sm_count, smem_limit, backward, elem)
    if found:
        return min(found, key=lambda p: (cost(p, H, backward), p.rows, -p.nb))
    widest = 0
    for units, nbs in (BWD_SLICES if backward else FWD_SLICES).items():
        fits = [w for w in range(units * sm_count, 0, -1)
                if _smem(w, units, min(nbs), backward, elem) <= smem_limit]
        widest = max(widest, fits[0] if fits else 0)
    raise ValueError(
        f"gru_seq: hidden width {H} is past the limit of {widest} for {sm_count} SMs with "
        f"{smem_limit} bytes of shared memory each (W_hh must fit the card's shared memory)")


def _plan_args(B: int, H: int, device, backward: bool, dtype: torch.dtype):
    """The plan for this device and stream dtype as the C entry points take
    it, and the zeroed barrier counters (one 128-byte line a group)."""
    p = plan(B, H, *_build.device_limits(device), backward=backward,
             elem=_build.elem_bytes(dtype))
    return _build.int_array(p), torch.zeros(32 * p.groups, device=device, dtype=torch.int32)


def gru_seq_fwd(xg: Tensor, w_hh: Tensor, b_hh: Tensor) -> Tuple[Tensor, Tensor]:
    """Same contract as :func:`gru_seq_fwd_plain`; CUDA tensors go through
    the kernel (contiguous; f32 streams the f32 instantiation, bf16 streams
    the bf16 one), CPU tensors through the plain version."""
    if not xg.is_cuda:
        return gru_seq_fwd_plain(xg, w_hh, b_hh)
    B, T, _ = xg.shape
    H = w_hh.shape[1]
    dt, dev = xg.dtype, xg.device
    _build.check_tensors("gru_seq", dev, xg=(xg, (B, T, 3 * H), dt),
                         w_hh=(w_hh, (3 * H, H), dt), b_hh=(b_hh, (3 * H,), dt))
    if B < 1 or T < 1:
        raise ValueError(f"gru_seq: B and T must be at least 1, got {B} and {T}")
    lib = _build.library()
    plan_v, sync = _plan_args(B, H, dev, backward=False, dtype=dt)
    ys = torch.empty((B, T, H), device=dev, dtype=dt)
    gates = torch.empty((B, T, 4 * H), device=dev, dtype=dt)
    ptrs = [xg.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), ys.data_ptr(), gates.data_ptr()]
    if dt == torch.float32:
        name = "rtvc_gru_seq_fwd"
    else:  # the bf16 instantiation carries h through an f32 exchange
        name = "rtvc_gru_seq_fwd_bf16"
        ptrs.append(torch.empty((2, B, H), device=dev, dtype=torch.float32).data_ptr())
    err = getattr(lib, name)(*ptrs, B, T, H, plan_v, sync.data_ptr(),
                             _build.stream_handle(dev))
    _build.check(err, name)
    _build.launch_counts["gru_seq" if dt == torch.float32 else "gru_seq_bf16"] += 1
    return ys, gates


def _bwd(dys: Tensor, gates: Tensor, ys: Tensor, w_hh: Tensor) -> Tuple[Tensor, Tensor]:
    """The backward kernel → (dxg, dhg), dhg = [dr, dz, dn·r] (B, T, 3H),
    both f32."""
    B, T, H = dys.shape
    dt, dev = dys.dtype, dys.device
    _build.check_tensors("gru_seq_bwd", dev, dys=(dys, (B, T, H), dt),
                         gates=(gates, (B, T, 4 * H), dt), ys=(ys, (B, T, H), dt),
                         w_hh=(w_hh, (3 * H, H), dt))
    if B < 1 or T < 1:
        raise ValueError(f"gru_seq_bwd: B and T must be at least 1, got {B} and {T}")
    lib = _build.library()
    plan_v, sync = _plan_args(B, H, dev, backward=True, dtype=dt)
    dxg, dhg = (torch.empty((B, T, 3 * H), device=dev, dtype=torch.float32) for _ in range(2))
    carry = torch.empty((B, H), device=dev, dtype=torch.float32)
    name = "rtvc_gru_seq_bwd" if dt == torch.float32 else "rtvc_gru_seq_bwd_bf16"
    err = getattr(lib, name)(dys.data_ptr(), gates.data_ptr(), ys.data_ptr(), w_hh.data_ptr(),
                             dxg.data_ptr(), dhg.data_ptr(), carry.data_ptr(), B, T, H, plan_v,
                             sync.data_ptr(), _build.stream_handle(dev))
    _build.check(err, name)
    _build.launch_counts["gru_seq_bwd" if dt == torch.float32 else "gru_seq_bwd_bf16"] += 1
    return dxg, dhg


def gru_seq_bwd(dys: Tensor, gates: Tensor, ys: Tensor, w_hh: Tensor) -> Tensor:
    """Same contract as :func:`gru_seq_bwd_plain`; CUDA tensors go through
    the kernel of their dtype, CPU tensors through the plain version."""
    if not dys.is_cuda:
        return gru_seq_bwd_plain(dys, gates, ys, w_hh)
    return _bwd(dys, gates, ys, w_hh)[0]


class GRUSeqFn(torch.autograd.Function):
    """Differentiable GRU sequence: (xg, w_hh, b_hh) → ys. Both halves are K4
    kernels for CUDA tensors and plain PyTorch for CPU tensors. With bf16
    streams the backward's f32 dxg gives ``dW_hh`` and ``db_hh`` in f32
    before all three are rounded to their inputs' dtype, as in the JAX
    package."""

    @staticmethod
    def forward(ctx, xg, w_hh, b_hh):
        ys, gates = gru_seq_fwd(xg, w_hh, b_hh)
        ctx.save_for_backward(w_hh, b_hh, ys, gates)
        return ys

    @staticmethod
    def backward(ctx, dys):
        w_hh, b_hh, ys, gates = ctx.saved_tensors
        H = w_hh.shape[1]
        dys = dys.contiguous()
        if dys.is_cuda:
            dxg, dhg = _bwd(dys, gates, ys, w_hh)
        else:
            dxg = gru_seq_bwd_plain(dys, gates, ys, w_hh)
            # hidden-side pre-activation cotangent: the n slice regains its ·r
            dhg = torch.cat([dxg[..., :2 * H], dxg[..., 2 * H:] * widen(gates[..., :H])],
                            dim=-1)
        h_prev = widen(torch.cat([torch.zeros_like(ys[:, :1]), ys[:, :-1]], dim=1))
        dw_hh = dhg.reshape(-1, 3 * H).t() @ h_prev.reshape(-1, H)
        return dxg.to(ys.dtype), dw_hh.to(w_hh.dtype), dhg.sum(dim=(0, 1)).to(b_hh.dtype)
