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
the plan counts. For bf16 streams the plan names one of two designs: the
tensor-core mode (``csrc/lstm_seq_mma.cu``, :class:`MmaPlan`: the recurrent
product as ``wgmma`` on the resident bf16 W_hh, the f32 operand split into
two bf16 halves), wherever it fits and is the faster, and otherwise the
CUDA-core design of ``csrc/lstm_seq.cu`` (:class:`Plan`). A bf16 CUDA
tensor reaches the kernel its plan names or raises; :func:`launch_fwd` and
:func:`launch_bwd` take an explicit plan of either design, so that the
scripts can time both on the same inputs.

Gate order is torch's [i, f, g, o]; both biases are folded into ``xg``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def cuda_core_plan(B: int, H: int, sm_count: int, smem_limit: int, backward: bool = False,
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


# The tensor-core mode (csrc/lstm_seq_mma.cu), for bf16 streams. A CTA owns
# `tiles` tiles of MMA_TILE batch rows (one warpgroup each: wgmma's 64 rows)
# and `units` hidden units (4 · units product columns in the forward, i, f,
# g and o of a unit in one thread), for the whole sequence, and keeps 4 ·
# units x H weights of W_hh in shared memory. The instantiations (units,
# tiles): (32, 2) cuts the GE2E step's B 640 x H 768 into 5 groups x 24
# slices = 120 CTAs; (32, 1) takes half the rows a CTA where two tiles would
# leave SMs idle (B 320: 5 x 24 against 3 x 24); (8, 1) keeps a small batch
# at H 512 on 64 CTAs.
MMA_KINDS = ((32, 2), (32, 1), (8, 1))
MMA_TILE = 64
MMA_COLUMNS = 128  # H must be a multiple of this: whole pairs of 4-step batches
# The backward's K-groups: `kgroup` slices pool their dxg, and each CTA's
# partial dh covers H / kgroup columns, which its instantiation fixes by
# its units (csrc/lstm_seq_mma.cu:RTVC_MMA_BWD): 192 (K-groups of 4 at H
# 768) for 32 units, 128 (4 at H 512) for 8.
MMA_BWD_COLUMNS = {32: 192, 8: 128}
MMA_BATCH = 4  # k16 steps a batch of fragment loads (csrc/lstm_seq_mma.cu:kBatch)
# The least batch at which each direction takes the tensor-core mode:
# (forward, backward). On an NVIDIA H100 80GB HBM3 at 700 W, bf16 at
# ForwardTacotron's T 900 x H 512, tensor cores against the CUDA-core
# design by explicit plans in one call (chip_smoke.py:k3_bf16_designs):
# B 16 forward 4.261 against 4.118 ms (64 slices of 8 units, one 64-row
# tile mostly padding: a step is a chain of latencies), backward 5.244
# against 5.639; B 48 forward 4.606 against 8.766, backward 5.951 against
# 15.390 (PERF.md section 6). Between 16 and 48 nothing was timed; the
# forward's threshold sits half way.
MMA_MIN_ROWS = (32, 1)


class MmaPlan(NamedTuple):
    """A launch of the tensor-core mode: ``groups`` x ``slices`` CTAs; a CTA
    owns ``units`` hidden units (every slice full: H = slices · units) of
    ``tiles`` x 64 batch rows (the last group's rows may run past B); the
    backward's CTAs pool their dxg in K-groups of ``kgroup`` slices (0 for
    the forward); ``smem`` bytes of shared memory a CTA."""
    groups: int
    slices: int
    units: int
    tiles: int
    kgroup: int
    smem: int


def mma_candidates(B: int, H: int, sm_count: int, smem_limit: int,
                   backward: bool = False) -> list:
    """Each tensor-core instantiation's :class:`MmaPlan` for a bf16 (B, T, H)
    sequence where its CTAs fit the SMs (all resident at once), its W slice
    (4 · units x H bf16) fits a block's shared memory and, for the
    backward, its K-group divides the slices and feeds the product whole
    pairs of batches. Empty where H is not a multiple of
    :data:`MMA_COLUMNS`."""
    if B < 1 or H < 1 or sm_count < 1:
        raise ValueError(f"lstm_seq: B {B}, H {H} and the SM count {sm_count} must be positive")
    out = []
    if H % MMA_COLUMNS:
        return out
    for units, tiles in MMA_KINDS:
        slices = H // units
        groups = -(-B // (tiles * MMA_TILE))
        smem = 2 * 4 * units * H
        if groups * slices > sm_count or smem > smem_limit:
            continue
        kgroup = 0
        if backward:
            kgroup, ragged = divmod(H, MMA_BWD_COLUMNS[units])
            if (ragged or not kgroup or slices % kgroup
                    or kgroup * units // 4 % (2 * MMA_BATCH)):
                continue
        out.append(MmaPlan(groups, slices, units, tiles, kgroup, smem))
    return out


def mma_plan(B: int, H: int, sm_count: int, smem_limit: int,
             backward: bool = False) -> Optional[MmaPlan]:
    """The tensor-core plan of the fewest rows x units a CTA (its share of
    the product and of the state it reads), the most CTAs on a tie; None
    where no instantiation fits."""
    fits = mma_candidates(B, H, sm_count, smem_limit, backward)
    if not fits:
        return None
    return min(fits, key=lambda p: (p.tiles * p.units, -p.groups * p.slices))


def plan(B: int, H: int, sm_count: int, smem_limit: int, backward: bool = False,
         elem: int = 4):
    """The launch of a (B, T, H) sequence whose streams take ``elem`` bytes
    an element: for bf16 (2) the :func:`mma_plan` wherever there is one and
    B reaches the direction's :data:`MMA_MIN_ROWS` (below it too where the
    CUDA-core design does not fit), else (and always for f32) the
    :func:`cuda_core_plan`, which raises ValueError for a hidden width past
    what the card can hold."""
    if elem == 2:
        p = mma_plan(B, H, sm_count, smem_limit, backward)
        if p is not None and (B >= MMA_MIN_ROWS[backward] or not any(
                isinstance(c, Plan) for c in candidates(B, H, sm_count, smem_limit, backward,
                                                        elem))):
            return p
    return cuda_core_plan(B, H, sm_count, smem_limit, backward, elem)


def describe(p) -> str:
    """A plan in words, for the scripts' lines."""
    if isinstance(p, MmaPlan):
        pool = f", dxg pooled in K-groups of {p.kgroup}" if p.kgroup else ""
        return (f"tensor cores: {p.groups} groups x {p.slices} slices of {p.units} units, "
                f"{p.tiles * MMA_TILE} rows a CTA{pool}, {p.smem} bytes of shared memory")
    return (f"{p.groups} groups x {p.slices} slices of {p.units} units, {p.nb} rows a warp, "
            f"{p.smem} bytes of shared memory")


def mode(p) -> str:
    return "tensor-core" if isinstance(p, MmaPlan) else "cuda-core"


def device_plan(B: int, H: int, device, backward: bool, dtype: torch.dtype):
    """:func:`plan` for this device's limits and stream dtype."""
    return plan(B, H, *_build.device_limits(device), backward=backward,
                elem=_build.elem_bytes(dtype))


def _call(lib, name: str, p, pointers, B: int, T: int, H: int, device, sync=None) -> None:
    """One launch through the C entry point ``name`` of ``lib`` (the built
    library when None) under the plan ``p``, with its zeroed barrier
    counters (:func:`barrier_words`, or ``sync``) held until the launch is
    queued."""
    if sync is None:
        sync = torch.zeros(barrier_words(p), device=device, dtype=torch.int32)
    err = getattr(lib or _build.library(), name)(
        *pointers, B, T, H, _build.int_array(p), sync.data_ptr(), _build.stream_handle(device))
    _build.check(err, name)


def barrier_words(p) -> int:
    """The int32 barrier counters a launch under ``p`` takes: one 128-byte
    line a batch group, and for the tensor-core backward one more a K-group
    of every group."""
    lines = p.groups
    if isinstance(p, MmaPlan) and p.kgroup:
        lines += p.groups * (p.slices // p.kgroup)
    return 32 * lines


def launch_fwd(p, xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor, ys: Tensor, hT: Tensor,
               cT: Tensor, cs: Optional[Tensor] = None, gates: Optional[Tensor] = None,
               lib=None, sync: Optional[Tensor] = None) -> None:
    """The forward kernel of ``p``'s design (an :class:`MmaPlan`, or a
    :class:`Plan` of the CUDA-core design) and of the streams' dtype, into
    ``ys``, ``hT``, ``cT`` and, when given, the residuals ``cs`` and
    ``gates``. Checks no tensor and counts no launch: the wrappers do both,
    and the scripts reach an explicit plan through this. ``sync``, zeroed
    int32 words (:func:`barrier_words` at least), replaces the barrier
    counters the launch makes itself (``profile_lstm`` reads its clocks from
    them)."""
    B, T, _ = xg.shape
    H = w_hh.shape[1]
    dev = xg.device
    ptrs = [t.data_ptr() if t is not None else None
            for t in (xg, w_hh, h0, c0, ys, hT, cT, cs, gates)]
    if isinstance(p, MmaPlan):  # h's hi/lo fragments, 32-bit words, rows past B zero
        name = "rtvc_lstm_mma_fwd_bf16"
        hx = torch.zeros((2, 2, p.groups * p.tiles * MMA_TILE, H // 2), device=dev,
                         dtype=torch.int32)
        ptrs.append(hx.data_ptr())
    elif xg.dtype == torch.float32:
        name = "rtvc_lstm_seq_fwd"
    else:  # the CUDA-core bf16 design carries h through an f32 exchange
        name = "rtvc_lstm_seq_fwd_bf16"
        hx = torch.empty((2, B, H), device=dev, dtype=torch.float32)
        ptrs.append(hx.data_ptr())
    _call(lib, name, p, ptrs, B, T, H, dev, sync)


def launch_bwd(p, dys: Tensor, dhT: Tensor, dcT: Tensor, gates: Tensor, cs: Tensor,
               c0: Tensor, w_hh: Tensor, dxg: Tensor, dh0: Tensor, dc0: Tensor,
               lib=None, sync: Optional[Tensor] = None) -> None:
    """The backward kernel of ``p``'s design and of the streams' dtype, into
    the f32 ``dxg``, ``dh0`` and ``dc0``, as :func:`launch_fwd`."""
    B, T, H = dys.shape
    dev = dys.device
    ptrs = [t.data_ptr() for t in (dys, dhT, dcT, gates, cs, c0, w_hh, dxg, dh0, dc0)]
    if isinstance(p, MmaPlan):  # dxg's hi/lo fragments, the K-groups' partial dh
        name = "rtvc_lstm_mma_bwd_bf16"
        rows = p.groups * p.tiles * MMA_TILE
        dx = torch.empty((2, 2, rows, 2 * H), device=dev, dtype=torch.int32)
        part = torch.empty((2, p.slices // p.kgroup, rows, H), device=dev, dtype=torch.float32)
        ptrs += [dx.data_ptr(), part.data_ptr()]
    else:
        name = "rtvc_lstm_seq_bwd" if dys.dtype == torch.float32 else "rtvc_lstm_seq_bwd_bf16"
    _call(lib, name, p, ptrs, B, T, H, dev, sync)


def grid_barrier_steps(ctas: int, steps: int, device) -> None:
    """A launch of ``steps`` grid barriers over ``ctas`` CTAs and nothing
    else: the cost a step of the recurrence pays before any work."""
    sync = torch.zeros(1, device=device, dtype=torch.int32)
    err = _build.library().rtvc_grid_barrier_steps(sync.data_ptr(), ctas, steps,
                                                   _build.stream_handle(device))
    _build.check(err, "rtvc_grid_barrier_steps")
    _build.count_launch("grid_barrier_steps")


def _fwd_kernel(xg: Tensor, w_hh: Tensor, h0: Tensor, c0: Tensor, residuals: bool):
    B, T, _ = xg.shape
    H = w_hh.shape[1]
    dt, dev = xg.dtype, xg.device
    _build.check_tensors("lstm_seq", dev, xg=(xg, (B, T, 4 * H), dt),
                         w_hh=(w_hh, (4 * H, H), dt), h0=(h0, (B, H)), c0=(c0, (B, H)))
    if B < 1 or T < 1:
        raise ValueError(f"lstm_seq: B and T must be at least 1, got {B} and {T}")
    f32 = lambda *shape: torch.empty(shape, device=dev, dtype=torch.float32)  # noqa: E731
    stream = lambda *shape: torch.empty(shape, device=dev, dtype=dt)  # noqa: E731
    ys, hT, cT = stream(B, T, H), f32(B, H), f32(B, H)
    cs, gates = (stream(B, T, H), stream(B, T, 4 * H)) if residuals else (None, None)
    launch_fwd(device_plan(B, H, dev, False, dt), xg, w_hh, h0, c0, ys, hT, cT, cs, gates)
    _build.count_launch("lstm_seq" if dt == torch.float32 else "lstm_seq_bf16")
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
    dxg = torch.empty((B, T, 4 * H), device=dev, dtype=torch.float32)
    dh0 = torch.empty((B, H), device=dev, dtype=torch.float32)
    dc0 = torch.empty((B, H), device=dev, dtype=torch.float32)
    launch_bwd(device_plan(B, H, dev, True, dt), dys, dhT, dcT, gates, cs, c0, w_hh, dxg, dh0,
               dc0)
    _build.count_launch("lstm_seq_bwd" if dt == torch.float32 else "lstm_seq_bwd_bf16")
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
