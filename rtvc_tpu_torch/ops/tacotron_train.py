"""K5: the teacher-forced Tacotron decoder chain, forward and backward.

Replaces ``rtvc_tpu/ops/pallas/tacotron_train_kernel.py:taco_decoder_train_fused``
(``_fwd_kernel`` / ``_bwd_kernel``). The CUDA kernels are in
``csrc/tacotron_train.cu``. One iteration of the chain is

    attention GRU (torch gate order r|z|n, ``b_hn`` inside the reset product,
    the context half of the input projection inside the loop)
    → location-sensitive attention (the ``KS``-tap conv over the cumulative
      scores folded with ``L`` into ``mloc`` (KS, D), query, tanh, ``v``, the
      multiplicative char mask, softmax) → context
    → ``rnn_input`` → two residual LSTMs with zoneout masks drawn outside.

Everything that does not depend on the recurrent state stays outside, as in
the JAX package: the prenet, the prenet half of the GRU's input projection
(``xg_pre``), the mel and stop projections, and the weight gradients, which
are sums over (iterations × batch) of the per-step cotangents the backward
emits.

- ``prepare_train_weights``: the model's parameters → :class:`TrainWeights`
  (plain differentiable tensor ops, so gradients chain back to the
  parameters, including the ``lsa_conv`` bias folded into ``bq``);
- ``taco_train_fwd`` / ``taco_train_bwd``: the two kernels' wrappers. CUDA
  tensors launch the kernel or raise; CPU tensors run the plain versions
  (``*_plain``), which the CPU tests hold against the JAX package;
- ``plan_fwd`` / ``plan_bwd``: the two kernels' partitions over the card
  (pure Python: the candidates, their cost on the card's rates, the
  shared-memory and workspace layouts each kernel reads);
- ``TacoDecoderTrainFn``: both halves as a ``torch.autograd.Function``.

Layouts: streams over iterations are time-major (n_iters, B, ·), as in the
JAX package; attention memory is (B, T_text, ·). The walk is over the exact
T_text and n_iters: there is no padding and no additive mask.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from rtvc_tpu_torch import _build
from rtvc_tpu_torch.ops.precision import widen

Tensor = torch.Tensor


class TrainWeights(NamedTuple):
    """The chain's weights in (in, out) layout, the JAX package's order."""

    gwh: Tensor      # (D, 3D)   attention GRU, hidden side
    gbh: Tensor      # (3D,)
    wq: Tensor       # (D, D)    query projection
    bq: Tensor       # (D,)      its bias plus the conv bias pushed through L
    mloc: Tensor     # (KS, D)   conv taps ⊗ L
    vv: Tensor       # (D,)
    wri: Tensor      # (E + D, L) rnn_input over [context | attention hidden]
    bri: Tensor      # (L,)
    l1wi: Tensor     # (L, 4L)
    l1wh: Tensor     # (L, 4L)
    l1b: Tensor      # (4L,)     bias_ih + bias_hh
    l2wi: Tensor
    l2wh: Tensor
    l2b: Tensor
    gwi_ctx: Tensor  # (E, 3D)   attention GRU, context half of the input side

    @property
    def dims(self) -> Tuple[int, int, int, int]:
        """(D, L, E, KS)."""
        D, L = self.gwh.shape[0], self.wri.shape[1]
        return D, L, self.wri.shape[0] - D, self.mloc.shape[0]


class TrainResiduals(NamedTuple):
    """What the forward keeps for the backward, all (n_iters, B, ·) but
    ``cum_T`` (B, T): the attention hidden, its gates [r, z, n, hn], the
    LSTM input, each LSTM's activated gates [i, f, g, o], cell and hidden,
    the scores, the context, and the final cumulative scores."""

    ah: Tensor
    g4: Tensor
    x0: Tensor
    gates1: Tensor
    c1: Tensor
    h1: Tensor
    gates2: Tensor
    c2: Tensor
    h2: Tensor
    scores: Tensor
    ctx: Tensor
    cum_T: Tensor


def prepare_train_weights(decoder, E: int) -> TrainWeights:
    """``models.tacotron.Decoder`` parameters → :class:`TrainWeights`
    (``tacotron_train_kernel.py:prepare_train_weights``). The location term
    ``L(conv(cum))`` is linear in ``cum``, so conv and ``L`` fold into one
    (KS, D) matrix and the conv bias into the query bias. Every parameter is
    widened to f32 first, as the JAX package's is: under the bf16 policy the
    chain runs in f32, and its weight gradients reach the bf16 casts through
    the widening."""
    cell, lsa = decoder.attn_rnn, decoder.attn_net
    conv_w = widen(lsa.conv.weight)[:, 0, :]                  # (F, KS)
    L_w = widen(lsa.L.weight)
    mloc = conv_w.t() @ L_w.t()                            # (KS, D)
    bq = widen(lsa.W.bias)
    if lsa.conv.bias is not None:
        bq = bq + L_w @ widen(lsa.conv.bias)
    l1, l2 = decoder.res_rnn1, decoder.res_rnn2
    return TrainWeights(
        gwh=widen(cell.weight_hh).t(), gbh=widen(cell.bias_hh), wq=widen(lsa.W.weight).t(), bq=bq,
        mloc=mloc, vv=widen(lsa.v.weight).reshape(-1), wri=widen(decoder.rnn_input.weight).t(),
        bri=widen(decoder.rnn_input.bias),
        l1wi=widen(l1.weight_ih).t(), l1wh=widen(l1.weight_hh).t(),
        l1b=widen(l1.bias_ih) + widen(l1.bias_hh),
        l2wi=widen(l2.weight_ih).t(), l2wh=widen(l2.weight_hh).t(),
        l2b=widen(l2.bias_ih) + widen(l2.bias_hh),
        gwi_ctx=widen(cell.weight_ih)[:, :E].t())


def _al4(n: int) -> int:
    return -(-n // 4) * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _windows(cum: Tensor, KS: int) -> Tensor:
    """cum (B, T) → (B, T, KS): win[b, t, k] = cum[b, t + k - (KS-1)/2],
    zero outside."""
    pad = (KS - 1) // 2
    return F.pad(cum, (pad, pad)).unfold(1, KS, 1)


def _lstm(x, h_prev, c_prev, wi, wh, b, zo, L):
    g = x @ wi + h_prev @ wh + b
    i = torch.sigmoid(g[:, :L])
    f = torch.sigmoid(g[:, L:2 * L])
    gg = torch.tanh(g[:, 2 * L:3 * L])
    o = torch.sigmoid(g[:, 3 * L:])
    c = f * c_prev + i * gg
    h = zo * h_prev + (1.0 - zo) * (o * torch.tanh(c))
    return h, c, torch.cat([i, f, gg, o], dim=1)


class FwdState(NamedTuple):
    """The chain's carried state: the attention hidden (B, D), the context
    (B, E), the cumulative scores (B, T) and both LSTMs' hidden and cell
    (B, L)."""

    ah: Tensor
    ctx: Tensor
    cum: Tensor
    h1: Tensor
    c1: Tensor
    h2: Tensor
    c2: Tensor


def fwd_step_plain(w: TrainWeights, xg_pre: Tensor, enc_seq: Tensor, enc_proj: Tensor,
                   char_mask: Tensor, zo1: Tensor, zo2: Tensor, state: FwdState
                   ) -> Tuple[Tensor, Dict[str, Tensor], FwdState]:
    """One step of the chain from ``state``: xg_pre (B, 3D) and zo1/zo2
    (B, L) are the step's slices. Returns x0 + h1 + h2 (B, L), the step's
    residual streams by :class:`TrainResiduals` field (``cum_T`` apart) and
    the next state."""
    D, L, E, KS = w.dims
    xg = xg_pre + state.ctx @ w.gwi_ctx
    hg = state.ah @ w.gwh + w.gbh
    r = torch.sigmoid(xg[:, :D] + hg[:, :D])
    zg = torch.sigmoid(xg[:, D:2 * D] + hg[:, D:2 * D])
    hn = hg[:, 2 * D:]
    ng = torch.tanh(xg[:, 2 * D:] + r * hn)
    ah = (1.0 - zg) * ng + zg * state.ah

    q = ah @ w.wq + w.bq
    tv = torch.tanh(q[:, None, :] + enc_proj + _windows(state.cum, KS) @ w.mloc)
    # the reference multiplies the logits by the pad mask (not an additive
    # mask): pad characters take part in the softmax at logit 0
    scores = torch.softmax((tv @ w.vv) * char_mask, dim=1)
    cum = state.cum + scores
    ctx = torch.einsum("bt,bte->be", scores, enc_seq)

    x0 = torch.cat([ctx, ah], dim=1) @ w.wri + w.bri
    h1, c1, g1 = _lstm(x0, state.h1, state.c1, w.l1wi, w.l1wh, w.l1b, zo1, L)
    h2, c2, g2 = _lstm(x0 + h1, state.h2, state.c2, w.l2wi, w.l2wh, w.l2b, zo2, L)
    streams = {"ah": ah, "g4": torch.cat([r, zg, ng, hn], dim=1), "x0": x0, "gates1": g1,
               "c1": c1, "h1": h1, "gates2": g2, "c2": c2, "h2": h2, "scores": scores,
               "ctx": ctx}
    return x0 + h1 + h2, streams, FwdState(ah, ctx, cum, h1, c1, h2, c2)


def taco_train_fwd_plain(w: TrainWeights, xg_pre: Tensor, enc_seq: Tensor, enc_proj: Tensor,
                         char_mask: Tensor, zo1: Tensor, zo2: Tensor
                         ) -> Tuple[Tensor, TrainResiduals]:
    """The chain from a zero state (:func:`fwd_step_plain` a step). xg_pre
    (n, B, 3D) is the hoisted half of the attention GRU's input projection
    (``bias_ih`` included); enc_seq (B, T, E), enc_proj (B, T, D), char_mask
    (B, T); zo1/zo2 (n, B, L) are the zoneout masks in {0, 1} (1 keeps the
    previous hidden). Returns x_all = x0 + h1 + h2 (n, B, L) and the
    residuals, whose ``ctx`` and ``scores`` are the chain's other two
    outputs."""
    D, L, E, KS = w.dims
    n, B, _ = xg_pre.shape
    T = enc_seq.shape[1]
    z = xg_pre.new_zeros
    state = FwdState(z((B, D)), z((B, E)), z((B, T)), z((B, L)), z((B, L)), z((B, L)),
                     z((B, L)))
    out = {k: [] for k in TrainResiduals._fields[:-1]}
    xs = []
    for s in range(n):
        x, streams, state = fwd_step_plain(w, xg_pre[s], enc_seq, enc_proj, char_mask, zo1[s],
                                           zo2[s], state)
        xs.append(x)
        for k, v in streams.items():
            out[k].append(v)
    res = TrainResiduals(**{k: torch.stack(v) for k, v in out.items()}, cum_T=state.cum)
    return torch.stack(xs), res


class TrainCotangents(NamedTuple):
    """What the backward emits: per-step cotangents (n, B, ·) of the GRU's
    input gates with the hidden-side n slice appended [dr, dz, dn, dn·r], of
    the query, of the LSTM input and of each LSTM's pre-activations; the
    cotangents of the attention memory (B, T, ·); and of ``vv`` (D,) and
    ``mloc`` (KS, D), summed over the batch."""

    dxg4: Tensor
    dq: Tensor
    dx0: Tensor
    dgates1: Tensor
    dgates2: Tensor
    denc_seq: Tensor
    denc_proj: Tensor
    dv: Tensor
    dmloc: Tensor


def _lstm_bwd(dh_tot, dc_in, gates, c, c_prev, zo, L):
    """One zoneout-LSTM step backwards → (dgates, dc carried to t-1)."""
    i, f, gg, o = gates[:, :L], gates[:, L:2 * L], gates[:, 2 * L:3 * L], gates[:, 3 * L:]
    tanh_c = torch.tanh(c)
    dhn = dh_tot * (1.0 - zo)
    d_o = dhn * tanh_c * o * (1.0 - o)
    dc = dc_in + dhn * o * (1.0 - tanh_c * tanh_c)
    d_i = dc * gg * i * (1.0 - i)
    d_f = dc * c_prev * f * (1.0 - f)
    d_g = dc * i * (1.0 - gg * gg)
    return torch.cat([d_i, d_f, d_g, d_o], dim=1), dc * f


def taco_train_bwd_plain(w: TrainWeights, res: TrainResiduals, enc_seq: Tensor,
                         enc_proj: Tensor, char_mask: Tensor, zo1: Tensor, zo2: Tensor,
                         dx_all: Tensor, dctx_all: Tensor, dscores_all: Tensor
                         ) -> TrainCotangents:
    """The reverse walk of ``tacotron_train_kernel.py:_bwd_kernel``, written
    out by hand: seven carried cotangents (attention hidden, both LSTMs'
    hidden and cell, context, cumulative scores); ``tanh`` terms recomputed
    from the stored scores (``cum_prev = cum - scores``); the previous
    step's streams read one step back (zero at step 0). dx_all (n, B, L),
    dctx_all (n, B, E) and dscores_all (n, B, T) are the cotangents of the
    forward's three outputs."""
    D, L, E, KS = w.dims
    n, B, _ = dx_all.shape
    T = enc_seq.shape[1]
    pad = (KS - 1) // 2
    z = dx_all.new_zeros
    dah, dctx, dcum = z((B, D)), z((B, E)), z((B, T))
    dh1, dc1, dh2, dc2 = z((B, L)), z((B, L)), z((B, L)), z((B, L))
    denc_seq, denc_proj = torch.zeros_like(enc_seq), torch.zeros_like(enc_proj)
    dv, dmloc = z((D,)), z((KS, D))
    cum = res.cum_T
    zeros_L, zeros_D = z((B, L)), z((B, D))
    dxg4, dq_all, dx0_all, dg1_all, dg2_all = [], [], [], [], []
    W = T + KS - 1
    for s in range(n - 1, -1, -1):
        dx2 = dx_all[s]
        dh2_tot = dx2 + dh2
        dg2, dc2 = _lstm_bwd(dh2_tot, dc2, res.gates2[s], res.c2[s],
                             res.c2[s - 1] if s else zeros_L, zo2[s], L)
        dh2 = dh2_tot * zo2[s] + dg2 @ w.l2wh.t()
        dx1 = dx2 + dg2 @ w.l2wi.t()
        dh1_tot = dx1 + dh1
        dg1, dc1 = _lstm_bwd(dh1_tot, dc1, res.gates1[s], res.c1[s],
                             res.c1[s - 1] if s else zeros_L, zo1[s], L)
        dh1 = dh1_tot * zo1[s] + dg1 @ w.l1wh.t()
        dx0 = dx1 + dg1 @ w.l1wi.t()

        dcat = dx0 @ w.wri.t()
        dctx_tot = dctx_all[s] + dctx + dcat[:, :E]
        dah_tot = dah + dcat[:, E:]

        scores = res.scores[s]
        denc_seq += scores[:, :, None] * dctx_tot[:, None, :]
        dsc = dscores_all[s] + dcum + torch.einsum("be,bte->bt", dctx_tot, enc_seq)
        du = scores * (dsc - (dsc * scores).sum(dim=1, keepdim=True)) * char_mask

        cum = cum - scores                      # the cumulative scores before step s
        win = _windows(cum, KS)
        q = res.ah[s] @ w.wq + w.bq
        tv = torch.tanh(q[:, None, :] + enc_proj + win @ w.mloc)
        dv += (du[:, :, None] * tv).sum(dim=(0, 1))
        darg = du[:, :, None] * w.vv * (1.0 - tv * tv)
        denc_proj += darg
        dq = darg.sum(dim=1)
        dmloc += win.reshape(B * T, KS).t() @ darg.reshape(B * T, D)
        # adjoint of the windows: dcum[τ] += Σ_k (darg · mlocᵀ)[τ + pad - k, k],
        # the anti-diagonal sums of a (T, KS) matrix, taken by a skewed view
        sk = F.pad(darg @ w.mloc.t(), (0, W + 1 - KS))
        dcum = dcum + sk.reshape(B, -1)[:, :T * W].reshape(B, T, W).sum(dim=1)[:, pad:pad + T]

        dah_tot = dah_tot + dq @ w.wq.t()
        g4 = res.g4[s]
        r, zg, ng, hn = g4[:, :D], g4[:, D:2 * D], g4[:, 2 * D:3 * D], g4[:, 3 * D:]
        ah_prev = res.ah[s - 1] if s else zeros_D
        dz = dah_tot * (ah_prev - ng) * zg * (1.0 - zg)
        dn = dah_tot * (1.0 - zg) * (1.0 - ng * ng)
        dr = dn * hn * r * (1.0 - r)
        dah = dah_tot * zg + torch.cat([dr, dz, dn * r], dim=1) @ w.gwh.t()
        dctx = torch.cat([dr, dz, dn], dim=1) @ w.gwi_ctx.t()
        dxg4.append(torch.cat([dr, dz, dn, dn * r], dim=1))
        dq_all.append(dq)
        dx0_all.append(dx0)
        dg1_all.append(dg1)
        dg2_all.append(dg2)

    def stack(parts):
        return torch.stack(parts[::-1])

    return TrainCotangents(stack(dxg4), stack(dq_all), stack(dx0_all), stack(dg1_all),
                           stack(dg2_all), denc_seq, denc_proj, dv, dmloc)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


_MATS = ("gwh", "wq", "wri", "l1wi", "l1wh", "l2wi", "l2wh", "gwi_ctx")


def _check_mats(fn: str, w: TrainWeights, dev) -> list:
    """The eight matrices as TrainWeights holds them (any strides: the kernels
    gather their rows themselves), after checking type, shape and device."""
    D, L, E, _ = w.dims
    shapes = ((D, 3 * D), (D, D), (E + D, L), (L, 4 * L), (L, 4 * L), (L, 4 * L), (L, 4 * L),
              (E, 3 * D))
    mats = [getattr(w, name) for name in _MATS]
    for name, m, shape in zip(_MATS, mats, shapes):
        if m.device != dev or m.dtype != torch.float32 or tuple(m.shape) != shape:
            raise ValueError(f"{fn}: {name} must be f32 {shape} on {dev}, got "
                             f"{m.dtype} {tuple(m.shape)} on {m.device}")
    return mats


def _work(fn: str, work, total: int, dev) -> Tensor:
    """``work`` (at least ``total`` floats) or a new workspace, the barrier's
    counter zeroed."""
    if work is None:
        work = torch.empty(total, device=dev, dtype=torch.float32)
    elif work.numel() < total or work.device != dev or work.dtype != torch.float32:
        raise ValueError(f"{fn}: work must be at least {total} f32 on {dev}")
    work[:32].zero_()
    return work


def taco_train_fwd(w: TrainWeights, xg_pre: Tensor, enc_seq: Tensor, enc_proj: Tensor,
                   char_mask: Tensor, zo1: Tensor, zo2: Tensor
                   ) -> Tuple[Tensor, TrainResiduals]:
    """Same contract as :func:`taco_train_fwd_plain`; CUDA tensors go through
    the kernel with this card's plan, CPU tensors through the plain version."""
    if not xg_pre.is_cuda:
        return taco_train_fwd_plain(w, xg_pre, enc_seq, enc_proj, char_mask, zo1, zo2)
    out = fwd_launch(_build.library(), w, xg_pre, enc_seq, enc_proj, char_mask, zo1, zo2)
    _build.launch_counts["tacotron_train_fwd"] += 1
    return out


def fwd_launch(lib, w: TrainWeights, xg_pre: Tensor, enc_seq: Tensor, enc_proj: Tensor,
               char_mask: Tensor, zo1: Tensor, zo2: Tensor, p: "FwdPlan" = None,
               work: Tensor = None) -> Tuple[Tensor, TrainResiduals]:
    """One launch of ``lib``'s ``rtvc_tacotron_train_fwd`` (the package's
    library, or a variant that ``profile_tacotron_train`` builds) on CUDA
    tensors, after the shape checks, with ``p`` or this card's plan, and
    ``work`` (at least ``p.ws[-1]`` floats) or a new workspace. The kernel
    reads the eight matrices as TrainWeights holds them (transposed views and
    the column slice ``gwi_ctx`` of the GRU's ``weight_ih`` included) and
    gathers its slices itself: no copy is made."""
    D, L, E, KS = w.dims
    n, B, _ = xg_pre.shape
    T = enc_seq.shape[1]
    fn, dev = "tacotron_train_fwd", xg_pre.device
    if p is None:
        p = device_plan_fwd(n, B, T, (D, L, E, KS), dev)
    mats = _check_mats(fn, w, dev)
    vecs = [v.contiguous() for v in (w.gbh, w.bq, w.mloc, w.vv, w.bri, w.l1b, w.l2b)]
    _build.check_tensors(
        fn, dev, xg_pre=(xg_pre, (n, B, 3 * D)), enc_seq=(enc_seq, (B, T, E)),
        enc_proj=(enc_proj, (B, T, D)), char_mask=(char_mask, (B, T)),
        zo1=(zo1, (n, B, L)), zo2=(zo2, (n, B, L)),
        gbh=(vecs[0], (3 * D,)), bq=(vecs[1], (D,)), mloc=(vecs[2], (KS, D)),
        vv=(vecs[3], (D,)), bri=(vecs[4], (L,)), l1b=(vecs[5], (4 * L,)),
        l2b=(vecs[6], (4 * L,)))

    def e(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    x_all = e(n, B, L)
    res = TrainResiduals(ah=e(n, B, D), g4=e(n, B, 4 * D), x0=e(n, B, L),
                         gates1=e(n, B, 4 * L), c1=e(n, B, L), h1=e(n, B, L),
                         gates2=e(n, B, 4 * L), c2=e(n, B, L), h2=e(n, B, L),
                         scores=e(n, B, T), ctx=e(n, B, E), cum_T=e(B, T))
    work = _work(fn, work, p.ws[-1], dev)
    ints = p.ints()
    err = lib.rtvc_tacotron_train_fwd(
        _build.pointer_array([*mats, *vecs]),
        _build.int_array([x for m in mats for x in m.stride()]),
        _build.pointer_array([xg_pre, zo1, zo2, enc_seq, enc_proj, char_mask]),
        _build.pointer_array([x_all, *res]),
        _build.int_array([n, B, T, D, L, E, KS]), _build.int_array(ints), len(ints),
        work.data_ptr(), _build.stream_handle(dev))
    _build.check(err, "rtvc_tacotron_train_fwd")
    return x_all, res


# ---------------------------------------------------------------------------
# The kernels' partitions over the card
# ---------------------------------------------------------------------------

# The kernels' constants (csrc/tacotron_train.cu: kThreads, kRows, kNB,
# kChunk, kMaxTaps, kHeaderFloats; bwd::kPairTile, bwd::kStageSteps x
# bwd::kStageT; fwd::kCtxCols).
THREADS = 256       # threads of a CTA of either kernel
WARPS = THREADS // 32
ROWS = 8            # weight rows an item of a product takes
NB = 8              # batch rows an item takes
CHUNK = 128         # floats of the reduction axis a warp covers at once
MAX_TAPS = 32       # location taps a thread keeps in registers (at most 31 used)
HEADER = 512        # floats of shared memory for the launch's parameters
PAIR_TILE = 8       # (row, character) pairs the backward's attention phase takes at once
STAGE = 2048        # floats of the buffer the backward's last phase stages the scores in
CTX_COLS = 128      # context columns of an item of the forward's phase D

# Candidate partitions of both kernels: (mode, batch groups). "resident": the
# weight slices in the CTA's shared memory; "l2": read every step from a copy
# the kernel gathers into the workspace. With g groups the CTAs of a group
# own the units of every cut for that group's batch rows.
MODES = ("resident", "l2")
CANDIDATES = (("resident", 1), ("l2", 1), ("l2", 2))

# The card's rates the cost models rank candidates by (NVIDIA H100 SXM): one
# SM streams ≈ 78 GB/s out of L2 and the card ≈ 8 TB/s (measured for K1-K5);
# device memory 3.35 TB/s and a 50 MB L2; a grid barrier over 132 CTAs
# ≈ 1.05 µs (measured for K3); a phase's own latency, an L2 round trip and the
# lanes' sum, ≈ 2 µs (measured for K2); 67 TFLOP/s of f32 FMAs over the SMs.
# The backward's model, which charges the products and the attention at
# those rates, missed the card by 2.5-3x (PERF.md section 6): outside
# its barriers a step took ≈ 3.3 times the model's time, the products and the
# attention being chains of dependent loads with 8 warps a SM. The forward's
# model charges its products' L2 bytes and FMAs, and its attention's FMAs,
# at the share of those rates the backward reached (REACHED); the
# backward's keeps the card's rates, which rank its candidates in the card's
# order (PERF.md section 6).
L2_SM_BPS = 78e9
L2_CARD_BPS = 8e12
L2_BYTES = 50e6
HBM_BPS = 3.35e12
BARRIER_US = 1.05
PHASE_US = 2.0
FMA_CARD = 67e12 / 2
REACHED = 0.3

# The backward's cuts (csrc: bwd::Cut): LSTM units, context columns,
# attention units, (row, character) pairs. The first three are cut over the
# slices of a batch group, the pairs over every CTA.
BWD_CUTS = ("lstm", "ctx", "att", "pair")
# The products of a reverse step in the kernel's order (csrc: bwd::Product);
# bwd_products gives each one's cut, gates, reduction length and phase.
BWD_PRODUCTS = ("q", "gctx", "gh", "l2", "l1", "ric", "ria", "wq")
# Phases of a step, each ended by a grid barrier.
BWD_PHASES = "ABCDEFGH"
# Shared-memory offsets besides the weights and the products' sums, in the
# order of bwd::Plan's fields from dh2 to end.
BWD_SMEM_SLOTS = ("dh2", "dc2", "hold2", "dh1", "dc1", "hold1", "dx1", "dctx", "dah", "outs",
                  "scratch", "rowbuf", "row_stride", "soft_rows", "wpart", "end")
# The workspace after the barrier's 32 words (csrc: bwd::Ws), in floats.
BWD_WS_SLOTS = ("q", "dhg", "u", "cum0", "cum1", "dcum", "sarr", "dqp", "dvp", "dmlp", "dctx",
                "wl2", "total")

# The forward's cuts (csrc: fwd::Cut): attention units (a unit's 3 gate rows
# of gwh and gwi_ctx and its query column), LSTM units (a unit's 4 gate rows
# of each LSTM's two matrices and rnn_input's output column), cut over the
# slices of a batch group; (row, character) pairs, cut over every CTA. The
# context items (row b, CTX_COLS columns k) go with the pairs: item k of row b
# is the CTA's that owns pair (b, k·T // ceil(E / CTX_COLS)).
FWD_CUTS = ("att", "lstm", "pair")
FWD_PRODUCTS = ("gctx", "gh", "l1h", "l2h", "q", "ria", "ric", "l1i", "l2i")
FWD_PHASES = "ABCDEFG"
# The state of the CTA's units for its rows, in the order of fwd::Plan's
# fields from ah, then the other offsets to end.
FWD_STATE = (("ah", "att"), ("c1", "lstm"), ("h1", "lstm"), ("c2", "lstm"), ("h2", "lstm"),
             ("x0", "lstm"), ("x1", "lstm"))
FWD_SMEM_SLOTS = tuple(s for s, _ in FWD_STATE) + ("outs", "scratch", "rowbuf", "row_stride",
                                                   "soft_rows", "wpart", "end")
FWD_WS_SLOTS = ("q", "u", "cum", "x1", "wl2", "total")


def bwd_products(D: int, L: int, E: int) -> Dict[str, Tuple[str, int, int, str]]:
    """name → (cut, gates, reduction length, phase). Every product of the
    backward multiplies by a transpose, so a unit's row is a row of the
    (in, out) matrix of TrainWeights: ``q`` lsa_W's column j (the query,
    recomputed from the stored attention hidden), ``gctx`` gwi_ctx's row e,
    ``gh`` gwh's row j, ``l2``/``l1`` the two rows [W_hh; W_ih] of LSTM
    unit j, ``ric``/``ria`` rnn_input's rows e and E + j, ``wq`` lsa_W's
    row j."""
    return {"q": ("att", 1, D, "A"), "gctx": ("ctx", 1, 3 * D, "A"),
            "gh": ("att", 1, 3 * D, "A"), "l2": ("lstm", 2, 4 * L, "B"),
            "l1": ("lstm", 2, 4 * L, "C"), "ric": ("ctx", 1, L, "D"),
            "ria": ("att", 1, L, "D"), "wq": ("att", 1, D, "H")}


def fwd_products(D: int, L: int, E: int) -> Dict[str, Tuple[str, int, int, str, str]]:
    """name → (cut, gates, reduction length, phase, the phase that reads its
    sums). A unit's row of a forward product is a column of the (in, out)
    matrix: ``gctx`` / ``gh`` the GRU unit's 3 gate columns of gwi_ctx (over
    the previous context) and gwh (over the previous attention hidden);
    ``l1h`` / ``l2h`` the LSTM unit's 4 gate columns of W_hh over the
    previous h, beside the chain in phase A and read in F and G; ``q`` lsa_W's
    column; ``ria`` / ``ric`` rnn_input's column over the attention hidden and
    over the context; ``l1i`` / ``l2i`` the 4 gate columns of W_ih."""
    return {"gctx": ("att", 3, E, "A", "A"), "gh": ("att", 3, D, "A", "A"),
            "l1h": ("lstm", 4, L, "A", "F"), "l2h": ("lstm", 4, L, "A", "G"),
            "q": ("att", 1, D, "B", "B"), "ria": ("lstm", 1, D, "B", "B"),
            "ric": ("lstm", 1, E, "E", "E"), "l1i": ("lstm", 4, L, "F", "F"),
            "l2i": ("lstm", 4, L, "G", "G")}


class Plan(NamedTuple):
    """How a kernel is cut over the card: ``ctas`` CTAs in ``groups`` batch
    groups of ``rows`` batch rows (CTA c is slice c // groups of group
    c % groups); ``mode`` (index into MODES); ``smem`` bytes of shared memory
    a CTA. ``q``: units a slice of each cut (pairs a CTA for "pair"). For
    each product: ``ks`` pieces its reduction axis is cut into, ``w_off``
    the offset of the CTA's weight rows (gates × units of the slice; in
    shared memory, or in its workspace copy for "l2"), ``out_off`` the
    offset of its sums. ``sm``: the offsets of the direction's
    SMEM_SLOTS; ``ws``: those of its WS_SLOTS in the workspace (floats after
    32 words for the barrier)."""
    ctas: int
    groups: int
    mode: int
    rows: int
    smem: int
    q: Tuple[int, ...]
    ks: Tuple[int, ...]
    w_off: Tuple[int, ...]
    out_off: Tuple[int, ...]
    sm: Tuple[int, ...]
    ws: Tuple[int, ...]
    cost_ms: float

    CUTS = BWD_CUTS

    def ints(self):
        """The plan as the kernel reads it (csrc: fwd::Plan, bwd::Plan)."""
        out = [self.ctas, self.groups, self.mode, self.rows, self.smem]
        for part in self[5:11]:
            out.extend(part)
        return out

    @property
    def slices(self) -> int:
        return self.ctas // self.groups

    @property
    def name(self) -> str:
        return f"{MODES[self.mode]} x{self.groups}"

    def owned(self, cut: str, n: int, cta: int) -> range:
        """The units [0, n) of ``cut`` that CTA ``cta`` owns (for the batch
        rows of its group, but for the pairs, cut over every CTA)."""
        q = self.q[self.CUTS.index(cut)]
        start = (cta if cut == "pair" else cta // self.groups) * q
        return range(min(start, n), min(start + q, n))

    def batch_rows(self, B: int, cta: int) -> range:
        g = cta % self.groups
        return range(min(g * self.rows, B), min((g + 1) * self.rows, B))


class BwdPlan(Plan):
    """The backward's :class:`Plan` (csrc: bwd::Plan)."""
    __slots__ = ()
    CUTS = BWD_CUTS


class FwdPlan(Plan):
    """The forward's :class:`Plan` (csrc: fwd::Plan)."""
    __slots__ = ()
    CUTS = FWD_CUTS


def _pair_rows(q_pair: int, B: int, T: int, ctas: int) -> int:
    """The most batch rows the (row, character) pairs of one CTA touch."""
    most = 0
    for c in range(ctas):
        lo, hi = c * q_pair, min((c + 1) * q_pair, B * T)
        if lo < hi:
            most = max(most, (hi - 1) // T - lo // T + 1)
    return most


def bwd_row_stride(T: int, D: int, E: int, KS: int) -> int:
    """Floats a staged batch row takes in the attention phases: in phase F
    its cotangent of the logits, scores, char mask, the zero-bordered
    cumulative scores, the query and the CTA's part of dq; in phase E its
    context cotangent."""
    return max(3 * _al4(T) + _al4(T + KS - 1) + 2 * _al4(D), _al4(E))


def fwd_row_stride(T: int, D: int) -> int:
    """Floats a staged batch row takes in the forward: in phase C its
    cumulative scores with a zero border wide enough for a tile's windows,
    and its query; in phase D its logits, then scores."""
    return max(_al4(T + 2 * MAX_TAPS) + _al4(D), _al4(T))


def _check_inputs(fn: str, n, B, T, dims, sm_count) -> None:
    D, L, E, KS = dims
    if min(n, B, T, D, L, E, KS, sm_count) < 1:
        raise ValueError(f"{fn}: bad plan inputs n {n} B {B} T {T} dims {dims} "
                         f"SMs {sm_count}")
    if KS % 2 == 0 or KS > MAX_TAPS - 1:
        raise ValueError(f"{fn}: {KS} location taps: odd and at most "
                         f"{MAX_TAPS - 1}, the limit of the registers a thread keeps them in")


def _choose(fn: str, layout, n, B, T, dims, sm_count, smem_limit, candidate):
    """Every candidate of CANDIDATES (or ``candidate`` alone) laid out on
    ``sm_count`` CTAs; the cheapest that fits ``smem_limit``."""
    _check_inputs(fn, n, B, T, dims, sm_count)
    D, L, E, _ = dims
    if candidate is not None and tuple(candidate) not in CANDIDATES:
        raise ValueError(f"{fn}: candidate {candidate} is not one of {CANDIDATES}")
    made, refused = [], []
    for mode, groups in ([tuple(candidate)] if candidate is not None else CANDIDATES):
        ctas = sm_count // groups * groups
        if ctas < 1:
            refused.append(f"{mode} x{groups}: fewer than {groups} CTAs")
            continue
        p = layout(n, B, T, dims, ctas, groups, mode)
        if p.smem <= smem_limit:
            made.append(p)
        else:
            refused.append(f"{mode} x{groups} needs {p.smem}")
    if not made:
        raise ValueError(f"{fn}: B {B} x T {T} at D {D}, L {L}, E {E} on "
                         f"{sm_count} SMs: " + "; ".join(refused) +
                         f" bytes of shared memory a CTA, past the limit of {smem_limit}")
    return min(made, key=lambda p: p.cost_ms)


@functools.lru_cache(maxsize=256)
def plan_bwd(n: int, B: int, T: int, dims: Tuple[int, int, int, int], sm_count: int,
             smem_limit: int, candidate=None) -> BwdPlan:
    """The partition of K5's backward for ``n`` steps of B rows of T
    characters at widths ``dims`` = (D, L, E, KS) on a card with ``sm_count``
    SMs whose blocks take ``smem_limit`` bytes of shared memory. Every
    candidate of CANDIDATES that fits is costed by the model above and the
    cheapest is taken; ``candidate`` = (mode, groups) forces one (the profile
    and the tests use that). Raises ValueError, naming the limit, for a shape
    past it. Kept per argument tuple: a wrapper plans on every call, and a
    plan takes ≈ 0.4 ms of the host's time."""
    return _choose("tacotron_train_bwd", _bwd_layout, n, B, T, dims, sm_count, smem_limit,
                   candidate)


@functools.lru_cache(maxsize=256)
def plan_fwd(n: int, B: int, T: int, dims: Tuple[int, int, int, int], sm_count: int,
             smem_limit: int, candidate=None) -> FwdPlan:
    """The partition of K5's forward, with the same arguments, candidates
    and refusals as :func:`plan_bwd`."""
    return _choose("tacotron_train_fwd", _fwd_layout, n, B, T, dims, sm_count, smem_limit,
                   candidate)


def _pieces(prods, q, rows) -> Dict[str, int]:
    """Pieces each product's reduction axis is cut into: enough items that
    every warp of the CTA has one, in whole chunks."""
    ks = {}
    for name, (cut, gates, k, *_) in prods.items():
        items = _cdiv(gates * q[cut], ROWS) * _cdiv(rows, NB)
        chunks = _cdiv(k, CHUNK)
        want = min(chunks, _cdiv(WARPS, items))
        ks[name] = _cdiv(chunks, _cdiv(chunks, want))
    return ks


def _place_weights(prods, q, mode, o):
    """Each product's weight rows: in shared memory from offset ``o``, or in
    the CTA's workspace copy for "l2". → (offsets, floats of the copy, o)."""
    w_off, wl2 = {}, 0
    for name, (cut, gates, k, *_) in prods.items():
        size = gates * q[cut] * _al4(k)
        if mode == "l2":
            w_off[name] = wl2
            wl2 += size
        else:
            w_off[name] = o
            o += size
    return w_off, wl2, o


def _phase_sums(prods, phases, q, rows, ks, o):
    """The products' sums from offset ``o``: those of the products of one
    phase side by side, the phases over the same floats. → (offsets, o)."""
    out_off, widest = {}, 0
    for phase in phases:
        at = o
        for name, (cut, gates, _, ph, *_) in prods.items():
            if ph == phase and name not in out_off:
                out_off[name] = at
                at += _al4(ks[name] * gates * q[cut] * rows)
        widest = max(widest, at - o)
    return out_off, o + widest


def _products_s(prods, phase, q, rows, mode, l2_sm, fma_sm) -> float:
    """Seconds of one CTA's products of ``phase``: the slower of their inputs
    (read once for each block of ROWS weight rows) and L2 weights over
    ``l2_sm``, a SM's share of L2, and their FMAs over ``fma_sm``, a SM's
    rate."""
    l2 = fma = 0.0
    for cut, gates, k, ph, *_ in prods.values():
        if ph != phase:
            continue
        n_rows = gates * q[cut]
        l2 += 4 * _cdiv(n_rows, ROWS) * rows * k
        if mode == "l2":
            l2 += 4 * n_rows * k * _cdiv(rows, NB)
        fma += n_rows * k * rows
    return max(l2 / l2_sm, fma / fma_sm)


def _bwd_layout(n, B, T, dims, ctas, groups, mode) -> BwdPlan:
    D, L, E, KS = dims
    slices = ctas // groups
    rows = _cdiv(B, groups)
    q = {"lstm": _cdiv(L, slices), "ctx": _cdiv(E, slices), "att": _cdiv(D, slices),
         "pair": _cdiv(B * T, ctas)}
    prods = bwd_products(D, L, E)
    ks = _pieces(prods, q, rows)
    w_off, wl2, o = _place_weights(prods, q, mode, HEADER)
    sm = {}
    for slot, cut in (("dh2", "lstm"), ("dc2", "lstm"), ("hold2", "lstm"), ("dh1", "lstm"),
                      ("dc1", "lstm"), ("hold1", "lstm"), ("dx1", "lstm"), ("dctx", "ctx"),
                      ("dah", "att")):
        sm[slot] = o
        o += _al4(q[cut] * rows)
    sm["outs"] = o
    out_off, o = _phase_sums(prods, BWD_PHASES, q, rows, ks, o)
    sm["scratch"] = o
    o += WARPS * _cdiv(ROWS * NB, 32) * 32
    sm["soft_rows"] = _pair_rows(q["pair"], B, T, ctas)
    sm["row_stride"] = bwd_row_stride(T, D, E, KS)
    sm["rowbuf"] = o
    o += sm["soft_rows"] * sm["row_stride"]
    sm["wpart"] = o
    o += max(PAIR_TILE * THREADS, STAGE)
    sm["end"] = o
    T4, D4, E4 = _al4(T), _al4(D), _al4(E)
    ws, w = {}, 32
    for slot, size in (("q", B * D4), ("dhg", B * _al4(3 * D)), ("u", B * T4), ("cum0", B * T4),
                       ("cum1", B * T4), ("dcum", B * T4), ("sarr", B * T * MAX_TAPS),
                       ("dqp", ctas * sm["soft_rows"] * D4), ("dvp", ctas * D4),
                       ("dmlp", ctas * KS * D4), ("dctx", n * B * E4), ("wl2", ctas * wl2)):
        ws[slot] = w
        w += size
    ws["total"] = w
    cost = _bwd_cost_ms(n, B, T, dims, ctas, mode, q, rows, prods)
    return BwdPlan(ctas, groups, MODES.index(mode), rows, 4 * o,
                   tuple(q[c] for c in BWD_CUTS), tuple(ks[p] for p in BWD_PRODUCTS),
                   tuple(w_off[p] for p in BWD_PRODUCTS), tuple(out_off[p] for p in BWD_PRODUCTS),
                   tuple(sm[k] for k in BWD_SMEM_SLOTS), tuple(ws[k] for k in BWD_WS_SLOTS), cost)


def _bwd_cost_ms(n, B, T, dims, ctas, mode, q, rows, prods) -> float:
    """The model's milliseconds for the whole launch: per step, the barriers
    and each phase's latency, each product phase's time, and the attention
    phases (their device-memory bytes over the card's rate or their FMAs);
    then the scores · context product after the walk."""
    D, L, E, KS = dims
    l2_sm = min(L2_SM_BPS, L2_CARD_BPS / ctas)
    fma_sm = FMA_CARD / ctas
    step = len(BWD_PHASES) * (BARRIER_US + PHASE_US) * 1e-6
    for phase in BWD_PHASES:
        step += _products_s(prods, phase, q, rows, mode, l2_sm, fma_sm)
    hbm = 4 * B * T * (E + 3 * D)
    pair_fma = _cdiv(B * T, ctas) * (E + 3 * KS * D + 8 * D)
    step += max(hbm / HBM_BPS, pair_fma / fma_sm)
    after = n * B * T * E / (0.5 * FMA_CARD)
    return 1e3 * (n * step + after)


def _fwd_layout(n, B, T, dims, ctas, groups, mode) -> FwdPlan:
    D, L, E, KS = dims
    slices = ctas // groups
    rows = _cdiv(B, groups)
    q = {"att": _cdiv(D, slices), "lstm": _cdiv(L, slices), "pair": _cdiv(B * T, ctas)}
    prods = fwd_products(D, L, E)
    ks = _pieces(prods, q, rows)
    w_off, wl2, o = _place_weights(prods, q, mode, HEADER)
    sm = {}
    for slot, cut in FWD_STATE:
        sm[slot] = o
        o += _al4(q[cut] * rows)
    # the sums a later phase reads keep their own floats
    out_off = {}
    for name, (cut, gates, _, ph, read) in prods.items():
        if read != ph:
            out_off[name] = o
            o += _al4(ks[name] * gates * q[cut] * rows)
    sm["outs"] = o
    shared, o = _phase_sums({k: v for k, v in prods.items() if k not in out_off}, FWD_PHASES,
                            q, rows, ks, o)
    out_off.update(shared)
    sm["scratch"] = o
    o += WARPS * _cdiv(ROWS * NB, 32) * 32
    sm["soft_rows"] = _pair_rows(q["pair"], B, T, ctas)
    sm["row_stride"] = fwd_row_stride(T, D)
    sm["rowbuf"] = o
    o += sm["soft_rows"] * sm["row_stride"]
    # phase C: two halves of the warps' partial sums, then its pairs' sums;
    # phase D: a float4 of partial context sums a thread
    sm["wpart"] = o
    o += max(2 * WARPS * 32 + _al4(q["pair"]), 4 * THREADS)
    sm["end"] = o
    ws, w = {}, 32
    for slot, size in (("q", B * _al4(D)), ("u", B * _al4(T)), ("cum", B * _al4(T)),
                       ("x1", B * _al4(L)), ("wl2", ctas * wl2)):
        ws[slot] = w
        w += size
    ws["total"] = w
    cost = _fwd_cost_ms(n, B, T, dims, ctas, mode, q, rows, prods)
    return FwdPlan(ctas, groups, MODES.index(mode), rows, 4 * o,
                   tuple(q[c] for c in FWD_CUTS), tuple(ks[p] for p in FWD_PRODUCTS),
                   tuple(w_off[p] for p in FWD_PRODUCTS), tuple(out_off[p] for p in FWD_PRODUCTS),
                   tuple(sm[k] for k in FWD_SMEM_SLOTS), tuple(ws[k] for k in FWD_WS_SLOTS), cost)


def _fwd_cost_ms(n, B, T, dims, ctas, mode, q, rows, prods) -> float:
    """The model's milliseconds for the whole launch: per step, the barriers
    and each phase's latency, each product phase's time, the energies (the
    enc_proj bytes, or their location taps and tanh) and the context (the
    enc_seq bytes, or its FMAs), the L2 and the FMAs at the share REACHED
    of the card's rates. The attention memory comes from device memory
    where it outgrows the L2, else from the L2."""
    D, L, E, KS = dims
    l2_sm = min(L2_SM_BPS, L2_CARD_BPS / ctas) * REACHED
    fma_sm = FMA_CARD * REACHED / ctas
    step = len(FWD_PHASES) * (BARRIER_US + PHASE_US) * 1e-6
    for phase in FWD_PHASES:
        step += _products_s(prods, phase, q, rows, mode, l2_sm, fma_sm)
    rate = HBM_BPS if 4 * B * T * (E + D) > L2_BYTES else L2_CARD_BPS * REACHED
    step += max(4 * B * T * D / rate, q["pair"] * (KS + 4) * D / fma_sm)
    items = _cdiv(q["pair"] * _cdiv(E, CTX_COLS), T)
    step += max(4 * B * T * E / rate, items * CTX_COLS * T / fma_sm)
    return 1e3 * n * step


def device_plan_bwd(n: int, B: int, T: int, dims, dev, candidate=None) -> BwdPlan:
    """:func:`plan_bwd` for the card ``dev`` holds."""
    return plan_bwd(n, B, T, dims, *_build.device_limits(dev), candidate)


def device_plan_fwd(n: int, B: int, T: int, dims, dev, candidate=None) -> FwdPlan:
    """:func:`plan_fwd` for the card ``dev`` holds."""
    return plan_fwd(n, B, T, dims, *_build.device_limits(dev), candidate)


def taco_train_bwd(w: TrainWeights, res: TrainResiduals, enc_seq: Tensor, enc_proj: Tensor,
                   char_mask: Tensor, zo1: Tensor, zo2: Tensor, dx_all: Tensor,
                   dctx_all: Tensor, dscores_all: Tensor) -> TrainCotangents:
    """Same contract as :func:`taco_train_bwd_plain`; CUDA tensors go through
    the kernel with this card's plan, CPU tensors through the plain version."""
    if not dx_all.is_cuda:
        return taco_train_bwd_plain(w, res, enc_seq, enc_proj, char_mask, zo1, zo2, dx_all,
                                    dctx_all, dscores_all)
    out = bwd_launch(_build.library(), w, res, enc_seq, enc_proj, char_mask, zo1, zo2, dx_all,
                     dctx_all, dscores_all)
    _build.launch_counts["tacotron_train_bwd"] += 1
    return out


def bwd_launch(lib, w: TrainWeights, res: TrainResiduals, enc_seq: Tensor, enc_proj: Tensor,
               char_mask: Tensor, zo1: Tensor, zo2: Tensor, dx_all: Tensor, dctx_all: Tensor,
               dscores_all: Tensor, p: "BwdPlan" = None, work: Tensor = None
               ) -> TrainCotangents:
    """One launch of ``lib``'s ``rtvc_tacotron_train_bwd`` (the package's
    library, or a variant that ``profile_tacotron_train`` builds) on CUDA
    tensors, after the shape checks, with ``p`` or this card's plan, and
    ``work`` (at least ``p.ws[-1]`` floats) or a new workspace. The
    kernel reads the eight matrices as TrainWeights holds them (transposed
    views of the parameters included) and gathers its slices itself; it
    leaves ``dv`` and ``dmloc`` as one partial per CTA (no atomics, so two
    runs give the same bits), summed here in a fixed order."""
    D, L, E, KS = w.dims
    n, B, _ = dx_all.shape
    T = enc_seq.shape[1]
    fn, dev = "tacotron_train_bwd", dx_all.device
    if p is None:
        p = device_plan_bwd(n, B, T, (D, L, E, KS), dev)
    mats = _check_mats(fn, w, dev)
    vecs = [v.contiguous() for v in (w.bq, w.mloc, w.vv)]
    _build.check_tensors(
        fn, dev, dx_all=(dx_all, (n, B, L)), dctx_all=(dctx_all, (n, B, E)),
        dscores_all=(dscores_all, (n, B, T)), enc_seq=(enc_seq, (B, T, E)),
        enc_proj=(enc_proj, (B, T, D)), char_mask=(char_mask, (B, T)),
        zo1=(zo1, (n, B, L)), zo2=(zo2, (n, B, L)),
        ah=(res.ah, (n, B, D)), g4=(res.g4, (n, B, 4 * D)),
        gates1=(res.gates1, (n, B, 4 * L)), c1=(res.c1, (n, B, L)),
        gates2=(res.gates2, (n, B, 4 * L)), c2=(res.c2, (n, B, L)),
        scores=(res.scores, (n, B, T)), cum_T=(res.cum_T, (B, T)),
        bq=(vecs[0], (D,)), mloc=(vecs[1], (KS, D)), vv=(vecs[2], (D,)))

    def e(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    dxg4, dq, dx0 = e(n, B, 4 * D), e(n, B, D), e(n, B, L)
    dgates1, dgates2 = e(n, B, 4 * L), e(n, B, 4 * L)
    denc_seq, denc_proj = e(B, T, E), e(B, T, D)
    ws = dict(zip(BWD_WS_SLOTS, p.ws))
    work = _work(fn, work, ws["total"], dev)
    ints = p.ints()
    err = lib.rtvc_tacotron_train_bwd(
        _build.pointer_array([*mats, *vecs]),
        _build.int_array([x for m in mats for x in m.stride()]),
        _build.pointer_array([dx_all, dctx_all, dscores_all, res.ah, res.g4, res.gates1,
                              res.c1, res.gates2, res.c2, res.scores, res.cum_T, zo1, zo2,
                              enc_seq, enc_proj, char_mask]),
        _build.pointer_array([dxg4, dq, dx0, dgates1, dgates2, denc_seq, denc_proj]),
        _build.int_array([n, B, T, D, L, E, KS]), _build.int_array(ints), len(ints),
        work.data_ptr(), _build.stream_handle(dev))
    _build.check(err, "rtvc_tacotron_train_bwd")
    D4 = _al4(D)
    dv = work[ws["dvp"]:ws["dvp"] + p.ctas * D4].view(p.ctas, D4)[:, :D].sum(dim=0)
    dmloc = work[ws["dmlp"]:ws["dmlp"] + p.ctas * KS * D4].view(p.ctas, KS, D4)[..., :D].sum(
        dim=0)
    return TrainCotangents(dxg4, dq, dx0, dgates1, dgates2, denc_seq, denc_proj, dv, dmloc)


class TacoDecoderTrainFn(torch.autograd.Function):
    """Differentiable chain: ``apply(xg_pre, enc_seq, enc_proj, char_mask,
    zo1, zo2, *weights)`` → (x_all (n, B, L), ctx_all (n, B, E), scores_all
    (n, B, T)), with ``weights`` the fields of :class:`TrainWeights` in
    order. Both halves are K5 kernels for CUDA tensors and the plain
    versions for CPU tensors. The weight gradients are sums over (n · B) of
    the backward's per-step cotangents against the stored streams
    (``tacotron_train_kernel.py:_bwd_vjp``)."""

    @staticmethod
    def forward(ctx, xg_pre, enc_seq, enc_proj, char_mask, zo1, zo2, *weights):
        w = TrainWeights(*weights)
        c = [t.contiguous() for t in (xg_pre, enc_seq, enc_proj, char_mask, zo1, zo2)]
        x_all, res = taco_train_fwd(w, *c)
        ctx.save_for_backward(*c[1:], *weights, *res)
        return x_all, res.ctx, res.scores

    @staticmethod
    def backward(ctx, dx_all, dctx_all, dscores_all):
        saved = ctx.saved_tensors
        enc_seq, enc_proj, char_mask, zo1, zo2 = saved[:5]
        nw = len(TrainWeights._fields)
        w, res = TrainWeights(*saved[5:5 + nw]), TrainResiduals(*saved[5 + nw:])
        D, L, E, _ = w.dims

        c = taco_train_bwd(w, res, enc_seq, enc_proj, char_mask, zo1, zo2, dx_all.contiguous(),
                           dctx_all.contiguous(), dscores_all.contiguous())

        def prev(x):  # the stream one step back, zero at step 0
            return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)

        def outer(a, b):  # Σ over (n, B) of a ⊗ b
            return a.flatten(0, 1).t() @ b.flatten(0, 1)

        def total(a):
            return a.sum(dim=(0, 1))

        dxg = c.dxg4[..., :3 * D]
        dhg = torch.cat([c.dxg4[..., :2 * D], c.dxg4[..., 3 * D:]], dim=-1)
        d_w = TrainWeights(
            gwh=outer(prev(res.ah), dhg), gbh=total(dhg), wq=outer(res.ah, c.dq),
            bq=total(c.dq), mloc=c.dmloc, vv=c.dv,
            wri=outer(torch.cat([res.ctx, res.ah], dim=-1), c.dx0), bri=total(c.dx0),
            l1wi=outer(res.x0, c.dgates1), l1wh=outer(prev(res.h1), c.dgates1),
            l1b=total(c.dgates1), l2wi=outer(res.x0 + res.h1, c.dgates2),
            l2wh=outer(prev(res.h2), c.dgates2), l2b=total(c.dgates2),
            gwi_ctx=outer(prev(res.ctx), dxg))
        return (dxg, c.denc_seq, c.denc_proj, None, None, None, *d_w)


def taco_decoder_train(w: TrainWeights, xg_pre: Tensor, enc_seq: Tensor, enc_proj: Tensor,
                       char_mask: Tensor, zo1: Tensor, zo2: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """:class:`TacoDecoderTrainFn` with the weights as one argument. Under
    no grad autograd builds no graph, so no residual outlives the call.

    K5 has no bf16 instantiation, as the JAX kernel has none: bf16 inputs
    (the bf16 policy's streams) are widened to f32 around the launch
    (``tacotron_train_kernel.py:_fwd_rule``), the f32 kernel runs, its
    outputs stay f32 (the attention's f32 island), and autograd returns each
    input's cotangent in that input's dtype through the widening."""
    return TacoDecoderTrainFn.apply(
        *(widen(t) for t in (xg_pre, enc_seq, enc_proj, char_mask, zo1, zo2, *w)))
