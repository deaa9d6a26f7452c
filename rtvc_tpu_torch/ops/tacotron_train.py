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
- ``TacoDecoderTrainFn``: both halves as a ``torch.autograd.Function``.

Layouts: streams over iterations are time-major (n_iters, B, ·), as in the
JAX package; attention memory is (B, T_text, ·). The walk is over the exact
T_text and n_iters: there is no padding and no additive mask.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from rtvc_tpu_torch import _build

Tensor = torch.Tensor

MAX_THREADS = 1024      # threads of a CTA (csrc/tacotron_train.cu)
MAX_SMEM = 232448       # bytes of shared memory a CTA can opt in to (sm_90)


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
    (KS, D) matrix and the conv bias into the query bias."""
    cell, lsa = decoder.attn_rnn, decoder.attn_net
    conv_w = lsa.conv.weight[:, 0, :]                      # (F, KS)
    mloc = conv_w.t() @ lsa.L.weight.t()                   # (KS, D)
    bq = lsa.W.bias
    if lsa.conv.bias is not None:
        bq = bq + lsa.L.weight @ lsa.conv.bias
    l1, l2 = decoder.res_rnn1, decoder.res_rnn2
    return TrainWeights(
        gwh=cell.weight_hh.t(), gbh=cell.bias_hh, wq=lsa.W.weight.t(), bq=bq, mloc=mloc,
        vv=lsa.v.weight.reshape(-1), wri=decoder.rnn_input.weight.t(),
        bri=decoder.rnn_input.bias,
        l1wi=l1.weight_ih.t(), l1wh=l1.weight_hh.t(), l1b=l1.bias_ih + l1.bias_hh,
        l2wi=l2.weight_ih.t(), l2wh=l2.weight_hh.t(), l2b=l2.bias_ih + l2.bias_hh,
        gwi_ctx=cell.weight_ih[:, :E].t())


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


def taco_train_fwd_plain(w: TrainWeights, xg_pre: Tensor, enc_seq: Tensor, enc_proj: Tensor,
                         char_mask: Tensor, zo1: Tensor, zo2: Tensor
                         ) -> Tuple[Tensor, TrainResiduals]:
    """The chain from a zero state. xg_pre (n, B, 3D) is the hoisted half of
    the attention GRU's input projection (``bias_ih`` included); enc_seq
    (B, T, E), enc_proj (B, T, D), char_mask (B, T); zo1/zo2 (n, B, L) are
    the zoneout masks in {0, 1} (1 keeps the previous hidden). Returns
    x_all = x0 + h1 + h2 (n, B, L) and the residuals, whose ``ctx`` and
    ``scores`` are the chain's other two outputs."""
    D, L, E, KS = w.dims
    n, B, _ = xg_pre.shape
    T = enc_seq.shape[1]
    z = xg_pre.new_zeros
    ah, ctx, cum = z((B, D)), z((B, E)), z((B, T))
    h1, c1, h2, c2 = z((B, L)), z((B, L)), z((B, L)), z((B, L))
    out = {k: [] for k in TrainResiduals._fields[:-1]}
    xs = []
    for s in range(n):
        xg = xg_pre[s] + ctx @ w.gwi_ctx
        hg = ah @ w.gwh + w.gbh
        r = torch.sigmoid(xg[:, :D] + hg[:, :D])
        zg = torch.sigmoid(xg[:, D:2 * D] + hg[:, D:2 * D])
        hn = hg[:, 2 * D:]
        ng = torch.tanh(xg[:, 2 * D:] + r * hn)
        ah = (1.0 - zg) * ng + zg * ah

        q = ah @ w.wq + w.bq
        tv = torch.tanh(q[:, None, :] + enc_proj + _windows(cum, KS) @ w.mloc)
        # the reference multiplies the logits by the pad mask (not an
        # additive mask): pad characters take part in the softmax at logit 0
        scores = torch.softmax((tv @ w.vv) * char_mask, dim=1)
        cum = cum + scores
        ctx = torch.einsum("bt,bte->be", scores, enc_seq)

        x0 = torch.cat([ctx, ah], dim=1) @ w.wri + w.bri
        h1, c1, g1 = _lstm(x0, h1, c1, w.l1wi, w.l1wh, w.l1b, zo1[s], L)
        h2, c2, g2 = _lstm(x0 + h1, h2, c2, w.l2wi, w.l2wh, w.l2b, zo2[s], L)
        xs.append(x0 + h1 + h2)
        for k, v in (("ah", ah), ("g4", torch.cat([r, zg, ng, hn], dim=1)), ("x0", x0),
                     ("gates1", g1), ("c1", c1), ("h1", h1), ("gates2", g2), ("c2", c2),
                     ("h2", h2), ("scores", scores), ("ctx", ctx)):
            out[k].append(v)
    res = TrainResiduals(**{k: torch.stack(v) for k, v in out.items()}, cum_T=cum)
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


def _check_shapes(fn: str, dims, backward: bool) -> None:
    """Raise on a shape the kernels do not take."""
    n, B, T, D, L, E, KS = dims
    if min(dims) < 1:
        raise ValueError(f"{fn}: empty shape (n, B, T, D, L, E, KS) = {tuple(dims)}")
    if D > MAX_THREADS:
        raise ValueError(f"{fn}: decoder_dims {D} exceeds the kernel's {MAX_THREADS} "
                         "threads (one thread owns one attention column)")
    if KS % 2 == 0:
        raise ValueError(f"{fn}: the location conv must have an odd number of taps, got {KS}")
    need = _build.library().rtvc_tacotron_train_smem(_build.int_array(dims), int(backward))
    if need > MAX_SMEM:
        raise ValueError(f"{fn}: T_text {T} with D {D}, L {L}, E {E} needs {need} bytes of "
                         f"shared memory, the card gives a CTA {MAX_SMEM}")


def _torch_layout(w: TrainWeights):
    """The eight matrices as (out, in) rows, contiguous: the forward kernel
    streams rows of these. For weights from :func:`prepare_train_weights`
    seven are the parameters themselves and are not copied; ``gwi_ctx`` is a
    column slice of the attention GRU's ``weight_ih``, so its (3D, E) rows
    are copied on every call."""
    return [m.t().contiguous() for m in (w.gwh, w.wq, w.wri, w.l1wi, w.l1wh, w.l2wi, w.l2wh,
                                         w.gwi_ctx)]


def taco_train_fwd(w: TrainWeights, xg_pre: Tensor, enc_seq: Tensor, enc_proj: Tensor,
                   char_mask: Tensor, zo1: Tensor, zo2: Tensor
                   ) -> Tuple[Tensor, TrainResiduals]:
    """Same contract as :func:`taco_train_fwd_plain`; CUDA tensors go through
    the kernel (f32, contiguous), CPU tensors through the plain version."""
    if not xg_pre.is_cuda:
        return taco_train_fwd_plain(w, xg_pre, enc_seq, enc_proj, char_mask, zo1, zo2)
    D, L, E, KS = w.dims
    n, B, _ = xg_pre.shape
    T = enc_seq.shape[1]
    fn, dev = "tacotron_train_fwd", xg_pre.device
    dims = [n, B, T, D, L, E, KS]
    _check_shapes(fn, dims, backward=False)
    mats = _torch_layout(w)
    vecs = [v.contiguous() for v in (w.gbh, w.bq, w.mloc, w.vv, w.bri, w.l1b, w.l2b)]
    _build.check_tensors(
        fn, dev, xg_pre=(xg_pre, (n, B, 3 * D)), enc_seq=(enc_seq, (B, T, E)),
        enc_proj=(enc_proj, (B, T, D)), char_mask=(char_mask, (B, T)),
        zo1=(zo1, (n, B, L)), zo2=(zo2, (n, B, L)),
        gwh=(mats[0], (3 * D, D)), wq=(mats[1], (D, D)), wri=(mats[2], (L, E + D)),
        l1wi=(mats[3], (4 * L, L)), l1wh=(mats[4], (4 * L, L)), l2wi=(mats[5], (4 * L, L)),
        l2wh=(mats[6], (4 * L, L)), gwi_ctx=(mats[7], (3 * D, E)),
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
    err = _build.library().rtvc_tacotron_train_fwd(
        _build.pointer_array(mats + vecs),
        _build.pointer_array([xg_pre, zo1, zo2, enc_seq, enc_proj, char_mask]),
        _build.pointer_array([x_all, *res]),
        _build.int_array(dims), _build.stream_handle(dev))
    _build.check(err, "rtvc_tacotron_train_fwd")
    _build.launch_counts["tacotron_train_fwd"] += 1
    return x_all, res


def taco_train_bwd(w: TrainWeights, res: TrainResiduals, enc_seq: Tensor, enc_proj: Tensor,
                   char_mask: Tensor, zo1: Tensor, zo2: Tensor, dx_all: Tensor,
                   dctx_all: Tensor, dscores_all: Tensor) -> TrainCotangents:
    """Same contract as :func:`taco_train_bwd_plain`; CUDA tensors go through
    the kernel, CPU tensors through the plain version. The kernel writes
    ``dv`` and ``dmloc`` as one partial per batch row (it uses no atomics,
    so two runs give the same bits); they are summed here."""
    if not dx_all.is_cuda:
        return taco_train_bwd_plain(w, res, enc_seq, enc_proj, char_mask, zo1, zo2, dx_all,
                                    dctx_all, dscores_all)
    D, L, E, KS = w.dims
    n, B, _ = dx_all.shape
    T = enc_seq.shape[1]
    fn, dev = "tacotron_train_bwd", dx_all.device
    dims = [n, B, T, D, L, E, KS]
    _check_shapes(fn, dims, backward=True)
    # the reverse walk multiplies by the transposes: it streams rows of the
    # (in, out) matrices, and of lsa_W itself for the query it recomputes
    mats = [m.contiguous() for m in (w.gwh, w.wq, w.wri, w.l1wi, w.l1wh, w.l2wi, w.l2wh,
                                     w.gwi_ctx)] + [w.wq.t().contiguous()]
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
        gwh=(mats[0], (D, 3 * D)), wq=(mats[1], (D, D)), wri=(mats[2], (E + D, L)),
        l1wi=(mats[3], (L, 4 * L)), l1wh=(mats[4], (L, 4 * L)), l2wi=(mats[5], (L, 4 * L)),
        l2wh=(mats[6], (L, 4 * L)), gwi_ctx=(mats[7], (E, 3 * D)), wq_t=(mats[8], (D, D)),
        bq=(vecs[0], (D,)), mloc=(vecs[1], (KS, D)), vv=(vecs[2], (D,)))

    def e(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    dxg4, dq, dx0 = e(n, B, 4 * D), e(n, B, D), e(n, B, L)
    dgates1, dgates2 = e(n, B, 4 * L), e(n, B, 4 * L)
    denc_seq, denc_proj = e(B, T, E), e(B, T, D)
    dv_b, dmloc_b = e(B, D), e(B, KS, D)
    err = _build.library().rtvc_tacotron_train_bwd(
        _build.pointer_array(mats + vecs),
        _build.pointer_array([dx_all, dctx_all, dscores_all, res.ah, res.g4, res.gates1,
                              res.c1, res.gates2, res.c2, res.scores, res.cum_T, zo1, zo2,
                              enc_seq, enc_proj, char_mask]),
        _build.pointer_array([dxg4, dq, dx0, dgates1, dgates2, denc_seq, denc_proj, dv_b,
                              dmloc_b]),
        _build.int_array(dims), _build.stream_handle(dev))
    _build.check(err, "rtvc_tacotron_train_bwd")
    _build.launch_counts["tacotron_train_bwd"] += 1
    return TrainCotangents(dxg4, dq, dx0, dgates1, dgates2, denc_seq, denc_proj,
                           dv_b.sum(dim=0), dmloc_b.sum(dim=0))


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
    """:class:`TacoDecoderTrainFn` with the weights as one argument."""
    return TacoDecoderTrainFn.apply(xg_pre, enc_seq, enc_proj, char_mask, zo1, zo2, *w)
