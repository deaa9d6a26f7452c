// Tacotron teacher-forced decoder chain for training: forward and backward.
//
// Replaces: rtvc_tpu/ops/pallas/tacotron_train_kernel.py:taco_decoder_train_fused,
// both halves (_fwd_kernel and _bwd_kernel with its wrapper _bwd_vjp). One
// iteration is: attention GRU (torch gate order r|z|n, b_hn inside the reset
// product, the context half of its input projection inside the loop) →
// location-sensitive attention (the KS-tap conv over the cumulative scores
// folded with L into mloc (KS, D), query, tanh, v, the multiplicative char
// mask, softmax) → context → rnn_input → two residual LSTMs with zoneout
// masks that the caller draws. The prenet, the prenet half of the GRU's input
// projection, the mel and stop projections and every weight gradient are
// large batched products outside the kernels, as in the JAX package.
//
// What bounds it on the H100: an iteration multiplies eight matrices, 5.7M
// weights (23 MB in f32) at the default widths (D 256, L 512, E 896), by one
// vector per batch row, and reads that row's attention memory (160 x 896
// floats, 573 KB) once in the forward and twice in the backward. That is
// about 2 FLOP per 4 bytes, far below the card's balance point: the chain is
// bound by how fast an SM streams the weights out of the 50 MB L2, where
// they stay resident, and by its ten to twenty dependent phases a step.
//
// Design: one CTA per batch row runs every iteration in one launch (rows
// are independent recurrences), 112 CTAs in one wave at the training batch.
// The carried state lives in shared memory, with the folded location matrix
// mloc. The eight products are common.cuh:matvec, warps owning four weight
// rows at a time with 16-byte loads; the forward streams rows of the (out,
// in) matrices, the backward rows of their transposes, which the wrapper
// passes as contiguous copies. The conv over the cumulative scores and its
// two adjoints are direct loops over a zero-bordered copy of the scores:
// the TPU kernel's padding of T to 128, its additive mask, its (B, Tp, 1)
// layout, its time and batch tiles and its shifted concatenations answer
// that compiler's limits and are not carried over; the walk is over the
// exact T_text and n_iters. The backward indexes the previous step's
// streams one step back instead of taking shifted copies.
//
// The backward's attention part works on tiles of TT characters: threads own
// (character, column) pairs and leave darg = du · v · (1 - tanh²) in a shared
// tile, from which the conv adjoints are taken: s[t][k] = darg[t] · mloc[k]
// by warps, and dmloc[k][j] += Σ_t cum[t+k-pad] · darg[t][j] by the thread
// that owns (k, j). denc_seq and denc_proj belong to the CTA's batch row and
// are accumulated in place in device memory; dv and dmloc sum over the
// batch, so every CTA writes its own partial and the wrapper adds them. No
// float atomics anywhere: two runs give the same bits.
//
// Next steps for speed, neither taken here: split each product's rows over
// the SMs of a cluster (the weights then stay in shared memory), or let a
// CTA apply each weight row to several batch rows (matvec<NB>).
#include <cfloat>

#include "common.cuh"

namespace {

using rtvc::matvec;
using rtvc::sigmoidf_;
using rtvc::warp_sum;

struct Dims {
  int n, B, T, D, L, E, KS;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline int seg(int& o, int n) {
  const int at = o;
  o += round4(n);
  return at;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

struct FwdWeights {  // (out, in) matrices, then vectors
  const float *gwh, *wq, *wri, *l1wi, *l1wh, *l2wi, *l2wh, *gwi_ctx;
  const float *gbh, *bq, *mloc, *vv, *bri, *l1b, *l2b;
};
constexpr int kFwdWeights = 15;

struct FwdInputs {
  const float *xg_pre, *zo1, *zo2, *enc_seq, *enc_proj, *char_mask;
};
constexpr int kFwdInputs = 6;

struct FwdOutputs {
  float *x_all, *ah, *g4, *x0, *gates1, *c1, *h1, *gates2, *c2, *h2, *scores, *ctx, *cum_T;
};
constexpr int kFwdOutputs = 13;

// Shared memory of the forward, in floats. `state` floats from the start
// are zeroed before the first step.
struct FwdLayout {
  int ah, ctx, cp, h1, c1, h2, c2, state, q, xg, hg, u, x0, x1, gates, mloc, total;
  __host__ __device__ explicit FwdLayout(const Dims& d) {
    int o = 0;
    ah = seg(o, d.D); ctx = seg(o, d.E); cp = seg(o, d.T + d.KS - 1);
    h1 = seg(o, d.L); c1 = seg(o, d.L); h2 = seg(o, d.L); c2 = seg(o, d.L);
    state = o;
    q = seg(o, d.D); xg = seg(o, 3 * d.D); hg = seg(o, 3 * d.D); u = seg(o, d.T);
    x0 = seg(o, d.L); x1 = seg(o, d.L); gates = seg(o, 4 * d.L); mloc = seg(o, d.KS * d.D);
    total = o;
  }
};

// One zoneout LSTM step from the pre-activations in `gates` (biases in):
// updates h and c, writes the residuals, and xo = xi + h.
__device__ void lstm_update(const float* gates, float* h, float* c, const float* zo,
                            const float* xi, float* xo, float* g_out, float* c_out,
                            float* h_out, int L) {
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const float i_g = sigmoidf_(gates[j]);
    const float f_g = sigmoidf_(gates[L + j]);
    const float g_g = tanhf(gates[2 * L + j]);
    const float o_g = sigmoidf_(gates[3 * L + j]);
    const float cj = f_g * c[j] + i_g * g_g;
    const float z = zo[j];
    const float hj = z * h[j] + (1.0f - z) * (o_g * tanhf(cj));
    c[j] = cj;
    h[j] = hj;
    xo[j] = xi[j] + hj;
    g_out[j] = i_g;
    g_out[L + j] = f_g;
    g_out[2 * L + j] = g_g;
    g_out[3 * L + j] = o_g;
    c_out[j] = cj;
    h_out[j] = hj;
  }
}

__global__ void __launch_bounds__(1024)
tacotron_train_fwd_kernel(FwdWeights w, FwdInputs in, FwdOutputs out, Dims d) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const FwdLayout lo(d);
  float *ah = sm + lo.ah, *ctx = sm + lo.ctx, *cp = sm + lo.cp, *h1 = sm + lo.h1,
        *c1 = sm + lo.c1, *h2 = sm + lo.h2, *c2 = sm + lo.c2, *q = sm + lo.q, *xg = sm + lo.xg,
        *hg = sm + lo.hg, *u = sm + lo.u, *x0 = sm + lo.x0, *x1 = sm + lo.x1,
        *gates = sm + lo.gates, *mloc = sm + lo.mloc;
  const int n = d.n, B = d.B, T = d.T, D = d.D, L = d.L, E = d.E, KS = d.KS;
  const int pad = (KS - 1) / 2;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const float* es = in.enc_seq + (size_t)b * T * E;
  const float* ep = in.enc_proj + (size_t)b * T * D;
  const float* cm = in.char_mask + (size_t)b * T;

  for (int i = tid; i < lo.state; i += blockDim.x) sm[i] = 0.0f;
  for (int i = tid; i < KS * D; i += blockDim.x) mloc[i] = w.mloc[i];
  __syncthreads();

  for (int s = 0; s < n; ++s) {
    const size_t sb = (size_t)s * B + b;

    // attention GRU pre-activations: the context half of the input side on
    // top of the hoisted half, and the hidden side
    matvec<1>(w.gwi_ctx, E, 3 * D, ctx, 0, E, 1, xg, 0, nullptr, in.xg_pre + sb * 3 * D, 0,
              false, rtvc::kNone);
    matvec<1>(w.gwh, D, 3 * D, ah, 0, D, 1, hg, 0, w.gbh, nullptr, 0, false, rtvc::kNone);
    __syncthreads();
    {
      float* g4 = out.g4 + sb * 4 * D;
      for (int j = tid; j < D; j += blockDim.x) {
        const float rg = sigmoidf_(xg[j] + hg[j]);
        const float zg = sigmoidf_(xg[D + j] + hg[D + j]);
        const float hn = hg[2 * D + j];
        const float ng = tanhf(xg[2 * D + j] + rg * hn);
        const float a = (1.0f - zg) * ng + zg * ah[j];
        ah[j] = a;
        out.ah[sb * D + j] = a;
        g4[j] = rg;
        g4[D + j] = zg;
        g4[2 * D + j] = ng;
        g4[3 * D + j] = hn;
      }
    }
    __syncthreads();

    // location-sensitive attention
    matvec<1>(w.wq, D, D, ah, 0, D, 1, q, 0, w.bq, nullptr, 0, false, rtvc::kNone);
    __syncthreads();
    for (int t = warp; t < T; t += nwarps) {
      float acc = 0.0f;
      for (int j = lane; j < D; j += 32) {
        float pl = 0.0f;
        for (int k = 0; k < KS; ++k) pl += cp[t + k] * mloc[k * D + j];
        acc += w.vv[j] * tanhf(q[j] + ep[(size_t)t * D + j] + pl);
      }
      acc = warp_sum(acc);
      // the reference multiplies the logits by the pad mask
      if (lane == 0) u[t] = acc * cm[t];
    }
    __syncthreads();
    if (warp == 0) {
      float mx = -FLT_MAX;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, u[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.0f;
      for (int t = lane; t < T; t += 32) {
        const float e = expf(u[t] - mx);
        u[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int t = lane; t < T; t += 32) {
        const float sc = u[t] / sum;
        u[t] = sc;
        cp[pad + t] += sc;
        out.scores[sb * T + t] = sc;
      }
    }
    __syncthreads();
    for (int e = tid; e < E; e += blockDim.x) {
      float acc = 0.0f;
#pragma unroll 4
      for (int t = 0; t < T; ++t) acc += u[t] * es[(size_t)t * E + e];
      ctx[e] = acc;
      out.ctx[sb * E + e] = acc;
    }
    __syncthreads();

    // rnn_input over [context | attention hidden]
    matvec<1>(w.wri, E + D, L, ctx, 0, E, 1, x0, 0, w.bri, nullptr, 0, false, rtvc::kNone);
    matvec<1>(w.wri + E, E + D, L, ah, 0, D, 1, x0, 0, nullptr, nullptr, 0, true, rtvc::kNone);
    __syncthreads();

    // two residual zoneout LSTMs
    matvec<1>(w.l1wi, L, 4 * L, x0, 0, L, 1, gates, 0, w.l1b, nullptr, 0, false, rtvc::kNone);
    matvec<1>(w.l1wh, L, 4 * L, h1, 0, L, 1, gates, 0, nullptr, nullptr, 0, true, rtvc::kNone);
    for (int j = tid; j < L; j += blockDim.x) out.x0[sb * L + j] = x0[j];
    __syncthreads();
    lstm_update(gates, h1, c1, in.zo1 + sb * L, x0, x1, out.gates1 + sb * 4 * L,
                out.c1 + sb * L, out.h1 + sb * L, L);
    __syncthreads();
    matvec<1>(w.l2wi, L, 4 * L, x1, 0, L, 1, gates, 0, w.l2b, nullptr, 0, false, rtvc::kNone);
    matvec<1>(w.l2wh, L, 4 * L, h2, 0, L, 1, gates, 0, nullptr, nullptr, 0, true, rtvc::kNone);
    __syncthreads();
    lstm_update(gates, h2, c2, in.zo2 + sb * L, x1, out.x_all + sb * L,
                out.gates2 + sb * 4 * L, out.c2 + sb * L, out.h2 + sb * L, L);
    __syncthreads();
  }
  for (int t = tid; t < T; t += blockDim.x) out.cum_T[(size_t)b * T + t] = cp[pad + t];
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

struct BwdWeights {  // (in, out) matrices, lsa_W itself (wq_t), then vectors
  const float *gwh, *wq, *wri, *l1wi, *l1wh, *l2wi, *l2wh, *gwi_ctx, *wq_t;
  const float *bq, *mloc, *vv;
};
constexpr int kBwdWeights = 12;

struct BwdInputs {
  const float *dx_all, *dctx_all, *dscores_all, *ah, *g4, *gates1, *c1, *gates2, *c2, *scores,
      *cum_T, *zo1, *zo2, *enc_seq, *enc_proj, *char_mask;
};
constexpr int kBwdInputs = 16;

struct BwdOutputs {
  float *dxg4, *dq, *dx0, *dgates1, *dgates2, *denc_seq, *denc_proj, *dv_b, *dmloc_b;
};
constexpr int kBwdOutputs = 9;

struct BwdLayout {
  int dah, dh1, dc1, dh2, dc2, dctx, dcum, dmloc, dv, state;
  int cp, du, sc, q, dq, ahs, tmpD, tmpL, dx1, dx0, dg, dhg, dxg3, sarr, mloc, part, tile, TT,
      total;
  __host__ __device__ explicit BwdLayout(const Dims& d) {
    int o = 0;
    dah = seg(o, d.D); dh1 = seg(o, d.L); dc1 = seg(o, d.L); dh2 = seg(o, d.L);
    dc2 = seg(o, d.L); dctx = seg(o, d.E); dcum = seg(o, d.T); dmloc = seg(o, d.KS * d.D);
    dv = seg(o, d.D);
    state = o;
    cp = seg(o, d.T + d.KS - 1); du = seg(o, d.T); sc = seg(o, d.T); q = seg(o, d.D);
    dq = seg(o, d.D); ahs = seg(o, d.D); tmpD = seg(o, d.D); tmpL = seg(o, d.L);
    dx1 = seg(o, d.L); dx0 = seg(o, d.L); dg = seg(o, 4 * d.L); dhg = seg(o, 3 * d.D);
    dxg3 = seg(o, 3 * d.D); sarr = seg(o, d.T * d.KS); mloc = seg(o, d.KS * d.D);
    part = seg(o, 2 * 1024);
    TT = 8192 / d.D;
    if (TT < 1) TT = 1;
    if (TT > d.T) TT = d.T;
    tile = seg(o, TT * d.D);
    total = o;
  }
};

// One zoneout LSTM step backwards (tacotron_train_kernel.py:274-292): from
// dh_tot = dx[j] + dh[j] and the carried dc, the pre-activation cotangents
// into dg and dg_out, dc ← dc·f, and hold[j] = dh_tot·zo for the next
// phase's dh = hold + dg · W_hhᵀ.
__device__ void lstm_bwd_update(const float* dx, const float* dh, float* dc, const float* gates,
                                const float* c, const float* c_prev, const float* zo, float* dg,
                                float* dg_out, float* hold, int L) {
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const float i_g = gates[j], f_g = gates[L + j], g_g = gates[2 * L + j], o_g = gates[3 * L + j];
    const float tanhc = tanhf(c[j]);
    const float cp = c_prev ? c_prev[j] : 0.0f;
    const float z = zo[j];
    const float dh_tot = dx[j] + dh[j];
    const float dhn = dh_tot * (1.0f - z);
    const float d_o = dhn * tanhc * o_g * (1.0f - o_g);
    const float dcj = dc[j] + dhn * o_g * (1.0f - tanhc * tanhc);
    const float d_i = dcj * g_g * i_g * (1.0f - i_g);
    const float d_f = dcj * cp * f_g * (1.0f - f_g);
    const float d_g = dcj * i_g * (1.0f - g_g * g_g);
    dg[j] = d_i;
    dg[L + j] = d_f;
    dg[2 * L + j] = d_g;
    dg[3 * L + j] = d_o;
    dg_out[j] = d_i;
    dg_out[L + j] = d_f;
    dg_out[2 * L + j] = d_g;
    dg_out[3 * L + j] = d_o;
    dc[j] = dcj * f_g;
    hold[j] = dh_tot * z;
  }
}

__global__ void __launch_bounds__(1024)
tacotron_train_bwd_kernel(BwdWeights w, BwdInputs in, BwdOutputs out, Dims d) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const BwdLayout lo(d);
  float *dah = sm + lo.dah, *dh1 = sm + lo.dh1, *dc1 = sm + lo.dc1, *dh2 = sm + lo.dh2,
        *dc2 = sm + lo.dc2, *dctx = sm + lo.dctx, *dcum = sm + lo.dcum, *dmloc = sm + lo.dmloc,
        *dv = sm + lo.dv, *cp = sm + lo.cp, *du = sm + lo.du, *sc = sm + lo.sc, *q = sm + lo.q,
        *dq = sm + lo.dq, *ahs = sm + lo.ahs, *tmpD = sm + lo.tmpD, *tmpL = sm + lo.tmpL,
        *dx1 = sm + lo.dx1, *dx0 = sm + lo.dx0, *dg = sm + lo.dg, *dhg = sm + lo.dhg,
        *dxg3 = sm + lo.dxg3, *sarr = sm + lo.sarr, *mloc = sm + lo.mloc, *part = sm + lo.part,
        *tile = sm + lo.tile;
  const int n = d.n, B = d.B, T = d.T, D = d.D, L = d.L, E = d.E, KS = d.KS, TT = lo.TT;
  const int pad = (KS - 1) / 2;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  // attention columns: thread (tg, j) owns column j for the characters
  // tg, tg + TG, ... of a tile
  const int TG = blockDim.x / D;
  const bool col_owner = tid < TG * D;
  const int cj = tid % D, tg = tid / D;
  const float* es = in.enc_seq + (size_t)b * T * E;
  const float* ep = in.enc_proj + (size_t)b * T * D;
  const float* cm = in.char_mask + (size_t)b * T;
  float* des = out.denc_seq + (size_t)b * T * E;
  float* dep = out.denc_proj + (size_t)b * T * D;

  for (int i = tid; i < lo.state; i += blockDim.x) sm[i] = 0.0f;
  for (int i = tid; i < T + KS - 1; i += blockDim.x) cp[i] = 0.0f;
  for (int i = tid; i < KS * D; i += blockDim.x) mloc[i] = w.mloc[i];
  __syncthreads();
  for (int t = tid; t < T; t += blockDim.x) cp[pad + t] = in.cum_T[(size_t)b * T + t];
  __syncthreads();

  for (int s = n - 1; s >= 0; --s) {
    const size_t sb = (size_t)s * B + b;
    const size_t sp = (size_t)(s - 1) * B + b;  // the previous step's streams (s > 0)
    const bool first = s == n - 1;

    // second residual LSTM; meanwhile this step's small streams come in
    lstm_bwd_update(in.dx_all + sb * L, dh2, dc2, in.gates2 + sb * 4 * L, in.c2 + sb * L,
                    s > 0 ? in.c2 + sp * L : nullptr, in.zo2 + sb * L, dg,
                    out.dgates2 + sb * 4 * L, tmpL, L);
    for (int e = tid; e < E; e += blockDim.x) dctx[e] += in.dctx_all[sb * E + e];
    for (int t = tid; t < T; t += blockDim.x) {
      const float v = in.scores[sb * T + t];
      sc[t] = v;
      cp[pad + t] -= v;  // the cumulative scores before this step
    }
    for (int j = tid; j < D; j += blockDim.x) ahs[j] = in.ah[sb * D + j];
    __syncthreads();
    matvec<1>(w.l2wh, 4 * L, L, dg, 0, 4 * L, 1, dh2, 0, nullptr, tmpL, 0, false, rtvc::kNone);
    matvec<1>(w.l2wi, 4 * L, L, dg, 0, 4 * L, 1, dx1, 0, nullptr, in.dx_all + sb * L, 0, false,
              rtvc::kNone);
    // the query of this step, recomputed for the tanh terms
    matvec<1>(w.wq_t, D, D, ahs, 0, D, 1, q, 0, w.bq, nullptr, 0, false, rtvc::kNone);
    __syncthreads();

    // first residual LSTM
    lstm_bwd_update(dx1, dh1, dc1, in.gates1 + sb * 4 * L, in.c1 + sb * L,
                    s > 0 ? in.c1 + sp * L : nullptr, in.zo1 + sb * L, dg,
                    out.dgates1 + sb * 4 * L, tmpL, L);
    __syncthreads();
    matvec<1>(w.l1wh, 4 * L, L, dg, 0, 4 * L, 1, dh1, 0, nullptr, tmpL, 0, false, rtvc::kNone);
    matvec<1>(w.l1wi, 4 * L, L, dg, 0, 4 * L, 1, dx0, 0, nullptr, dx1, 0, false, rtvc::kNone);
    __syncthreads();

    // rnn_input: dctx and dah take their halves of dx0 · Wᵀ on top of what
    // they carry
    for (int j = tid; j < L; j += blockDim.x) out.dx0[sb * L + j] = dx0[j];
    matvec<1>(w.wri, L, E, dx0, 0, L, 1, dctx, 0, nullptr, nullptr, 0, true, rtvc::kNone);
    matvec<1>(w.wri + (size_t)E * L, L, D, dx0, 0, L, 1, dah, 0, nullptr, nullptr, 0, true,
              rtvc::kNone);
    __syncthreads();

    // context = scores · enc_seq: denc_seq += scores ⊗ dctx, and the scores'
    // cotangent
    for (int t = warp; t < T; t += nwarps) {
      const float* row = es + (size_t)t * E;
      float* drow = des + (size_t)t * E;
      const float st = sc[t];
      float dot = 0.0f;
      for (int e = lane; e < E; e += 32) {
        const float dc = dctx[e];
        dot += dc * row[e];
        const float v = st * dc;
        drow[e] = first ? v : drow[e] + v;
      }
      dot = warp_sum(dot);
      if (lane == 0) du[t] = in.dscores_all[sb * T + t] + dcum[t] + dot;
    }
    __syncthreads();
    // softmax backwards, then the multiplicative char mask
    if (warp == 0) {
      float dot = 0.0f;
      for (int t = lane; t < T; t += 32) dot += du[t] * sc[t];
      dot = warp_sum(dot);
      for (int t = lane; t < T; t += 32) du[t] = sc[t] * (du[t] - dot) * cm[t];
    }
    __syncthreads();

    // energies backwards, a tile of characters at a time
    float dq_acc = 0.0f, dv_acc = 0.0f;
    for (int t0 = 0; t0 < T; t0 += TT) {
      const int tt = T - t0 < TT ? T - t0 : TT;
      if (col_owner) {
        const float qj = q[cj], vj = w.vv[cj];
        for (int tl = tg; tl < tt; tl += TG) {
          const int t = t0 + tl;
          float pl = 0.0f;
          for (int k = 0; k < KS; ++k) pl += cp[t + k] * mloc[k * D + cj];
          const float tv = tanhf(qj + ep[(size_t)t * D + cj] + pl);
          const float da = du[t] * vj * (1.0f - tv * tv);
          tile[tl * D + cj] = da;
          float* dp = dep + (size_t)t * D + cj;
          *dp = first ? da : *dp + da;
          dq_acc += da;
          dv_acc += du[t] * tv;
        }
      }
      __syncthreads();
      // s[t][k] = darg[t] · mloc[k]
      for (int pr = warp; pr < tt * KS; pr += nwarps) {
        const int tl = pr / KS, k = pr % KS;
        float acc = 0.0f;
        for (int j = lane; j < D; j += 32) acc += tile[tl * D + j] * mloc[k * D + j];
        acc = warp_sum(acc);
        if (lane == 0) sarr[(t0 + tl) * KS + k] = acc;
      }
      // dmloc[k][j] += Σ_t cum_prev[t + k - pad] · darg[t][j]
      for (int idx = tid; idx < KS * D; idx += blockDim.x) {
        const int k = idx / D, j = idx % D;
        float acc = 0.0f;
        for (int tl = 0; tl < tt; ++tl) acc += cp[t0 + tl + k] * tile[tl * D + j];
        dmloc[idx] += acc;
      }
      __syncthreads();
    }
    if (col_owner) {
      part[tid] = dq_acc;
      part[1024 + tid] = dv_acc;
    }
    __syncthreads();
    for (int j = tid; j < D; j += blockDim.x) {
      float a = 0.0f, c = 0.0f;
      for (int g = 0; g < TG; ++g) {
        a += part[g * D + j];
        c += part[1024 + g * D + j];
      }
      dq[j] = a;
      out.dq[sb * D + j] = a;
      dv[j] += c;
    }
    // dcum[τ] += Σ_k s[τ + pad - k][k]
    for (int t = tid; t < T; t += blockDim.x) {
      float acc = 0.0f;
      for (int k = 0; k < KS; ++k) {
        const int tsrc = t + pad - k;
        if (tsrc >= 0 && tsrc < T) acc += sarr[tsrc * KS + k];
      }
      dcum[t] += acc;
    }
    __syncthreads();

    // attention GRU
    matvec<1>(w.wq, D, D, dq, 0, D, 1, dah, 0, nullptr, nullptr, 0, true, rtvc::kNone);
    __syncthreads();
    {
      const float* g4 = in.g4 + sb * 4 * D;
      float* dxg4 = out.dxg4 + sb * 4 * D;
      for (int j = tid; j < D; j += blockDim.x) {
        const float rg = g4[j], zg = g4[D + j], ng = g4[2 * D + j], hn = g4[3 * D + j];
        const float ahp = s > 0 ? in.ah[sp * D + j] : 0.0f;
        const float dt = dah[j];
        const float dz = dt * (ahp - ng) * zg * (1.0f - zg);
        const float dn = dt * (1.0f - zg) * (1.0f - ng * ng);
        const float dr = dn * hn * rg * (1.0f - rg);
        dxg4[j] = dr;
        dxg4[D + j] = dz;
        dxg4[2 * D + j] = dn;
        dxg4[3 * D + j] = dn * rg;
        dhg[j] = dr;
        dhg[D + j] = dz;
        dhg[2 * D + j] = dn * rg;
        dxg3[j] = dr;
        dxg3[D + j] = dz;
        dxg3[2 * D + j] = dn;
        tmpD[j] = dt * zg;
      }
    }
    __syncthreads();
    matvec<1>(w.gwh, 3 * D, D, dhg, 0, 3 * D, 1, dah, 0, nullptr, tmpD, 0, false, rtvc::kNone);
    matvec<1>(w.gwi_ctx, 3 * D, E, dxg3, 0, 3 * D, 1, dctx, 0, nullptr, nullptr, 0, false,
              rtvc::kNone);
    __syncthreads();
  }
  for (int j = tid; j < D; j += blockDim.x) out.dv_b[(size_t)b * D + j] = dv[j];
  for (int i = tid; i < KS * D; i += blockDim.x) out.dmloc_b[(size_t)b * KS * D + i] = dmloc[i];
}

template <typename S>
S from_pointers(const void* const* p, int count) {
  S s;
  const void** sp = reinterpret_cast<const void**>(&s);
  for (int i = 0; i < count; ++i) sp[i] = p[i];
  return s;
}

Dims read_dims(const int* dims) {
  Dims d;
  int* dp = reinterpret_cast<int*>(&d);
  for (int i = 0; i < (int)(sizeof(Dims) / sizeof(int)); ++i) dp[i] = dims[i];
  return d;
}

}  // namespace

// dims: n_iters, B, T_text, D, L, E, KS → bytes of dynamic shared memory a
// CTA of the forward (backward = 0) or backward kernel takes.
extern "C" int rtvc_tacotron_train_smem(const int* dims, int backward) {
  const Dims d = read_dims(dims);
  return (int)sizeof(float) * (backward ? BwdLayout(d).total : FwdLayout(d).total);
}

// weights: gwh (3D, D), wq (D, D), wri (L, E+D), l1wi, l1wh, l2wi, l2wh
// (4L, L), gwi_ctx (3D, E) as (out, in) rows; gbh (3D), bq (D), mloc (KS, D),
// vv (D), bri (L), l1b, l2b (4L). inputs: xg_pre (n, B, 3D), zo1, zo2
// (n, B, L), enc_seq (B, T, E), enc_proj (B, T, D), char_mask (B, T).
// outputs: x_all (n, B, L), ah (n, B, D), g4 (n, B, 4D), x0, gates1 (n, B, 4L),
// c1, h1, gates2, c2, h2, scores (n, B, T), ctx (n, B, E), cum_T (B, T). All
// f32, contiguous. Returns the launch's cudaError_t.
extern "C" int rtvc_tacotron_train_fwd(const void* const* weights, const void* const* inputs,
                                       const void* const* outputs, const int* dims,
                                       void* stream) {
  const Dims d = read_dims(dims);
  const size_t smem = sizeof(float) * (size_t)FwdLayout(d).total;
  cudaError_t e = rtvc::allow_smem((const void*)tacotron_train_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  tacotron_train_fwd_kernel<<<d.B, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
      from_pointers<FwdWeights>(weights, kFwdWeights),
      from_pointers<FwdInputs>(inputs, kFwdInputs),
      from_pointers<FwdOutputs>(outputs, kFwdOutputs), d);
  return (int)cudaGetLastError();
}

// weights: gwh (D, 3D), wq (D, D), wri (E+D, L), l1wi, l1wh, l2wi, l2wh
// (L, 4L), gwi_ctx (E, 3D) as (in, out) rows, wq_t (D, D) = wqᵀ; bq (D), mloc
// (KS, D), vv (D). inputs: the cotangents dx_all (n, B, L), dctx_all
// (n, B, E), dscores_all (n, B, T); the forward's ah, g4, gates1, c1, gates2,
// c2, scores, cum_T; zo1, zo2, enc_seq, enc_proj, char_mask. outputs: dxg4
// (n, B, 4D) = [dr, dz, dn, dn·r], dq (n, B, D), dx0 (n, B, L), dgates1,
// dgates2 (n, B, 4L), denc_seq (B, T, E), denc_proj (B, T, D), and one
// partial per batch row of dv (B, D) and dmloc (B, KS, D). D may not exceed
// the 1024 threads of a CTA. Returns the launch's cudaError_t.
extern "C" int rtvc_tacotron_train_bwd(const void* const* weights, const void* const* inputs,
                                       const void* const* outputs, const int* dims,
                                       void* stream) {
  const Dims d = read_dims(dims);
  if (d.D > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)BwdLayout(d).total;
  cudaError_t e = rtvc::allow_smem((const void*)tacotron_train_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  tacotron_train_bwd_kernel<<<d.B, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
      from_pointers<BwdWeights>(weights, kBwdWeights),
      from_pointers<BwdInputs>(inputs, kBwdInputs),
      from_pointers<BwdOutputs>(outputs, kBwdOutputs), d);
  return (int)cudaGetLastError();
}
