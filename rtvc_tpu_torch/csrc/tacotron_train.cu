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
// What bounds it on the H100: a step multiplies eight matrices, 5.7M weights
// (23 MB in f32) at the default widths (D 256, L 512, E 896), by one vector a
// batch row, and reads that row's attention memory (160 x 896 floats, 573 KB)
// once in the forward and once in the backward: about 2 FLOP per 4 bytes.
//
// The forward: one CTA per batch row runs every iteration in one launch
// (rows are independent recurrences), its state and the folded location
// matrix mloc in shared memory, the eight products streamed out of L2 with
// common.cuh:matvec. The conv over the cumulative scores is a direct loop
// over a zero-bordered copy: the TPU kernel's padding of T to 128, its
// additive mask, its time and batch tiles answer that compiler's limits and
// are not carried over.
//
// The backward (namespace bwd) is one cooperative launch over the card, the
// design of K2 (tacotron_decode.cu): ops/tacotron_train.py:plan_bwd cuts the
// work and lays out the shared memory and the workspace, the kernel takes
// every offset from it. Every product of the reverse walk multiplies by a
// transpose, so its output columns are the rows of an (in, out) matrix of
// TrainWeights; they are cut over the CTAs by unit: LSTM units (the rows of
// W_hh and W_ih of a unit in one CTA, so both LSTMs' elementwise backward and
// their carried dh and dc stay there), context columns (rows of gwi_ctx and
// of rnn_input's first E rows) and attention units (rows of gwh, of lsa_W and
// of its transpose, of rnn_input's last D rows, so that the GRU's backward
// and the carried dah stay in the CTA). All batch rows ride in every CTA, or
// one batch group of them where the plan makes groups. The CTA gathers its
// weight rows once a launch from the matrices as torch holds them (strided
// views of the parameters) into its shared memory ("resident"), into a copy
// in the workspace read through L2 every step ("l2"), or, in a cluster of one
// CTA a batch group, into the shared memory of the cluster's CTAs, each
// reading the others' part over distributed shared memory ("cluster"). An
// item of a product is 8 weight rows x 8 batch rows, its inputs read from L2
// (__ldcg: other CTAs wrote them) once for all 8 rows, the lanes summed by a
// transposing butterfly. The (row, character) pairs of the attention are cut
// over all CTAs. A reverse step is eight phases, each ended by a grid barrier:
//   A  the GRU's products of the step before (dah and dctx carried), the query
//      of this step (lsa_W·ah, which needs only the stored ah), the second
//      LSTM's elementwise backward, the pairs' cumulative scores before it;
//   B  dh2 and dx1 = dg2 · [W_hh; W_ih]ᵀ of LSTM 2, LSTM 1's backward;
//   C  dh1 and dx0 = dg1 · [W_hh; W_ih]ᵀ of LSTM 1;
//   D  rnn_input's backward onto dctx (kept as a stream over the steps) and
//      dah;
//   E  u = dscores + dcum + enc_seq · dctx for the CTA's pairs;
//   F  the softmax's and the mask's backward of each row the CTA's pairs touch
//      (in every such CTA), the energies' backward: denc_proj, and per CTA
//      partials of dq, dv and dmloc, and s = darg · mlocᵀ;
//   G  dcum from s (the location adjoint needs the neighbours' s: 15
//      characters each side), dq summed over the CTAs of a row in order;
//   H  dq · lsa_Wᵀ onto dah, the GRU's elementwise backward.
// After the walk a last phase computes denc_seq = Σ_s scores_s ⊗ dctx_s from
// the stream, instead of reading and writing (B, T, E) every step. dv and
// dmloc stay one partial per CTA, summed by the wrapper; no sum goes through
// an atomic: two runs give equal bits.
#include <cfloat>
#include <cstring>

#include <cooperative_groups.h>

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
// Backward: the reverse walk split over the card
// ---------------------------------------------------------------------------

namespace bwd {

constexpr int kThreads = rtvc::kRecThreads;
constexpr int kWarps = rtvc::kRecWarps;
constexpr int kRows = 8;        // weight rows an item of a product takes
constexpr int kNB = 8;          // batch rows an item takes
constexpr int kChunk = 128;     // floats of the reduction axis a warp covers at once
constexpr int kMaxTaps = 32;    // location taps a thread keeps in registers
constexpr int kPairTile = 8;    // pairs the attention phase takes at once
constexpr int kHeaderFloats = 512;
constexpr int kStageSteps = 64;  // steps of scores the last phase stages at once
constexpr int kStageT = 32;      // characters an item of the last phase takes
constexpr int kAhead = 6;        // pairs the attention phase loads ahead
constexpr int kEnc = 8;          // float4 of an enc_seq row a lane loads at once (E <= 1024)

enum Cut { kLstm, kCtx, kAtt, kPair, kCuts };
enum Product { kQ, kGctx, kGh, kL2, kL1, kRic, kRia, kWq, kProducts };
enum Mode { kModeResident, kModeL2, kModeCluster };
enum Ws { kWsQ, kWsDhg, kWsU, kWsCum0, kWsCum1, kWsDcum, kWsSarr, kWsDqp, kWsDvp, kWsDmlp,
          kWsDctx, kWsWl2, kWsTotal, kWs };

// ops/tacotron_train.py:BwdPlan.ints, field for field.
struct Plan {
  int ctas, groups, cluster, mode, rows, smem;
  int q[kCuts];
  int ks[kProducts], w_off[kProducts], w_rows[kProducts], out_off[kProducts];
  int dh2, dc2, hold2, dh1, dc1, hold1, dx1, dctx, dah, outs, scratch, rowbuf, row_stride,
      soft_rows, wpart, end;
  int ws[kWs];
};

// A matrix of TrainWeights as torch holds it: element (r, c) at p[r·sr + c·sc]
// (the weights are often transposed views of the parameters).
struct Mat {
  const float* p;
  int sr, sc;
};

struct Weights {
  Mat gwh, wq, wri, l1wi, l1wh, l2wi, l2wh, gwi_ctx;
  const float *bq, *mloc, *vv;
};

struct Inputs {
  const float *dx_all, *dctx_all, *dscores_all, *ah, *g4, *gates1, *c1, *gates2, *c2, *scores,
      *cum_T, *zo1, *zo2, *enc_seq, *enc_proj, *char_mask;
};
constexpr int kInputs = 16;

struct Outputs {
  float *dxg4, *dq, *dx0, *dgates1, *dgates2, *denc_seq, *denc_proj;
};
constexpr int kOutputs = 7;

// One product as this CTA runs it, worked out once a launch (make_run): its
// cut's units [u0, u0 + nu) of q, gates G (rows g·q + j), its weight rows
// (ld floats apart; in shared memory at w_off, or in the CTA's workspace
// copy at Wg), its input (batch row b of step s at x + s·x_step + b·xs), the
// row blocks, batch groups and ks pieces of `per` floats of its reduction
// length n, and its sums at `out` (rows G·q, the group's batch rows each).
struct Run {
  const float* x;
  const float* Wg;
  long long x_step;
  int xs, u0, nu, q, G, blocks, groups, ks, per, n, out, rows, w_off, ld, vec;
};

struct Header {
  Weights w;
  Inputs in;
  Outputs out;
  Dims d;
  Plan pl;
  Run run[kProducts];
  float* ws;
  int group, slice, b_lo, nb_rows;
};
static_assert(sizeof(Header) <= 4 * kHeaderFloats, "the header outgrew its room");

// Every access to shared memory goes through this symbol with an offset
// from the plan, so that the compiler emits shared loads and stores.
extern __shared__ float4 g_smem[];

__device__ __forceinline__ float* S() { return reinterpret_cast<float*>(g_smem); }
__device__ __forceinline__ Header& H() { return *reinterpret_cast<Header*>(g_smem); }

__host__ __device__ constexpr int al4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ int cut_size(int cut) {
  const Dims& d = H().d;
  switch (cut) {
    case kLstm: return d.L;
    case kCtx: return d.E;
    case kAtt: return d.D;
    default: return d.B * d.T;
  }
}

// The units [x, x + y) of a cut that this CTA owns (y may be 0).
__device__ int2 units_of(int cut) {
  const Plan& pl = H().pl;
  const int q = pl.q[cut];
  const int u0 = (cut == kPair ? (int)blockIdx.x : H().slice) * q;
  return make_int2(u0, max(0, min(q, cut_size(cut) - u0)));
}

__device__ int product_cut(int p) {
  switch (p) {
    case kGctx: case kRic: return kCtx;
    case kL2: case kL1: return kLstm;
    default: return kAtt;
  }
}

// Gate g of unit u of product p: its matrix, with its row, as a row of the
// backward's products (rows of the (in, out) matrices; for the query, a
// column of lsa_W).
__device__ Mat unit_row(int p, int g, int u, int& row) {
  const Weights& w = H().w;
  row = u;
  switch (p) {
    case kQ: return {w.wq.p, w.wq.sc, w.wq.sr};
    case kGctx: return w.gwi_ctx;
    case kGh: return w.gwh;
    case kL2: return g == 0 ? w.l2wh : w.l2wi;
    case kL1: return g == 0 ? w.l1wh : w.l1wi;
    case kRic: return w.wri;
    case kRia: row = H().d.E + u; return w.wri;
    default: return w.wq;
  }
}

__device__ int reduction_of(int p) {
  const Dims& d = H().d;
  switch (p) {
    case kQ: case kWq: return d.D;
    case kGctx: case kGh: return 3 * d.D;
    case kL2: case kL1: return 4 * d.L;
    default: return d.L;
  }
}

// This CTA's run of product p.
__device__ Run make_run(int p) {
  const Plan& pl = H().pl;
  const Dims& d = H().d;
  const Inputs& in = H().in;
  const Outputs& out = H().out;
  float* ws = H().ws;
  const int cut = product_cut(p);
  const int2 un = units_of(cut);
  const int B = d.B, D = d.D, L = d.L;
  Run rn;
  switch (p) {
    case kQ: rn.x = in.ah; rn.x_step = (long long)B * D; rn.xs = D; break;
    case kGctx: rn.x = out.dxg4; rn.x_step = (long long)B * 4 * D; rn.xs = 4 * D; break;
    case kGh: rn.x = ws + pl.ws[kWsDhg]; rn.x_step = 0; rn.xs = al4(3 * D); break;
    case kL2: rn.x = out.dgates2; rn.x_step = (long long)B * 4 * L; rn.xs = 4 * L; break;
    case kL1: rn.x = out.dgates1; rn.x_step = (long long)B * 4 * L; rn.xs = 4 * L; break;
    case kRic: case kRia: rn.x = out.dx0; rn.x_step = (long long)B * L; rn.xs = L; break;
    default: rn.x = out.dq; rn.x_step = (long long)B * D; rn.xs = D; break;
  }
  rn.G = (p == kL2 || p == kL1) ? 2 : 1;
  rn.u0 = un.x;
  rn.nu = un.y;
  rn.q = pl.q[cut];
  rn.rows = rn.G * rn.q;
  rn.blocks = (rn.rows + kRows - 1) / kRows;
  rn.groups = (H().nb_rows + kNB - 1) / kNB;
  rn.ks = pl.ks[p];
  rn.n = reduction_of(p);
  const int chunks = (rn.n + kChunk - 1) / kChunk;
  rn.per = (chunks + rn.ks - 1) / rn.ks * kChunk;
  rn.out = pl.out_off[p];
  rn.ld = al4(rn.n);
  rn.w_off = pl.w_off[p];
  rn.Wg = nullptr;
  if (pl.mode == kModeL2) {
    const int per_cta = (pl.ws[kWsTotal] - pl.ws[kWsWl2]) / pl.ctas;
    rn.Wg = ws + pl.ws[kWsWl2] + (size_t)blockIdx.x * per_cta + rn.w_off;
  }
  rn.vec = (rn.xs & 3) == 0 && (rn.n & 3) == 0 && (rn.x_step & 3) == 0 && aligned16(rn.x);
  return rn;
}

// Gathers this CTA's rows of product p, once a launch: row r = g·q + j of
// the slice (zero past the matrix's units, and past n up to ld) goes to the
// CTA's shared memory, to its copy in the workspace ("l2"), or, in a cluster,
// to the shared memory of rank r mod C at row r / C.
__device__ void load_slice(int p) {
  const Run& rn = H().run[p];
  const Plan& pl = H().pl;
  const int C = pl.mode == kModeCluster ? pl.cluster : 1;
  const int rank = pl.mode == kModeCluster ? (int)(blockIdx.x % pl.cluster) : 0;
  const int mine = (rn.rows - rank + C - 1) / C;  // rows r ≡ rank (mod C)
  const int total = mine * rn.ld;
  float* dst = pl.mode == kModeL2 ? const_cast<float*>(rn.Wg) : S() + rn.w_off;
  int row0;
  const Mat m0 = unit_row(p, 0, rn.u0, row0);
  // walk along whichever axis of the torch layout is contiguous
  const bool along_k = abs(m0.sc) <= abs(m0.sr);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int lr = along_k ? i / rn.ld : i % mine;
    const int k = along_k ? i % rn.ld : i / mine;
    const int r = lr * C + rank, g = r / rn.q, j = r % rn.q;
    float v = 0.0f;
    if (j < rn.nu && k < rn.n) {
      int row;
      const Mat m = unit_row(p, g, rn.u0 + j, row);
      v = __ldg(m.p + (size_t)row * m.sr + (size_t)k * m.sc);
    }
    dst[(size_t)lr * rn.ld + k] = v;
  }
}

// Row rr of product p's slice as this CTA reads it.
template <int MODE>
__device__ __forceinline__ const float* slice_row(const Run& rn, int rr) {
  if (MODE == kModeResident) return S() + rn.w_off + rr * rn.ld;
  if (MODE == kModeL2) return rn.Wg + (size_t)rr * rn.ld;
  const int C = H().pl.cluster;
  namespace cg = cooperative_groups;
  return cg::this_cluster().map_shared_rank(S() + rn.w_off + (rr / C) * rn.ld,
                                            rr % C);
}

// scratch[r·kNB + b] = Σ_k W_r[k0 + k] · in[b·xs + k] for kRows rows from r0
// (rows past the slice repeat row r0 and are not read), b < nb (zero past),
// k < kn, computed by one warp: the rows in shared memory (local or a
// cluster rank's) or in the workspace copy, `in` in device memory through L2.
template <int MODE>
__device__ __forceinline__ void rows_product(const Run& rn, int r0, int nr, int k0, int kn,
                                             const float* in, int nb, bool vec, int scratch) {
  constexpr int N = rtvc::padded(kRows * kNB);
  const int lane = threadIdx.x & 31;
  const int xs = rn.xs;
  const float* row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) row[r] = slice_row<MODE>(rn, r < nr ? r0 + r : r0) + k0;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  if (vec) {
    constexpr int DEPTH = 16 / kNB;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = lane * 4; k < kn; k += DEPTH * kChunk) {
      float4 xv[DEPTH][kNB];
#pragma unroll
      for (int s = 0; s < DEPTH; ++s)
#pragma unroll
        for (int b = 0; b < kNB; ++b)
          xv[s][b] = (b < nb && k + s * kChunk < kn)
                         ? __ldcg(reinterpret_cast<const float4*>(in + b * xs + k + s * kChunk))
                         : zero;
#pragma unroll
      for (int s = 0; s < DEPTH; ++s) {
        if (k + s * kChunk < kn) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < nr) {
              const float4 wv = *reinterpret_cast<const float4*>(row[r] + k + s * kChunk);
#pragma unroll
              for (int b = 0; b < kNB; ++b)
                acc[r * kNB + b] = rtvc::dot4(wv, xv[s][b], acc[r * kNB + b]);
            }
          }
        }
      }
    }
  } else {
    for (int k = lane; k < kn; k += 32) {
      float v[kNB];
#pragma unroll
      for (int b = 0; b < kNB; ++b) v[b] = b < nb ? __ldcg(in + b * xs + k) : 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nr) {
          const float wv = row[r][k];
#pragma unroll
          for (int b = 0; b < kNB; ++b) acc[r * kNB + b] = fmaf(wv, v[b], acc[r * kNB + b]);
        }
      }
    }
  }
  rtvc::warp_transpose_sum<N>(acc);
  const int x5 = (int)(__brev((unsigned)lane) >> 27);
#pragma unroll
  for (int m = 0; m < N / 32; ++m) S()[scratch + 32 * m + x5] = acc[m];
}

// The last row of product p's slice that holds one of the CTA's units.
__device__ __forceinline__ int last_row(const Run& rn) { return (rn.G - 1) * rn.q + rn.nu - 1; }

// Deals the items of product p (step s's input) out over the warps from item
// `base` on (the products of a phase share the warps); each writes its sums
// to out[(piece · rows + r) · nb_rows + b]. Returns the next base. The
// helpers that run more than once a step are not inlined: one copy each
// keeps the code a step runs small (instruction fetches are part of each
// phase's latency, as measured for K2).
__device__ __noinline__ int run_product(int p, int s, int base) {
  const Run& rn = H().run[p];
  if (rn.nu <= 0) return base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nbr = H().nb_rows, ks = rn.ks, groups = rn.groups, blocks = rn.blocks;
  const int items = blocks * groups * ks;
  const int scratch = H().pl.scratch + warp * rtvc::padded(kRows * kNB);
  const int mode = H().pl.mode;
  const float* x = rn.x + (size_t)s * rn.x_step + (size_t)H().b_lo * rn.xs;
  for (int it = ((warp - base) % kWarps + kWarps) % kWarps; it < items; it += kWarps) {
    const int split = it % ks, grp = it / ks % groups, blk = it / (ks * groups);
    const int r0 = blk * kRows, nr = min(kRows, last_row(rn) + 1 - r0);
    const int k0 = split * rn.per, kn = max(0, min(rn.n - k0, rn.per));
    const int b0 = grp * kNB, nb = min(kNB, nbr - b0);
    const float* in = x + (size_t)b0 * rn.xs + k0;
    const bool vec = rn.vec && aligned16(in);
    if (mode == kModeResident)
      rows_product<kModeResident>(rn, r0, nr, k0, kn, in, nb, vec, scratch);
    else if (mode == kModeL2)
      rows_product<kModeL2>(rn, r0, nr, k0, kn, in, nb, vec, scratch);
    else
      rows_product<kModeCluster>(rn, r0, nr, k0, kn, in, nb, vec, scratch);
    __syncwarp();
    for (int i = lane; i < kRows * kNB; i += 32) {
      const int r = i / kNB, b = i % kNB;
      if (r0 + r < rn.rows && b < nb)
        S()[rn.out + (split * rn.rows + r0 + r) * nbr + b0 + b] = S()[scratch + i];
    }
    __syncwarp();
  }
  return base + items;
}

// Product p's sum for (gate g, unit j of the CTA, batch row bl of the group),
// its pieces added in order.
__device__ __forceinline__ float psum(int p, int g, int j, int bl) {
  const Run& rn = H().run[p];
  const int nbr = H().nb_rows;
  const int at = rn.out + (g * rn.q + j) * nbr + bl;
  float v = S()[at];
  for (int s = 1; s < rn.ks; ++s) v += S()[at + s * rn.rows * nbr];
  return v;
}

// One zoneout LSTM step backwards for the CTA's units and its group's rows
// (tacotron_train_kernel.py:274-292): dh_tot = dx + dh and the carried dc give
// the pre-activation cotangents (→ dg_out, step s), dc ← dc·f, and hold =
// dh_tot·zo for dh = hold + dg · W_hhᵀ in the next phase. `dx` is the step's
// stream (dx_all) when x_local < 0, else the CTA's own buffer there.
__device__ __noinline__ void lstm_bwd(int s, const float* dx_stream, int x_local, int dh, int dc,
                                      int hold, const float* gates, const float* c,
                                      const float* zo, float* dg_out) {
  const int2 un = units_of(kLstm);
  const Dims& d = H().d;
  const int B = d.B, L = d.L, nbr = H().nb_rows, b_lo = H().b_lo;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < un.y * nbr; idx += kThreads) {
    const int j = idx % un.y, bl = idx / un.y, u = un.x + j, b = b_lo + bl;
    const size_t sb = (size_t)s * B + b;
    const int at = j * nbr + bl;
    const float* g = gates + sb * 4 * L;
    const float i_g = g[u], f_g = g[L + u], g_g = g[2 * L + u], o_g = g[3 * L + u];
    const float tanhc = tanhf(c[sb * L + u]);
    const float cp = s > 0 ? c[(sb - B) * L + u] : 0.0f;
    const float z = zo[sb * L + u];
    const float dx = x_local < 0 ? dx_stream[sb * L + u] : S()[x_local + at];
    const float dh_tot = dx + S()[dh + at];
    const float dhn = dh_tot * (1.0f - z);
    const float d_o = dhn * tanhc * o_g * (1.0f - o_g);
    const float dcj = S()[dc + at] + dhn * o_g * (1.0f - tanhc * tanhc);
    float* o = dg_out + sb * 4 * L;
    o[u] = dcj * g_g * i_g * (1.0f - i_g);
    o[L + u] = dcj * cp * f_g * (1.0f - f_g);
    o[2 * L + u] = dcj * i_g * (1.0f - g_g * g_g);
    o[3 * L + u] = d_o;
    S()[dc + at] = dcj * f_g;
    S()[hold + at] = dh_tot * z;
  }
}

// Phase F of step s: the softmax's and the char mask's backward for the
// batch rows of the CTA's (row, character) pairs, then for each pair and
// each attention column j the energies' backward: darg = du · v · (1 - tanh²)
// into denc_proj (the pair's owner accumulates it in place), Σ du · tanh into
// the CTA's partial of dv, darg into the CTA's part of dq for the row, the
// location adjoint's dmloc[k][j] += cum_prev[t + k - pad] · darg into the
// CTA's partial of dmloc, and s[t][k] = darg[t] · mloc[k] (summed over the
// columns: each warp's lanes by a transposing butterfly, then the warps in
// order) into the workspace for phase G. A thread owns a column j for all of
// its pairs, so its location taps and its part of dmloc stay in registers.
__device__ __noinline__ void attention_bwd(int s) {
  const Dims& d = H().d;
  const Plan& pl = H().pl;
  const Inputs& in = H().in;
  float* ws = H().ws;
  const int2 pr = units_of(kPair);
  if (pr.y <= 0) return;
  const int B = d.B, T = d.T, D = d.D, KS = d.KS, pad = (KS - 1) / 2;
  const int T4 = al4(T), D4 = al4(D), Wc = al4(T + KS - 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r_lo = pr.x / T, nrows = (pr.x + pr.y - 1) / T - r_lo + 1;
  const int RS = pl.row_stride;
  const float* cum = ws + pl.ws[(s & 1) ? kWsCum1 : kWsCum0];
  // a staged row: du (first the logits' cotangent u), scores, mask, the
  // cumulative scores before step s with a zero border, the query, dq's part
  const int oU = 0, oSC = T4, oCM = 2 * T4, oCP = 3 * T4, oQ = 3 * T4 + Wc, oDQ = oQ + D4;
  // every element's source picked first, so that an unrolled round keeps
  // four loads in flight
  const float* u_ws = ws + pl.ws[kWsU];
  const float* q_ws = ws + pl.ws[kWsQ];
#pragma unroll 4
  for (int i = tid; i < nrows * RS; i += kThreads) {
    const int rr = i / RS, k = i % RS, b = r_lo + rr;
    const float* src = nullptr;
    if (k < oSC) {
      if (k < T) src = u_ws + (size_t)b * T4 + k;
    } else if (k < oCM) {
      if (k - oSC < T) src = in.scores + ((size_t)s * B + b) * T + k - oSC;
    } else if (k < oCP) {
      if (k - oCM < T) src = in.char_mask + (size_t)b * T + k - oCM;
    } else if (k < oQ) {
      const int t = k - oCP - pad;
      if (t >= 0 && t < T) src = cum + (size_t)b * T4 + t;
    } else if (k < oDQ) {
      if (k - oQ < D) src = q_ws + (size_t)b * D4 + k - oQ;
    }
    S()[pl.rowbuf + i] = src ? __ldcg(src) : 0.0f;
  }
  __syncthreads();
  for (int rr = warp; rr < nrows; rr += kWarps) {
    float* row = S() + pl.rowbuf + rr * RS;
    float dot = 0.0f;
    for (int t = lane; t < T; t += 32) dot += row[oU + t] * row[oSC + t];
    dot = rtvc::warp_sum(dot);
    for (int t = lane; t < T; t += 32)
      row[oU + t] = row[oSC + t] * (row[oU + t] - dot) * row[oCM + t];
  }
  __syncthreads();
  const bool first = s == d.n - 1;
  const int x5 = (int)(__brev((unsigned)lane) >> 27);
  float* sarr = ws + pl.ws[kWsSarr];
  float* dvp = ws + pl.ws[kWsDvp] + (size_t)blockIdx.x * D4;
  float* dmlp = ws + pl.ws[kWsDmlp] + (size_t)blockIdx.x * KS * D4;
  for (int jb = 0; jb < D; jb += kThreads) {
    const int j = jb + tid;
    const bool col = j < D;
    float m[kMaxTaps], dml[kMaxTaps];
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      m[k] = (col && k < KS) ? __ldg(H().w.mloc + (size_t)k * D + j) : 0.0f;
      dml[k] = 0.0f;
    }
    const float vj = col ? __ldg(H().w.vv + j) : 0.0f;
    float dv_acc = 0.0f;
    // the pairs one after another, the loads of enc_proj and of denc_proj
    // kAhead pairs ahead (a device-memory round trip is several pairs' work);
    // every kPairTile pairs the warps' sums of s are added
    const float* ep = in.enc_proj + j;
    float* dep = H().out.denc_proj + j;
    float ea[kAhead], da_[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const bool on = col && i < pr.y;
      ea[i] = on ? __ldg(ep + (size_t)(pr.x + i) * D) : 0.0f;
      da_[i] = on && !first ? dep[(size_t)(pr.x + i) * D] : 0.0f;
    }
    const int npad = (pr.y + kPairTile - 1) / kPairTile * kPairTile;
    for (int pn = 0; pn < npad; ++pn) {
      const float e0 = ea[0], d0 = da_[0];
#pragma unroll
      for (int i = 0; i + 1 < kAhead; ++i) {
        ea[i] = ea[i + 1];
        da_[i] = da_[i + 1];
      }
      {
        const int pa = pn + kAhead;
        const bool on = col && pa < pr.y;
        ea[kAhead - 1] = on ? __ldg(ep + (size_t)(pr.x + pa) * D) : 0.0f;
        da_[kAhead - 1] = on && !first ? dep[(size_t)(pr.x + pa) * D] : 0.0f;
      }
      const int pi = pn % kPairTile;
      float v[kMaxTaps];
      if (col && pn < pr.y) {
        const int p = pr.x + pn, b = p / T, t = p % T;
        float* row = S() + pl.rowbuf + (b - r_lo) * RS;
        float cw[kMaxTaps];
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) {
          cw[k] = k < KS ? row[oCP + t + k] : 0.0f;
          part[k % 4] = fmaf(cw[k], m[k], part[k % 4]);
        }
        const float pl_ = (part[0] + part[1]) + (part[2] + part[3]);
        const float tv = tanhf(row[oQ + j] + e0 + pl_);
        const float du = row[oU + t];
        const float da = du * vj * (1.0f - tv * tv);
        dep[(size_t)p * D] = d0 + da;
        dv_acc = fmaf(du, tv, dv_acc);
        row[oDQ + j] += da;
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) {
          dml[k] = fmaf(cw[k], da, dml[k]);
          v[k] = da * m[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) v[k] = 0.0f;
      }
      rtvc::warp_transpose_sum<kMaxTaps>(v);
      S()[pl.wpart + (pi * kWarps + warp) * 32 + x5] = v[0];
      if (pi == kPairTile - 1) {
        const int p0 = pn - pi;
        __syncthreads();
        for (int i = tid; i < kPairTile * kMaxTaps; i += kThreads) {
          const int q = i / kMaxTaps, k = i % kMaxTaps;
          if (k < KS && p0 + q < pr.y) {
            float acc = 0.0f;
            for (int w = 0; w < kWarps; ++w) acc += S()[pl.wpart + (q * kWarps + w) * 32 + k];
            float* o = sarr + (size_t)(pr.x + p0 + q) * kMaxTaps + k;
            *o = jb == 0 ? acc : *o + acc;
          }
        }
        __syncthreads();
      }
    }
    if (col) {
      dvp[j] += dv_acc;
#pragma unroll
      for (int k = 0; k < kMaxTaps; ++k)
        if (k < KS) dmlp[(size_t)k * D4 + j] += dml[k];
    }
  }
  // the CTA's part of dq for each of its rows, for phase G
  float* dqp = ws + pl.ws[kWsDqp] + (size_t)blockIdx.x * pl.soft_rows * D4;
  for (int i = tid; i < nrows * D; i += kThreads) {
    const int rr = i / D, j = i % D;
    dqp[(size_t)rr * D4 + j] = S()[pl.rowbuf + rr * RS + oDQ + j];
  }
}

// After the walk: denc_seq[b, t, e] = Σ_s scores[s, b, t] · dctx_s[b, e], the
// context cotangents of each step (phase D) against its scores, the steps
// added in order. An item is (row, 32 characters, 128 columns); the scores of
// 64 steps at a time are staged, and each thread keeps 16 sums.
__device__ __noinline__ void denc_seq_after_walk() {
  const Dims& d = H().d;
  const Plan& pl = H().pl;
  const int n = d.n, B = d.B, T = d.T, E = d.E, E4 = al4(E);
  const int tid = threadIdx.x, th = tid / 128;
  const int tiles_t = (T + kStageT - 1) / kStageT, tiles_e = (E + 127) / 128;
  const float* dctx = H().ws + pl.ws[kWsDctx];
  float* st = S() + pl.wpart;
  for (int it = blockIdx.x; it < B * tiles_t * tiles_e; it += pl.ctas) {
    const int b = it / (tiles_t * tiles_e), t0 = it / tiles_e % tiles_t * kStageT;
    const int e = it % tiles_e * 128 + tid % 128;
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
    for (int s0 = 0; s0 < n; s0 += kStageSteps) {
      const int ns = min(kStageSteps, n - s0);
      for (int i = tid; i < ns * kStageT; i += kThreads) {
        const int sl = i / kStageT, t = t0 + i % kStageT;
        st[i] = t < T ? H().in.scores[((size_t)(s0 + sl) * B + b) * T + t] : 0.0f;
      }
      __syncthreads();
      if (e < E) {
        for (int sl = 0; sl < ns; ++sl) {
          const float dc = __ldcg(dctx + ((size_t)(s0 + sl) * B + b) * E4 + e);
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[i] = fmaf(st[sl * kStageT + th * 16 + i], dc, acc[i]);
        }
      }
      __syncthreads();
    }
    if (e < E) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int t = t0 + th * 16 + i;
        if (t < T) H().out.denc_seq[((size_t)b * T + t) * E + e] = acc[i];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
tacotron_train_bwd_kernel(Weights w_in, Inputs in_in, Outputs out_in, Dims d_in, Plan pl_in,
                          float* ws) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    H().w = w_in;
    H().in = in_in;
    H().out = out_in;
    H().d = d_in;
    H().pl = pl_in;
    H().ws = ws;
    H().group = blockIdx.x % pl_in.groups;
    H().slice = blockIdx.x / pl_in.groups;
    H().b_lo = min(d_in.B, H().group * pl_in.rows);
    H().nb_rows = min(d_in.B, H().b_lo + pl_in.rows) - H().b_lo;
  }
  __syncthreads();
  if (tid < kProducts) H().run[tid] = make_run(tid);
  __syncthreads();
  const Dims& d = H().d;
  const Plan& pl = H().pl;
  const Inputs& in = H().in;
  const Outputs& out = H().out;
  const int n = d.n, B = d.B, T = d.T, D = d.D, L = d.L, E = d.E, KS = d.KS;
  const int T4 = al4(T), D4 = al4(D), E4 = al4(E), D34 = al4(3 * D);
  const int pad = (KS - 1) / 2;
  const int nbr = H().nb_rows, b_lo = H().b_lo;
  unsigned int* sync = reinterpret_cast<unsigned int*>(ws);
  const unsigned int ctas = gridDim.x;
  unsigned int barriers = 0;
  const int2 lstm = units_of(kLstm), ctxu = units_of(kCtx), att = units_of(kAtt);
  const int2 pairs = units_of(kPair);

  // ---- the CTA's weight rows, zero state and partials, once a launch ----
  for (int p = 0; p < kProducts; ++p) load_slice(p);
  for (int i = pl.dh2 + tid; i < pl.outs; i += kThreads) S()[i] = 0.0f;
  for (int i = tid; i < pairs.y; i += kThreads) {
    const int p = pairs.x + i;
    ws[pl.ws[kWsDcum] + (size_t)(p / T) * T4 + p % T] = 0.0f;
  }
  for (int i = tid; i < D4; i += kThreads) ws[pl.ws[kWsDvp] + (size_t)blockIdx.x * D4 + i] = 0.0f;
  for (int i = tid; i < KS * D4; i += kThreads)
    ws[pl.ws[kWsDmlp] + (size_t)blockIdx.x * KS * D4 + i] = 0.0f;
  if (pl.mode == kModeCluster) cooperative_groups::this_cluster().sync();
  __syncthreads();

  for (int s = n - 1; s >= 0; --s) {
    const bool first = s == n - 1;
    // ---- A: the attention GRU's products of step s + 1 (the carried dctx and
    // dah), the query of step s, the second LSTM's backward, the cumulative
    // scores before step s ----
    {
      int base = 0;
      if (!first) base = run_product(kGh, s + 1, run_product(kGctx, s + 1, 0));
      run_product(kQ, s, base);
    }
    __syncthreads();
    if (!first) {
      for (int idx = tid; idx < ctxu.y * nbr; idx += kThreads) {
        const int j = idx % ctxu.y, bl = idx / ctxu.y;
        S()[pl.dctx + j * nbr + bl] = psum(kGctx, 0, j, bl);
      }
      for (int idx = tid; idx < att.y * nbr; idx += kThreads) {
        const int j = idx % att.y, bl = idx / att.y;
        S()[pl.dah + j * nbr + bl] += psum(kGh, 0, j, bl);
      }
    }
    for (int idx = tid; idx < att.y * nbr; idx += kThreads) {
      const int j = idx % att.y, bl = idx / att.y, u = att.x + j;
      ws[pl.ws[kWsQ] + (size_t)(b_lo + bl) * D4 + u] = psum(kQ, 0, j, bl) + __ldg(H().w.bq + u);
    }
    lstm_bwd(s, in.dx_all, -1, pl.dh2, pl.dc2, pl.hold2, in.gates2, in.c2, in.zo2, out.dgates2);
    {
      float* now = ws + pl.ws[(s & 1) ? kWsCum1 : kWsCum0];
      const float* next = ws + pl.ws[(s & 1) ? kWsCum0 : kWsCum1];
      for (int i = tid; i < pairs.y; i += kThreads) {
        const int p = pairs.x + i, b = p / T, t = p % T;
        const float after = first ? in.cum_T[p] : __ldcg(next + (size_t)b * T4 + t);
        now[(size_t)b * T4 + t] = after - in.scores[(size_t)s * B * T + p];
      }
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- B: dh2 and dx1 from the second LSTM's gates; the first LSTM's
    // backward ----
    run_product(kL2, s, 0);
    __syncthreads();
    for (int idx = tid; idx < lstm.y * nbr; idx += kThreads) {
      const int j = idx % lstm.y, bl = idx / lstm.y, u = lstm.x + j, at = j * nbr + bl;
      S()[pl.dh2 + at] = S()[pl.hold2 + at] + psum(kL2, 0, j, bl);
      S()[pl.dx1 + at] = in.dx_all[((size_t)s * B + b_lo + bl) * L + u] + psum(kL2, 1, j, bl);
    }
    __syncthreads();
    lstm_bwd(s, nullptr, pl.dx1, pl.dh1, pl.dc1, pl.hold1, in.gates1, in.c1, in.zo1, out.dgates1);
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- C: dh1 and dx0 from the first LSTM's gates ----
    run_product(kL1, s, 0);
    __syncthreads();
    for (int idx = tid; idx < lstm.y * nbr; idx += kThreads) {
      const int j = idx % lstm.y, bl = idx / lstm.y, u = lstm.x + j, at = j * nbr + bl;
      S()[pl.dh1 + at] = S()[pl.hold1 + at] + psum(kL1, 0, j, bl);
      out.dx0[((size_t)s * B + b_lo + bl) * L + u] = S()[pl.dx1 + at] + psum(kL1, 1, j, bl);
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- D: rnn_input's backward onto the context's and the attention
    // hidden's cotangents ----
    run_product(kRia, s, run_product(kRic, s, 0));
    __syncthreads();
    for (int idx = tid; idx < ctxu.y * nbr; idx += kThreads) {
      const int j = idx % ctxu.y, bl = idx / ctxu.y, u = ctxu.x + j;
      const size_t sb = (size_t)s * B + b_lo + bl;
      ws[pl.ws[kWsDctx] + sb * E4 + u] =
          in.dctx_all[sb * E + u] + S()[pl.dctx + j * nbr + bl] + psum(kRic, 0, j, bl);
    }
    for (int idx = tid; idx < att.y * nbr; idx += kThreads) {
      const int j = idx % att.y, bl = idx / att.y;
      S()[pl.dah + j * nbr + bl] += psum(kRia, 0, j, bl);
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- E: the logits' cotangent u = dscores + dcum + enc_seq · dctx for
    // the CTA's pairs: the rows' dctx staged, a warp two pairs at a time with
    // all their enc_seq loads in flight ----
    if (pairs.y > 0) {
      const int lane = tid & 31, warp = tid >> 5;
      const int r_lo = pairs.x / T, nrows = (pairs.x + pairs.y - 1) / T - r_lo + 1;
      const float* dctx = ws + pl.ws[kWsDctx] + (size_t)s * B * E4;
#pragma unroll 8
      for (int i = tid; i < nrows * E; i += kThreads)
        S()[pl.rowbuf + i / E * pl.row_stride + i % E] =
            __ldcg(dctx + (size_t)(r_lo + i / E) * E4 + i % E);
      __syncthreads();
      const bool vec = (E & 3) == 0 && E <= 32 * 4 * kEnc && aligned16(in.enc_seq);
      for (int p0 = 2 * warp; p0 < pairs.y; p0 += 2 * kWarps) {
        float acc[2] = {0.0f, 0.0f};
        if (vec) {
          float4 a[2][kEnc];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int i = 0; i < kEnc; ++i) {
              const int e4 = lane + 32 * i;
              a[q][i] = p0 + q < pairs.y && 4 * e4 < E
                            ? __ldg(reinterpret_cast<const float4*>(
                                  in.enc_seq + (size_t)(pairs.x + p0 + q) * E) + e4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int rr = min(p0 + q, pairs.y - 1) + pairs.x;
            const float4* dc = reinterpret_cast<const float4*>(
                S() + pl.rowbuf + (rr / T - r_lo) * pl.row_stride);
#pragma unroll
            for (int i = 0; i < kEnc; ++i)
              if (4 * (lane + 32 * i) < E) acc[q] = rtvc::dot4(a[q][i], dc[lane + 32 * i], acc[q]);
          }
        } else {
          for (int q = 0; q < 2 && p0 + q < pairs.y; ++q) {
            const int p = pairs.x + p0 + q;
            const float* es = in.enc_seq + (size_t)p * E;
            const float* dc = S() + pl.rowbuf + (p / T - r_lo) * pl.row_stride;
            for (int e = lane; e < E; e += 32) acc[q] = fmaf(__ldg(es + e), dc[e], acc[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float dot = rtvc::warp_sum(acc[q]);
          if (lane == 0 && p0 + q < pairs.y) {
            const int p = pairs.x + p0 + q;
            const size_t at = (size_t)(p / T) * T4 + p % T;
            ws[pl.ws[kWsU] + at] = in.dscores_all[(size_t)s * B * T + p] +
                                   ws[pl.ws[kWsDcum] + at] + dot;
          }
        }
      }
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- F: softmax, mask and energies backwards ----
    attention_bwd(s);
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- G: the location term's adjoint onto dcum (the pairs' neighbours'
    // s from other CTAs); dq summed over the CTAs that hold a row's pairs ----
    {
      const float* sarr = ws + pl.ws[kWsSarr];
      for (int i = tid; i < pairs.y; i += kThreads) {
        const int p = pairs.x + i, b = p / T, t = p % T;
        float acc = 0.0f;
#pragma unroll 8
        for (int k = max(0, t + pad - (T - 1)); k < min(KS, t + pad + 1); ++k)
          acc += __ldcg(sarr + ((size_t)b * T + t + pad - k) * kMaxTaps + k);
        ws[pl.ws[kWsDcum] + (size_t)b * T4 + t] += acc;
      }
      const int qp = pl.q[kPair];
      const float* dqp = ws + pl.ws[kWsDqp];
      for (int idx = tid; idx < att.y * nbr; idx += kThreads) {
        const int j = idx % att.y, bl = idx / att.y, u = att.x + j, b = b_lo + bl;
        const int c_hi = min((int)ctas - 1, ((b + 1) * T - 1) / qp);
        float acc = 0.0f;
        for (int c = b * T / qp; c <= c_hi; ++c)
          acc += __ldcg(dqp + ((size_t)c * pl.soft_rows + b - c * qp / T) * D4 + u);
        out.dq[((size_t)s * B + b) * D + u] = acc;
      }
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- H: dq · lsa_Wᵀ onto dah, and the attention GRU's backward ----
    run_product(kWq, s, 0);
    __syncthreads();
    for (int idx = tid; idx < att.y * nbr; idx += kThreads) {
      const int j = idx % att.y, bl = idx / att.y, u = att.x + j, b = b_lo + bl;
      const size_t sb = (size_t)s * B + b;
      const float* g4 = in.g4 + sb * 4 * D;
      const float rg = g4[u], zg = g4[D + u], ng = g4[2 * D + u], hn = g4[3 * D + u];
      const float ahp = s > 0 ? in.ah[(sb - B) * D + u] : 0.0f;
      const float dt = S()[pl.dah + j * nbr + bl] + psum(kWq, 0, j, bl);
      const float dz = dt * (ahp - ng) * zg * (1.0f - zg);
      const float dn = dt * (1.0f - zg) * (1.0f - ng * ng);
      const float dr = dn * hn * rg * (1.0f - rg);
      float* o = out.dxg4 + sb * 4 * D;
      o[u] = dr;
      o[D + u] = dz;
      o[2 * D + u] = dn;
      o[3 * D + u] = dn * rg;
      float* hg = ws + pl.ws[kWsDhg] + (size_t)b * D34;
      hg[u] = dr;
      hg[D + u] = dz;
      hg[2 * D + u] = dn * rg;
      S()[pl.dah + j * nbr + bl] = dt * zg;
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);
  }

  denc_seq_after_walk();
  // no CTA of a cluster leaves while another may read its shared memory
  if (pl.mode == kModeCluster) cooperative_groups::this_cluster().sync();
}

bool plan_ok(const Plan& pl, const Dims& d) {
  const int C = pl.mode == kModeCluster ? pl.groups : 1;
  return pl.ctas >= 1 && pl.groups >= 1 && pl.ctas % pl.groups == 0 && pl.cluster == C &&
         pl.mode >= kModeResident && pl.mode <= kModeCluster && pl.rows >= 1 &&
         (long long)pl.rows * pl.groups >= d.B && pl.dh2 >= kHeaderFloats &&
         pl.smem >= 4 * pl.end && d.KS % 2 == 1 && d.KS < kMaxTaps &&
         pl.row_stride >= al4(d.E) &&
         pl.row_stride >= 3 * al4(d.T) + al4(d.T + d.KS - 1) + 2 * al4(d.D) &&
         (long long)pl.q[kPair] * pl.ctas >= (long long)d.B * d.T &&
         pl.wpart + kStageSteps * kStageT <= pl.end &&
         pl.wpart + kPairTile * kThreads <= pl.end;
}

cudaLaunchConfig_t launch_config(const Plan& pl, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)pl.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = pl.cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.cluster > 1 ? 2 : 1;
  return cfg;
}

}  // namespace bwd

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
// CTA of the forward kernel takes.
extern "C" int rtvc_tacotron_train_smem(const int* dims) {
  return (int)sizeof(float) * FwdLayout(read_dims(dims)).total;
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

// weights: the eight matrices of TrainWeights as torch holds them, gwh (D, 3D),
// wq (D, D), wri (E+D, L), l1wi, l1wh, l2wi, l2wh (L, 4L), gwi_ctx (E, 3D),
// then bq (D), mloc (KS, D), vv (D), contiguous; strides: each matrix's row
// and column strides in floats. inputs: the cotangents dx_all (n, B, L),
// dctx_all (n, B, E), dscores_all (n, B, T); the forward's ah, g4, gates1,
// c1, gates2, c2, scores, cum_T; zo1, zo2, enc_seq, enc_proj, char_mask.
// outputs: dxg4 (n, B, 4D) = [dr, dz, dn, dn·r], dq (n, B, D), dx0 (n, B, L),
// dgates1, dgates2 (n, B, 4L), denc_seq (B, T, E), denc_proj (B, T, D). plan:
// plan_len ints (ops/tacotron_train.py:BwdPlan.ints). work: the plan's
// ws[kWsTotal] floats, the barrier's counter (first word) zeroed; dv and
// dmloc are left there as one partial per CTA. Returns the launch's
// cudaError_t: cudaErrorInvalidValue for a plan that does not match,
// cudaErrorCooperativeLaunchTooLarge for a grid that does not fit the card.
extern "C" int rtvc_tacotron_train_bwd(const void* const* weights, const int* strides,
                                       const void* const* inputs, const void* const* outputs,
                                       const int* dims, const int* plan, int plan_len,
                                       void* work, void* stream) {
  bwd::Weights w;
  bwd::Mat* mats[] = {&w.gwh, &w.wq, &w.wri, &w.l1wi, &w.l1wh, &w.l2wi, &w.l2wh, &w.gwi_ctx};
  for (int i = 0; i < 8; ++i)
    *mats[i] = {static_cast<const float*>(weights[i]), strides[2 * i], strides[2 * i + 1]};
  w.bq = static_cast<const float*>(weights[8]);
  w.mloc = static_cast<const float*>(weights[9]);
  w.vv = static_cast<const float*>(weights[10]);
  const Dims d = read_dims(dims);
  if (plan_len != (int)(sizeof(bwd::Plan) / sizeof(int))) return (int)cudaErrorInvalidValue;
  bwd::Plan pl;
  std::memcpy(&pl, plan, sizeof(bwd::Plan));
  if (!bwd::plan_ok(pl, d)) return (int)cudaErrorInvalidValue;
  cudaError_t e = rtvc::allow_smem((const void*)bwd::tacotron_train_bwd_kernel, (size_t)pl.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = bwd::launch_config(pl, static_cast<cudaStream_t>(stream), attr);
  e = cudaLaunchKernelEx(&cfg, bwd::tacotron_train_bwd_kernel, w,
                         from_pointers<bwd::Inputs>(inputs, bwd::kInputs),
                         from_pointers<bwd::Outputs>(outputs, bwd::kOutputs), d, pl,
                         static_cast<float*>(work));
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch must not fail the next one's check
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// CTAs of the backward that the card runs at once in clusters of `cluster`
// with `smem` bytes of shared memory each (0 where it runs none), or minus
// the cudaError_t of the query.
extern "C" int rtvc_tacotron_train_bwd_clusters(int cluster, int smem) {
  cudaError_t e = rtvc::allow_smem((const void*)bwd::tacotron_train_bwd_kernel, (size_t)smem);
  if (e != cudaSuccess) return -(int)e;
  bwd::Plan pl = {};
  pl.ctas = cluster;
  pl.cluster = cluster;
  pl.smem = smem;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = bwd::launch_config(pl, nullptr, attr);
  cfg.attrs = attr + 1;  // the cluster's shape alone
  cfg.numAttrs = 1;
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, (const void*)bwd::tacotron_train_bwd_kernel, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return count * cluster;
}
