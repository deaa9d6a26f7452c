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
// batch row, and reads the attention memory (160 x (896 + 256) floats a row,
// 82.6 MB a step at batch 112, more than the 50 MB L2) once in each
// direction: about 2 FLOP per 4 bytes of weights, and a chain of dependent
// products a step. One CTA a batch row streaming the weights out of L2 took
// ≈ 374 µs a step (forward) and ≈ 600 µs (backward) at batch 112. Split over
// the card, with the weights resident, a step is bound at batch 112 by the
// L2's rate for the products' inputs, which every CTA reads for all batch
// rows (≈ 3 MB a CTA a forward step), and by device memory for enc_seq; at
// batch 22 by the chain of its phases, each a few L2 round trips and a grid
// barrier (PERF.md, section 6).
//
// Both directions are one cooperative launch over the card, the design of K2
// (tacotron_decode.cu): ops/tacotron_train.py:plan_fwd and plan_bwd cut the
// work and lay out the shared memory and the workspace, and the kernel takes
// every offset from the plan. Each product's output columns (the forward) or
// rows of an (in, out) matrix (the backward) are cut over the CTAs by unit, a
// unit's gate rows in one CTA so that its elementwise update and its carried
// state stay there; all batch rows ride in every CTA, or one batch group of
// them where the plan makes groups. The CTA gathers its weight rows once a
// launch from the matrices as torch holds them (strided views of the
// parameters, the context half of the GRU's weight_ih a column slice) into
// its shared memory ("resident"), or into a copy in the workspace read
// through L2 every step ("l2"). An item of a product is 8 weight rows x 8
// batch rows, its inputs read from L2 (__ldcg: other CTAs wrote them) once
// for all 8 rows, the lanes summed by a transposing butterfly
// (common.cuh:warp_transpose_sum); run_items below serves both directions.
// The attention's (row, character) pairs are cut over all CTAs. No sum goes
// through an atomic: two runs give equal bits.
//
// The forward (namespace fwd), seven phases a step, each ended by a grid
// barrier (K2's order without the prenet, mel and stop):
//   A  the GRU: gwi_ctx·ctx and gwh·ah of the step before, the update; beside
//      the chain both LSTMs' W_hh·h of the step before (their sums kept for
//      F and G);
//   B  the query lsa_W·ah; beside it rnn_input's attention-hidden half;
//   C  the energies v·tanh(q + enc_proj + location) x char mask of the CTA's
//      pairs: a thread owns a column j, its KS taps of mloc in registers, and
//      takes 32 pairs of a row at once, the location term Σ_k cum[t + k - pad]
//      · mloc[k][j] from 62 cumulative scores in registers (31 FMAs a pair
//      and column, no shared-memory load in the inner loop; the row is
//      staged with a zero border: the TPU kernel's padding of T to 128, its
//      additive mask and its tiles answer that compiler's limits and are not
//      carried over), the columns summed per pair by the butterfly, then
//      over the warps in order. The
//      location term is computed here, in the CTA that needs it, and not
//      beside the LSTMs of the step before as K2 does: there it would be
//      written to and read back from the workspace (two more (B, T, D) streams,
//      36.7 MB a step at batch 112) for the same FMAs;
//   D  the softmax of every row the CTA's pairs touch, computed in each such
//      CTA in a fixed order; the scores and cumulative scores of its pairs;
//      its context items, (row, 128 columns) each, item k of row b owned by
//      the CTA that owns pair (b, k·T / ⌈E / 128⌉) so that its row's softmax
//      is at hand: a warp's lanes on float4 columns and the warps on
//      interleaved characters, ten loads in flight a thread, enc_seq read
//      as a stream where the attention memory outgrows the L2;
//   E  rnn_input's context half, giving x0;
//   F  LSTM 1 (W_ih·x0 plus the kept W_hh·h), giving h1 and x1 = x0 + h1;
//   G  LSTM 2, giving h2 and x_all = x1 + h2.
// Every output stream is written by the CTA that owns it, and the products
// read their inputs from those streams (ah, h1, h2, ctx, x0 of this step or
// the one before); the workspace holds the query, the logits, the cumulative
// scores and x1.
//
// The backward (namespace bwd), eight phases a reverse step, each ended by a
// grid barrier:
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
// dmloc stay one partial per CTA, summed by the wrapper.
#include <cfloat>
#include <cstring>

#include "common.cuh"

namespace {

using rtvc::sigmoidf_;
using rtvc::warp_sum;

constexpr int kThreads = rtvc::kRecThreads;
constexpr int kWarps = rtvc::kRecWarps;
constexpr int kRows = 8;           // weight rows an item of a product takes
constexpr int kNB = 8;             // batch rows an item takes
constexpr int kChunk = 128;        // floats of the reduction axis a warp covers at once
constexpr int kMaxTaps = 32;       // location taps a thread keeps in registers (31 used)
constexpr int kHeaderFloats = 512;

// Where a CTA's weight rows live (ops/tacotron_train.py:MODES).
enum Mode { kModeResident, kModeL2 };

struct Dims {
  int n, B, T, D, L, E, KS;
};

// A matrix of TrainWeights as torch holds it: element (r, c) at p[r·sr + c·sc]
// (the weights are often transposed views of the parameters).
struct Mat {
  const float* p;
  int sr, sc;
};

// Its transpose: row c is the matrix's column c.
__device__ __forceinline__ Mat transposed(const Mat& m) { return {m.p, m.sc, m.sr}; }

__host__ __device__ constexpr int al4(int n) { return (n + 3) & ~3; }

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Every access to shared memory goes through this symbol with an offset
// from the plan, so that the compiler emits shared loads and stores.
extern __shared__ float4 g_smem[];

__device__ __forceinline__ float* S() { return reinterpret_cast<float*>(g_smem); }

// The launch's parameters at the start of shared memory (a direction's
// Header: the phases index its runs at run time, which kernel parameters
// would serve from local memory).
template <class Hd>
__device__ __forceinline__ Hd& hdr() {
  return *reinterpret_cast<Hd*>(g_smem);
}

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

// Fills the fields of a run that follow from the plan: gates G, its units
// un, q, reduction length n, pieces ks, offsets of its weights and sums.
__device__ __forceinline__ void shape_run(Run& rn, int G, int2 un, int q, int n, int ks,
                                          int w_off, int out, int nb_rows, int mode,
                                          float* wl2) {
  rn.G = G;
  rn.u0 = un.x;
  rn.nu = un.y;
  rn.q = q;
  rn.rows = G * q;
  rn.blocks = (rn.rows + kRows - 1) / kRows;
  rn.groups = (nb_rows + kNB - 1) / kNB;
  rn.ks = ks;
  rn.n = n;
  const int chunks = (n + kChunk - 1) / kChunk;
  rn.per = (chunks + ks - 1) / ks * kChunk;
  rn.out = out;
  rn.ld = al4(n);
  rn.w_off = w_off;
  rn.Wg = mode == kModeL2 ? wl2 + w_off : nullptr;
  rn.vec = (rn.xs & 3) == 0 && (n & 3) == 0 && (rn.x_step & 3) == 0 && aligned16(rn.x);
}

// Gathers this CTA's rows of product p, once a launch: row r = g·q + j of
// the slice (zero past the matrix's units, and past n up to ld) goes to the
// CTA's shared memory or to its copy in the workspace ("l2"). row_of(p, g,
// u, row) gives gate g of unit u as a row of a matrix.
template <class Hd, class RowOf>
__device__ void load_slice(int p, RowOf row_of) {
  const Run& rn = hdr<Hd>().run[p];
  float* dst = hdr<Hd>().pl.mode == kModeL2 ? const_cast<float*>(rn.Wg) : S() + rn.w_off;
  const int total = rn.rows * rn.ld;
  int row0;
  const Mat m0 = row_of(p, 0, rn.u0, row0);
  // walk along whichever axis of the torch layout is contiguous
  const bool along_k = abs(m0.sc) <= abs(m0.sr);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = along_k ? i / rn.ld : i % rn.rows;
    const int k = along_k ? i % rn.ld : i / rn.rows;
    const int g = r / rn.q, j = r % rn.q;
    float v = 0.0f;
    if (j < rn.nu && k < rn.n) {
      int row;
      const Mat m = row_of(p, g, rn.u0 + j, row);
      v = __ldg(m.p + (size_t)row * m.sr + (size_t)k * m.sc);
    }
    dst[(size_t)r * rn.ld + k] = v;
  }
}

// Row rr of a product's slice as this CTA reads it.
template <int MODE>
__device__ __forceinline__ const float* slice_row(const Run& rn, int rr) {
  if (MODE == kModeResident) return S() + rn.w_off + rr * rn.ld;
  return rn.Wg + (size_t)rr * rn.ld;
}

// scratch[r·kNB + b] = Σ_k W_r[k0 + k] · in[b·xs + k] for kRows rows from r0
// (rows past the slice repeat row r0 and are not read), b < nb (zero past),
// k < kn, computed by one warp: the rows in shared memory or in the
// workspace copy, `in` in device memory through L2.
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

// The last row of a product's slice that holds one of the CTA's units.
__device__ __forceinline__ int last_row(const Run& rn) { return (rn.G - 1) * rn.q + rn.nu - 1; }

// Deals the items of product p (step s's input) out over the warps from item
// `base` on (the products of a phase share the warps); each writes its sums
// to out[(piece · rows + r) · nb_rows + b]. Returns the next base. The
// helpers that run more than once a step are not inlined: one copy each
// keeps the code a step runs small (instruction fetches are part of each
// phase's latency, as measured for K2).
template <class Hd>
__device__ __noinline__ int run_items(int p, int s, int base) {
  const Hd& h = hdr<Hd>();
  const Run& rn = h.run[p];
  if (rn.nu <= 0) return base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nbr = h.nb_rows, ks = rn.ks, groups = rn.groups, blocks = rn.blocks;
  const int items = blocks * groups * ks;
  const int scratch = h.pl.scratch + warp * rtvc::padded(kRows * kNB);
  const int mode = h.pl.mode;
  const float* x = rn.x + (size_t)s * rn.x_step + (size_t)h.b_lo * rn.xs;
  for (int it = ((warp - base) % kWarps + kWarps) % kWarps; it < items; it += kWarps) {
    const int split = it % ks, grp = it / ks % groups, blk = it / (ks * groups);
    const int r0 = blk * kRows, nr = min(kRows, last_row(rn) + 1 - r0);
    const int k0 = split * rn.per, kn = max(0, min(rn.n - k0, rn.per));
    const int b0 = grp * kNB, nb = min(kNB, nbr - b0);
    const float* in = x + (size_t)b0 * rn.xs + k0;
    const bool vec = rn.vec && aligned16(in);
    if (mode == kModeResident)
      rows_product<kModeResident>(rn, r0, nr, k0, kn, in, nb, vec, scratch);
    else
      rows_product<kModeL2>(rn, r0, nr, k0, kn, in, nb, vec, scratch);
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
template <class Hd>
__device__ __forceinline__ float sum_of(int p, int g, int j, int bl) {
  const Run& rn = hdr<Hd>().run[p];
  const int nbr = hdr<Hd>().nb_rows;
  const int at = rn.out + (g * rn.q + j) * nbr + bl;
  float v = S()[at];
  for (int s = 1; s < rn.ks; ++s) v += S()[at + s * rn.rows * nbr];
  return v;
}

template <class S_>
S_ from_pointers(const void* const* p, int count) {
  S_ s;
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

// The eight matrices of TrainWeights, each with its row and column strides.
void read_mats(const void* const* weights, const int* strides, Mat* const* mats) {
  for (int i = 0; i < 8; ++i)
    *mats[i] = {static_cast<const float*>(weights[i]), strides[2 * i], strides[2 * i + 1]};
}

// A cooperative launch of `ctas` CTAs of kThreads threads with `smem` bytes
// of dynamic shared memory, through cudaLaunchKernelEx with the cooperative
// attribute: all CTAs resident at once, or the launch is refused
// (cudaErrorCooperativeLaunchTooLarge) instead of hanging at a barrier.
// Returns the cudaError_t.
template <class... Params, class... Args>
int launch(void (*kernel)(Params...), int ctas, int smem, void* stream, Args... args) {
  cudaError_t e = rtvc::allow_smem((const void*)kernel, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch must not fail the next one's check
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Forward: the chain split over the card
// ---------------------------------------------------------------------------

namespace fwd {

constexpr int kPhases = 7;      // phases a step, each ended by a grid barrier
constexpr int kCtxCols = 128;   // context columns of an item of phase D
constexpr int kCtxDepth = 10;   // enc_seq loads a thread of phase D keeps in flight
constexpr int kTile = 32;       // pairs of one row the energies take at once
constexpr int kWindow = kTile + kMaxTaps - 2;  // cumulative scores a tile's windows span

enum Cut { kAtt, kLstm, kPair, kCuts };
enum Product { kGctx, kGh, kL1h, kL2h, kQ, kRia, kRic, kL1i, kL2i, kProducts };
enum Ws { kWsQ, kWsU, kWsCum, kWsX1, kWsWl2, kWsTotal, kWs };

// ops/tacotron_train.py:FwdPlan.ints, field for field.
struct Plan {
  int ctas, groups, mode, rows, smem;
  int q[kCuts];
  int ks[kProducts], w_off[kProducts], out_off[kProducts];
  int ah, c1, h1, c2, h2, x0, x1, outs, scratch, rowbuf, row_stride, soft_rows, wpart, end;
  int ws[kWs];
};

struct Weights {
  Mat gwh, wq, wri, l1wi, l1wh, l2wi, l2wh, gwi_ctx;
  const float *gbh, *bq, *mloc, *vv, *bri, *l1b, *l2b;
};
constexpr int kVectors = 7;

struct Inputs {
  const float *xg_pre, *zo1, *zo2, *enc_seq, *enc_proj, *char_mask;
};
constexpr int kInputs = 6;

struct Outputs {
  float *x_all, *ah, *g4, *x0, *gates1, *c1, *h1, *gates2, *c2, *h2, *scores, *ctx, *cum_T;
};
constexpr int kOutputs = 13;

struct Header {
  Weights w;
  Inputs in;
  Outputs out;
  Dims d;
  Plan pl;
  Run run[kProducts];
  float* ws;
  int group, slice, b_lo, nb_rows, stream;
};
static_assert(sizeof(Header) <= 4 * kHeaderFloats, "the header outgrew its room");

__device__ __forceinline__ Header& H() { return hdr<Header>(); }

__host__ __device__ inline int cut_size(const Dims& d, int cut) {
  switch (cut) {
    case kAtt: return d.D;
    case kLstm: return d.L;
    default: return d.B * d.T;
  }
}

// The units [x, x + y) of a cut that CTA `cta` owns (y may be 0): the
// attention and LSTM units of its slice, its pairs.
__host__ __device__ inline int2 units_for(const Plan& pl, const Dims& d, int cut, int cta) {
  const int q = pl.q[cut];
  const int u0 = (cut == kPair ? cta : cta / pl.groups) * q;
  const int y = q < cut_size(d, cut) - u0 ? q : cut_size(d, cut) - u0;
  return make_int2(u0, y > 0 ? y : 0);
}

__device__ __forceinline__ int2 units_of(int cut) {
  return units_for(H().pl, H().d, cut, (int)blockIdx.x);
}

// The batch rows of CTA `cta`'s pairs, (first, count): the rows whose
// softmax it computes, and the rows of its context items.
__host__ __device__ inline int2 pair_rows(const Plan& pl, const Dims& d, int cta) {
  const int2 pr = units_for(pl, d, kPair, cta);
  if (pr.y <= 0) return make_int2(0, 0);
  return make_int2(pr.x / d.T, (pr.x + pr.y - 1) / d.T - pr.x / d.T + 1);
}

__device__ int product_cut(int p) {
  switch (p) {
    case kGctx: case kGh: case kQ: return kAtt;
    default: return kLstm;
  }
}

__device__ int gates_of(int p) {
  switch (p) {
    case kGctx: case kGh: return 3;
    case kQ: case kRia: case kRic: return 1;
    default: return 4;
  }
}

__device__ int reduction_of(int p) {
  const Dims& d = H().d;
  switch (p) {
    case kGctx: case kRic: return d.E;
    case kGh: case kQ: case kRia: return d.D;
    default: return d.L;
  }
}

// Gate g of unit u of product p as a row: a column of its (in, out) matrix.
struct UnitRow {
  __device__ Mat operator()(int p, int g, int u, int& row) const {
    const Weights& w = H().w;
    const int D = H().d.D, L = H().d.L, E = H().d.E;
    switch (p) {
      case kGctx: row = g * D + u; return transposed(w.gwi_ctx);
      case kGh: row = g * D + u; return transposed(w.gwh);
      case kL1h: row = g * L + u; return transposed(w.l1wh);
      case kL2h: row = g * L + u; return transposed(w.l2wh);
      case kL1i: row = g * L + u; return transposed(w.l1wi);
      case kL2i: row = g * L + u; return transposed(w.l2wi);
      case kQ: row = u; return transposed(w.wq);
      case kRia: row = u; return {w.wri.p + (size_t)E * w.wri.sr, w.wri.sc, w.wri.sr};
      default: row = u; return transposed(w.wri);
    }
  }
};

// This CTA's run of product p: its input is a stream the kernel writes
// (step s's rows, or the step before's for phase A), or x1 in the workspace.
__device__ Run make_run(int p) {
  const Plan& pl = H().pl;
  const Dims& d = H().d;
  const Outputs& out = H().out;
  float* ws = H().ws;
  const int B = d.B, D = d.D, L = d.L, E = d.E;
  Run rn;
  switch (p) {
    case kGctx: case kRic: rn.x = out.ctx; rn.x_step = (long long)B * E; rn.xs = E; break;
    case kGh: case kQ: case kRia: rn.x = out.ah; rn.x_step = (long long)B * D; rn.xs = D; break;
    case kL1h: rn.x = out.h1; rn.x_step = (long long)B * L; rn.xs = L; break;
    case kL2h: rn.x = out.h2; rn.x_step = (long long)B * L; rn.xs = L; break;
    case kL1i: rn.x = out.x0; rn.x_step = (long long)B * L; rn.xs = L; break;
    default: rn.x = ws + pl.ws[kWsX1]; rn.x_step = 0; rn.xs = al4(L); break;
  }
  const int cut = product_cut(p);
  const int per_cta = (pl.ws[kWsTotal] - pl.ws[kWsWl2]) / pl.ctas;
  shape_run(rn, gates_of(p), units_of(cut), pl.q[cut], reduction_of(p), pl.ks[p], pl.w_off[p],
            pl.out_off[p], H().nb_rows, pl.mode,
            ws + pl.ws[kWsWl2] + (size_t)blockIdx.x * per_cta);
  return rn;
}

__device__ __forceinline__ int run_product(int p, int s, int base) {
  return run_items<Header>(p, s, base);
}

__device__ __forceinline__ float psum(int p, int g, int j, int bl) {
  return sum_of<Header>(p, g, j, bl);
}

// Phase C of step s: u[b, t] = char_mask[b, t] · Σ_j v[j] · tanh(q[b, j] +
// enc_proj[b, t, j] + Σ_k cum[b, t + k - pad] · mloc[k, j]) for the CTA's
// pairs. The rows of its pairs are staged first: their cumulative scores
// before step s with a zero border, and their query. A thread owns column
// j (for D > kThreads, one block of columns after another, the pairs'
// sums added in order), its taps of mloc in registers; it takes kTile
// pairs of one row at once with the kWindow cumulative scores their windows
// span in registers. Each warp's lanes are summed per pair by the
// butterfly, the warps in order by the tile's first threads, through one of
// two halves of the partials' buffer (so that a tile needs one barrier of
// the CTA).
__device__ __noinline__ void energies(int s) {
  const Dims& d = H().d;
  const Plan& pl = H().pl;
  const int2 pr = units_of(kPair);
  if (pr.y <= 0) return;
  const int T = d.T, D = d.D, KS = d.KS, pad = (KS - 1) / 2, T4 = al4(T), D4 = al4(D);
  const int WC = al4(T + 2 * kMaxTaps), RS = pl.row_stride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int2 rows = pair_rows(pl, d, (int)blockIdx.x);
  const int r_lo = rows.x, nrows = rows.y;
  const float* ws = H().ws;
  const float* cum = ws + pl.ws[kWsCum];
  const float* qv = ws + pl.ws[kWsQ];
#pragma unroll 4
  for (int i = tid; i < nrows * RS; i += kThreads) {
    const int rr = i / RS, k = i % RS, b = r_lo + rr;
    const float* src = nullptr;
    if (k < WC) {
      const int t = k - pad;
      if (t >= 0 && t < T) src = cum + (size_t)b * T4 + t;
    } else if (k - WC < D) {
      src = qv + (size_t)b * D4 + k - WC;
    }
    S()[pl.rowbuf + i] = src ? __ldcg(src) : 0.0f;
  }
  __syncthreads();
  const int x5 = (int)(__brev((unsigned)lane) >> 27);
  const int sums = pl.wpart + 2 * kWarps * 32;
  int tile = 0;
  for (int jb = 0; jb < D; jb += kThreads) {
    const int j = jb + tid;
    const bool col = j < D;
    float m[kMaxTaps - 1];
#pragma unroll
    for (int k = 0; k < kMaxTaps - 1; ++k)
      m[k] = (col && k < KS) ? __ldg(H().w.mloc + (size_t)k * D + j) : 0.0f;
    const float vj = col ? __ldg(H().w.vv + j) : 0.0f;
    const float* ep = H().in.enc_proj + j;
    for (int pt = pr.x; pt < pr.x + pr.y; ++tile) {
      const int b = pt / T, t0 = pt % T;
      const int nt = min(kTile, min(pr.x + pr.y, (b + 1) * T) - pt);
      float e[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        e[i] = (col && i < nt) ? __ldg(ep + (size_t)(pt + i) * D) : 0.0f;
      const int row = pl.rowbuf + (b - r_lo) * RS;
      float c[kWindow];
#pragma unroll
      for (int x = 0; x < kWindow; ++x) c[x] = S()[row + t0 + x];
      float v[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxTaps - 1; ++k) acc = fmaf(c[i + k], m[k], acc);
        v[i] = acc;
      }
      const float qj = col ? S()[row + WC + j] : 0.0f;
#pragma unroll
      for (int i = 0; i < kTile; ++i) v[i] = (col && i < nt) ? vj * tanhf(qj + e[i] + v[i]) : 0.0f;
      rtvc::warp_transpose_sum<kTile>(v);
      const int half = pl.wpart + (tile & 1) * kWarps * 32;
      S()[half + warp * 32 + x5] = v[0];
      __syncthreads();
      if (tid < nt) {
        float acc = 0.0f;
        for (int w = 0; w < kWarps; ++w) acc += S()[half + w * 32 + tid];
        const int at = sums + pt - pr.x + tid;
        S()[at] = jb == 0 ? acc : S()[at] + acc;
      }
      pt += nt;
    }
  }
  __syncthreads();
  float* u = H().ws + pl.ws[kWsU];
  for (int i = tid; i < pr.y; i += kThreads) {
    const int p = pr.x + i;
    u[(size_t)(p / T) * T4 + p % T] = S()[sums + i] * __ldg(H().in.char_mask + p);
  }
}

// Phase D of step s: the softmax of each row of the CTA's pairs (the logits
// of every pair of the row, from the CTAs that own them), in every such CTA
// in the same order; the scores and the cumulative scores of its pairs; then
// its context items: ctx[b, e] = Σ_t scores[b, t] · enc_seq[b, t, e] for 128
// columns e of row b, item k of row b being the CTA's where it owns pair
// (b, k·T / nblk), a warp's lanes on 4 columns each (float4 where E allows),
// the warps on interleaved characters, the warps' sums added in order.
__device__ __noinline__ void attend(int s) {
  const Dims& d = H().d;
  const Plan& pl = H().pl;
  const int B = d.B, T = d.T, E = d.E, T4 = al4(T), RS = pl.row_stride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int2 pr = units_of(kPair);
  if (pr.y <= 0) return;
  const int lo = pr.x / T, nrows = (pr.x + pr.y - 1) / T - lo + 1;
  float* ws = H().ws;
  const float* u = ws + pl.ws[kWsU];
  for (int i = tid; i < nrows * T; i += kThreads)
    S()[pl.rowbuf + i / T * RS + i % T] = __ldcg(u + (size_t)(lo + i / T) * T4 + i % T);
  __syncthreads();
  for (int rr = warp; rr < nrows; rr += kWarps) {
    float* sr = S() + pl.rowbuf + rr * RS;
    float mx = -FLT_MAX;
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(sr[t] - mx);
      sr[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < T; t += 32) sr[t] = sr[t] / sum;
  }
  __syncthreads();
  float* cum = ws + pl.ws[kWsCum];
  for (int i = tid; i < pr.y; i += kThreads) {
    const int p = pr.x + i, b = p / T, t = p % T;
    const float sc = S()[pl.rowbuf + (b - lo) * RS + t];
    H().out.scores[(size_t)s * B * T + p] = sc;
    float* c = cum + (size_t)b * T4 + t;
    *c = __ldcg(c) + sc;
  }
  const int nblk = cdiv(E, kCtxCols);
  const bool vec = (E & 3) == 0 && aligned16(H().in.enc_seq);
  // where the attention memory outgrows the L2 (batch 112: 82.6 MB), enc_seq
  // is read as a stream (evict first), so that enc_proj, which phase C reads
  // every step, stays there
  const bool stream = H().stream;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4* part = reinterpret_cast<float4*>(S() + pl.wpart);
  for (int item = 0; item < nrows * nblk; ++item) {
    const int b = lo + item / nblk, k = item % nblk, e0 = k * kCtxCols;
    const int rep = b * T + k * T / nblk;
    if (rep < pr.x || rep >= pr.x + pr.y) continue;  // the same for every thread
    const int e = e0 + 4 * lane;
    const float* sr = S() + pl.rowbuf + (b - lo) * RS;
    const float* es = H().in.enc_seq + (size_t)b * T * E + e;
    float4 acc = zero;
    if (e < E) {
      for (int t0 = warp; t0 < T; t0 += kWarps * kCtxDepth) {
        float4 v[kCtxDepth];
#pragma unroll
        for (int k = 0; k < kCtxDepth; ++k) {
          const int t = t0 + k * kWarps;
          v[k] = zero;
          if (t < T) {
            const float* at = es + (size_t)t * E;
            if (vec)
              v[k] = stream ? __ldcs(reinterpret_cast<const float4*>(at))
                            : __ldg(reinterpret_cast<const float4*>(at));
            else
              v[k] = make_float4(__ldg(at), e + 1 < E ? __ldg(at + 1) : 0.0f,
                                 e + 2 < E ? __ldg(at + 2) : 0.0f,
                                 e + 3 < E ? __ldg(at + 3) : 0.0f);
          }
        }
#pragma unroll
        for (int k = 0; k < kCtxDepth; ++k) {
          const int t = t0 + k * kWarps;
          if (t < T) {
            const float sv = sr[t];
            acc.x = fmaf(sv, v[k].x, acc.x);
            acc.y = fmaf(sv, v[k].y, acc.y);
            acc.z = fmaf(sv, v[k].z, acc.z);
            acc.w = fmaf(sv, v[k].w, acc.w);
          }
        }
      }
    }
    part[tid] = acc;
    __syncthreads();
    if (tid < 32) {
      float4 a = part[tid];
      for (int w = 1; w < kWarps; ++w) {
        const float4 v = part[w * 32 + tid];
        a.x += v.x;
        a.y += v.y;
        a.z += v.z;
        a.w += v.w;
      }
      const int ec = e0 + 4 * tid;
      float* o = H().out.ctx + ((size_t)s * B + b) * E + ec;
      const float a4[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (ec + c < E) o[c] = a4[c];
    }
    __syncthreads();
  }
}

// One zoneout LSTM step for the CTA's units and its group's rows: the
// pre-activations from the input product pi, the kept W_hh·h product ph (none
// at step 0) and the bias; c and h in shared memory; the gates, c and h into
// their streams; x = x_in + h (x_in the CTA's own units, in shared memory)
// into x_out (row b at s·x_step + b·x_ld) and, where x_own is not negative,
// into shared memory there.
__device__ __noinline__ void lstm_fwd(int s, int pi, int ph, const float* bias, int c, int h,
                                      int x_in, int x_own, const float* zo, float* g_out,
                                      float* c_out, float* h_out, float* x_out,
                                      long long x_step, int x_ld) {
  const int2 un = units_of(kLstm);
  const Dims& d = H().d;
  const int B = d.B, L = d.L, nbr = H().nb_rows, b_lo = H().b_lo;
  const bool first = s == 0;
  for (int idx = threadIdx.x; idx < un.y * nbr; idx += kThreads) {
    const int j = idx % un.y, bl = idx / un.y, u = un.x + j, b = b_lo + bl, at = j * nbr + bl;
    const size_t sb = (size_t)s * B + b;
    float g[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      g[k] = (psum(pi, k, j, bl) + (first ? 0.0f : psum(ph, k, j, bl))) + __ldg(bias + k * L + u);
    const float i_g = sigmoidf_(g[0]), f_g = sigmoidf_(g[1]), g_g = tanhf(g[2]);
    const float o_g = sigmoidf_(g[3]);
    const float cn = f_g * S()[c + at] + i_g * g_g;
    const float z = zo[sb * L + u];
    const float hn = z * S()[h + at] + (1.0f - z) * (o_g * tanhf(cn));
    S()[c + at] = cn;
    S()[h + at] = hn;
    float* go = g_out + sb * 4 * L;
    go[u] = i_g;
    go[L + u] = f_g;
    go[2 * L + u] = g_g;
    go[3 * L + u] = o_g;
    c_out[sb * L + u] = cn;
    h_out[sb * L + u] = hn;
    const float x = S()[x_in + at] + hn;
    if (x_own >= 0) S()[x_own + at] = x;
    x_out[(size_t)s * x_step + (size_t)b * x_ld + u] = x;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
tacotron_train_fwd_kernel(Weights w_in, Inputs in_in, Outputs out_in, Dims d_in, Plan pl_in,
                          float* ws, int stream) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    H().stream = stream;
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
  const Weights& w = H().w;
  const int n = d.n, B = d.B, T = d.T, D = d.D, L = d.L;
  const int T4 = al4(T), D4 = al4(D), L4 = al4(L);
  const int nbr = H().nb_rows, b_lo = H().b_lo;
  unsigned int* sync = reinterpret_cast<unsigned int*>(ws);
  const unsigned int ctas = gridDim.x;
  unsigned int barriers = 0;
  const int2 att = units_of(kAtt), lstm = units_of(kLstm), pairs = units_of(kPair);
  float* cum = ws + pl.ws[kWsCum];

  // ---- the CTA's weight rows and zero state, once a launch ----
  for (int p = 0; p < kProducts; ++p) load_slice<Header>(p, UnitRow());
  for (int i = pl.ah + tid; i < pl.outs; i += kThreads) S()[i] = 0.0f;
  for (int i = tid; i < pairs.y; i += kThreads) {
    const int p = pairs.x + i;
    cum[(size_t)(p / T) * T4 + p % T] = 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < n; ++s) {
    const bool first = s == 0;
    const size_t sB = (size_t)s * B;
    // ---- A: the attention GRU over the context and attention hidden of the
    // step before; beside it both LSTMs' W_hh·h of the step before ----
    if (!first)
      run_product(kL2h, s - 1,
                  run_product(kL1h, s - 1, run_product(kGh, s - 1, run_product(kGctx, s - 1, 0))));
    __syncthreads();
    for (int idx = tid; idx < att.y * nbr; idx += kThreads) {
      const int j = idx % att.y, bl = idx / att.y, u = att.x + j, b = b_lo + bl;
      const size_t sb = sB + b;
      float xg[3], hg[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        xg[g] = in.xg_pre[sb * 3 * D + g * D + u] + (first ? 0.0f : psum(kGctx, g, j, bl));
        hg[g] = (first ? 0.0f : psum(kGh, g, j, bl)) + __ldg(w.gbh + g * D + u);
      }
      const float rg = sigmoidf_(xg[0] + hg[0]);
      const float zg = sigmoidf_(xg[1] + hg[1]);
      const float ng = tanhf(xg[2] + rg * hg[2]);
      const int own = pl.ah + j * nbr + bl;
      const float a = (1.0f - zg) * ng + zg * S()[own];
      S()[own] = a;
      out.ah[sb * D + u] = a;
      float* g4 = out.g4 + sb * 4 * D;
      g4[u] = rg;
      g4[D + u] = zg;
      g4[2 * D + u] = ng;
      g4[3 * D + u] = hg[2];
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- B: the query; beside it rnn_input's attention-hidden half ----
    run_product(kRia, s, run_product(kQ, s, 0));
    __syncthreads();
    for (int idx = tid; idx < att.y * nbr; idx += kThreads) {
      const int j = idx % att.y, bl = idx / att.y, u = att.x + j;
      ws[pl.ws[kWsQ] + (size_t)(b_lo + bl) * D4 + u] = psum(kQ, 0, j, bl) + __ldg(w.bq + u);
    }
    for (int idx = tid; idx < lstm.y * nbr; idx += kThreads) {
      const int j = idx % lstm.y, bl = idx / lstm.y;
      S()[pl.x0 + j * nbr + bl] = psum(kRia, 0, j, bl);
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- C: the energies of the CTA's pairs ----
    energies(s);
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- D: softmax, scores, cumulative scores, context ----
    attend(s);
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- E: rnn_input's context half, giving x0 ----
    run_product(kRic, s, 0);
    __syncthreads();
    for (int idx = tid; idx < lstm.y * nbr; idx += kThreads) {
      const int j = idx % lstm.y, bl = idx / lstm.y, u = lstm.x + j, at = j * nbr + bl;
      const float x = (psum(kRic, 0, j, bl) + S()[pl.x0 + at]) + __ldg(w.bri + u);
      S()[pl.x0 + at] = x;
      out.x0[(sB + b_lo + bl) * L + u] = x;
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- F: LSTM 1, giving h1 and x1 = x0 + h1 ----
    run_product(kL1i, s, 0);
    __syncthreads();
    lstm_fwd(s, kL1i, kL1h, w.l1b, pl.c1, pl.h1, pl.x0, pl.x1, in.zo1, out.gates1, out.c1,
             out.h1, ws + pl.ws[kWsX1], 0, L4);
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- G: LSTM 2, giving h2 and x_all = x1 + h2 ----
    run_product(kL2i, s, 0);
    __syncthreads();
    lstm_fwd(s, kL2i, kL2h, w.l2b, pl.c2, pl.h2, pl.x1, -1, in.zo2, out.gates2, out.c2, out.h2,
             out.x_all, (long long)B * L, L);
    rtvc::grid_barrier(sync, ctas * ++barriers);
  }

  for (int i = tid; i < pairs.y; i += kThreads) {
    const int p = pairs.x + i;
    out.cum_T[p] = __ldcg(cum + (size_t)(p / T) * T4 + p % T);
  }
}

bool plan_ok(const Plan& pl, const Dims& d) {
  if (!(pl.ctas >= 1 && pl.groups >= 1 && pl.ctas % pl.groups == 0 &&
        pl.mode >= kModeResident && pl.mode <= kModeL2 && pl.rows >= 1 &&
        (long long)pl.rows * pl.groups >= d.B && pl.ah >= kHeaderFloats &&
        pl.smem >= 4 * pl.end && d.KS % 2 == 1 && d.KS < kMaxTaps &&
        pl.row_stride >= al4(d.T + 2 * kMaxTaps) + al4(d.D) &&
        pl.wpart + 2 * kWarps * 32 + al4(pl.q[kPair]) <= pl.end &&
        pl.wpart + 4 * kThreads <= pl.end && pl.wpart % 4 == 0))
    return false;
  const long long slices = pl.ctas / pl.groups;
  for (int cut = 0; cut < kCuts; ++cut)
    if ((long long)pl.q[cut] * (cut == kPair ? pl.ctas : slices) < cut_size(d, cut)) return false;
  // every CTA's rows fit the staged rows
  for (int c = 0; c < pl.ctas; ++c)
    if (pair_rows(pl, d, c).y > pl.soft_rows) return false;
  return true;
}

}  // namespace fwd

// ---------------------------------------------------------------------------
// Backward: the reverse walk split over the card
// ---------------------------------------------------------------------------

namespace bwd {

constexpr int kPhases = 8;       // phases a step, each ended by a grid barrier
constexpr int kPairTile = 8;     // pairs the attention phase takes at once
constexpr int kStageSteps = 64;  // steps of scores the last phase stages at once
constexpr int kStageT = 32;      // characters an item of the last phase takes
constexpr int kAhead = 6;        // pairs the attention phase loads ahead
constexpr int kEnc = 8;          // float4 of an enc_seq row a lane loads at once (E <= 1024)

enum Cut { kLstm, kCtx, kAtt, kPair, kCuts };
enum Product { kQ, kGctx, kGh, kL2, kL1, kRic, kRia, kWq, kProducts };
enum Ws { kWsQ, kWsDhg, kWsU, kWsCum0, kWsCum1, kWsDcum, kWsSarr, kWsDqp, kWsDvp, kWsDmlp,
          kWsDctx, kWsWl2, kWsTotal, kWs };

// ops/tacotron_train.py:BwdPlan.ints, field for field.
struct Plan {
  int ctas, groups, mode, rows, smem;
  int q[kCuts];
  int ks[kProducts], w_off[kProducts], out_off[kProducts];
  int dh2, dc2, hold2, dh1, dc1, hold1, dx1, dctx, dah, outs, scratch, rowbuf, row_stride,
      soft_rows, wpart, end;
  int ws[kWs];
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

__device__ __forceinline__ Header& H() { return hdr<Header>(); }

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
struct UnitRow {
  __device__ Mat operator()(int p, int g, int u, int& row) const {
    const Weights& w = H().w;
    row = u;
    switch (p) {
      case kQ: return transposed(w.wq);
      case kGctx: return w.gwi_ctx;
      case kGh: return w.gwh;
      case kL2: return g == 0 ? w.l2wh : w.l2wi;
      case kL1: return g == 0 ? w.l1wh : w.l1wi;
      case kRic: return w.wri;
      case kRia: row = H().d.E + u; return w.wri;
      default: return w.wq;
    }
  }
};

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
  const int per_cta = (pl.ws[kWsTotal] - pl.ws[kWsWl2]) / pl.ctas;
  shape_run(rn, (p == kL2 || p == kL1) ? 2 : 1, units_of(cut), pl.q[cut], reduction_of(p),
            pl.ks[p], pl.w_off[p], pl.out_off[p], H().nb_rows, pl.mode,
            ws + pl.ws[kWsWl2] + (size_t)blockIdx.x * per_cta);
  return rn;
}

__device__ __forceinline__ int run_product(int p, int s, int base) {
  return run_items<Header>(p, s, base);
}

__device__ __forceinline__ float psum(int p, int g, int j, int bl) {
  return sum_of<Header>(p, g, j, bl);
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
  for (int p = 0; p < kProducts; ++p) load_slice<Header>(p, UnitRow());
  for (int i = pl.dh2 + tid; i < pl.outs; i += kThreads) S()[i] = 0.0f;
  for (int i = tid; i < pairs.y; i += kThreads) {
    const int p = pairs.x + i;
    ws[pl.ws[kWsDcum] + (size_t)(p / T) * T4 + p % T] = 0.0f;
  }
  for (int i = tid; i < D4; i += kThreads) ws[pl.ws[kWsDvp] + (size_t)blockIdx.x * D4 + i] = 0.0f;
  for (int i = tid; i < KS * D4; i += kThreads)
    ws[pl.ws[kWsDmlp] + (size_t)blockIdx.x * KS * D4 + i] = 0.0f;
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
}

bool plan_ok(const Plan& pl, const Dims& d) {
  return pl.ctas >= 1 && pl.groups >= 1 && pl.ctas % pl.groups == 0 &&
         pl.mode >= kModeResident && pl.mode <= kModeL2 && pl.rows >= 1 &&
         (long long)pl.rows * pl.groups >= d.B && pl.dh2 >= kHeaderFloats &&
         pl.smem >= 4 * pl.end && d.KS % 2 == 1 && d.KS < kMaxTaps &&
         pl.row_stride >= al4(d.E) &&
         pl.row_stride >= 3 * al4(d.T) + al4(d.T + d.KS - 1) + 2 * al4(d.D) &&
         (long long)pl.q[kPair] * pl.ctas >= (long long)d.B * d.T &&
         pl.wpart + kStageSteps * kStageT <= pl.end &&
         pl.wpart + kPairTile * kThreads <= pl.end;
}

}  // namespace bwd

}  // namespace

// weights: the eight matrices of TrainWeights as torch holds them, gwh (D, 3D),
// wq (D, D), wri (E+D, L), l1wi, l1wh, l2wi, l2wh (L, 4L), gwi_ctx (E, 3D),
// then gbh (3D), bq (D), mloc (KS, D), vv (D), bri (L), l1b, l2b (4L),
// contiguous; strides: each matrix's row and column strides in floats.
// inputs: xg_pre (n, B, 3D), zo1, zo2 (n, B, L), enc_seq (B, T, E), enc_proj
// (B, T, D), char_mask (B, T). outputs: x_all (n, B, L), ah (n, B, D), g4
// (n, B, 4D), x0, gates1 (n, B, 4L), c1, h1, gates2, c2, h2, scores (n, B, T),
// ctx (n, B, E), cum_T (B, T). plan: plan_len ints
// (ops/tacotron_train.py:FwdPlan.ints). work: the plan's ws[kWsTotal] floats,
// the barrier's counter (first word) zeroed. All f32. enc_seq is read as a
// stream where the attention memory outgrows the device's L2. Returns the
// launch's cudaError_t: cudaErrorInvalidValue for a plan that does not match,
// cudaErrorCooperativeLaunchTooLarge for a grid that does not fit the card.
extern "C" int rtvc_tacotron_train_fwd(const void* const* weights, const int* strides,
                                       const void* const* inputs, const void* const* outputs,
                                       const int* dims, const int* plan, int plan_len,
                                       void* work, void* stream) {
  fwd::Weights w;
  Mat* mats[] = {&w.gwh, &w.wq, &w.wri, &w.l1wi, &w.l1wh, &w.l2wi, &w.l2wh, &w.gwi_ctx};
  read_mats(weights, strides, mats);
  const float** vecs[] = {&w.gbh, &w.bq, &w.mloc, &w.vv, &w.bri, &w.l1b, &w.l2b};
  for (int i = 0; i < fwd::kVectors; ++i) *vecs[i] = static_cast<const float*>(weights[8 + i]);
  const Dims d = read_dims(dims);
  if (plan_len != (int)(sizeof(fwd::Plan) / sizeof(int))) return (int)cudaErrorInvalidValue;
  fwd::Plan pl;
  std::memcpy(&pl, plan, sizeof(fwd::Plan));
  if (!fwd::plan_ok(pl, d)) return (int)cudaErrorInvalidValue;
  int device = 0, l2 = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device);
  if (e != cudaSuccess) return (int)e;
  const int streamed = 4.0 * d.B * d.T * (d.E + d.D) > (double)l2;
  return launch(fwd::tacotron_train_fwd_kernel, pl.ctas, pl.smem, stream, w,
                from_pointers<fwd::Inputs>(inputs, fwd::kInputs),
                from_pointers<fwd::Outputs>(outputs, fwd::kOutputs), d, pl,
                static_cast<float*>(work), streamed);
}

// weights: the eight matrices as for the forward, then bq (D), mloc (KS, D),
// vv (D), contiguous; strides: each matrix's row and column strides in
// floats. inputs: the cotangents dx_all (n, B, L), dctx_all (n, B, E),
// dscores_all (n, B, T); the forward's ah, g4, gates1, c1, gates2, c2,
// scores, cum_T; zo1, zo2, enc_seq, enc_proj, char_mask. outputs: dxg4
// (n, B, 4D) = [dr, dz, dn, dn·r], dq (n, B, D), dx0 (n, B, L), dgates1,
// dgates2 (n, B, 4L), denc_seq (B, T, E), denc_proj (B, T, D). plan: plan_len
// ints (ops/tacotron_train.py:BwdPlan.ints). work: the plan's ws[kWsTotal]
// floats, the barrier's counter (first word) zeroed; dv and dmloc are left
// there as one partial per CTA. Returns the launch's cudaError_t, as the
// forward's entry does.
extern "C" int rtvc_tacotron_train_bwd(const void* const* weights, const int* strides,
                                       const void* const* inputs, const void* const* outputs,
                                       const int* dims, const int* plan, int plan_len,
                                       void* work, void* stream) {
  bwd::Weights w;
  Mat* mats[] = {&w.gwh, &w.wq, &w.wri, &w.l1wi, &w.l1wh, &w.l2wi, &w.l2wh, &w.gwi_ctx};
  read_mats(weights, strides, mats);
  w.bq = static_cast<const float*>(weights[8]);
  w.mloc = static_cast<const float*>(weights[9]);
  w.vv = static_cast<const float*>(weights[10]);
  const Dims d = read_dims(dims);
  if (plan_len != (int)(sizeof(bwd::Plan) / sizeof(int))) return (int)cudaErrorInvalidValue;
  bwd::Plan pl;
  std::memcpy(&pl, plan, sizeof(bwd::Plan));
  if (!bwd::plan_ok(pl, d)) return (int)cudaErrorInvalidValue;
  return launch(bwd::tacotron_train_bwd_kernel, pl.ctas, pl.smem, stream, w,
                from_pointers<bwd::Inputs>(inputs, bwd::kInputs),
                from_pointers<bwd::Outputs>(outputs, bwd::kOutputs), d, pl,
                static_cast<float*>(work));
}
