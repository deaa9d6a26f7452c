// Tacotron inference decoder loop, split over the card.
//
// Replaces: rtvc_tpu/ops/pallas/tacotron_kernel.py:decode_pallas (body
// _make_kernel :50, step :97, weights _prepare_weights :182, call :407), the
// autoregressive decoder of the synthesizer.
//
// What bounds it on the H100: an iteration runs the prenet (2 x 512 rows),
// the attention GRU (768 rows over 896 + 512 inputs, 768 over 256), the
// location-sensitive attention over the T characters, rnn_input (512 x 1152),
// two residual LSTMs (2 x 2048 x 1024) and the r mel rows plus the stop row:
// ≈ 6.5M weights, 26 MB in f32, for a batch of 1 to 24 texts, a few FLOP a
// byte. One CTA streaming them out of L2 took ≈ 0.7 ms an iteration at B 2
// and 21.6 ms at B 24. Spread over the card they fit in shared memory
// (219-229 KB a CTA over 132 CTAs at r 2, B 1-24), and an iteration is then
// bound by its chain of ten dependent phases, each ended by a grid barrier
// (≈ 1 µs and the wait for the slowest CTA), and by each phase's own chain:
// its inputs from L2, the lanes' sum, the elementwise part and its stores
// (PERF.md, section 6, gives the measured split by phase).
//
// Design: one cooperative launch of `ctas` CTAs, all resident, runs every
// iteration (ops/tacotron_decode.py:plan cuts the work and lays out the
// shared memory and the workspace; the kernel takes every offset from it).
// Each product of an iteration is cut along a unit axis (struct Plan, q and
// first): a CTA owns prenet rows, GRU units (the 3 gate rows of W_ih and of
// W_hh of each, so the GRU update runs where its gates were computed), query
// rows, rnn_input rows, LSTM units (4 gate rows of W_ih and W_hh, so the cell
// update and the residual stay in the CTA), mel channels (the r rows
// c·max_r + s) and the stop row, for all batch rows at once. A product is cut
// into items of kRowBlock rows x NB batch rows (x ks pieces of its reduction
// axis where that leaves warps idle), dealt out over the warps; the lanes
// run over the reduction axis, the inputs come from device memory through L2
// (__ldcg: other CTAs wrote them), and a transposing butterfly sums the lanes
// (common.cuh:warp_transpose_sum). The weight slices are gathered from the
// torch layout into shared memory once a launch (plan.resident), or read from
// L2 in place every iteration. The phases of an iteration:
//   A  prenet fc1; off the chain W_hh·ah and W_ih[:, :E]·context of the GRU
//      (they depend on the previous iteration only);
//   B  prenet fc2; off the chain the first LSTM's W_hh·h;
//   C  W_ih[:, E:]·prenet and the GRU update;
//   D  the query W·ah; off the chain rnn_input's W[:, E:]·ah and the second
//      LSTM's W_hh·h;
//   E  the scores v·tanh(query + enc_proj + location) x char mask of the
//      CTA's pairs;
//   F  the softmax of every batch row the CTA needs, computed in each such
//      CTA; the attention and the cumulative attention of its pairs, the
//      context columns it owns;
//   G  rnn_input over the context; off the chain the stop row's context part;
//   H, I  the two LSTMs with their residuals;
//   J  the r mel frames and the stop token; off the chain the location term
//      of the CTA's (row, character) pairs for the next iteration,
//      enc_proj + L·conv(cum), written to the workspace.
// After J's barrier every CTA reads the B stop values and takes the same
// decision: the loop ends in the iteration where every stop token exceeds
// 0.5 (after step 10, and not before iteration min_iters), with no host
// read-back, and the outputs past it are written as the pad value (mel) and
// zeros (attention, stops). Prenet dropout stays on unless disabled,
// Philox-4x32-10 noise keyed by (seed; group of 4, absolute iteration, batch
// row, layer) and a 24-bit threshold, so a mask does not depend on the plan
// or on how the iterations are cut into launches. No sum goes through an
// atomic: two runs give equal bits.
//
// A launch may resume a decode (the streaming clone's chunks): it then reads
// the decoder state from a carry (attention GRU hidden, both LSTMs' h and c,
// context, cumulative attention, previous frame; ops/tacotron_decode.py:
// DecoderCarry) in place of zeros, each CTA the units it owns, into shared
// memory (the cells and the GRU hidden) and the workspace, with one grid
// barrier before the first iteration; its iterations count from `start`, a
// `done` flag carried in makes it write only the pad, and after its last
// iteration (or at the stop) each CTA writes its units of the state back.
// The chunks of a decode, joined, give the bits of one launch.
#include <cfloat>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = rtvc::kRecThreads;
constexpr int kWarps = rtvc::kRecWarps;
constexpr int kRowBlock = 4;     // weight rows an item of a product takes
constexpr int kChunk = 128;      // floats of the reduction axis a warp covers at once
constexpr int kMaxFilters = 32;  // location filters a thread keeps in registers
constexpr int kPieces = 16;      // pieces a context output's sum over characters is cut into
constexpr int kNumWeights = 27;

enum Cut { kCutFc, kCutGru, kCutQuery, kCutRi, kCutLstm, kCutMel, kCutStop, kCutPair, kCutCtx,
           kCuts };
enum Product { kFc1, kFc2, kGruX, kGruH, kGruP, kQuery, kRiA, kRiC, kL1H, kL2H, kL1I, kL2I,
               kMel, kStopC, kStopX, kProducts };
enum Ws { kWsPrev, kWsPre1, kWsPre2, kWsCtx, kWsAh, kWsQ, kWsX0, kWsX1, kWsX2, kWsH1, kWsH2,
          kWsBase, kWsU, kWsCum, kWsStop, kWsLt, kWsTotal, kWs };

struct Weights {
  const float *pre_w1, *pre_b1, *pre_w2, *pre_b2;
  const float *gru_wih, *gru_bih, *gru_whh, *gru_bhh;
  const float *conv_w, *conv_b, *L_w, *W_w, *W_b, *v_w;
  const float *ri_w, *ri_b;
  const float *l1_wih, *l1_whh, *l1_bih, *l1_bhh;
  const float *l2_wih, *l2_whh, *l2_bih, *l2_bhh;
  const float *mel_w, *stop_w, *stop_b;
};

struct Dims {
  int B, T, E, D, L, P, M, max_r, r, max_iters, NF, KS, dropout, drop_thr, start, min_iters;
};

// The decoder state between two launches, each (B, width) contiguous in the
// order of ops/tacotron_decode.py:CARRY: attention hidden (D), the LSTMs'
// h1, c1, h2, c2 (L), context (E), cumulative attention (T), previous frame
// (M). Null pointers: a zero state (carry in) or none written (carry out).
struct Carry {
  const float *ah, *h1, *c1, *h2, *c2, *ctx, *cum, *prev;
};
struct CarryOut {
  float *ah, *h1, *c1, *h2, *c2, *ctx, *cum, *prev;
};

// ops/tacotron_decode.py:Plan.ints, field for field.
struct Plan {
  int ctas, nb, resident, smem;
  int q[kCuts], first[kCuts];
  int ks[kProducts], w_off[kProducts], out_off[kProducts];
  int c1, c2, v, conv_w, conv_b, soft, soft_rows, scratch, part, conv_buf, conv_pairs, bias,
      ah_own, x0_own, x1_own, qs, end;
  int ws[kWs];
};


// One product as this CTA runs it, worked out once a launch (make_run): its
// weight slice (in shared memory at w_sm, or in the torch layout at W), the
// floats from a gate's rows to the next gate's and from a row to the next,
// its input (batch row 0 of a workspace buffer, rows xs apart), the CTA's
// units (nu of q), gates G, row blocks, batch groups and ks pieces of
// `per` floats of its reduction length n, and its sums at `out` (rows G·q).
struct Run {
  const float* W;
  const float* x;
  int w_sm, gate_stride, ld, nu, q, G, blocks, groups, ks, per, n, xs, out, rows, vec;
};

// The launch's parameters and runs, at the start of shared memory: the
// phases index them at run time, which kernel parameters would serve from
// local memory.
struct Header {
  Weights w;
  Dims d;
  Plan pl;
  Run run[kProducts];
  float* ws;
};
constexpr int kHeaderFloats = 512;  // shared memory the plan leaves for the Header
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

// A product: its torch matrix at (row 0, its first column), the matrix's row
// stride, the rows between two gates and between two units, the gates a unit
// owns, the reduction length, the cut, and its input (B rows of stride xs in
// the workspace).
struct Desc {
  const float* W;
  int ld, gate_rows, unit_rows, G, n, cut;
  const float* x;
  int xs;
};

__device__ Desc describe(int p) {
  const Weights& w = H().w;
  const Dims& d = H().d;
  const int E = d.E, D = d.D, L = d.L, P = d.P, M = d.M;
  const int* o = H().pl.ws;
  float* ws = H().ws;
  switch (p) {
    case kFc1: return {w.pre_w1, M, 0, 1, 1, M, kCutFc, ws + o[kWsPrev], al4(M)};
    case kFc2: return {w.pre_w2, P, 0, 1, 1, P, kCutFc, ws + o[kWsPre1], al4(P)};
    case kGruX: return {w.gru_wih, E + P, D, 1, 3, E, kCutGru, ws + o[kWsCtx], al4(E)};
    case kGruH: return {w.gru_whh, D, D, 1, 3, D, kCutGru, ws + o[kWsAh], al4(D)};
    case kGruP: return {w.gru_wih + E, E + P, D, 1, 3, P, kCutGru, ws + o[kWsPre2], al4(P)};
    case kQuery: return {w.W_w, D, 0, 1, 1, D, kCutQuery, ws + o[kWsAh], al4(D)};
    case kRiA: return {w.ri_w + E, E + D, 0, 1, 1, D, kCutRi, ws + o[kWsAh], al4(D)};
    case kRiC: return {w.ri_w, E + D, 0, 1, 1, E, kCutRi, ws + o[kWsCtx], al4(E)};
    case kL1H: return {w.l1_whh, L, L, 1, 4, L, kCutLstm, ws + o[kWsH1], al4(L)};
    case kL2H: return {w.l2_whh, L, L, 1, 4, L, kCutLstm, ws + o[kWsH2], al4(L)};
    case kL1I: return {w.l1_wih, L, L, 1, 4, L, kCutLstm, ws + o[kWsX0], al4(L)};
    case kL2I: return {w.l2_wih, L, L, 1, 4, L, kCutLstm, ws + o[kWsX1], al4(L)};
    case kMel: return {w.mel_w, L, 1, d.max_r, d.r, L, kCutMel, ws + o[kWsX2], al4(L)};
    case kStopC: return {w.stop_w + L, L + E, 0, 1, 1, E, kCutStop, ws + o[kWsCtx], al4(E)};
    default: return {w.stop_w, L + E, 0, 1, 1, L, kCutStop, ws + o[kWsX2], al4(L)};
  }
}

__device__ int cut_size(int cut) {
  const Dims& d = H().d;
  switch (cut) {
    case kCutFc: return d.P;
    case kCutGru: case kCutQuery: return d.D;
    case kCutRi: case kCutLstm: return d.L;
    case kCutMel: return d.M;
    case kCutStop: return 1;
    case kCutPair: return d.B * d.T;
    default: return d.B * d.E;
  }
}

// The units [u0, u0 + nu) of a cut that this CTA owns (nu may be 0).
__device__ int2 units_of(int cut) {
  const Plan& pl = H().pl;
  const int q = pl.q[cut];
  const int u0 = ((int)blockIdx.x - pl.first[cut] + pl.ctas) % pl.ctas * q;
  return make_int2(u0, max(0, min(q, cut_size(cut) - u0)));
}

// This CTA's run of product p with NB batch rows an item.
__device__ Run make_run(int p, int NB) {
  const Plan& pl = H().pl;
  const Desc ds = describe(p);
  const int2 un = units_of(ds.cut);
  const int q = pl.q[ds.cut], B = H().d.B, ks = pl.ks[p];
  const int chunks = (ds.n + kChunk - 1) / kChunk;
  Run rn;
  rn.x = ds.x;
  rn.xs = ds.xs;
  rn.nu = un.y;
  rn.q = q;
  rn.G = ds.G;
  rn.blocks = (un.y + kRowBlock - 1) / kRowBlock;
  rn.groups = (B + NB - 1) / NB;
  rn.ks = ks;
  rn.per = (chunks + ks - 1) / ks * kChunk;
  rn.n = ds.n;
  rn.out = pl.out_off[p];
  rn.rows = ds.G * q;
  rn.w_sm = pl.w_off[p];
  if (rn.w_sm >= 0) {
    rn.W = nullptr;
    rn.ld = al4(ds.n);
    rn.gate_stride = q * rn.ld;
    rn.vec = 1;
  } else {
    rn.W = ds.W + (size_t)un.x * ds.unit_rows * ds.ld;
    rn.ld = ds.unit_rows * ds.ld;
    rn.gate_stride = ds.gate_rows * ds.ld;
    rn.vec = (ds.n & 3) == 0 && (ds.ld & 3) == 0 && aligned16(ds.W);
  }
  return rn;
}

// out[r * NB + b] = Σ_k W[r * ld + k] · in[b * xs + k] for r < R, b < NB (zero
// for b >= nb; rows r >= nr repeat row 0 and are not read), computed by one
// warp into padded(R * NB) floats of shared memory at `out`: W in shared
// memory at w_sm (RES) or in device memory, `in` in device memory, read
// through L2. `vec`: n and xs multiples of 4 (or zero-padded to them), W's
// rows and `in` 16-byte aligned (always so for RES).
template <int R, int NB, bool RES>
__device__ __forceinline__ void rows_product(const float* Wg, int w_sm, int ld, int nr, int n,
                                             const float* in, int xs, int nb, bool vec,
                                             int out) {
  constexpr int N = rtvc::padded(R * NB);
  const int lane = threadIdx.x & 31;
  const float* W = RES ? S() + w_sm : Wg;
  const float* row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) row[r] = W + (size_t)(r < nr ? r : 0) * ld;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  if (RES || vec) {
    // DEPTH pieces of 128 floats of every batch row's input in flight at
    // once: a product along 896 takes one L2 round trip at NB 2
    constexpr int DEPTH = NB >= 8 ? 2 : 16 / NB;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = lane * 4; k0 < n; k0 += DEPTH * kChunk) {
      float4 xv[DEPTH][NB];
#pragma unroll
      for (int s = 0; s < DEPTH; ++s)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          xv[s][b] = (b < nb && k0 + s * kChunk < n)
                         ? __ldcg(reinterpret_cast<const float4*>(in + b * xs + k0 + s * kChunk))
                         : zero;
#pragma unroll
      for (int s = 0; s < DEPTH; ++s) {
        if (k0 + s * kChunk < n) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 wv = *reinterpret_cast<const float4*>(row[r] + k0 + s * kChunk);
#pragma unroll
            for (int b = 0; b < NB; ++b)
              acc[r * NB + b] = rtvc::dot4(wv, xv[s][b], acc[r * NB + b]);
          }
        }
      }
    }
  } else {
    for (int k = lane; k < n; k += 32) {
      float v[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) v[b] = b < nb ? __ldcg(in + b * xs + k) : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float wv = row[r][k];
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[r * NB + b] = fmaf(wv, v[b], acc[r * NB + b]);
      }
    }
  }
  rtvc::warp_transpose_sum<N>(acc);
  const int x5 = (int)(__brev((unsigned)lane) >> 27);
#pragma unroll
  for (int m = 0; m < N / 32; ++m) S()[out + 32 * m + x5] = acc[m];
}

// Gathers this CTA's rows of product p into shared memory: row g·q + j of the
// slice (ld al4(n), zero past the matrix and past the CTA's units) is the
// matrix's row for gate g of unit u0 + j.
__device__ void load_slice(int p) {
  const int off = H().pl.w_off[p];
  if (off < 0) return;
  const Desc ds = describe(p);
  const int2 un = units_of(ds.cut);
  const int q = H().pl.q[ds.cut], ld4 = al4(ds.n);
  const int total = ds.G * q * ld4;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int row = i / ld4, k = i % ld4, g = row / q, j = row % q;
    float v = 0.0f;
    if (j < un.y && k < ds.n)
      v = ds.W[((size_t)g * ds.gate_rows + (size_t)(un.x + j) * ds.unit_rows) * ds.ld + k];
    S()[off + i] = v;
  }
}

// The helpers that run more than once an iteration (this one, and the
// prenet's, the LSTMs', the staging and the location term's) are not
// inlined: one copy of each keeps the code an iteration runs small, and
// instruction fetches are part of each phase's latency (PERF.md, section 6).
//
// Deals the items of product p out over the warps, continuing the rotation
// at item `base` (so that the products of a phase share the warps); each
// writes its sums to out[(piece · G·q + g·q + j) · B + b]. Returns the next
// base.
template <int NB>
__device__ __noinline__ int run_product(int p, int base) {
  const Run& rn = H().run[p];
  const int nu = rn.nu, B = H().d.B;
  if (nu <= 0) return base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ks = rn.ks, groups = rn.groups, blocks = rn.blocks;
  const int items = rn.G * blocks * groups * ks;
  const int scratch = H().pl.scratch + warp * 32;
  for (int it = ((warp - base) % kWarps + kWarps) % kWarps; it < items; it += kWarps) {
    int rem = it;
    const int split = rem % ks;
    rem /= ks;
    const int grp = rem % groups;
    rem /= groups;
    const int blk = rem % blocks, g = rem / blocks;
    const int j0 = blk * kRowBlock, nr = min(kRowBlock, nu - j0);
    const int k0 = split * rn.per, kn = max(0, min(rn.n - k0, rn.per));
    const int b0 = grp * NB, nb = min(NB, B - b0);
    const float* in = rn.x + (size_t)b0 * rn.xs + k0;
    const size_t w_at = (size_t)g * rn.gate_stride + (size_t)j0 * rn.ld + k0;
    if (rn.w_sm >= 0) {
      rows_product<kRowBlock, NB, true>(nullptr, rn.w_sm + (int)w_at, rn.ld, nr, al4(kn), in,
                                        rn.xs, nb, true, scratch);
    } else {
      const float* W = rn.W + w_at;
      const bool vec = rn.vec && (rn.xs & 3) == 0 && aligned16(W) && aligned16(in);
      rows_product<kRowBlock, NB, false>(W, 0, rn.ld, nr, kn, in, rn.xs, nb, vec, scratch);
    }
    __syncwarp();
    for (int i = lane; i < kRowBlock * NB; i += 32) {
      const int r = i / NB, b = i % NB;
      if (r < nr && b < nb)
        S()[rn.out + (split * rn.rows + g * rn.q + j0 + r) * B + b0 + b] = S()[scratch + i];
    }
    __syncwarp();
  }
  return base + items;
}

// Product p's sum for (gate g, unit j of the CTA, batch row b), its pieces
// added in order.
__device__ __forceinline__ float psum(int p, int g, int j, int b) {
  const Run& rn = H().run[p];
  const int B = H().d.B;
  const int at = rn.out + (g * rn.q + j) * B + b;
  float v = S()[at];
  for (int s = 1; s < rn.ks; ++s) v += S()[at + s * rn.rows * B];
  return v;
}

// Offsets of the CTA's biases in shared memory (after plan.bias): the same
// arithmetic as ops/tacotron_decode.py:_bias_floats.
struct Biases {
  int fc1, fc2, gru_ih, gru_hh, query, ri, l1_ih, l1_hh, l2_ih, l2_hh, stop, total;
};

__host__ __device__ inline Biases bias_layout(const Plan& pl) {
  Biases b;
  int o = pl.bias;
  auto seg = [&](int n) {
    const int at = o;
    o += al4(n);
    return at;
  };
  const int qf = pl.q[kCutFc], qg = pl.q[kCutGru], ql = pl.q[kCutLstm];
  b.fc1 = seg(qf);
  b.fc2 = seg(qf);
  b.gru_ih = seg(3 * qg);
  b.gru_hh = seg(3 * qg);
  b.query = seg(pl.q[kCutQuery]);
  b.ri = seg(pl.q[kCutRi]);
  b.l1_ih = seg(4 * ql);
  b.l1_hh = seg(4 * ql);
  b.l2_ih = seg(4 * ql);
  b.l2_hh = seg(4 * ql);
  b.stop = seg(1);
  b.total = o - pl.bias;
  return b;
}

// S()[dst + g·q + j] = src[g·gate + u0 + j] for the CTA's units of a cut
// (zero past them), G gates.
__device__ void load_bias(int dst, const float* src, int cut, int G, int gate) {
  const int2 un = units_of(cut);
  const int q = H().pl.q[cut];
  for (int i = threadIdx.x; i < G * q; i += kThreads) {
    const int g = i / q, j = i % q;
    S()[dst + i] = j < un.y ? src[g * gate + un.x + j] : 0.0f;
  }
}

// relu(product + bias), then the always-on dropout → dst[b * al4(P) + row].
__device__ __noinline__ void prenet_out(int p, int bias, float* dst, int layer, int it,
                                        uint2 key) {
  const int2 un = units_of(kCutFc);
  const Dims& d = H().d;
  const int B = d.B, P4 = al4(d.P);
  const float scale = 1.0f / (1.0f - (float)d.drop_thr * (1.0f / 16777216.0f));
  for (int idx = threadIdx.x; idx < un.y * B; idx += kThreads) {
    const int j = idx % un.y, b = idx / un.y, u = un.x + j;
    float v = fmaxf(psum(p, 0, j, b) + S()[bias + j], 0.0f);
    if (d.dropout) {
      const uint4 rnd = rtvc::philox4x32(
          make_uint4((uint32_t)(u / 4), (uint32_t)it, (uint32_t)b, (uint32_t)layer), key);
      const int i = u % 4;
      const uint32_t bits = i == 0 ? rnd.x : i == 1 ? rnd.y : i == 2 ? rnd.z : rnd.w;
      v = (bits >> 8) >= (uint32_t)d.drop_thr ? v * scale : 0.0f;
    }
    dst[(size_t)b * P4 + u] = v;
  }
}

// Copies rows [b_lo, b_lo + n_rows) of a (B, ld) workspace buffer, n floats
// a row, into shared memory at dst (row stride ld), all loads in flight at
// once.
__device__ __noinline__ void stage_rows(int dst, const float* src, int b_lo, int n_rows, int n,
                                        int ld) {
  for (int i = threadIdx.x; i < n_rows * n; i += kThreads) {
    const int row = i / n, k = i % n;
    S()[dst + row * ld + k] = __ldcg(src + (size_t)(b_lo + row) * ld + k);
  }
}

// base[p, :] = enc_proj[p, :] + L · conv(cum)[p] for the CTA's (row,
// character) pairs p = b·T + t: the 31-tap convolution over the cumulative
// attention (its rows staged at `cum_s` from row b_lo on), then the filters
// → D projection, one thread a column j (its row of L in registers, read
// from the transposed copy `lt` so that a warp's loads are coalesced),
// conv_pairs pairs at a time (their filters in phase F's buffer for the
// context's pieces, which is free outside F).
__device__ __noinline__ void location(const float* __restrict__ enc_proj, int cum_s, int b_lo) {
  const Dims& d = H().d;
  const Plan& pl = H().pl;
  const int2 un = units_of(kCutPair);
  const int T = d.T, NF = d.NF, KS = d.KS, pad = (d.KS - 1) / 2, D4 = al4(d.D), T4 = al4(T);
  float* base = H().ws + pl.ws[kWsBase];
  const float* lt = H().ws + pl.ws[kWsLt];
  const int conv = pl.conv_buf;
  const float4* conv4 = reinterpret_cast<const float4*>(S() + conv);
  for (int p0 = 0; p0 < un.y; p0 += pl.conv_pairs) {
    const int np = min(pl.conv_pairs, un.y - p0);
    for (int idx = threadIdx.x; idx < np * kMaxFilters; idx += kThreads) {
      const int pi = idx / kMaxFilters, f = idx % kMaxFilters;
      const int pr = un.x + p0 + pi, b = pr / T, t = pr % T;
      const int cum = cum_s + (b - b_lo) * T4;
      float acc = 0.0f;
      if (f < NF) {
        acc = S()[pl.conv_b + f];
        for (int k = max(0, pad - t); k < min(KS, T + pad - t); ++k)
          acc += S()[pl.conv_w + f * KS + k] * S()[cum + t + k - pad];
      }
      S()[conv + idx] = acc;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < d.D; j += kThreads) {
      float lr[kMaxFilters];
#pragma unroll
      for (int f = 0; f < kMaxFilters; ++f) lr[f] = f < NF ? __ldcg(lt + f * d.D + j) : 0.0f;
      for (int pi0 = 0; pi0 < np; pi0 += 16) {
        const size_t pr0 = (size_t)un.x + p0 + pi0;
        float ep[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          ep[i] = pi0 + i < np ? __ldg(enc_proj + (pr0 + i) * d.D + j) : 0.0f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (pi0 + i < np) {
            float acc = 0.0f;
#pragma unroll
            for (int f4 = 0; f4 < kMaxFilters / 4; ++f4) {
              const float4 cv = conv4[(pi0 + i) * (kMaxFilters / 4) + f4];
              acc = fmaf(lr[4 * f4], cv.x, acc);
              acc = fmaf(lr[4 * f4 + 1], cv.y, acc);
              acc = fmaf(lr[4 * f4 + 2], cv.z, acc);
              acc = fmaf(lr[4 * f4 + 3], cv.w, acc);
            }
            base[(pr0 + i) * D4 + j] = ep[i] + acc;
          }
        }
      }
    }
    __syncthreads();
  }
}

// The stop rule of absolute iteration `at`, whose B stop values are in
// stop_buf: every stop token past 0.5, after step 10 and not before
// min_iters. Every CTA reads the same values and takes the same decision.
__device__ __forceinline__ bool stop_fired(const float* stop_buf, int at) {
  const Dims& d = H().d;
  int fired = 1;
  for (int b = threadIdx.x; b < d.B; b += kThreads) fired &= __ldcg(stop_buf + b) > 0.5f;
  return __syncthreads_and(fired) && at * d.r > 10 && at >= d.min_iters;
}

// The LSTM of the CTA's units: gates from the input product pi and the state
// product ph with both biases, c in shared memory, h → h_buf, and the residual
// x_out = x_in + h (x_in the CTA's own units, in shared memory; x_out also
// kept there at x_own when that is not negative).
__device__ __noinline__ void lstm_update(int pi, int ph, int bih, int bhh, int c_off,
                                         float* h_buf, int x_in, float* x_out, int x_own) {
  const int2 un = units_of(kCutLstm);
  const int B = H().d.B, L4 = al4(H().d.L), q = H().pl.q[kCutLstm];
  for (int idx = threadIdx.x; idx < un.y * B; idx += kThreads) {
    const int j = idx % un.y, b = idx / un.y, u = un.x + j;
    float g[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      g[k] = psum(pi, k, j, b) + psum(ph, k, j, b) + S()[bih + k * q + j] +
             S()[bhh + k * q + j];
    const int cs = c_off + j * B + b;
    const float cn = rtvc::sigmoidf_(g[1]) * S()[cs] + rtvc::sigmoidf_(g[0]) * tanhf(g[2]);
    const float h = rtvc::sigmoidf_(g[3]) * tanhf(cn);
    S()[cs] = cn;
    h_buf[(size_t)b * L4 + u] = h;
    const float x = S()[x_in + j * B + b] + h;
    x_out[(size_t)b * L4 + u] = x;
    if (x_own >= 0) S()[x_own + j * B + b] = x;
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(Weights w_in, Dims d_in, Plan pl_in, uint2 key, const float* __restrict__ enc_seq,
              const float* __restrict__ enc_proj, const float* __restrict__ char_mask,
              float* __restrict__ mel, float* __restrict__ attn, float* __restrict__ stops,
              float* ws, Carry cin, CarryOut cout, const int* __restrict__ done_in,
              int* __restrict__ flags, float pad) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    H().w = w_in;
    H().d = d_in;
    H().pl = pl_in;
    H().ws = ws;
  }
  __syncthreads();
  if (tid < kProducts) H().run[tid] = make_run(tid, NB);
  const Weights& w = H().w;
  const Dims& d = H().d;
  const Plan& pl = H().pl;
  const int B = d.B, T = d.T, E = d.E, D = d.D, M = d.M, r = d.r;
  const int T4 = al4(T), D4 = al4(D), E4 = al4(E), L4 = al4(d.L), M4 = al4(M);
  unsigned int* sync = reinterpret_cast<unsigned int*>(ws);
  const unsigned int ctas = gridDim.x;
  unsigned int barriers = 0;
  float* ah = ws + pl.ws[kWsAh];
  float* qv = ws + pl.ws[kWsQ];
  float* ctx = ws + pl.ws[kWsCtx];
  float* u_buf = ws + pl.ws[kWsU];
  float* cum = ws + pl.ws[kWsCum];
  float* stop_buf = ws + pl.ws[kWsStop];
  const float* base_buf = ws + pl.ws[kWsBase];
  const Biases bo = bias_layout(pl);
  const int soft = pl.soft;

  // ---- the CTA's weights, biases and constants, once a launch ----
  for (int p = 0; p < kProducts; ++p) load_slice(p);
  load_bias(bo.fc1, w.pre_b1, kCutFc, 1, 0);
  load_bias(bo.fc2, w.pre_b2, kCutFc, 1, 0);
  load_bias(bo.gru_ih, w.gru_bih, kCutGru, 3, D);
  load_bias(bo.gru_hh, w.gru_bhh, kCutGru, 3, D);
  load_bias(bo.query, w.W_b, kCutQuery, 1, 0);
  load_bias(bo.ri, w.ri_b, kCutRi, 1, 0);
  load_bias(bo.l1_ih, w.l1_bih, kCutLstm, 4, d.L);
  load_bias(bo.l1_hh, w.l1_bhh, kCutLstm, 4, d.L);
  load_bias(bo.l2_ih, w.l2_bih, kCutLstm, 4, d.L);
  load_bias(bo.l2_hh, w.l2_bhh, kCutLstm, 4, d.L);
  if (tid == 0) S()[bo.stop] = w.stop_b[0];
  for (int i = tid; i < D; i += kThreads) S()[pl.v + i] = w.v_w[i];
  for (int i = tid; i < d.NF * d.KS; i += kThreads) S()[pl.conv_w + i] = w.conv_w[i];
  for (int i = tid; i < d.NF; i += kThreads) S()[pl.conv_b + i] = w.conv_b[i];
  for (int i = tid; i < pl.q[kCutLstm] * B; i += kThreads) {
    S()[pl.c1 + i] = 0.0f;
    S()[pl.c2 + i] = 0.0f;
  }
  for (int i = tid; i < pl.q[kCutGru] * B; i += kThreads) S()[pl.ah_own + i] = 0.0f;
  // L transposed, (NF, D): every CTA writes the same values, and reads only
  // after its own writes
  for (int i = tid; i < d.NF * D; i += kThreads)
    ws[pl.ws[kWsLt] + i] = w.L_w[(i % D) * d.NF + i / D];
  __syncthreads();

  const int2 pairs = units_of(kCutPair);
  const int2 outs = units_of(kCutCtx);
  const int2 gru_u = units_of(kCutGru), lstm_u = units_of(kCutLstm), mel_u = units_of(kCutMel);
  float* h1_buf = ws + pl.ws[kWsH1];
  float* h2_buf = ws + pl.ws[kWsH2];
  float* prev_buf = ws + pl.ws[kWsPrev];
  if (cin.ah) {
    // the carried state, each CTA its own units, visible to the others after
    // the barrier (on a counter of its own: the phases' barriers count from 0)
    for (int idx = tid; idx < gru_u.y * B; idx += kThreads) {
      const int j = idx % gru_u.y, b = idx / gru_u.y, u = gru_u.x + j;
      const float v = cin.ah[(size_t)b * D + u];
      S()[pl.ah_own + j * B + b] = v;
      ah[(size_t)b * D4 + u] = v;
    }
    for (int idx = tid; idx < lstm_u.y * B; idx += kThreads) {
      const int j = idx % lstm_u.y, b = idx / lstm_u.y, u = lstm_u.x + j;
      const size_t at = (size_t)b * d.L + u;
      S()[pl.c1 + j * B + b] = cin.c1[at];
      S()[pl.c2 + j * B + b] = cin.c2[at];
      h1_buf[(size_t)b * L4 + u] = cin.h1[at];
      h2_buf[(size_t)b * L4 + u] = cin.h2[at];
    }
    for (int i = tid; i < outs.y; i += kThreads) {
      const int o = outs.x + i;
      ctx[(size_t)(o / E) * E4 + o % E] = cin.ctx[o];
    }
    for (int i = tid; i < pairs.y; i += kThreads) {
      const int pr = pairs.x + i;
      cum[(size_t)(pr / T) * T4 + pr % T] = cin.cum[pr];
    }
    for (int idx = tid; idx < mel_u.y * B; idx += kThreads) {
      const int j = idx % mel_u.y, b = idx / mel_u.y, ch = mel_u.x + j;
      prev_buf[(size_t)b * M4 + ch] = cin.prev[(size_t)b * M + ch];
    }
    rtvc::grid_barrier(sync + 1, ctas);
  }
  // the batch rows whose softmax this CTA needs: the hull of its pairs' and
  // its context outputs' rows
  int b_lo = B, b_hi = -1, p_lo = 0, p_rows = 0;
  if (pairs.y > 0) {
    b_lo = p_lo = pairs.x / T;
    b_hi = (pairs.x + pairs.y - 1) / T;
    p_rows = b_hi - p_lo + 1;
  }
  if (outs.y > 0) {
    b_lo = min(b_lo, outs.x / E);
    b_hi = max(b_hi, (outs.x + outs.y - 1) / E);
  }
  const int n_rows = b_hi - b_lo + 1;  // at most pl.soft_rows
  // the first iteration's location term (the cumulative attention is zero)
  stage_rows(soft, cum, p_lo, p_rows, T, T4);
  __syncthreads();
  location(enc_proj, soft, p_lo);

  // a launch after the stop runs no iteration and writes only the pad
  const bool was_done = done_in && *done_in != 0;
  int n_iters = d.max_iters;
  for (int it = 0; it < d.max_iters && !was_done; ++it) {
    // ---- A: the stop rule, prenet fc1, the GRU's off-chain products ----
    if (it > 0 && stop_fired(stop_buf, d.start + it - 1)) {
      n_iters = it;
      break;  // every CTA reads the same stop values: the same decision
    }
    run_product<NB>(kGruH, run_product<NB>(kGruX, run_product<NB>(kFc1, 0)));
    __syncthreads();
    prenet_out(kFc1, bo.fc1, ws + pl.ws[kWsPre1], 0, d.start + it, key);
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- B: prenet fc2; off the chain the first LSTM's W_hh·h ----
    run_product<NB>(kL1H, run_product<NB>(kFc2, 0));
    __syncthreads();
    prenet_out(kFc2, bo.fc2, ws + pl.ws[kWsPre2], 1, d.start + it, key);
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- C: the attention GRU over [context | prenet] ----
    run_product<NB>(kGruP, 0);
    __syncthreads();
    {
      const int2 un = units_of(kCutGru);
      const int q = pl.q[kCutGru];
      for (int idx = tid; idx < un.y * B; idx += kThreads) {
        const int j = idx % un.y, b = idx / un.y, u = un.x + j;
        float xg[3], hg[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          xg[g] = psum(kGruP, g, j, b) + psum(kGruX, g, j, b) + S()[bo.gru_ih + g * q + j];
          hg[g] = psum(kGruH, g, j, b) + S()[bo.gru_hh + g * q + j];
        }
        const float rg = rtvc::sigmoidf_(xg[0] + hg[0]);
        const float zg = rtvc::sigmoidf_(xg[1] + hg[1]);
        const float ng = tanhf(xg[2] + rg * hg[2]);
        const int own = pl.ah_own + j * B + b;
        const float h = (1.0f - zg) * ng + zg * S()[own];
        S()[own] = h;
        ah[(size_t)b * D4 + u] = h;
      }
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- D: the query; off the chain rnn_input's attention-hidden part and
    // the second LSTM's W_hh·h ----
    run_product<NB>(kL2H, run_product<NB>(kRiA, run_product<NB>(kQuery, 0)));
    __syncthreads();
    {
      const int2 un = units_of(kCutQuery);
      for (int idx = tid; idx < un.y * B; idx += kThreads) {
        const int j = idx % un.y, b = idx / un.y, u = un.x + j;
        qv[(size_t)b * D4 + u] = psum(kQuery, 0, j, b) + S()[bo.query + j];
      }
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- E: u[b, t] = v · tanh(q + enc_proj[t] + location[t]) x char mask ----
    stage_rows(pl.qs, qv, p_lo, p_rows, D, D4);
    __syncthreads();
    for (int pi = warp; pi < pairs.y; pi += kWarps) {
      const int pr = pairs.x + pi, b = pr / T, t = pr % T;
      const int qb = pl.qs + (b - p_lo) * D4;
      const float* eb = base_buf + (size_t)pr * D4;
      float acc = 0.0f;
      for (int j0 = 0; j0 < D; j0 += 256) {
        float e8[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = j0 + lane + 32 * i;
          e8[i] = j < D ? __ldcg(eb + j) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = j0 + lane + 32 * i;
          if (j < D) acc += S()[pl.v + j] * tanhf(S()[qb + j] + e8[i]);
        }
      }
      acc = rtvc::warp_sum(acc);
      if (lane == 0) u_buf[(size_t)b * T4 + t] = acc * __ldg(char_mask + pr);
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- F: softmax, attention, cumulative attention, context ----
    stage_rows(soft, u_buf, b_lo, n_rows, T, T4);
    __syncthreads();
    for (int row = warp; row < n_rows; row += kWarps) {
      float* s = S() + soft + row * T4;
      float mx = -FLT_MAX;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, s[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.0f;
      for (int t = lane; t < T; t += 32) {
        const float e = expf(s[t] - mx);
        s[t] = e;
        sum += e;
      }
      sum = rtvc::warp_sum(sum);
      for (int t = lane; t < T; t += 32) s[t] = s[t] / sum;
    }
    __syncthreads();
    for (int pi = tid; pi < pairs.y; pi += kThreads) {
      const int pr = pairs.x + pi, b = pr / T, t = pr % T;
      const float s = S()[soft + (b - b_lo) * T4 + t];
      attn[((size_t)b * d.max_iters + it) * T + t] = s;
      cum[(size_t)b * T4 + t] = __ldcg(cum + (size_t)b * T4 + t) + s;
    }
    {
      // the CTA's context outputs in groups of 4 columns (plan.q[kCutCtx] is
      // a multiple of 4; E too where the groups take float4 loads), each
      // summed over the characters in `ts` interleaved pieces, four loads in
      // flight, then the pieces added in order
      const bool vec = (E & 3) == 0;
      const int groups = (outs.y + 3) / 4;
      float4* part = reinterpret_cast<float4*>(S() + pl.part);
      for (int g0 = 0; g0 < groups; g0 += kThreads) {
        const int n = min(kThreads, groups - g0), ts = min(kPieces, kThreads / n);
        if (tid < n * ts) {
          const int gi = tid % n, piece = tid / n, o = outs.x + 4 * (g0 + gi);
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
          if (vec) {
            const int b = o / E, e = o % E;
            const float* s = S() + soft + (b - b_lo) * T4;
            const float4* es = reinterpret_cast<const float4*>(enc_seq + (size_t)b * T * E + e);
            const int E_4 = E / 4;
            int t = piece;
            for (; t + 3 * ts < T; t += 4 * ts) {
              float4 v[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) v[i] = __ldg(es + (size_t)(t + i * ts) * E_4);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float sv = s[t + i * ts];
                acc.x += sv * v[i].x;
                acc.y += sv * v[i].y;
                acc.z += sv * v[i].z;
                acc.w += sv * v[i].w;
              }
            }
            for (; t < T; t += ts) {
              const float4 v = __ldg(es + (size_t)t * E_4);
              const float sv = s[t];
              acc.x += sv * v.x;
              acc.y += sv * v.y;
              acc.z += sv * v.z;
              acc.w += sv * v.w;
            }
          } else {
            float a4[4] = {0.f, 0.f, 0.f, 0.f};
            for (int i = 0; i < 4 && o + i < outs.x + outs.y; ++i) {
              const int b = (o + i) / E, e = (o + i) % E;
              const float* s = S() + soft + (b - b_lo) * T4;
              const float* es = enc_seq + (size_t)b * T * E + e;
              for (int t = piece; t < T; t += ts) a4[i] += s[t] * __ldg(es + (size_t)t * E);
            }
            acc = make_float4(a4[0], a4[1], a4[2], a4[3]);
          }
          part[tid] = acc;
        }
        __syncthreads();
        if (tid < n) {
          float4 acc = part[tid];
          for (int piece = 1; piece < ts; ++piece) {
            const float4 v = part[piece * n + tid];
            acc.x += v.x;
            acc.y += v.y;
            acc.z += v.z;
            acc.w += v.w;
          }
          const float a4[4] = {acc.x, acc.y, acc.z, acc.w};
          const int o = outs.x + 4 * (g0 + tid);
          for (int i = 0; i < 4 && o + i < outs.x + outs.y; ++i)
            ctx[(size_t)((o + i) / E) * E4 + (o + i) % E] = a4[i];
        }
        __syncthreads();
      }
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- G: rnn_input over [context | attention hidden]; the stop row's
    // context part ----
    run_product<NB>(kStopC, run_product<NB>(kRiC, 0));
    __syncthreads();
    {
      const int2 un = units_of(kCutRi);
      float* x0 = ws + pl.ws[kWsX0];
      for (int idx = tid; idx < un.y * B; idx += kThreads) {
        const int j = idx % un.y, b = idx / un.y, u = un.x + j;
        const float x = psum(kRiC, 0, j, b) + psum(kRiA, 0, j, b) + S()[bo.ri + j];
        x0[(size_t)b * L4 + u] = x;
        S()[pl.x0_own + j * B + b] = x;
      }
    }
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- H, I: the two residual LSTMs (their units are the CTA's rnn_input
    // rows, so the residual's input is in shared memory) ----
    run_product<NB>(kL1I, 0);
    __syncthreads();
    lstm_update(kL1I, kL1H, bo.l1_ih, bo.l1_hh, pl.c1, ws + pl.ws[kWsH1], pl.x0_own,
                ws + pl.ws[kWsX1], pl.x1_own);
    rtvc::grid_barrier(sync, ctas * ++barriers);
    run_product<NB>(kL2I, 0);
    __syncthreads();
    lstm_update(kL2I, kL2H, bo.l2_ih, bo.l2_hh, pl.c2, ws + pl.ws[kWsH2], pl.x1_own,
                ws + pl.ws[kWsX2], -1);
    rtvc::grid_barrier(sync, ctas * ++barriers);

    // ---- J: the r mel frames (rows c·max_r + s) and the stop token; off the
    // chain the next iteration's location term ----
    stage_rows(soft, cum, p_lo, p_rows, T, T4);
    run_product<NB>(kStopX, run_product<NB>(kMel, 0));
    __syncthreads();
    {
      const int2 un = mel_u;
      float* prev = prev_buf;
      for (int idx = tid; idx < un.y * r * B; idx += kThreads) {
        const int j = idx % un.y, s = idx / un.y % r, b = idx / (un.y * r), ch = un.x + j;
        const float v = psum(kMel, s, j, b);
        mel[((size_t)b * M + ch) * ((size_t)d.max_iters * r) + (size_t)it * r + s] = v;
        if (s == r - 1) prev[(size_t)b * M4 + ch] = v;
      }
      if (units_of(kCutStop).y > 0) {
        for (int b = tid; b < B; b += kThreads) {
          const float v = rtvc::sigmoidf_(psum(kStopX, 0, 0, b) + psum(kStopC, 0, 0, b) +
                                          S()[bo.stop]);
          stop_buf[b] = v;
          stops[(size_t)b * d.max_iters + it] = v;
        }
      }
    }
    location(enc_proj, soft, p_lo);
    rtvc::grid_barrier(sync, ctas * ++barriers);
  }
  // the last iteration's stop, which a resumed decode carries on
  const bool done = was_done || n_iters < d.max_iters ||
                    (d.max_iters > 0 && stop_fired(stop_buf, d.start + d.max_iters - 1));
  if (was_done) n_iters = 0;

  // Past the stop: the pad (zeros for a whole decode, as the reference's
  // while_loop leaves them).
  const int rest = d.max_iters - n_iters;
  if (rest > 0) {
    const size_t g0 = (size_t)blockIdx.x * kThreads + tid, stride = (size_t)ctas * kThreads;
    const size_t cols = (size_t)rest * r, wide = (size_t)d.max_iters * r;
    for (size_t i = g0; i < (size_t)B * M * cols; i += stride)
      mel[i / cols * wide + (size_t)n_iters * r + i % cols] = pad;
    for (size_t i = g0; i < (size_t)B * rest * T; i += stride) {
      const size_t b = i / ((size_t)rest * T), k = i % ((size_t)rest * T);
      attn[(b * d.max_iters + n_iters) * T + k] = 0.0f;
    }
    for (size_t i = g0; i < (size_t)B * rest; i += stride)
      stops[i / rest * d.max_iters + n_iters + i % rest] = 0.0f;
  }

  // The state after the last iteration run, each CTA its own units (its own
  // writes, visible to the CTA after the barrier's __syncthreads).
  if (cout.ah) {
    __syncthreads();
    for (int idx = tid; idx < gru_u.y * B; idx += kThreads) {
      const int j = idx % gru_u.y, b = idx / gru_u.y;
      cout.ah[(size_t)b * D + gru_u.x + j] = S()[pl.ah_own + j * B + b];
    }
    for (int idx = tid; idx < lstm_u.y * B; idx += kThreads) {
      const int j = idx % lstm_u.y, b = idx / lstm_u.y, u = lstm_u.x + j;
      const size_t at = (size_t)b * d.L + u;
      cout.c1[at] = S()[pl.c1 + j * B + b];
      cout.c2[at] = S()[pl.c2 + j * B + b];
      cout.h1[at] = __ldcg(h1_buf + (size_t)b * L4 + u);
      cout.h2[at] = __ldcg(h2_buf + (size_t)b * L4 + u);
    }
    for (int i = tid; i < outs.y; i += kThreads) {
      const int o = outs.x + i;
      cout.ctx[o] = __ldcg(ctx + (size_t)(o / E) * E4 + o % E);
    }
    for (int i = tid; i < pairs.y; i += kThreads) {
      const int pr = pairs.x + i;
      cout.cum[pr] = __ldcg(cum + (size_t)(pr / T) * T4 + pr % T);
    }
    for (int idx = tid; idx < mel_u.y * B; idx += kThreads) {
      const int j = idx % mel_u.y, b = idx / mel_u.y, ch = mel_u.x + j;
      cout.prev[(size_t)b * M + ch] = __ldcg(prev_buf + (size_t)b * M4 + ch);
    }
  }
  if (flags && blockIdx.x == 0 && tid == 0) {
    flags[0] = done ? 1 : 0;
    flags[1] = n_iters;
  }
}

const void* kernel_for(int nb) {
  if (nb == 2) return (const void*)decode_kernel<2>;
  if (nb == 4) return (const void*)decode_kernel<4>;
  if (nb == 8) return (const void*)decode_kernel<8>;
  return nullptr;
}

}  // namespace

// weights: kNumWeights device pointers in the order of struct Weights, torch
// layout, contiguous. dims: dims_len ints B, T, E, D, L, P, M, max_r, r,
// max_iters (this launch's iterations), NF, KS, dropout, drop_thr, start (the
// absolute iteration of the first), min_iters. plan: plan_len ints
// (ops/tacotron_decode.py:Plan.ints). enc_seq (B, T, E), enc_proj (B, T, D),
// char_mask (B, T) → mel (B, M, max_iters·r), attn (B, max_iters, T), stops
// (B, max_iters). work: the plan's ws[kWsTotal] zeroed floats, the grid
// barriers' counters first. carry_in, carry_out: 8 pointers each in the
// order of struct Carry, or null (a zero state; no state written). done_in:
// one int, or null; flags (or null) ← done, iterations run before the stop.
// pad: the mel past the stop. Returns the launch's cudaError_t:
// cudaErrorInvalidValue for dims or a plan that do not match,
// cudaErrorCooperativeLaunchTooLarge for a grid that does not fit the card.
extern "C" int rtvc_tacotron_decode(const void* const* weights, const int* dims, int dims_len,
                                    const int* plan, int plan_len, unsigned long long seed,
                                    const float* enc_seq, const float* enc_proj,
                                    const float* char_mask, float* mel, float* attn,
                                    float* stops, float* work, const void* const* carry_in,
                                    void* const* carry_out, const int* done_in, int* flags,
                                    float pad, void* stream) {
  Weights w;
  const float** wp = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < kNumWeights; ++i) wp[i] = static_cast<const float*>(weights[i]);
  if (dims_len != (int)(sizeof(Dims) / sizeof(int))) return (int)cudaErrorInvalidValue;
  Dims d;
  std::memcpy(&d, dims, sizeof(Dims));
  Carry cin{};
  CarryOut cout{};
  if (carry_in) std::memcpy(&cin, carry_in, sizeof(Carry));
  if (carry_out) std::memcpy(&cout, carry_out, sizeof(CarryOut));
  if (plan_len != (int)(sizeof(Plan) / sizeof(int))) return (int)cudaErrorInvalidValue;
  Plan pl;
  std::memcpy(&pl, plan, sizeof(Plan));
  const void* kernel = kernel_for(pl.nb);
  if (!kernel || pl.ctas < 1 || d.B < 1 || d.T < 1 || d.r < 1 || d.r > d.max_r ||
      d.NF > kMaxFilters || pl.v < kHeaderFloats || pl.smem < 4 * pl.end || d.start < 0 ||
      pl.q[kCutCtx] % 4 != 0 || pl.q[kCutRi] != pl.q[kCutLstm] ||
      pl.first[kCutRi] != pl.first[kCutLstm] ||
      bias_layout(pl).total > pl.ah_own - pl.bias)
    return (int)cudaErrorInvalidValue;
  const uint2 key = make_uint2((uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32));
  void* args[] = {&w, &d, &pl, const_cast<uint2*>(&key), &enc_seq, &enc_proj, &char_mask,
                  &mel, &attn, &stops, &work, &cin, &cout, &done_in, &flags, &pad};
  const int err = rtvc::launch_cooperative(kernel, pl.ctas, pl.smem, args,
                                           static_cast<cudaStream_t>(stream));
  if (err != 0) cudaGetLastError();  // a refused launch must not fail the next one's check
  return err;
}
