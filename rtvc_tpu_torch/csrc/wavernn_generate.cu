// WaveRNN autoregressive sample loop: the fatchord, geneing and runtimeracer
// variants, each with the categorical (RAW / BITS), mixture-of-logistics
// (MOL) or two-parameter beta (geneing RAW) sampling head, with every layer's
// weights resident in shared memory across the card.
//
// Replaces: rtvc_tpu/ops/pallas/wavernn_kernel.py:generate_core_pallas
// (body _make_kernel :67, call :506), the whole per-sample loop of the vocoder.
//
// What bounds it on the H100: a step is a chain of dependent matrix-vector
// products, one to four GRUs (W_ih and W_hh of 3R x R each) and two to five
// FCs, for every fold: 2.1M weights (8.4 MB in f32) for runtimeracer (R = F =
// 256), 4.2M (16.8 MB) for fatchord (R = F = 512), 0.56M (2.2 MB) for geneing
// (R = 256, F = 128). One CTA per fold, as the first version had it, re-read
// them from L2 every step, ≈ 125 µs a step whatever the fold count, on 13 of
// the 132 SMs for a 5 s clone. Spread over the card the weights fit in shared
// memory (runtimeracer ≈ 106 KB a CTA, fatchord ≈ 180 KB, geneing ≈ 30 KB,
// the padding and the phase buffers included). On an H100 at 700 W (PERF.md,
// section 6) runtimeracer then takes 26.8 µs a step at 6 folds, 28.7 at 13,
// 44.4 at 39, 98.8 at 169 and 145 at 264. CTA 0's cycles by phase (clock64)
// say what bounds it: at 6-13 folds the chain, the waits at the nine grid
// barriers a third of the step and each layer's product, elementwise part
// and stores ≈ 2 µs of latency; from ≈ 40 folds on the products, two thirds
// of the step at 169 folds (the GRUs' 46 %, the FCs' 23 %), since every CTA
// runs every fold of its rows: an item takes a warp ≈ 4000 cycles, of which
// the round trips for its inputs from L2 are ≈ 15 % (84 against 99 µs a
// step at 169 folds with the loads taken out). The inputs' bytes are not
// what bounds it: copying each layer's inputs once a cluster into a ring in
// shared memory (TMA multicast) was slower at every fold count, 237 against
// 152 µs at 169 folds, its copies' round trips exposed one a tile.
//
// Design: one cooperative launch of `ctas` CTAs, all resident, runs every
// step. A CTA owns U hidden units of every GRU (the 3U rows of W_ih, or of
// the state's columns `_wx`, and of W_hh that make their r, z, n gates) and a
// slice of the rows of every FC, loaded into shared memory with their biases
// once a launch (ops/wavernn_generate.py:plan cuts them). The layer list is a
// runtime table in the kernel's parameters (struct Layers). All folds ride in
// every CTA: a layer's product is cut into items of kRowBlock weight rows x NB
// folds, an FC's of its CTA's rows rounded up to 2, 4 or kRowBlock (runtimeracer's
// take 2: items of 8 were three quarters padding), each item on one warp
// (common.cuh:slice_product: lanes over the reduction axis, the fold vectors
// read from L2 one piece ahead, a transposing butterfly for the lanes' sums),
// dealt out over the warps; the layer's elementwise part then writes the
// CTA's slice of the layer's output to device memory, and a grid barrier
// makes it whole for the next layer. Activations alternate between two (B, W)
// buffers, the GRU states between two (B, R) buffers a layer by the step's
// parity, so no layer overwrites what a slower CTA may still read.
// The first GRU reads the conditioning stream i_cond directly: its input
// x = i_cond + prev·i_col gives x·W_ihᵀ = i_cond·W_ihᵀ + prev·(W_ih·i_col),
// and W_ih·i_col is computed once a launch. The head:
// - categorical (C up to 1024): each CTA adds the Gumbel noise of its own
//   classes, Philox-4x32-10 keyed by (class / 4, step, fold, 0) with the
//   seed's key, so a draw does not depend on the launch shape, takes a local
//   argmax per fold (ties to the lower index) and writes (value, index);
//   after the barrier every CTA reduces the partials to the same sample:
//   warp w the partials of a slice of the CTAs, a lane a fold, so that one
//   load reads 32 folds' and a slice's loads are in flight together, then a
//   thread a fold over the warps' maxima (a warp a fold, one round trip for
//   each 32 CTAs, took a third of the step at 169 folds);
// - MOL (30 columns) and beta (2 columns): the last FC's rows go to device
//   memory, and after the barrier every CTA runs the head for every fold, a
//   warp (MOL) or a thread (beta) a fold, with the arithmetic of the plain
//   version: expf / logf and explicitly rounded multiplies and adds, so the
//   sample that is fed back agrees with it where the head's inputs do.
// Each CTA keeps every fold's previous sample in shared memory; CTA 0 writes
// the samples out. `argmax` turns the noise off (greedy decode); `logits_out`
// (a test hook) receives the head's inputs at each step.
//
// Types (the vocoder's generation options, inference/vocoder.py:
// set_generation_options): the weights, biases and i_col in Tw, the
// conditioning streams in Ts, each f32 or bf16, the four (compute_dtype,
// stream_dtype) pairs of the JAX kernel (wavernn_kernel.py:317-330). A bf16
// weight takes two bytes of shared memory (so more folds fit the phase
// buffer beside them), a bf16 stream entry two bytes of device memory; both
// are widened where they are read, and every product and elementwise part
// runs in f32. As in the JAX kernel's body (:103-296), Tw is also the type
// of the carried GRU states, which are rounded to it where they are written
// (h_scr, :133: the buffer s.h holds the rounded values, which every CTA's
// next step reads), while the residual x + h adds the new state before that
// rounding (:141-142); and of the fed-back sample, rounded before it
// multiplies i_col in the next step (prev_scr, :295). The samples written
// out, the head's inputs and the sampler stay f32. The f32/f32
// instantiation is the kernel as it was before the others came.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = rtvc::kRecThreads;
constexpr int kWarps = rtvc::kRecWarps;
constexpr int kMaxRnn = 4;
constexpr int kMaxFc = 5;
constexpr int kRowBlock = 8;  // weight rows an item of a layer's product takes
constexpr int kHeadLoads = 16;  // partials a lane of the categorical head loads at once

enum Head { kCategorical = 0, kMol = 1, kBeta = 2 };

using rtvc::bf16;
using rtvc::to_f;

// The step's layers: weights in Tw, streams in Ts. A GRU with a conditioning
// stream has rnn_aux set and rnn_bih null (b_ih is folded into the stream),
// and its rnn_wih holds only the state's columns; likewise fc_aux / fc_b /
// fc_w. FC k maps (k == 0 ? R : F) inputs to (k == n_fc - 1 ? C : F) outputs.
template <typename Tw, typename Ts>
struct Layers {
  const Tw* i_col;
  const Tw* rnn_wih[kMaxRnn];
  const Tw* rnn_bih[kMaxRnn];
  const Tw* rnn_whh[kMaxRnn];
  const Tw* rnn_bhh[kMaxRnn];
  const Tw* fc_w[kMaxFc];
  const Tw* fc_b[kMaxFc];
  const Ts* i_cond;
  const Ts* rnn_aux[kMaxRnn];
  const Ts* fc_aux[kMaxFc];
  int n_rnn, n_fc;
  int fc_relu[kMaxFc];
};

// Widths, head and the plan (ops/wavernn_generate.py:plan): `units` of every
// GRU, `fc_rows` of every FC but the last and `last_rows` of the last a CTA,
// `fb` folds a block of the phase buffer, `nb` folds an item.
struct Dims {
  int B, T, R, F, C, head, argmax;
  int ctas, units, fc_rows, last_rows, fb, nb, smem;
};

// Device scratch of a launch: the GRU states (n_rnn x 2 x B x R, by the
// step's parity), the activations (2 x B x W), the last FC's outputs (B x C,
// MOL and beta), the categorical partials (ctas x B values and indices) and
// the barrier counter, all zeroed by the caller.
struct Scratch {
  float* h;
  float* act;
  float* logits;
  float* part_val;
  int* part_idx;
  unsigned int* sync;
};

__host__ __device__ constexpr int al4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int blocks_of(int n) {
  return (n + kRowBlock - 1) / kRowBlock * kRowBlock;
}

// A CTA's shared memory: first the weight region, `elem` (sizeof(Tw)) bytes
// an entry, which holds every layer's weight rows and biases and the i_col
// units (offsets in entries), rounded up to 16 bytes; then the f32 region
// (offsets in floats from its start): the first GRU's W_ih·i_col rows, the
// warps' sums, the phase buffer, the categorical partials, the previous
// samples. The same arithmetic as ops/wavernn_generate.py:_smem_bytes.
struct Layout {
  int g_rows;                // rows a GRU weight block keeps (3U, padded)
  int wih[kMaxRnn], whh[kMaxRnn], bih[kMaxRnn], bhh[kMaxRnn];
  int col;                   // i_col's units
  int fc_w[kMaxFc], fc_b[kMaxFc];
  int wbytes;                // bytes of the weight region
  int v;                     // the first GRU's W_ih·i_col rows
  int scratch, phase, phase_rows, red, prev;
  int total;                 // bytes in all
};

__host__ __device__ inline Layout layout(const Dims& d, int n_rnn, int n_fc, int elem) {
  Layout l{};
  const int ldR = al4(d.R), ldF = al4(d.F);
  l.g_rows = blocks_of(3 * d.units);
  int o = 0;
  for (int k = 0; k < n_rnn; ++k) {
    l.wih[k] = o;
    o += l.g_rows * ldR;
    l.whh[k] = o;
    o += l.g_rows * ldR;
    l.bih[k] = o;
    o += al4(3 * d.units);
    l.bhh[k] = o;
    o += al4(3 * d.units);
  }
  l.col = o;
  o += al4(d.units);
  int widest = 0;
  for (int k = 0; k < n_fc; ++k) {
    const int q = k == n_fc - 1 ? d.last_rows : d.fc_rows;
    widest = q > widest ? q : widest;
    l.fc_w[k] = o;
    o += blocks_of(q) * (k == 0 ? ldR : ldF);
    l.fc_b[k] = o;
    o += al4(q);
  }
  l.wbytes = (o * elem + 15) / 16 * 16;
  o = 0;
  l.v = o;
  o += al4(3 * d.units);
  l.scratch = o;
  o += kWarps * rtvc::padded(kRowBlock * d.nb);
  l.phase_rows = 2 * l.g_rows > blocks_of(widest) ? 2 * l.g_rows : blocks_of(widest);
  l.phase = o;
  o += l.phase_rows * d.fb;
  l.red = o;
  if (d.head == kCategorical) o += al4(2 * (d.last_rows / 4) * d.fb);
  l.prev = o;
  o += al4(d.B);
  l.total = l.wbytes + o * (int)sizeof(float);
  return l;
}

// A GRU (unit, fold) pair's inputs besides the product: the conditioning
// stream's three gate entries (zero without a stream), the unit's state and
// its input (the first GRU's conditioning entry, before prev · i_col).
struct GruIn {
  float aux[3], h, x;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float pick(uint4 r, int i) {
  return rtvc::u01(i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w);
}

// (v, i) ← the larger value, the lower index on a tie, across the warp.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// One Gamma(a, 1) draw from seven uniforms (Marsaglia and Tsang 2000):
// Box-Muller normals, two unrolled tries of the squeeze test with the
// fallback d after a double reject (below 0.25 % of draws), and the a < 1
// boost G(a) = G(a + 1)·U^(1/a). The arithmetic of
// rtvc_tpu/ops/pallas/wavernn_kernel.py:228-253.
__device__ float gamma_draw(float a, const float* u) {
  const float ab = a < 1.0f ? a + 1.0f : a;
  const float d = ab - 1.0f / 3.0f;
  const float c = 1.0f / sqrtf(9.0f * d);
  float g = d;
  bool done = false;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float x = sqrtf(-2.0f * logf(u[3 * k])) * cosf(6.283185307179586f * u[3 * k + 1]);
    const float w = 1.0f + c * x;
    const float v = w * w * w;
    const bool ok = v > 0.0f && logf(u[3 * k + 2]) <
                                    0.5f * x * x + d - d * v + d * logf(fmaxf(v, 1e-30f));
    if (ok && !done) {
      g = d * v;
      done = true;
    }
  }
  g = fmaxf(g, 1e-12f);
  return a < 1.0f ? g * powf(u[6], 1.0f / fmaxf(a, 1e-6f)) : g;
}

// Copies `rows` rows of a (.., n) weight matrix into shared memory as
// blocks_of(rows) rows of ld entries, zero past the matrix; row r of the
// block is the matrix's row `row_of(r)` (or zero where that is negative).
template <typename T, typename RowOf>
__device__ void load_rows(T* dst, const T* src, int rows, int n, int ld, RowOf row_of) {
  const int total = blocks_of(rows) * ld;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / ld, k = i % ld;
    const int row = r < rows ? row_of(r) : -1;
    dst[i] = (row >= 0 && k < n) ? src[(size_t)row * n + k] : rtvc::from_f<T>(0.0f);
  }
}

// Whether `slice_product` may read x (of type T, row stride xs, n long) four
// entries at a time.
template <typename T>
__device__ __forceinline__ bool vec_ok(const T* x, size_t xs, int n) {
  return (n & 3) == 0 && (xs & 3) == 0 &&
         (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(T) - 1)) == 0;
}

// P[r * fb + b] = Σ_k W[r * ld + k] · x[b * xs + k] for the first `rows`
// rows of one or two weight blocks (zero past the layer's rows, to a
// multiple of kRowBlock) and the `nf` folds of a fold block: items of RB
// rows x NB folds, dealt out over the warps (RB kRowBlock for the GRUs; for
// an FC, fc_product's rows a CTA rounded up to 2, 4 or kRowBlock). The
// second block (W2 over x2, stride xs2) lands in rows [rows, 2 rows) of P.
// x is f32 (the activations) or a bf16 stream (the first GRU's i_cond), x2
// always f32 (the GRU state).
template <int NB, int RB, typename Tw, typename Tx>
__device__ void layer_product(const Tw* W, const Tx* x, size_t xs, const Tw* W2,
                              const float* x2, size_t xs2, int rows, int ld, int n, int nf,
                              int fb, float* P, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (rows + RB - 1) / RB, groups = (nf + NB - 1) / NB;
  const int mats = W2 ? 2 : 1;
  for (int item = warp; item < mats * chunks * groups; item += kWarps) {
    const int mat = item / (chunks * groups), rest = item % (chunks * groups);
    const int chunk = rest / groups, g = rest % groups;
    const int nb = min(NB, nf - g * NB);
    const Tw* w = (mat ? W2 : W) + chunk * RB * ld;
    if constexpr (std::is_same<Tx, float>::value) {
      const float* in = mat ? x2 : x;
      const size_t stride = mat ? xs2 : xs;
      rtvc::slice_product<RB, NB>(w, ld, n, in + (size_t)g * NB * stride, stride, nb,
                                  vec_ok(in, stride, n), scratch);
    } else if (mat) {
      rtvc::slice_product<RB, NB>(w, ld, n, x2 + (size_t)g * NB * xs2, xs2, nb,
                                  vec_ok(x2, xs2, n), scratch);
    } else {
      rtvc::slice_product<RB, NB>(w, ld, n, x + (size_t)g * NB * xs, xs, nb, vec_ok(x, xs, n),
                                  scratch);
    }
    __syncwarp();
    for (int i = lane; i < RB * NB; i += 32) {
      const int r = i / NB, b = i % NB;
      if (b < nb) P[(mat * rows + chunk * RB + r) * fb + g * NB + b] = scratch[i];
    }
    __syncwarp();
  }
}

// An FC's product (layer_product without a second block): items of its
// CTA's `q` rows rounded up to 2, 4 or kRowBlock, so that they are not mostly
// padding (runtimeracer's FCs but the last take 2 rows a CTA).
template <int NB, typename Tw>
__device__ void fc_product(const Tw* W, const float* x, size_t xs, int q, int ld, int n, int nf,
                           int fb, float* P, float* scratch) {
  const Tw* none = nullptr;
  if (q <= 2)
    layer_product<NB, 2>(W, x, xs, none, nullptr, 0, q, ld, n, nf, fb, P, scratch);
  else if (q <= 4)
    layer_product<NB, 4>(W, x, xs, none, nullptr, 0, q, ld, n, nf, fb, P, scratch);
  else
    layer_product<NB, kRowBlock>(W, x, xs, none, nullptr, 0, q, ld, n, nf, fb, P, scratch);
}

template <int HEAD, int NB, typename Tw, typename Ts>
__global__ void __launch_bounds__(kThreads, 1)
wavernn_kernel(Layers<Tw, Ts> L, Dims d, Scratch s, uint2 key, float* __restrict__ out,
               float* __restrict__ logits_out) {
  extern __shared__ float4 smem4[];
  const int n_rnn = L.n_rnn, n_fc = L.n_fc;
  const Layout lay = layout(d, n_rnn, n_fc, (int)sizeof(Tw));
  Tw* smw = reinterpret_cast<Tw*>(smem4);
  float* sm = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + lay.wbytes);
  const int B = d.B, T = d.T, R = d.R, F = d.F, C = d.C, U = d.units, FB = d.fb;
  const int ldR = al4(R), ldF = al4(F), W = al4(R > F ? R : F);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cta = blockIdx.x;
  float* P = sm + lay.phase;
  float* scratch = sm + lay.scratch + warp * rtvc::padded(kRowBlock * NB);
  float* prev = sm + lay.prev;

  // ---- the CTA's weights, once a launch ----
  const int u0 = cta * U, nu = max(0, min(U, R - u0));
  const Tw zero = rtvc::from_f<Tw>(0.0f);
  for (int k = 0; k < n_rnn; ++k) {
    auto row_of = [&](int r) { return r % U < nu ? (r / U) * R + u0 + r % U : -1; };
    load_rows(smw + lay.wih[k], L.rnn_wih[k], 3 * U, R, ldR, row_of);
    load_rows(smw + lay.whh[k], L.rnn_whh[k], 3 * U, R, ldR, row_of);
    for (int r = tid; r < 3 * U; r += kThreads) {
      const int row = row_of(r);
      smw[lay.bih[k] + r] = (row >= 0 && L.rnn_bih[k]) ? L.rnn_bih[k][row] : zero;
      smw[lay.bhh[k] + r] = row >= 0 ? L.rnn_bhh[k][row] : zero;
    }
  }
  for (int j = tid; j < U; j += kThreads) smw[lay.col + j] = j < nu ? L.i_col[u0 + j] : zero;
  int fc_r0[kMaxFc], fc_nr[kMaxFc];
  for (int k = 0; k < n_fc; ++k) {
    const bool last = k == n_fc - 1;
    const int q = last ? d.last_rows : d.fc_rows, rows = last ? C : F;
    const int n_in = k == 0 ? R : F;
    fc_r0[k] = cta * q;
    fc_nr[k] = max(0, min(q, rows - fc_r0[k]));
    const int r0 = fc_r0[k], nr = fc_nr[k];
    load_rows(smw + lay.fc_w[k], L.fc_w[k], q, n_in, k == 0 ? ldR : ldF,
              [&](int r) { return r < nr ? r0 + r : -1; });
    for (int r = tid; r < q; r += kThreads)
      smw[lay.fc_b[k] + r] = (r < nr && L.fc_b[k]) ? L.fc_b[k][r0 + r] : zero;
  }
  for (int b = tid; b < B; b += kThreads) prev[b] = 0.0f;
  __syncthreads();
  // the first GRU's W_ih · i_col, for its input's prev · i_col term
  for (int r = tid; r < 3 * U; r += kThreads) {
    float acc = 0.0f;
    for (int k = 0; k < R; ++k)
      acc = fmaf(to_f(smw[lay.wih[0] + r * ldR + k]), to_f(L.i_col[k]), acc);
    sm[lay.v + r] = acc;
  }
  __syncthreads();

  unsigned int barriers = 0;
  const unsigned int ctas = (unsigned int)gridDim.x;
  // the last FC's CTAs: the categorical partials to reduce
  const int n_last = (C + d.last_rows - 1) / d.last_rows;

  for (int t = 0; t < T; ++t) {
    int phase = 0;
    // ---- the GRUs: h_k ← GRU(x, h_k), x ← x + h_k ----
    for (int k = 0; k < n_rnn; ++k, ++phase) {
      // the states as the last step rounded them to Tw (f32 storage)
      const float* h_read = s.h + ((size_t)(2 * k + ((t + 1) & 1)) * B) * R;
      float* h_write = s.h + ((size_t)(2 * k + (t & 1)) * B) * R;
      const float* act_in = s.act + (size_t)((phase + 1) & 1) * B * W;
      const Ts* cond = L.i_cond + (size_t)t * R;
      const size_t xs = k == 0 ? (size_t)T * R : (size_t)W;
      float* x_out = s.act + (size_t)(phase & 1) * B * W;
      const Ts* aux = L.rnn_aux[k];
      const Tw* wih = smw + lay.wih[k];
      const Tw* whh = smw + lay.whh[k];
      const Tw* bih = smw + lay.bih[k];
      const Tw* bhh = smw + lay.bhh[k];
      if (nu > 0) {
        for (int f0 = 0; f0 < B; f0 += FB) {
          const int nf = min(FB, B - f0), pairs = nu * nf;
          // a (unit, fold) pair's inputs besides the product: its stream
          // entries, its state and its input; the first pair of each thread
          // is loaded before the product, so that its latency hides there
          auto load_in = [&](int i) {
            const int j = i % nu, fold = f0 + i / nu, u = u0 + j;
            const size_t ft = (size_t)fold * T + t;
            GruIn in;
#pragma unroll
            for (int g = 0; g < 3; ++g)
              in.aux[g] = aux ? to_f(aux[ft * 3 * R + g * R + u]) : 0.0f;
            in.h = __ldcg(h_read + (size_t)fold * R + u);
            in.x = k == 0 ? to_f(L.i_cond[ft * R + u]) : __ldcg(act_in + (size_t)fold * W + u);
            return in;
          };
          GruIn first{};
          if (tid < pairs) first = load_in(tid);
          const float* hf = h_read + (size_t)f0 * R;
          if constexpr (std::is_same<Ts, float>::value) {
            const float* x_in = k == 0 ? cond : act_in;
            layer_product<NB, kRowBlock>(wih, x_in + (size_t)f0 * xs, xs, whh, hf, R,
                                         lay.g_rows, ldR, R, nf, FB, P, scratch);
          } else if (k == 0) {
            layer_product<NB, kRowBlock>(wih, cond + (size_t)f0 * xs, xs, whh, hf, R,
                                         lay.g_rows, ldR, R, nf, FB, P, scratch);
          } else {
            layer_product<NB, kRowBlock>(wih, act_in + (size_t)f0 * xs, xs, whh, hf, R,
                                         lay.g_rows, ldR, R, nf, FB, P, scratch);
          }
          __syncthreads();
          for (int i = tid; i < pairs; i += kThreads) {
            const GruIn in = i == tid ? first : load_in(i);
            const int j = i % nu, b = i / nu, fold = f0 + b, u = u0 + j;
            const float p = prev[fold];
            float xg[3], hg[3];
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              const int r = g * U + j;
              float v = P[r * FB + b];
              if (k == 0) v += p * sm[lay.v + r];
              xg[g] = v + (aux ? in.aux[g] : to_f(bih[r]));
              hg[g] = P[(lay.g_rows + r) * FB + b] + to_f(bhh[r]);
            }
            const float r_ = rtvc::sigmoidf_(xg[0] + hg[0]);
            const float z = rtvc::sigmoidf_(xg[1] + hg[1]);
            const float n = tanhf(xg[2] + r_ * hg[2]);
            const float hn = (1.0f - z) * n + z * in.h;
            h_write[(size_t)fold * R + u] = rtvc::round_as<Tw>(hn);
            const float xv =
                k == 0 ? __fadd_rn(in.x, __fmul_rn(p, to_f(smw[lay.col + j]))) : in.x;
            x_out[(size_t)fold * W + u] = xv + hn;  // the state before its rounding
          }
          __syncthreads();
        }
      }
      rtvc::grid_barrier(s.sync, ctas * ++barriers);
    }
    // ---- the FCs, the last one with the head's first half ----
    for (int k = 0; k < n_fc; ++k, ++phase) {
      const bool last = k == n_fc - 1;
      const int n_in = k == 0 ? R : F, r0 = fc_r0[k], nr = fc_nr[k];
      const int rows = last ? C : F;
      const float* x_in = s.act + (size_t)((phase + 1) & 1) * B * W;
      float* f_out = s.act + (size_t)(phase & 1) * B * W;
      const Ts* aux = L.fc_aux[k];
      const Tw* bias = smw + lay.fc_b[k];
      const int q = last ? d.last_rows : d.fc_rows;
      if (nr > 0) {
        for (int f0 = 0; f0 < B; f0 += FB) {
          const int nf = min(FB, B - f0);
          const bool gumbel = last && HEAD == kCategorical;
          // what the elementwise part reads besides the product, for each
          // thread's first item, before the product: a stream entry, or the
          // Gumbel noise of four classes
          const int nq = (nr + 3) / 4;
          auto load_aux = [&](int i) {
            return aux ? to_f(aux[((size_t)(f0 + i / nr) * T + t) * rows + r0 + i % nr]) : 0.0f;
          };
          auto noise = [&](int i) {
            const int qd = i % nq, fold = f0 + i / nq;
            float e4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (!d.argmax) {
              const uint4 rnd = rtvc::philox4x32(
                  make_uint4((uint32_t)(r0 / 4 + qd), (uint32_t)t, (uint32_t)fold, 0u), key);
#pragma unroll
              for (int e = 0; e < 4; ++e) e4[e] = logf(-logf(pick(rnd, e)));
            }
            return make_float4(e4[0], e4[1], e4[2], e4[3]);
          };
          float first_aux = 0.0f;
          float4 first_noise = make_float4(0.f, 0.f, 0.f, 0.f);
          if (!gumbel && tid < nr * nf) first_aux = load_aux(tid);
          if (gumbel && tid < nq * nf) first_noise = noise(tid);
          fc_product<NB>(smw + lay.fc_w[k], x_in + (size_t)f0 * W, (size_t)W, q,
                         k == 0 ? ldR : ldF, n_in, nf, FB, P, scratch);
          __syncthreads();
          if (!gumbel) {
            for (int i = tid; i < nr * nf; i += kThreads) {
              const int j = i % nr, b = i / nr, fold = f0 + b, row = r0 + j;
              const size_t ft = (size_t)fold * T + t;
              float v =
                  P[j * FB + b] + (aux ? (i == tid ? first_aux : load_aux(i)) : to_f(bias[j]));
              if (L.fc_relu[k]) v = fmaxf(v, 0.0f);
              if (!last) {
                f_out[(size_t)fold * W + row] = v;
              } else {
                s.logits[(size_t)fold * C + row] = v;
                if (logits_out) logits_out[ft * C + row] = v;
              }
            }
          } else {
            // Gumbel-argmax over the CTA's classes, four to a Philox draw
            float* red_v = sm + lay.red;
            int* red_i = reinterpret_cast<int*>(red_v + (d.last_rows / 4) * FB);
            for (int i = tid; i < nq * nf; i += kThreads) {
              const int qd = i % nq, b = i / nq, fold = f0 + b;
              const size_t ft = (size_t)fold * T + t;
              const float4 n4 = i == tid ? first_noise : noise(i);
              const float e4[4] = {n4.x, n4.y, n4.z, n4.w};
              float best = -FLT_MAX;
              int best_i = 0x7fffffff;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int j = qd * 4 + e, c = r0 + j;
                if (j < nr) {
                  float v = P[j * FB + b] + (aux ? to_f(aux[ft * rows + c]) : to_f(bias[j]));
                  if (L.fc_relu[k]) v = fmaxf(v, 0.0f);
                  if (logits_out) logits_out[ft * C + c] = v;
                  if (!d.argmax) v -= e4[e];
                  if (v > best || (v == best && c < best_i)) {
                    best = v;
                    best_i = c;
                  }
                }
              }
              red_v[qd * FB + b] = best;
              red_i[qd * FB + b] = best_i;
            }
            __syncthreads();
            for (int b = tid; b < nf; b += kThreads) {
              float best = red_v[b];
              int best_i = red_i[b];
              for (int qd = 1; qd < nq; ++qd) {
                const float v = red_v[qd * FB + b];
                const int c = red_i[qd * FB + b];
                if (v > best || (v == best && c < best_i)) {
                  best = v;
                  best_i = c;
                }
              }
              s.part_val[(size_t)cta * B + f0 + b] = best;
              s.part_idx[(size_t)cta * B + f0 + b] = best_i;
            }
          }
          __syncthreads();
        }
      }
      rtvc::grid_barrier(s.sync, ctas * ++barriers);
    }

    // ---- the head's second half: every CTA draws every fold's sample ----
    if constexpr (HEAD == kCategorical) {
      // The last FC's n_last CTAs left a (value, class) partial for each
      // fold. Warp w takes the CTAs of its slice, its lanes a fold each, so
      // that one load reads 32 consecutive folds of a CTA and the slice's
      // loads are in flight together: a round trip to L2 for 32 folds, not
      // one for each CTA of each fold. The warps' maxima meet in the phase
      // buffer (phase_rows >= 2·kWarps rows), and a thread a fold takes theirs
      // (the argmax, ties to the lower class, takes them in any order).
      const int slice = (n_last + kWarps - 1) / kWarps;
      const int c_lo = warp * slice, c_hi = min(n_last, c_lo + slice);
      float* best_v = P;
      int* best_c = reinterpret_cast<int*>(P + kWarps * FB);
      for (int f0 = 0; f0 < B; f0 += FB) {
        const int nf = min(FB, B - f0);
        for (int b = lane; b < nf; b += 32) {
          const int fold = f0 + b;
          float best = -FLT_MAX;
          int best_i = 0x7fffffff;
          for (int c0 = c_lo; c0 < c_hi; c0 += kHeadLoads) {
            float v[kHeadLoads];
            int ix[kHeadLoads];
#pragma unroll
            for (int m = 0; m < kHeadLoads; ++m) {
              const bool in = c0 + m < c_hi;
              v[m] = in ? __ldcg(s.part_val + (size_t)(c0 + m) * B + fold) : -FLT_MAX;
              ix[m] = in ? __ldcg(s.part_idx + (size_t)(c0 + m) * B + fold) : 0x7fffffff;
            }
#pragma unroll
            for (int m = 0; m < kHeadLoads; ++m) {
              if (v[m] > best || (v[m] == best && ix[m] < best_i)) {
                best = v[m];
                best_i = ix[m];
              }
            }
          }
          best_v[warp * FB + b] = best;
          best_c[warp * FB + b] = best_i;
        }
        __syncthreads();
        for (int b = tid; b < nf; b += kThreads) {
          float best = best_v[b];
          int best_i = best_c[b];
          for (int w = 1; w < kWarps; ++w) {
            const float v = best_v[w * FB + b];
            const int i = best_c[w * FB + b];
            if (v > best || (v == best && i < best_i)) {
              best = v;
              best_i = i;
            }
          }
          const int fold = f0 + b;
          const float sample = 2.0f * (float)best_i / ((float)C - 1.0f) - 1.0f;
          prev[fold] = rtvc::round_as<Tw>(sample);
          if (cta == 0) out[(size_t)fold * T + t] = sample;
        }
        if (f0 + FB < B) __syncthreads();  // the next block reuses the buffer
      }
    } else if constexpr (HEAD == kMol) {
      // Columns [logit_probs | means | log_scales] x k_mix: the component by
      // (Gumbel) argmax, then an inverse-CDF logistic draw around its mean.
      // Draw groups 0 .. ceil(k_mix / 4) - 1 feed the Gumbel noise, the next
      // one the logistic draw.
      const int k_mix = C / 3;
      for (int fold = warp; fold < B; fold += kWarps) {
        const float* lg = s.logits + (size_t)fold * C;
        float best = -FLT_MAX;
        int comp = 0x7fffffff;
        for (int c = lane; c < k_mix; c += 32) {
          float v = __ldcg(lg + c);
          if (!d.argmax) {
            const uint4 rnd = rtvc::philox4x32(
                make_uint4((uint32_t)(c >> 2), (uint32_t)t, (uint32_t)fold, 0u), key);
            v -= logf(-logf(clampf(pick(rnd, c & 3), 1e-5f, 1.0f - 1e-5f)));
          }
          if (v > best || (v == best && c < comp)) {
            best = v;
            comp = c;
          }
        }
        warp_argmax(best, comp);
        if (lane == 0) {
          float sample = __ldcg(lg + k_mix + comp);
          if (!d.argmax) {
            const float log_scale = fmaxf(__ldcg(lg + 2 * k_mix + comp), -32.23619130191664f);
            const uint4 rnd = rtvc::philox4x32(
                make_uint4((uint32_t)((k_mix + 3) >> 2), (uint32_t)t, (uint32_t)fold, 0u), key);
            const float u = clampf(pick(rnd, 0), 1e-5f, 1.0f - 1e-5f);
            sample = __fadd_rn(sample, __fmul_rn(expf(log_scale),
                                                 __fsub_rn(logf(u), logf(1.0f - u))));
          }
          sample = clampf(sample, -1.0f, 1.0f);
          prev[fold] = rtvc::round_as<Tw>(sample);
          if (cta == 0) out[(size_t)fold * T + t] = sample;
        }
      }
    } else {
      // Columns [log α | log β] of a Beta(α, β) over [0, 1], mapped to
      // [-1, 1]. Greedy: the mode where it exists (α, β > 1), else the mean.
      // Sampled: Gα / (Gα + Gβ) from 14 uniforms, draw groups 0 .. 3.
      for (int fold = tid; fold < B; fold += kThreads) {
        const float* lg = s.logits + (size_t)fold * C;
        const float alpha = expf(clampf(__ldcg(lg), -30.0f, 30.0f));
        const float beta = expf(clampf(__ldcg(lg + 1), -30.0f, 30.0f));
        float m;
        if (d.argmax) {
          m = (alpha > 1.0f && beta > 1.0f)
                  ? __fdiv_rn(alpha - 1.0f, __fsub_rn(__fadd_rn(alpha, beta), 2.0f))
                  : __fdiv_rn(alpha, __fadd_rn(alpha, beta));
        } else {
          float u[16];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const uint4 rnd = rtvc::philox4x32(
                make_uint4((uint32_t)g, (uint32_t)t, (uint32_t)fold, 0u), key);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              u[4 * g + i] = clampf(pick(rnd, i), 1e-7f, 1.0f - 1e-7f);
          }
          const float ga = gamma_draw(alpha, u);
          const float gb = gamma_draw(beta, u + 7);
          m = __fdiv_rn(ga, __fadd_rn(ga, gb));
        }
        const float sample = clampf(__fsub_rn(__fmul_rn(2.0f, m), 1.0f), -1.0f, 1.0f);
        prev[fold] = rtvc::round_as<Tw>(sample);
        if (cta == 0) out[(size_t)fold * T + t] = sample;
      }
    }
    __syncthreads();
  }
}

// The instantiations: NB folds an item of a layer's product, the head, the
// weight and stream types.
template <int HEAD, typename Tw, typename Ts>
const void* kernel_for(int nb) {
  if (nb == 4) return (const void*)wavernn_kernel<HEAD, 4, Tw, Ts>;
  if (nb == 8) return (const void*)wavernn_kernel<HEAD, 8, Tw, Ts>;
  return nullptr;
}

// One launch with the weights in Tw and the streams in Ts (the entry point
// below has checked the widths and the head).
template <typename Tw, typename Ts>
int launch_typed(const void* const* weights, const void* const* streams, const int* dims,
                 Dims d, unsigned long long seed, float* scratch, unsigned int* sync,
                 float* out, float* logits_out, cudaStream_t stream) {
  Layers<Tw, Ts> L;
  auto w = [&](int i) { return static_cast<const Tw*>(weights[i]); };
  auto st = [&](int i) { return static_cast<const Ts*>(streams[i]); };
  L.i_col = w(0);
  L.i_cond = st(0);
  for (int k = 0; k < kMaxRnn; ++k) {
    L.rnn_wih[k] = w(1 + 4 * k);
    L.rnn_bih[k] = w(2 + 4 * k);
    L.rnn_whh[k] = w(3 + 4 * k);
    L.rnn_bhh[k] = w(4 + 4 * k);
    L.rnn_aux[k] = st(1 + k);
  }
  for (int k = 0; k < kMaxFc; ++k) {
    L.fc_w[k] = w(1 + 4 * kMaxRnn + 2 * k);
    L.fc_b[k] = w(2 + 4 * kMaxRnn + 2 * k);
    L.fc_aux[k] = st(1 + kMaxRnn + k);
    L.fc_relu[k] = dims[8 + k];
  }
  L.n_rnn = dims[5];
  L.n_fc = dims[6];
  if ((int)layout(d, L.n_rnn, L.n_fc, (int)sizeof(Tw)).total != d.smem)
    return (int)cudaErrorInvalidValue;
  const void* kernel = d.head == kCategorical ? kernel_for<kCategorical, Tw, Ts>(d.nb)
                       : d.head == kMol       ? kernel_for<kMol, Tw, Ts>(d.nb)
                                              : kernel_for<kBeta, Tw, Ts>(d.nb);
  if (!kernel) return (int)cudaErrorInvalidValue;
  const int W = al4(d.R > d.F ? d.R : d.F);
  Scratch s;
  s.h = scratch;
  s.act = s.h + (size_t)L.n_rnn * 2 * d.B * d.R;
  s.logits = s.act + (size_t)2 * d.B * W;
  s.part_val = s.logits + (size_t)d.B * d.C;
  s.part_idx = reinterpret_cast<int*>(s.part_val + (size_t)d.ctas * d.B);
  s.sync = sync;
  const uint2 key = make_uint2((uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32));
  void* args[] = {&L, &d, &s, const_cast<uint2*>(&key), &out, &logits_out};
  return rtvc::launch_cooperative(kernel, d.ctas, d.smem, args, stream);
}

}  // namespace

// weights: 1 + 4·kMaxRnn + 2·kMaxFc device pointers: i_col, then for each of
// kMaxRnn GRU slots (wih, bih, whh, bhh), then for each of kMaxFc FC slots
// (w, b); null for an absent layer and for the bias of a layer that takes a
// stream. streams: 1 + kMaxRnn + kMaxFc pointers: i_cond (B, T, R), then one
// per GRU slot (B, T, 3R) and one per FC slot (B, T, F), null where the layer
// has its own bias. dims: B, T, R, F, C, n_rnn, n_fc, head (0 categorical,
// 1 MOL, 2 beta), then kMaxFc relu flags, then the plan: ctas, units,
// fc_rows, last_rows, nb, fb, smem (ops/wavernn_generate.py:plan), then the
// bytes of a weight and of a stream entry (4 for f32, 2 for bf16). scratch:
// zeroed floats, n_rnn·2·B·R (GRU states), then 2·B·W (activations, W = R
// and F's larger, rounded up to 4), B·C (head inputs), 2·ctas·B (partials);
// sync: 32 zeroed words. out: (B, T) f32 samples in [-1, 1]; logits_out:
// null, or (B, T, C) f32 for the head's inputs at each step. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a plan that does not cover
// the widths or has no instantiation, or for another type).
extern "C" int rtvc_wavernn_generate(const void* const* weights, const void* const* streams,
                                     const int* dims, int argmax, unsigned long long seed,
                                     float* scratch, unsigned int* sync, float* out,
                                     float* logits_out, void* stream) {
  Dims d;
  d.B = dims[0];
  d.T = dims[1];
  d.R = dims[2];
  d.F = dims[3];
  d.C = dims[4];
  const int n_rnn = dims[5], n_fc = dims[6];
  d.head = dims[7];
  d.argmax = argmax;
  const int* pl = dims + 8 + kMaxFc;
  d.ctas = pl[0];
  d.units = pl[1];
  d.fc_rows = pl[2];
  d.last_rows = pl[3];
  d.nb = pl[4];
  d.fb = pl[5];
  d.smem = pl[6];
  const int w_bytes = pl[7], s_bytes = pl[8];
  const int head = d.head;
  if (n_rnn < 1 || n_rnn > kMaxRnn || n_fc < 2 || n_fc > kMaxFc || head < 0 || head > 2 ||
      (head == kMol && (d.C % 3 != 0 || d.C < 3)) || (head == kBeta && d.C != 2) || d.B < 1 ||
      d.T < 1 || d.fb < 1 || d.ctas < 1)
    return (int)cudaErrorInvalidValue;
  // the plan must cover every layer (and match the layout's bytes: launch_typed)
  const bool covers = (long long)d.ctas * d.units >= d.R &&
                      (long long)d.ctas * d.fc_rows >= d.F &&
                      (long long)d.ctas * d.last_rows >= d.C &&
                      (head != kCategorical || d.last_rows % 4 == 0);
  if (!covers) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bytes == 4 && s_bytes == 4)
    return launch_typed<float, float>(weights, streams, dims, d, seed, scratch, sync, out,
                                      logits_out, st);
  if (w_bytes == 4 && s_bytes == 2)
    return launch_typed<float, bf16>(weights, streams, dims, d, seed, scratch, sync, out,
                                     logits_out, st);
  if (w_bytes == 2 && s_bytes == 2)
    return launch_typed<bf16, bf16>(weights, streams, dims, d, seed, scratch, sync, out,
                                    logits_out, st);
  if (w_bytes == 2 && s_bytes == 4)
    return launch_typed<bf16, float>(weights, streams, dims, d, seed, scratch, sync, out,
                                     logits_out, st);
  return (int)cudaErrorInvalidValue;
}
