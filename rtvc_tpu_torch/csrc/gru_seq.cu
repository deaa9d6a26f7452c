// GRU sequence over hoisted input gates from a zero state, forward and
// backward (torch semantics: the hidden-side bias b_hn sits inside the reset
// product), with W_hh resident in shared memory across the card.
//
// Replaces: rtvc_tpu/ops/pallas/gru_train_kernel.py:gru_seq_fused, both
// halves (_fwd_kernel :71 and _bwd_kernel :111), which run the teacher-forced
// GRUs of WaveRNN training on the TPU (runtimeracer: four GRUs of H = 256,
// fatchord: two of H = 512, over seq_len = 1000 samples at batch 40;
// geneing: one of H = 256 over 1400).
//
// What bounds it on the H100: every step multiplies W_hh (3H x H f32, 0.79 MB
// at H = 256, 3.1 MB at H = 512) by one vector per batch row: h in the
// forward, the hidden-side gate cotangent dhg = [dr, dz, dn·r] in the
// backward; 2 · 3H · H operations per row and step, in strict order over T.
// One CTA per batch row, as the first version had it, re-read W_hh from L2
// every step and used 40 of the 132 SMs: it lost 2x to cuDNN at H = 512.
// With W_hh resident a step at batch 40 is a few hundred thousand FMAs per
// SM, and its time is one dependent chain: 3.2-3.5 µs at H = 256 and
// 5.4-5.6 µs at H = 512 on an H100 at 700 W (PERF.md, section 6). Of a step
// at H = 512, the backward's reads of the 3H-wide dhg from L2 take 1.6 µs,
// the forward's weight reads from shared memory 1.0 µs and the barrier's
// wait at most 0.5 µs; the rest is the product's FMAs, the sum over the lanes
// and the gate update with its stores. Two batch groups at H = 512 (four at
// H = 256 backward) halve what each CTA reads from L2 a step.
//
// Design: K3's (lstm_seq.cu), with three gates in place of four. The grid is
// `groups` x `slices` CTAs, all resident at once (a cooperative launch). A
// CTA owns U hidden units for the whole sequence and a contiguous group of
// batch rows. The forward loads the 3U rows of W_hh that make its units' r, z
// and n gates, with their b_hh, into shared memory once; each step its warps
// take NB rows at a time, read those rows of h_{t-1} (ys[:, t-1]) from L2
// one piece ahead (common.cuh:slice_product), sum the lanes' partial sums with
// a transposing butterfly, and apply the GRU update to their (row, unit)
// pairs; the pair's own h_{t-1} is the ys entry its lane wrote a step before.
// The backward gathers its U columns of W_hh (3H long) itself; each step
// forms dh_t = dys_t + dh_{t+1}·z_{t+1} + dhg_{t+1} · W_hh for its units from
// the whole of the row's dhg_{t+1}, which every CTA wrote in the step before,
// and writes dxg and dhg at t. dhg is an output of its own (its n slice is
// dn·r, not dxg's dn), which the autograd function then uses for dW_hh and
// db_hh. The direct term dh·z of a pair lives in a (B, H) carry between steps.
// One grid barrier per batch group separates the steps (common.cuh:
// grid_barrier). The partition is ops/gru_seq.py:plan's; the entry points
// check it and pick the instantiation. No sum goes through an atomic, so two
// runs give equal bits. dW_hh and db_hh are batched reductions over (B·T) and
// stay outside the kernel, as in the JAX package (gru_train_kernel.py:329-343).
//
// The bf16 instantiation (the bf16 training policy, ops/precision.py) keeps
// the JAX kernel's contract under that policy: xg, W_hh, b_hh, ys and the
// gates are bf16, the arithmetic and the carried h f32 (gru_train_kernel.py:
// 224, :256); the backward reads the bf16 residuals, h_{t-1} from the bf16
// ys as the JAX package does, and writes f32 dxg and dhg (:123-127, :340).
// W_hh is resident at two bytes a weight, widened at use, and the forward's
// carried h goes between CTAs through an f32 buffer of two (B, H) slots, as
// in lstm_seq.cu, so that the state is never rounded.
//
// The row-resident mode (H <= 128: the Tacotron CBHGs' BiGRUs at H 64,
// ForwardTacotron's predictors at H 64 and 128). There the cooperative design
// is a chain across SMs every step: h_t stored to device memory, a grid
// barrier (~1 µs), h read back from L2, a transposing butterfly; 3.55 µs a
// step at B 1 x H 64 against cuDNN's 0.62 (PERF.md, section 6). None of it is
// needed at these widths: W_hh is 49,152 bytes at H 64 and 196,608 at H 128,
// and batch rows never exchange anything. So a CTA (to H 64) or a cluster of
// two CTAs (to H 128, each with half the units) owns all H units of one whole
// batch row for the whole sequence, and nothing it computes leaves the
// SM, or the cluster, on the chain: the state (h_{t-1} in the forward;
// dhg_{t+1} = [dr, dz, dn·r] and dh_{t+1}·z_{t+1} in the backward) stays in
// shared memory and registers, each CTA of a cluster writing what it computes
// into its own and its peer's shared memory, and a step ends with
// __syncthreads() or the cluster's barrier. Clusters share nothing, so the
// launch is an ordinary one (cudaLaunchKernelEx with a cluster dimension),
// B clusters that run in waves past the card's SMs (one row a CTA ran fastest
// at every shape timed; two rows 4-18 % slower: PERF.md, section 6). L lanes
// own a hidden unit j (2 to H 64, 4 in each CTA of a cluster to H 128): lane
// q holds the unit's
// weights over the k chunks of four q, q + L, ... (the forward its r, z and n
// rows of W_hh, the backward its column of each gate block), 96 weights, in
// registers; each step it multiplies them by the state's chunks (a 16-byte
// shared-memory read that every unit of the warp shares), the L lanes sum
// their partial sums with log2(L) shuffles, and lane 0 applies the unit's
// update. Fewer lanes a unit means fewer warps, each updating more
// units at once: 2 lanes of 96 weights ran 12-14 % faster than 4 of 48 at H
// 64, and 4 x 2 CTAs 13-19 % faster than 8 x 2 at H 128; 4 lanes with the
// weights in shared memory ran 17-20 % slower forward than in registers
// (PERF.md, section 6; profile_gru.py builds the shared-memory placement as a
// variant of this source). The inputs that do not depend on the state (xg in the forward; the gates, dys
// and h_{t-1} in the backward) are staged kRing - 1 steps ahead into a
// shared-memory ring with cp.async by one more warp, the producer, which
// takes no part in the product (staged by the compute warps, a step at B 1 x
// H 64 took 0.62 µs, 0.16 µs more than with the copies left out; with the
// producer, 0.58); ys, the gates, dxg and dhg are written with plain stores
// that nothing waits on. What bounds a step then is its dependent chain, not
// bytes or operations: at H 64 the product with its shuffles takes ≈ 390
// cycles, the update with its sigmoids and tanh ≈ 460 (PERF.md, section 6; the
// bound of a whole launch is far below 1 % of its time). The sums are in a fixed
// order and no atomic is used, so two runs give equal bits. The bf16
// instantiations keep the contract above with the f32 state on chip, so they
// need no exchange buffer.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kThreads = rtvc::kRecThreads;
constexpr int kWarps = rtvc::kRecWarps;
using rtvc::padded;
using rtvc::Part;
using rtvc::partition;
using rtvc::slice_product;
using rtvc::bf16;
using rtvc::from_f;
using rtvc::to_f;

// S is the streams' element type (f32, or bf16 under the bf16 policy, where
// W_hh and b_hh are bf16 too). With bf16 streams h_{t-1} goes between CTAs
// through `hx`, two f32 (B, H) slots (step t writes slot t & 1, reads slot
// (t - 1) & 1), so the recurrence never rounds its state; ys and the gates
// are written in bf16 beside it. With f32 streams h is read from ys itself
// and hx is null.
template <int U, int NB, typename S>
__global__ void __launch_bounds__(kThreads, 1)
gru_seq_kernel(const S* __restrict__ xg, const S* __restrict__ w_hh,
               const S* __restrict__ b_hh, S* ys, S* __restrict__ gates, float* hx, int B,
               int T, int H, int slices, int rows, unsigned int* sync) {
  constexpr int R = 3 * U;                       // gate rows of W_hh a CTA holds
  constexpr int PP = (U * NB + 31) / 32;         // (row, unit) pairs a lane updates
  constexpr bool kF32 = std::is_same<S, float>::value;
  extern __shared__ float4 smem4[];
  S* W = reinterpret_cast<S*>(smem4);            // R x ld, row gate * U + j
  const int ld = (H + 3) & ~3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* scratch = reinterpret_cast<float*>(W + R * ld);
  float* out = scratch + warp * padded(R * NB);
  float* bias = scratch + kWarps * padded(R * NB);  // R: the rows' b_hh, widened
  const Part p = partition(U, B, H, slices, rows, sync);
  const int G = 3 * H;
  for (int i = threadIdx.x; i < R * ld; i += kThreads) {
    const int r = i / ld, k = i % ld, gate = r / U, j = r % U;
    W[i] = (j < p.nu && k < H) ? w_hh[(size_t)(gate * H + p.u0 + j) * H + k] : from_f<S>(0.0f);
  }
  for (int r = threadIdx.x; r < R; r += kThreads)
    bias[r] = r % U < p.nu ? to_f(b_hh[(r / U) * H + p.u0 + r % U]) : 0.0f;
  __syncthreads();
  const bool vec = (H & 3) == 0;
  // where h_{t-1} of batch row b0 lies, and the stride between rows
  auto h_of = [&](int t, int b0) -> const float* {
    if constexpr (kF32) return ys + (size_t)b0 * T * H + (size_t)t * H;
    else return hx + (size_t)(t & 1) * B * H + (size_t)b0 * H;
  };
  const size_t hs = kF32 ? (size_t)T * H : (size_t)H;
  for (int t = 0; t < T; ++t) {
    for (int b0 = p.b_lo + warp * NB; b0 < p.b_hi; b0 += kWarps * NB) {
      const int nb = min(NB, p.b_hi - b0);
      // this lane's pairs: their input gates and previous state, fetched
      // before the product that they do not depend on
      float x_in[PP][3], h_prev[PP];
#pragma unroll
      for (int q = 0; q < PP; ++q) {
        const int pair = lane + 32 * q, j = pair / NB, b = pair % NB;
        if (j < p.nu && b < nb) {
          const size_t row = (size_t)(b0 + b), col = p.u0 + j;
#pragma unroll
          for (int gate = 0; gate < 3; ++gate)
            x_in[q][gate] = to_f(xg[(row * T + t) * G + gate * H + col]);
          h_prev[q] = t == 0 ? 0.0f : h_of(t - 1, b0)[b * hs + col];
        }
      }
      // hg = h_{t-1} · W_hhᵀ for the CTA's rows; zero at t = 0
      if (t > 0) {
        slice_product<R, NB>(W, ld, H, h_of(t - 1, b0), hs, nb, vec, out);
        __syncwarp();
      }
#pragma unroll
      for (int q = 0; q < PP; ++q) {
        const int pair = lane + 32 * q, j = pair / NB, b = pair % NB;
        if (j < p.nu && b < nb) {
          const size_t row = (size_t)(b0 + b), col = p.u0 + j, bt = row * T + t;
          float hg[3];
#pragma unroll
          for (int gate = 0; gate < 3; ++gate)
            hg[gate] = (t > 0 ? out[(gate * U + j) * NB + b] : 0.0f) + bias[gate * U + j];
          const float r = rtvc::sigmoidf_(x_in[q][0] + hg[0]);
          const float z = rtvc::sigmoidf_(x_in[q][1] + hg[1]);
          const float n = tanhf(x_in[q][2] + r * hg[2]);
          const float h = (1.0f - z) * n + z * h_prev[q];
          ys[bt * H + col] = from_f<S>(h);
          if (!kF32) hx[(size_t)(t & 1) * B * H + row * H + col] = h;
          S* gt = gates + bt * 4 * H + col;
          gt[0] = from_f<S>(r);
          gt[H] = from_f<S>(z);
          gt[2 * H] = from_f<S>(n);
          gt[3 * H] = from_f<S>(hg[2]);
        }
      }
      __syncwarp();
    }
    if (t + 1 < T) rtvc::grid_barrier(p.counter, p.slices * (unsigned int)(t + 1));
  }
}

// Reverse walk carrying dh, the math of gru_train_kernel.py:122-142. h_{t-1}
// is ys one step back, zero at t = 0. dhg_t = [dr, dz, dn·r] is written
// whole every step: the next step (t - 1) multiplies all of it by the CTA's
// columns of W_hh. With bf16 streams the residuals (gates, and ys as h_{t-1},
// as the JAX package reads them) and W_hh are bf16, widened at use; dxg and
// dhg are f32 in both instantiations, as the JAX kernel's dxg is.
template <int U, int NB, typename S>
__global__ void __launch_bounds__(kThreads, 1)
gru_seq_bwd_kernel(const S* __restrict__ dys, const S* __restrict__ gates,
                   const S* __restrict__ ys, const S* __restrict__ w_hh,
                   float* __restrict__ dxg, float* dhg, float* carry, int B, int T, int H,
                   int slices, int rows, unsigned int* sync) {
  constexpr int PP = (U * NB + 31) / 32;
  extern __shared__ float4 smem4[];
  S* W = reinterpret_cast<S*>(smem4);            // U x 3H: the CTA's columns of W_hh
  const int G = 3 * H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* out = reinterpret_cast<float*>(W + U * G) + warp * padded(U * NB);
  const Part p = partition(U, B, H, slices, rows, sync);
  for (int i = threadIdx.x; i < U * G; i += kThreads) {
    const int r = i / U, j = i % U;  // neighbouring threads read neighbouring columns
    W[j * G + r] = j < p.nu ? w_hh[(size_t)r * H + p.u0 + j] : from_f<S>(0.0f);
  }
  __syncthreads();
  const bool vec = (G & 3) == 0;
  const size_t xs = (size_t)T * G;
  for (int t = T - 1; t >= 0; --t) {
    for (int b0 = p.b_lo + warp * NB; b0 < p.b_hi; b0 += kWarps * NB) {
      const int nb = min(NB, p.b_hi - b0);
      float gt[PP][4], h_prev[PP], dy[PP], c[PP];
#pragma unroll
      for (int q = 0; q < PP; ++q) {
        const int pair = lane + 32 * q, j = pair / NB, b = pair % NB;
        if (j < p.nu && b < nb) {
          const size_t row = (size_t)(b0 + b), col = p.u0 + j, bt = row * T + t;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            gt[q][gate] = to_f(gates[bt * 4 * H + gate * H + col]);
          h_prev[q] = t > 0 ? to_f(ys[(bt - 1) * H + col]) : 0.0f;
          dy[q] = to_f(dys[bt * H + col]);
          c[q] = t < T - 1 ? carry[row * H + col] : 0.0f;
        }
      }
      // dhg_{t+1} · W_hh, from the whole of the step before
      if (t < T - 1) {
        slice_product<U, NB>(W, G, G, dhg + ((size_t)b0 * T + t + 1) * G, xs, nb, vec, out);
        __syncwarp();
      }
#pragma unroll
      for (int q = 0; q < PP; ++q) {
        const int pair = lane + 32 * q, j = pair / NB, b = pair % NB;
        if (j < p.nu && b < nb) {
          const size_t row = (size_t)(b0 + b), col = p.u0 + j, bt = row * T + t;
          const float r = gt[q][0], z = gt[q][1], n = gt[q][2], hn = gt[q][3];
          const float dhj = dy[q] + (t < T - 1 ? c[q] + out[j * NB + b] : 0.0f);
          const float dz = dhj * (h_prev[q] - n) * z * (1.0f - z);
          const float dn = dhj * (1.0f - z) * (1.0f - n * n);
          const float dr = dn * hn * r * (1.0f - r);
          float* dxt = dxg + bt * G + col;
          dxt[0] = dr;
          dxt[H] = dz;
          dxt[2 * H] = dn;
          float* dht = dhg + bt * G + col;
          dht[0] = dr;
          dht[H] = dz;
          dht[2 * H] = dn * r;
          carry[row * H + col] = dhj * z;
        }
      }
      __syncwarp();
    }
    if (t > 0) rtvc::grid_barrier(p.counter, p.slices * (unsigned int)(T - t));
  }
}

using Plan = rtvc::SeqPlan;

template <typename Kernel>
int launch(Kernel kernel, const Plan& plan, void** args, cudaStream_t stream) {
  return rtvc::launch_cooperative(kernel, plan.groups * plan.slices, plan.smem, args, stream);
}

// ---------------------------------------------------------------------------
// Row-resident mode
// ---------------------------------------------------------------------------

constexpr int kRing = 8;  // steps of the input ring: the copies run kRing - 1 steps ahead

using rtvc::dot4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages n elements of one batch row from src into shared memory at dst,
// spread over the 32 lanes of the producer warp: 16-byte copies when `vec` (n
// a multiple of 16 bytes, both addresses aligned), else one element at a time
// (bf16 elements, which cp.async does not take at two bytes, with a load and
// a store).
template <typename S>
__device__ __forceinline__ void stage_row(S* dst, const S* src, int n, bool vec, int lane) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(S);
    for (int i = lane * E; i < n; i += 32 * E) cp_async16(dst + i, src + i);
  } else {
    for (int i = lane; i < n; i += 32) {
      if constexpr (sizeof(S) == 4) cp_async4(dst + i, src + i);
      else dst[i] = src[i];
    }
  }
}

// n elements of S rounded up to a whole number of 16-byte pieces.
__host__ __device__ constexpr int pad16(int n, int elem) {
  return (n + 16 / elem - 1) / (16 / elem) * (16 / elem);
}

// Hidden units a CTA of a cluster of C owns, L lanes a unit: H / C rounded up
// so that the CTA's compute threads fill whole warps.
__host__ __device__ constexpr int row_units(int H, int L, int C) {
  return ((H + C - 1) / C + 32 / L - 1) / (32 / L) * (32 / L);
}

// Sums each of acc's values over the L lanes of a unit, in one fixed order, so
// that every lane ends with the same bits.
template <int L, int N>
__device__ __forceinline__ void group_sum(float (&acc)[N]) {
#pragma unroll
  for (int g = 0; g < N; ++g) {
#pragma unroll
    for (int o = 1; o < L; o <<= 1) acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], o);
  }
}

// A lane's weights, in registers: 3 x KI chunks of four, lane q of a unit's L
// holding the chunks q + L·i, i < KI (so a unit's lanes cover 4·L·KI values
// of k): the forward's W_hh[g·H + col][k] or the backward's W_hh[g·H + k][col]
// over k = 4 (q + L i) + e, zero past H or for a padding unit. Every index is
// a compile-time constant, so the array stays in registers.
template <int L, int KI>
struct LaneWeights {
  float4 w[3][KI];

  template <typename S>
  __device__ __forceinline__ void load(const S* w_hh, int H, int col, int q, bool transposed) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * (q + L * i) + e;
          v[e] = (col < H && k < H)
                     ? rtvc::to_f(transposed ? w_hh[(size_t)(g * H + k) * H + col]
                                             : w_hh[(size_t)(g * H + col) * H + k])
                     : 0.0f;
        }
        w[g][i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }

  __device__ __forceinline__ float4 at(int g, int i) const { return w[g][i]; }
};

// The end of a step: the CTA's barrier, or with a cluster of two the
// cluster's (barrier.cluster.arrive.release / wait.acquire), which also makes
// the state each CTA wrote into its peer's shared memory visible there.
template <int C>
__device__ __forceinline__ void step_barrier() {
  if constexpr (C == 1) __syncthreads();
  else cooperative_groups::this_cluster().sync();
}

// `v` into element `i` of the state buffer `buf` of this CTA and, with a
// cluster of two, of its peer (through distributed shared memory).
template <int C>
__device__ __forceinline__ void put_state(float* buf, int i, float v) {
  buf[i] = v;
  if constexpr (C == 2) {
    auto cluster = cooperative_groups::this_cluster();
    cluster.map_shared_rank(buf, cluster.block_rank() ^ 1)[i] = v;
  }
}

// The forward, row-resident: batch row b of a group of C CTAs (a cluster
// where C is 2), CTA rank c owning the units [c·uc, c·uc + uc), L lanes a
// unit, lane 0 of a unit applying its update, and one more warp, the
// producer, that stages the ring. Shared memory of each CTA: [the xg ring:
// kRing slots of pad16(3H)][h: two buffers (step t writes t & 1) of 16·L
// floats, zero past H; each CTA holds all of h].
template <int L, int KI, int C, typename S>
__global__ void __launch_bounds__(4 * L * KI / C * L + 32, 1)
gru_rows_kernel(const S* __restrict__ xg, const S* __restrict__ w_hh,
                const S* __restrict__ b_hh, S* __restrict__ ys, S* __restrict__ gates, int T,
                int H, bool vec) {
  constexpr int HP = 4 * L * KI;
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x - 32;  // compute threads
  const bool producer = threadIdx.x >= nt;
  const int q = threadIdx.x % L, j = threadIdx.x / L;
  const int col = (C == 1 ? 0 : (int)(blockIdx.x % C)) * (nt / L) + j;
  const int b = (int)(blockIdx.x / C), G = 3 * H;
  const int slot_n = pad16(G, (int)sizeof(S));
  S* ring = reinterpret_cast<S*>(smem4);
  float* hbuf = reinterpret_cast<float*>(ring + (size_t)kRing * slot_n);
  LaneWeights<L, KI> W;
  float bias[3] = {0.0f, 0.0f, 0.0f};
  if (!producer) {
    W.load(w_hh, H, col, q, false);
#pragma unroll
    for (int g = 0; g < 3; ++g) bias[g] = col < H ? rtvc::to_f(b_hh[g * H + col]) : 0.0f;
  }
  for (int i = threadIdx.x; i < 2 * HP; i += blockDim.x) hbuf[i] = 0.0f;
  // the ring: step s's xg row into slot s % kRing, by the producer warp
  const S* x_row = xg + (size_t)b * T * G;
  auto stage = [&](int s) {
    stage_row(ring + (s % kRing) * slot_n, x_row + (size_t)s * G, G, vec,
              (int)threadIdx.x - nt);
  };
  if (producer) {
    for (int s = 0; s < kRing - 1; ++s) {
      if (s < T) stage(s);
      cp_async_commit();
    }
    cp_async_wait<kRing - 2>();
  }
  // every CTA of the cluster has zeroed its h before any peer writes into it
  step_barrier<C>();
  float h_own = 0.0f;  // h_{t-1} of unit col for the lane that updates it
  const bool mine = !producer && q == 0 && col < H;
  for (int t = 0; t < T; ++t) {
    if (producer) {
      // slot (t - 1) % kRing was last read in step t - 1, before the barrier
      if (t + kRing - 1 < T) stage(t + kRing - 1);
      cp_async_commit();
      // step t + 1's slot has landed; the barrier shows it to every thread
      cp_async_wait<kRing - 2>();
    } else {
      const S* x = ring + (t % kRing) * slot_n;  // this step's xg
      float x_in[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) x_in[g] = mine ? rtvc::to_f(x[g * H + col]) : 0.0f;
      // hg = h_{t-1} · W_hhᵀ; zero at t = 0. Each gate's sum runs in two
      // chains, the even and the odd chunks, added at the end (4 % faster
      // than one chain a gate).
      float hg[3], part[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
      if (t > 0) {
        const float* hp = hbuf + ((t - 1) & 1) * HP;
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          const float4 hv = *reinterpret_cast<const float4*>(hp + 4 * (q + L * i));
#pragma unroll
          for (int g = 0; g < 3; ++g) part[g][i & 1] = dot4(W.at(g, i), hv, part[g][i & 1]);
        }
      }
#pragma unroll
      for (int g = 0; g < 3; ++g) hg[g] = part[g][0] + part[g][1];
      group_sum<L, 3>(hg);
      if (mine) {
#pragma unroll
        for (int g = 0; g < 3; ++g) hg[g] += bias[g];
        const float r = rtvc::sigmoidf_(x_in[0] + hg[0]);
        const float z = rtvc::sigmoidf_(x_in[1] + hg[1]);
        const float n = tanhf(x_in[2] + r * hg[2]);
        const float h = (1.0f - z) * n + z * h_own;
        h_own = h;
        put_state<C>(hbuf, (t & 1) * HP + col, h);
        const size_t bt = (size_t)b * T + t;
        ys[bt * H + col] = from_f<S>(h);
        S* gt = gates + bt * 4 * H + col;
        gt[0] = from_f<S>(r);
        gt[H] = from_f<S>(z);
        gt[2 * H] = from_f<S>(n);
        gt[3 * H] = from_f<S>(hg[2]);
      }
    }
    step_barrier<C>();
  }
}

// The backward, row-resident, the math of gru_seq_bwd_kernel, laid out as the
// forward. Shared memory of each CTA: [the ring: kRing slots of (gates 4H |
// dys H | ys_{t-1} H), each part pad16][dhg: two buffers (step t writes
// t & 1) of 3 x 16·L floats, zero past H; each CTA holds all of dhg]. The
// carry dh_{t+1}·z_{t+1} of unit col stays in its lane's register.
template <int L, int KI, int C, typename S>
__global__ void __launch_bounds__(4 * L * KI / C * L + 32, 1)
gru_rows_bwd_kernel(const S* __restrict__ dys, const S* __restrict__ gates,
                    const S* __restrict__ ys, const S* __restrict__ w_hh,
                    float* __restrict__ dxg, float* __restrict__ dhg, int T, int H, bool vec) {
  constexpr int HP = 4 * L * KI;
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x - 32;
  const bool producer = threadIdx.x >= nt;
  const int q = threadIdx.x % L, j = threadIdx.x / L;
  const int col = (C == 1 ? 0 : (int)(blockIdx.x % C)) * (nt / L) + j;
  const int b = (int)(blockIdx.x / C), G = 3 * H;
  const int e = (int)sizeof(S);
  const int off_dy = pad16(4 * H, e), off_y = off_dy + pad16(H, e), slot_n = off_y + pad16(H, e);
  S* ring = reinterpret_cast<S*>(smem4);
  float* dbuf = reinterpret_cast<float*>(ring + (size_t)kRing * slot_n);
  LaneWeights<L, KI> W;
  if (!producer) W.load(w_hh, H, col, q, true);
  for (int i = threadIdx.x; i < 2 * 3 * HP; i += blockDim.x) dbuf[i] = 0.0f;
  auto stage = [&](int s) {
    S* slot = ring + (s % kRing) * slot_n;
    const size_t bt = (size_t)b * T + s;
    const int lane = (int)threadIdx.x - nt;
    stage_row(slot, gates + bt * 4 * H, 4 * H, vec, lane);
    stage_row(slot + off_dy, dys + bt * H, H, vec, lane);
    if (s > 0) stage_row(slot + off_y, ys + (bt - 1) * H, H, vec, lane);
  };
  if (producer) {
    for (int s = T - 1; s > T - kRing; --s) {
      if (s >= 0) stage(s);
      cp_async_commit();
    }
    cp_async_wait<kRing - 2>();
  }
  step_barrier<C>();
  float carry = 0.0f;  // dh_{t+1}·z_{t+1} of unit col
  const bool mine = !producer && q == 0 && col < H;
  for (int t = T - 1; t >= 0; --t) {
    if (producer) {
      // slot (t + 1) % kRing was last read in step t + 1, before the barrier
      if (t - (kRing - 1) >= 0) stage(t - (kRing - 1));
      cp_async_commit();
      cp_async_wait<kRing - 2>();
    } else {
      const S* sl = ring + (t % kRing) * slot_n;
      float gt[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dy = 0.0f, h_prev = 0.0f;
      if (mine) {
#pragma unroll
        for (int g = 0; g < 4; ++g) gt[g] = rtvc::to_f(sl[g * H + col]);
        dy = rtvc::to_f(sl[off_dy + col]);
        h_prev = t > 0 ? rtvc::to_f(sl[off_y + col]) : 0.0f;
      }
      // dhg_{t+1} · W_hh; zero at t = T - 1 (one chain: six chains, a gate's
      // even and odd chunks, ran 4-7 % slower)
      float sum[1] = {0.0f};
      if (t < T - 1) {
        const float* dp = dbuf + ((t + 1) & 1) * 3 * HP;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
#pragma unroll
          for (int i = 0; i < KI; ++i)
            sum[0] = dot4(W.at(g, i),
                          *reinterpret_cast<const float4*>(dp + g * HP + 4 * (q + L * i)),
                          sum[0]);
        }
      }
      group_sum<L, 1>(sum);
      if (mine) {
        const float r = gt[0], z = gt[1], n = gt[2], hn = gt[3];
        const float dhj = dy + (carry + sum[0]);
        const float dz = dhj * (h_prev - n) * z * (1.0f - z);
        const float dn = dhj * (1.0f - z) * (1.0f - n * n);
        const float dr = dn * hn * r * (1.0f - r);
        const size_t bt = (size_t)b * T + t;
        float* dxt = dxg + bt * G + col;
        dxt[0] = dr;
        dxt[H] = dz;
        dxt[2 * H] = dn;
        float* dht = dhg + bt * G + col;
        dht[0] = dr;
        dht[H] = dz;
        dht[2 * H] = dn * r;
        const int at = (t & 1) * 3 * HP + col;
        put_state<C>(dbuf, at, dr);
        put_state<C>(dbuf, at + HP, dz);
        put_state<C>(dbuf, at + 2 * HP, dn * r);
        carry = dhj * z;
      }
    }
    step_barrier<C>();
  }
}

// The plan a row-resident wrapper hands over (ops/gru_seq.py:RowPlan): CTAs
// (one cluster a batch row, so B x cluster), lanes a unit, k chunks of four a
// lane holds a gate, CTAs a cluster, threads a CTA (lanes x the CTA's units,
// padded to whole warps, plus the producer warp), bytes of shared memory a
// CTA.
struct RowPlan {
  int ctas, lanes, chunks, cluster, threads, smem;
};

int row_smem(int H, int L, int KI, bool backward, int elem) {
  const int slot = backward ? pad16(4 * H, elem) + 2 * pad16(H, elem) : pad16(3 * H, elem);
  return kRing * slot * elem + 2 * (backward ? 3 : 1) * 4 * L * KI * 4;
}

// The plan's numbers agree with the shape; its kind is checked where it is
// launched (RTVC_ROWS_CASES), which takes no other.
bool row_plan_ok(const RowPlan& p, int B, int H, bool backward, int elem) {
  if (B < 1 || H < 1 || p.lanes < 1 || 32 % p.lanes != 0 || p.cluster < 1 || p.cluster > 2 ||
      4 * p.lanes * p.chunks < H)
    return false;
  return (long long)p.ctas == (long long)B * p.cluster &&
         p.threads == row_units(H, p.lanes, p.cluster) * p.lanes + 32 &&
         p.smem == row_smem(H, p.lanes, p.chunks, backward, elem);
}

// An ordinary launch of the plan's CTAs, in clusters of p.cluster.
template <typename... KArgs, typename... Args>
int launch_rows(void (*kernel)(KArgs...), const RowPlan& p, cudaStream_t stream,
                Args... args) {
  cudaError_t e = rtvc::allow_smem((const void*)kernel, (size_t)p.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The row-resident instantiations, (lanes a unit, chunks a gate, CTAs a
// cluster): (2, 8, 1) for H <= 64 and (4, 8, 2) for H <= 128, 96 weights a
// lane in registers each.
#define RTVC_ROWS_CASE(KERNEL, L, KI, C)                              \
  if (p.lanes == L && p.chunks == KI && p.cluster == C)               \
    return launch_rows(KERNEL<L, KI, C, S>, p, st, RTVC_ROWS_ARGS);
#define RTVC_ROWS_CASES(KERNEL) \
  RTVC_ROWS_CASE(KERNEL, 2, 8, 1) \
  RTVC_ROWS_CASE(KERNEL, 4, 8, 2)

template <typename S>
int gru_rows_fwd(const S* xg, const S* w_hh, const S* b_hh, S* ys, S* gates, int B, int T,
                 int H, const int* plan_v, void* stream) {
  const RowPlan p{plan_v[0], plan_v[1], plan_v[2], plan_v[3], plan_v[4], plan_v[5]};
  if (T < 1 || !row_plan_ok(p, B, H, false, (int)sizeof(S))) return (int)cudaErrorInvalidValue;
  const bool vec = (3 * H * (int)sizeof(S)) % 16 == 0 && aligned16(xg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RTVC_ROWS_ARGS xg, w_hh, b_hh, ys, gates, T, H, vec
  RTVC_ROWS_CASES(gru_rows_kernel)
#undef RTVC_ROWS_ARGS
  return (int)cudaErrorInvalidValue;
}

template <typename S>
int gru_rows_bwd(const S* dys, const S* gates, const S* ys, const S* w_hh, float* dxg,
                 float* dhg, int B, int T, int H, const int* plan_v, void* stream) {
  const RowPlan p{plan_v[0], plan_v[1], plan_v[2], plan_v[3], plan_v[4], plan_v[5]};
  if (T < 1 || !row_plan_ok(p, B, H, true, (int)sizeof(S))) return (int)cudaErrorInvalidValue;
  const bool vec = (H * (int)sizeof(S)) % 16 == 0 && aligned16(dys) && aligned16(gates) &&
                   aligned16(ys);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RTVC_ROWS_ARGS dys, gates, ys, w_hh, dxg, dhg, T, H, vec
  RTVC_ROWS_CASES(gru_rows_bwd_kernel)
#undef RTVC_ROWS_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define RTVC_GRU_CASE(KERNEL, UNITS, NB)                                      \
  if (plan.units == UNITS && plan.nb == NB)                                   \
    return launch(KERNEL<UNITS, NB, S>, plan, args, static_cast<cudaStream_t>(stream));

namespace {

template <typename S>
int gru_fwd(const S* xg, const S* w_hh, const S* b_hh, S* ys, S* gates, float* hx, int B,
            int T, int H, const int* plan_v, unsigned int* sync, void* stream) {
  const Plan plan = rtvc::seq_plan(plan_v);
  if (!rtvc::seq_plan_ok(plan, B, H, 3 * plan.units, (H + 3) & ~3, 3 * plan.units,
                         (int)sizeof(S)))
    return (int)cudaErrorInvalidValue;
  int slices = plan.slices, rows = plan.rows;
  void* args[] = {&xg, &w_hh, &b_hh, &ys, &gates, &hx, &B, &T, &H, &slices, &rows, &sync};
  RTVC_GRU_CASE(gru_seq_kernel, 1, 1)
  RTVC_GRU_CASE(gru_seq_kernel, 1, 3)
  RTVC_GRU_CASE(gru_seq_kernel, 1, 5)
  RTVC_GRU_CASE(gru_seq_kernel, 2, 1)
  RTVC_GRU_CASE(gru_seq_kernel, 2, 3)
  RTVC_GRU_CASE(gru_seq_kernel, 2, 5)
  RTVC_GRU_CASE(gru_seq_kernel, 4, 1)
  RTVC_GRU_CASE(gru_seq_kernel, 4, 3)
  RTVC_GRU_CASE(gru_seq_kernel, 4, 5)
  RTVC_GRU_CASE(gru_seq_kernel, 8, 1)
  RTVC_GRU_CASE(gru_seq_kernel, 8, 3)
  return (int)cudaErrorInvalidValue;
}

template <typename S>
int gru_bwd(const S* dys, const S* gates, const S* ys, const S* w_hh, float* dxg, float* dhg,
            float* carry, int B, int T, int H, const int* plan_v, unsigned int* sync,
            void* stream) {
  const Plan plan = rtvc::seq_plan(plan_v);
  if (!rtvc::seq_plan_ok(plan, B, H, plan.units, 3 * H, 0, (int)sizeof(S)))
    return (int)cudaErrorInvalidValue;
  int slices = plan.slices, rows = plan.rows;
  void* args[] = {&dys, &gates, &ys, &w_hh, &dxg, &dhg, &carry,
                  &B,   &T,     &H,  &slices, &rows, &sync};
  RTVC_GRU_CASE(gru_seq_bwd_kernel, 2, 1)
  RTVC_GRU_CASE(gru_seq_bwd_kernel, 2, 3)
  RTVC_GRU_CASE(gru_seq_bwd_kernel, 2, 5)
  RTVC_GRU_CASE(gru_seq_bwd_kernel, 4, 1)
  RTVC_GRU_CASE(gru_seq_bwd_kernel, 4, 3)
  RTVC_GRU_CASE(gru_seq_bwd_kernel, 4, 5)
  RTVC_GRU_CASE(gru_seq_bwd_kernel, 8, 1)
  RTVC_GRU_CASE(gru_seq_bwd_kernel, 8, 3)
  RTVC_GRU_CASE(gru_seq_bwd_kernel, 8, 5)
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xg (B, T, 3H) with b_ih folded in, w_hh (3H, H) in torch layout, b_hh (3H)
// → from a zero state: ys (B, T, H) and gates (B, T, 4H) = [r, z, n, hn]. All
// f32, contiguous, on the current device. plan_v = {groups, slices, units,
// nb, rows, smem} from ops/gru_seq.py:plan; sync is 32 zeroed words per
// group. Returns the launch's cudaError_t (cudaErrorInvalidValue for a plan
// that does not cover the shape or has no instantiation).
extern "C" int rtvc_gru_seq_fwd(const float* xg, const float* w_hh, const float* b_hh,
                                float* ys, float* gates, int B, int T, int H,
                                const int* plan_v, unsigned int* sync, void* stream) {
  return gru_fwd<float>(xg, w_hh, b_hh, ys, gates, nullptr, B, T, H, plan_v, sync, stream);
}

// The bf16 instantiation: every argument bf16 but hx, (2, B, H) f32 scratch
// for the carried h. The plan's smem counts W_hh at two bytes a weight.
extern "C" int rtvc_gru_seq_fwd_bf16(const bf16* xg, const bf16* w_hh, const bf16* b_hh,
                                     bf16* ys, bf16* gates, float* hx, int B, int T, int H,
                                     const int* plan_v, unsigned int* sync, void* stream) {
  return gru_fwd<bf16>(xg, w_hh, b_hh, ys, gates, hx, B, T, H, plan_v, sync, stream);
}

// dys (B, T, H), the forward's gates (B, T, 4H) and ys (B, T, H), w_hh (3H, H)
// in torch layout → dxg (B, T, 3H), the cotangent of the input gates
// [r, z, n], and dhg (B, T, 3H) = [dr, dz, dn·r], that of the hidden-side
// pre-activations; carry is (B, H) scratch. All f32, contiguous. plan_v and
// sync as for the forward. Returns the launch's cudaError_t.
extern "C" int rtvc_gru_seq_bwd(const float* dys, const float* gates, const float* ys,
                                const float* w_hh, float* dxg, float* dhg, float* carry,
                                int B, int T, int H, const int* plan_v, unsigned int* sync,
                                void* stream) {
  return gru_bwd<float>(dys, gates, ys, w_hh, dxg, dhg, carry, B, T, H, plan_v, sync, stream);
}

// The bf16 instantiation: dys, gates, ys and w_hh bf16; dxg, dhg and carry f32
// (the JAX kernel's dxg is f32: the weight gradients are taken from it before
// it is rounded).
extern "C" int rtvc_gru_seq_bwd_bf16(const bf16* dys, const bf16* gates, const bf16* ys,
                                     const bf16* w_hh, float* dxg, float* dhg, float* carry,
                                     int B, int T, int H, const int* plan_v,
                                     unsigned int* sync, void* stream) {
  return gru_bwd<bf16>(dys, gates, ys, w_hh, dxg, dhg, carry, B, T, H, plan_v, sync, stream);
}

// The row-resident mode, same arguments and outputs as rtvc_gru_seq_fwd
// without the barrier counters: plan_v = {ctas, lanes, chunks, cluster,
// threads, smem} from ops/gru_seq.py:row_plan. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a plan that does not cover the shape
// or has no instantiation).
extern "C" int rtvc_gru_rows_fwd(const float* xg, const float* w_hh, const float* b_hh,
                                 float* ys, float* gates, int B, int T, int H,
                                 const int* plan_v, void* stream) {
  return gru_rows_fwd<float>(xg, w_hh, b_hh, ys, gates, B, T, H, plan_v, stream);
}

// The bf16 instantiation: every argument bf16; the carried h stays f32 on chip.
extern "C" int rtvc_gru_rows_fwd_bf16(const bf16* xg, const bf16* w_hh, const bf16* b_hh,
                                      bf16* ys, bf16* gates, int B, int T, int H,
                                      const int* plan_v, void* stream) {
  return gru_rows_fwd<bf16>(xg, w_hh, b_hh, ys, gates, B, T, H, plan_v, stream);
}

// Same arguments and outputs as rtvc_gru_seq_bwd without the carry and the
// counters (the carry stays on chip); plan_v as for the forward.
extern "C" int rtvc_gru_rows_bwd(const float* dys, const float* gates, const float* ys,
                                 const float* w_hh, float* dxg, float* dhg, int B, int T, int H,
                                 const int* plan_v, void* stream) {
  return gru_rows_bwd<float>(dys, gates, ys, w_hh, dxg, dhg, B, T, H, plan_v, stream);
}

// The bf16 instantiation: dys, gates, ys and w_hh bf16; dxg and dhg f32.
extern "C" int rtvc_gru_rows_bwd_bf16(const bf16* dys, const bf16* gates, const bf16* ys,
                                      const bf16* w_hh, float* dxg, float* dhg, int B, int T,
                                      int H, const int* plan_v, void* stream) {
  return gru_rows_bwd<bf16>(dys, gates, ys, w_hh, dxg, dhg, B, T, H, plan_v, stream);
}
