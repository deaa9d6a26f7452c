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
