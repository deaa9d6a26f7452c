// LSTM sequence over hoisted input gates: forward (with optional training
// residuals) and backward, with W_hh resident in shared memory across the card.
//
// Replaces: rtvc_tpu/ops/pallas/lstm_train_kernel.py:lstm_seq_fused, both
// halves (_fwd_kernel :115 and _bwd_kernel :158), which run the speaker
// encoder's 3 x LSTM-768 over 160-frame partials on the TPU.
//
// What bounds it on the H100: the recurrent product, h · W_hhᵀ in the forward
// and dxg · W_hh in the backward, is 2 · 4H · H f32 operations per batch row
// and step. At the training batch (640 rows) that is the card's f32 rate; at
// the inference batch (8 rows) a step is a few hundred thousand operations per
// SM and its time is the grid barrier plus one round trip to L2. W_hh (9.4 MB
// at H = 768) does not fit in one SM, and re-reading it from L2 every step, as
// one CTA per batch row must, holds a step at 120 µs whatever the batch. With
// the weights resident, what is left at 640 rows is, in this order
// (profile_lstm.py takes the parts away one at a time): the rate at which the
// FMAs go out with the sums over the lanes and the cell update around them, the
// weights' way from shared memory into registers (16 bytes a lane feed 16
// FMAs), and in the backward the 12 KB of dxg per batch row that every CTA of
// a group reads from L2 each step.
//
// Design (the persistent RNN of Diamos et al., 2016): the weights stop moving.
// The grid is `groups` x `slices` CTAs, all resident at once (a cooperative
// launch). A CTA owns U hidden units for the whole sequence and a contiguous
// group of batch rows. It loads its part of W_hh from device memory once:
// the forward the 4U rows that make its units' i, f, g, o gates, the backward
// its U columns (as rows of W_hhᵀ, which it gathers itself). Every step, a
// warp takes NB batch rows at a time: its lanes split the reduction axis (H
// in the forward, 4H in the backward), read the rows' vectors straight from L2
// with 16-byte loads, one piece ahead of the arithmetic, and multiply them with
// the weights in shared memory; the (weight rows x NB) partial sums of the 32 lanes
// are summed by a transposing butterfly (common.cuh:warp_transpose_sum); then
// the lanes apply the cell update to the warp's (row, unit) pairs, whose
// inputs they fetched before the product. The forward writes its slice of
// ys[:, t], which is the h that every CTA of the group reads in the next step;
// the backward writes its slice of dxg[:, t], and the next step forms
// dh = dxg_t · W_hh from the whole of it. One grid barrier per batch group
// separates the steps (common.cuh:grid_barrier). The cell state c (forward)
// and its cotangent dc (backward) of a (row, unit) pair are touched by one
// lane only and live in the cT and dc0 outputs between steps.
//
// The partition (groups, slices, U, NB, shared-memory bytes) is computed by
// the wrapper (ops/lstm_seq.py:plan); the entry points check it and pick the
// instantiation. No sum goes through an atomic, so two runs give equal bits.
// The weight gradient Σ_t h_{t-1}ᵀ · dxg_t is a batched reduction over (B·T)
// and stays outside the kernel, as in the JAX package. The backward walks
// exactly t = T-1 … 0; there are no pad steps (the TPU kernel pads T to its
// time tile and neutralises the pad steps).
//
// The bf16 instantiation (the bf16 training policy, ops/precision.py) keeps
// the JAX kernel's contract under that policy: xg, W_hh, ys and the
// residuals cs and gates are bf16, the arithmetic and the carried h and c are
// f32 (lstm_train_kernel.py:222-223), and the backward reads the bf16
// residuals and writes an f32 dxg, from which the weight gradient is taken
// before it is rounded (:185, :381). W_hh stays resident at two bytes a
// weight, widened at use (common.cuh:load_w4), which halves the shared
// memory a slice takes. A bf16 ys would round the recurrence's state every
// step if the next step read it, as the f32 kernel reads ys: the carried h
// goes between CTAs through an f32 buffer of two (B, H) slots instead. Its
// bound is its bf16 bytes and its products at the tensor cores' bf16 rate;
// the product here still runs as f32 FMAs on the CUDA cores, with a
// conversion a weight (PERF.md section 6 has its time beside the f32
// kernel's).
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
using rtvc::round_as;
using rtvc::to_f;

// S is the streams' element type (f32, or bf16 under the bf16 policy, where
// W_hh is held in bf16 too). With bf16 streams the carried h goes between
// CTAs through `hx`, an f32 buffer of two (B, H) slots (step t writes slot
// t & 1 and reads slot (t - 1) & 1; the barrier between steps keeps the
// slots apart), so the recurrence never rounds its state; ys is written in
// bf16 beside it. With f32 streams h is read from ys itself and hx is null.
template <int U, int NB, typename S>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_kernel(const S* __restrict__ xg, const S* __restrict__ w_hh,
                const float* __restrict__ h0, const float* __restrict__ c0, S* ys,
                float* hT, float* cT, S* __restrict__ cs, S* __restrict__ gates, float* hx,
                int B, int T, int H, int slices, int rows, unsigned int* sync) {
  constexpr int R = 4 * U;                       // gate rows of W_hh a CTA holds
  constexpr int PP = (U * NB + 31) / 32;         // (row, unit) pairs a lane updates
  constexpr bool kF32 = std::is_same<S, float>::value;
  extern __shared__ float4 smem4[];
  S* W = reinterpret_cast<S*>(smem4);            // R x ld, row gate * U + j
  const int ld = (H + 3) & ~3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* out = reinterpret_cast<float*>(W + R * ld) + warp * padded(R * NB);
  const Part p = partition(U, B, H, slices, rows, sync);
  const int G = 4 * H;
  for (int i = threadIdx.x; i < R * ld; i += kThreads) {
    const int r = i / ld, k = i % ld, gate = r / U, j = r % U;
    W[i] = (j < p.nu && k < H) ? w_hh[(size_t)(gate * H + p.u0 + j) * H + k] : from_f<S>(0.0f);
  }
  __syncthreads();
  const bool vec = (H & 3) == 0;
  for (int t = 0; t < T; ++t) {
    const float* hprev;
    size_t hs;
    if (t == 0) {
      hprev = h0;
      hs = H;
    } else if constexpr (kF32) {
      hprev = ys + (size_t)(t - 1) * H;
      hs = (size_t)T * H;
    } else {
      hprev = hx + (size_t)((t - 1) & 1) * B * H;
      hs = H;
    }
    float* hnext = kF32 ? nullptr : hx + (size_t)(t & 1) * B * H;
    for (int b0 = p.b_lo + warp * NB; b0 < p.b_hi; b0 += kWarps * NB) {
      const int nb = min(NB, p.b_hi - b0);
      // this lane's pairs: their input gates and previous cell, fetched
      // before the product that they do not depend on
      float x_in[PP][4], c_prev[PP];
#pragma unroll
      for (int q = 0; q < PP; ++q) {
        const int pair = lane + 32 * q, j = pair / NB, b = pair % NB;
        if (j < p.nu && b < nb) {
          const size_t row = (size_t)(b0 + b), col = p.u0 + j;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            x_in[q][gate] = to_f(xg[(row * T + t) * G + gate * H + col]);
          c_prev[q] = t == 0 ? c0[row * H + col] : cT[row * H + col];
        }
      }
      slice_product<R, NB>(W, ld, H, hprev + (size_t)b0 * hs, hs, nb, vec, out);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < PP; ++q) {
        const int pair = lane + 32 * q, j = pair / NB, b = pair % NB;
        if (j < p.nu && b < nb) {
          const size_t row = (size_t)(b0 + b), col = p.u0 + j, bt = row * T + t;
          const float i_g = rtvc::sigmoidf_(out[(0 * U + j) * NB + b] + x_in[q][0]);
          const float f_g = rtvc::sigmoidf_(out[(1 * U + j) * NB + b] + x_in[q][1]);
          const float g_g = tanhf(out[(2 * U + j) * NB + b] + x_in[q][2]);
          const float o_g = rtvc::sigmoidf_(out[(3 * U + j) * NB + b] + x_in[q][3]);
          const float c = f_g * c_prev[q] + i_g * g_g;
          const float h = o_g * tanhf(c);
          ys[bt * H + col] = from_f<S>(h);
          if (!kF32) hnext[row * H + col] = h;
          cT[row * H + col] = c;
          if (t == T - 1) hT[row * H + col] = h;
          if (cs) {  // training residuals: the cell and the activated gates
            cs[bt * H + col] = from_f<S>(c);
            S* gt = gates + bt * G + col;
            gt[0] = from_f<S>(i_g);
            gt[H] = from_f<S>(f_g);
            gt[2 * H] = from_f<S>(g_g);
            gt[3 * H] = from_f<S>(o_g);
          }
        }
      }
      __syncwarp();
    }
    if (t + 1 < T) rtvc::grid_barrier(p.counter, p.slices * (unsigned int)(t + 1));
  }
}

// Reverse walk carrying (dh, dc), the math of lstm_train_kernel.py:172-191.
// c_{t-1} is read from cs one step back, and from c0 at t = 0 (rounded as
// cs is, as the JAX package stacks it with cs). With bf16 streams the
// residuals and W_hh are bf16, widened at use; dxg is f32 in both
// instantiations, as the JAX kernel writes it, and the dh chain reads the
// whole of the step before from it.
template <int U, int NB, typename S>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_bwd_kernel(const S* __restrict__ dys, const float* __restrict__ dhT,
                    const float* __restrict__ dcT, const S* __restrict__ gates,
                    const S* __restrict__ cs, const float* __restrict__ c0,
                    const S* __restrict__ w_hh, float* dxg, float* dh0, float* dc0,
                    int B, int T, int H, int slices, int rows, unsigned int* sync) {
  constexpr int PP = (U * NB + 31) / 32;
  extern __shared__ float4 smem4[];
  S* W = reinterpret_cast<S*>(smem4);            // U x 4H: the CTA's columns of W_hh
  const int G = 4 * H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* out = reinterpret_cast<float*>(W + U * G) + warp * padded(U * NB);
  const Part p = partition(U, B, H, slices, rows, sync);
  for (int i = threadIdx.x; i < U * G; i += kThreads) {
    const int r = i / U, j = i % U;  // neighbouring threads read neighbouring columns
    W[j * G + r] = j < p.nu ? w_hh[(size_t)r * H + p.u0 + j] : from_f<S>(0.0f);
  }
  __syncthreads();
  const size_t xs = (size_t)T * G;
  for (int t = T - 1; t >= 0; --t) {
    for (int b0 = p.b_lo + warp * NB; b0 < p.b_hi; b0 += kWarps * NB) {
      const int nb = min(NB, p.b_hi - b0);
      float gt[PP][4], c[PP], c_prev[PP], dy[PP], dc[PP];
#pragma unroll
      for (int q = 0; q < PP; ++q) {
        const int pair = lane + 32 * q, j = pair / NB, b = pair % NB;
        if (j < p.nu && b < nb) {
          const size_t row = (size_t)(b0 + b), col = p.u0 + j, bt = row * T + t;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            gt[q][gate] = to_f(gates[bt * G + gate * H + col]);
          c[q] = to_f(cs[bt * H + col]);
          c_prev[q] = t > 0 ? to_f(cs[(bt - 1) * H + col]) : round_as<S>(c0[row * H + col]);
          dy[q] = to_f(dys[bt * H + col]);
          dc[q] = t == T - 1 ? dcT[row * H + col] : dc0[row * H + col];
        }
      }
      // dh_t = dxg_{t+1} · W_hh, from the whole of the step before
      if (t < T - 1) {
        slice_product<U, NB>(W, G, G, dxg + ((size_t)b0 * T + t + 1) * G, xs, nb, true, out);
        __syncwarp();
      }
#pragma unroll
      for (int q = 0; q < PP; ++q) {
        const int pair = lane + 32 * q, j = pair / NB, b = pair % NB;
        if (j < p.nu && b < nb) {
          const size_t row = (size_t)(b0 + b), col = p.u0 + j, bt = row * T + t;
          const float i_g = gt[q][0], f_g = gt[q][1], g_g = gt[q][2], o_g = gt[q][3];
          const float tanhc = tanhf(c[q]);
          const float dhj = dy[q] + (t == T - 1 ? dhT[row * H + col] : out[j * NB + b]);
          const float d_o = dhj * tanhc * o_g * (1.0f - o_g);
          const float dcj = dc[q] + dhj * o_g * (1.0f - tanhc * tanhc);
          float* dxt = dxg + bt * G + col;
          dxt[0] = dcj * g_g * i_g * (1.0f - i_g);
          dxt[H] = dcj * c_prev[q] * f_g * (1.0f - f_g);
          dxt[2 * H] = dcj * i_g * (1.0f - g_g * g_g);
          dxt[3 * H] = d_o;
          dc0[row * H + col] = dcj * f_g;
        }
      }
      __syncwarp();
    }
    rtvc::grid_barrier(p.counter, p.slices * (unsigned int)(T - t));
  }
  // dh0 = dxg_0 · W_hh
  for (int b0 = p.b_lo + warp * NB; b0 < p.b_hi; b0 += kWarps * NB) {
    const int nb = min(NB, p.b_hi - b0);
    slice_product<U, NB>(W, G, G, dxg + (size_t)b0 * T * G, xs, nb, true, out);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < PP; ++q) {
      const int pair = lane + 32 * q, j = pair / NB, b = pair % NB;
      if (j < p.nu && b < nb) dh0[(size_t)(b0 + b) * H + p.u0 + j] = out[j * NB + b];
    }
    __syncwarp();
  }
}

// `steps` grid barriers and nothing else: what a step of a persistent
// recurrence pays before it does any work.
__global__ void __launch_bounds__(kThreads, 1)
barrier_steps_kernel(unsigned int* sync, int steps) {
  for (int t = 0; t < steps; ++t)
    rtvc::grid_barrier(sync, gridDim.x * (unsigned int)(t + 1));
}

using Plan = rtvc::SeqPlan;

template <typename Kernel>
int launch(Kernel kernel, const Plan& plan, void** args, cudaStream_t stream) {
  return rtvc::launch_cooperative(kernel, plan.groups * plan.slices, plan.smem, args, stream);
}

}  // namespace

// out[0] = SMs of the current device, out[1] = the most shared memory a block
// may opt in to, in bytes. Returns a cudaError_t.
extern "C" int rtvc_device_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// `steps` barriers over a grid of `ctas` CTAs; sync is one zeroed word.
extern "C" int rtvc_grid_barrier_steps(unsigned int* sync, int ctas, int steps, void* stream) {
  void* args[] = {&sync, &steps};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)barrier_steps_kernel, dim3(ctas),
                                              dim3(kThreads), args, 0,
                                              static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

#define RTVC_LSTM_CASE(KERNEL, UNITS, NB)                                     \
  if (plan.units == UNITS && plan.nb == NB)                                   \
    return launch(KERNEL<UNITS, NB, S>, plan, args, static_cast<cudaStream_t>(stream));

namespace {

template <typename S>
int lstm_fwd(const S* xg, const S* w_hh, const float* h0, const float* c0, S* ys, float* hT,
             float* cT, S* cs, S* gates, float* hx, int B, int T, int H, const int* plan_v,
             unsigned int* sync, void* stream) {
  const Plan plan = rtvc::seq_plan(plan_v);
  if (!rtvc::seq_plan_ok(plan, B, H, 4 * plan.units, (H + 3) & ~3, 0, (int)sizeof(S)))
    return (int)cudaErrorInvalidValue;
  int slices = plan.slices, rows = plan.rows;
  void* args[] = {&xg, &w_hh, &h0, &c0, &ys, &hT, &cT, &cs, &gates, &hx,
                  &B,  &T,    &H,  &slices, &rows, &sync};
  RTVC_LSTM_CASE(lstm_seq_kernel, 6, 1)
  RTVC_LSTM_CASE(lstm_seq_kernel, 6, 4)
  RTVC_LSTM_CASE(lstm_seq_kernel, 10, 1)
  RTVC_LSTM_CASE(lstm_seq_kernel, 10, 2)
  return (int)cudaErrorInvalidValue;
}

template <typename S>
int lstm_bwd(const S* dys, const float* dhT, const float* dcT, const S* gates, const S* cs,
             const float* c0, const S* w_hh, float* dxg, float* dh0, float* dc0, int B, int T,
             int H, const int* plan_v, unsigned int* sync, void* stream) {
  const Plan plan = rtvc::seq_plan(plan_v);
  if (!rtvc::seq_plan_ok(plan, B, H, plan.units, 4 * H, 0, (int)sizeof(S)))
    return (int)cudaErrorInvalidValue;
  int slices = plan.slices, rows = plan.rows;
  void* args[] = {&dys, &dhT, &dcT, &gates, &cs, &c0, &w_hh, &dxg, &dh0, &dc0,
                  &B,   &T,   &H,   &slices, &rows, &sync};
  RTVC_LSTM_CASE(lstm_seq_bwd_kernel, 12, 1)
  RTVC_LSTM_CASE(lstm_seq_bwd_kernel, 12, 8)
  RTVC_LSTM_CASE(lstm_seq_bwd_kernel, 10, 1)
  RTVC_LSTM_CASE(lstm_seq_bwd_kernel, 10, 8)
  RTVC_LSTM_CASE(lstm_seq_bwd_kernel, 4, 1)
  RTVC_LSTM_CASE(lstm_seq_bwd_kernel, 4, 2)
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xg (B, T, 4H), w_hh (4H, H) in torch layout, h0/c0 (B, H) → ys (B, T, H),
// hT/cT (B, H), and, when cs is not null, the training residuals cs (B, T, H)
// and gates (B, T, 4H) = [i, f, g, o] after their nonlinearities. All f32,
// contiguous, on the current device. plan_v = {groups, slices, units, nb,
// rows, smem} from ops/lstm_seq.py:plan; sync is 32 zeroed words per group.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a plan that
// does not cover the shape or has no instantiation).
extern "C" int rtvc_lstm_seq_fwd(const float* xg, const float* w_hh, const float* h0,
                                 const float* c0, float* ys, float* hT, float* cT,
                                 float* cs, float* gates, int B, int T, int H,
                                 const int* plan_v, unsigned int* sync, void* stream) {
  return lstm_fwd<float>(xg, w_hh, h0, c0, ys, hT, cT, cs, gates, nullptr, B, T, H, plan_v,
                         sync, stream);
}

// The bf16 instantiation: xg, w_hh, ys, cs and gates bf16; h0, c0, hT and cT
// f32, and hx (2, B, H) f32 scratch for the carried h. The plan's smem counts
// W_hh at two bytes a weight.
extern "C" int rtvc_lstm_seq_fwd_bf16(const bf16* xg, const bf16* w_hh, const float* h0,
                                      const float* c0, bf16* ys, float* hT, float* cT,
                                      bf16* cs, bf16* gates, float* hx, int B, int T, int H,
                                      const int* plan_v, unsigned int* sync, void* stream) {
  return lstm_fwd<bf16>(xg, w_hh, h0, c0, ys, hT, cT, cs, gates, hx, B, T, H, plan_v, sync,
                        stream);
}

// dys (B, T, H), dhT/dcT (B, H), the forward's residuals gates (B, T, 4H) and
// cs (B, T, H), c0 (B, H), w_hh (4H, H) → dxg (B, T, 4H), dh0/dc0 (B, H). All
// f32, contiguous. plan_v and sync as for the forward. Returns the launch's
// cudaError_t.
extern "C" int rtvc_lstm_seq_bwd(const float* dys, const float* dhT, const float* dcT,
                                 const float* gates, const float* cs, const float* c0,
                                 const float* w_hh, float* dxg, float* dh0, float* dc0,
                                 int B, int T, int H, const int* plan_v, unsigned int* sync,
                                 void* stream) {
  return lstm_bwd<float>(dys, dhT, dcT, gates, cs, c0, w_hh, dxg, dh0, dc0, B, T, H, plan_v,
                         sync, stream);
}

// The bf16 instantiation: dys, gates, cs and w_hh bf16; dhT, dcT, c0, dxg,
// dh0 and dc0 f32 (the JAX kernel's dxg is f32: the weight gradient is
// taken from it before it is rounded).
extern "C" int rtvc_lstm_seq_bwd_bf16(const bf16* dys, const float* dhT, const float* dcT,
                                      const bf16* gates, const bf16* cs, const float* c0,
                                      const bf16* w_hh, float* dxg, float* dh0, float* dc0,
                                      int B, int T, int H, const int* plan_v,
                                      unsigned int* sync, void* stream) {
  return lstm_bwd<bf16>(dys, dhT, dcT, gates, cs, c0, w_hh, dxg, dh0, dc0, B, T, H, plan_v,
                        sync, stream);
}
