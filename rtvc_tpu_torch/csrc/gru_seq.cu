// GRU sequence over hoisted input gates, forward and backward (torch
// semantics: the hidden-side bias b_hn sits inside the reset product).
//
// Replaces: rtvc_tpu/ops/pallas/gru_train_kernel.py:gru_seq_fused, both
// halves (_fwd_kernel and _bwd_kernel), which run the teacher-forced GRUs of
// WaveRNN training on the TPU (runtimeracer: four GRUs of H = 256 over
// seq_len = 1000 samples at batch 40).
//
// What bounds it on the H100: every step multiplies W_hh (3H x H f32, 786 KB
// at H = 256) by one vector per batch row: h in the forward, the hidden-side
// gate cotangent dhg in the backward. W_hh is larger than one SM's 227 KB of
// shared memory, so it cannot stay on chip; at 2 FLOP per 4 bytes the step
// is bound by how fast one SM streams W_hh out of the 50 MB L2, plus the two
// block barriers of every step (T = 1000 steps run strictly in order).
//
// Design: one CTA per batch row runs the whole sequence in one launch; the
// state and the step's gate vector live in shared memory; W_hh is re-read
// through L2 every step by warps that each own four rows at a time with
// 16-byte loads (common.cuh:matvec). At batch 40 this uses 40 of the 132
// SMs. Next step, not taken here: one CTA that applies each weight row to
// several batch rows (matvec<NB>, as tacotron_decode.cu does), which divides
// the L2 traffic by the rows per CTA, or W_hh's rows split over a cluster of
// CTAs whose shared memory holds it whole (4 x 197 KB), with a cluster
// barrier per step.
//
// The backward's carry needs dh·z + dhg · W_hh, the transpose of the
// forward's product. The kernel reads it from a one-off transposed copy
// W_hhᵀ (H x 3H, contiguous) that the wrapper makes once per backward call
// (ops/gru_seq.py). dW_hh and db_hh are batched reductions over (B·T) and
// stay outside the kernel, as in the JAX package.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(1024)
gru_seq_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, float* __restrict__ ys,
               float* __restrict__ gates, int T, int H) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* h = sm;        // H
  float* hg = sm + H;   // 3H: h · W_hhᵀ + b_hh
  const int b = blockIdx.x;
  const int G = 3 * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) h[j] = 0.0f;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const size_t bt = (size_t)b * T + t;
    rtvc::matvec<1>(w_hh, H, G, h, 0, H, 1, hg, 0, b_hh, nullptr, 0, false, rtvc::kNone);
    __syncthreads();
    const float* xt = xg + bt * G;
    float* gt = gates + bt * 4 * H;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float r = rtvc::sigmoidf_(xt[j] + hg[j]);
      const float z = rtvc::sigmoidf_(xt[H + j] + hg[H + j]);
      const float hn = hg[2 * H + j];
      const float n = tanhf(xt[2 * H + j] + r * hn);
      const float hj = (1.0f - z) * n + z * h[j];
      h[j] = hj;
      ys[bt * H + j] = hj;
      gt[j] = r;
      gt[H + j] = z;
      gt[2 * H + j] = n;
      gt[3 * H + j] = hn;
    }
    __syncthreads();
  }
}

// Reverse walk carrying dh, the math of gru_train_kernel.py:122-142.
// h_{t-1} is read from ys one step back, and is zero at t = 0.
__global__ void __launch_bounds__(1024)
gru_seq_bwd_kernel(const float* __restrict__ dys, const float* __restrict__ gates,
                   const float* __restrict__ ys, const float* __restrict__ w_hh_t,
                   float* __restrict__ dxg, int T, int H) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* dh = sm;        // H: the carry from step t+1
  float* dhg = sm + H;   // 3H: [dr, dz, dn·r], the hidden-side gate cotangent
  const int b = blockIdx.x;
  const int G = 3 * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) dh[j] = 0.0f;
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const size_t bt = (size_t)b * T + t;
    const float* gt = gates + bt * 4 * H;
    float* dxt = dxg + bt * G;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float r = gt[j];
      const float z = gt[H + j];
      const float n = gt[2 * H + j];
      const float hn = gt[3 * H + j];
      const float h_prev = t > 0 ? ys[(bt - 1) * H + j] : 0.0f;
      const float dhj = dys[bt * H + j] + dh[j];
      const float dz = dhj * (h_prev - n) * z * (1.0f - z);
      const float dn = dhj * (1.0f - z) * (1.0f - n * n);
      const float dr = dn * hn * r * (1.0f - r);
      dxt[j] = dr;
      dxt[H + j] = dz;
      dxt[2 * H + j] = dn;
      dhg[j] = dr;
      dhg[H + j] = dz;
      dhg[2 * H + j] = dn * r;
      dh[j] = dhj * z;  // the direct path; the matvec below adds dhg · W_hh
    }
    __syncthreads();
    rtvc::matvec<1>(w_hh_t, G, H, dhg, 0, G, 1, dh, 0, nullptr, nullptr, 0, true,
                    rtvc::kNone);
    __syncthreads();
  }
}

}  // namespace

// xg (B, T, 3H) with b_ih folded in, w_hh (3H, H) in torch layout, b_hh (3H)
// → from a zero state: ys (B, T, H) and gates (B, T, 4H) = [r, z, n, hn].
// All f32, contiguous, on the current device. Returns the launch's
// cudaError_t.
extern "C" int rtvc_gru_seq_fwd(const float* xg, const float* w_hh, const float* b_hh,
                                float* ys, float* gates, int B, int T, int H,
                                void* stream) {
  const size_t smem = (size_t)4 * H * sizeof(float);
  cudaError_t e = rtvc::allow_smem((const void*)gru_seq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  gru_seq_kernel<<<B, 1024, smem, static_cast<cudaStream_t>(stream)>>>(xg, w_hh, b_hh, ys,
                                                                       gates, T, H);
  return (int)cudaGetLastError();
}

// dys (B, T, H), the forward's gates (B, T, 4H) and ys (B, T, H), w_hh_t
// (H, 3H) = W_hhᵀ contiguous → dxg (B, T, 3H), the cotangent of the input
// gates [r, z, n]. All f32, contiguous. Returns the launch's cudaError_t.
extern "C" int rtvc_gru_seq_bwd(const float* dys, const float* gates, const float* ys,
                                const float* w_hh_t, float* dxg, int B, int T, int H,
                                void* stream) {
  const size_t smem = (size_t)4 * H * sizeof(float);
  cudaError_t e = rtvc::allow_smem((const void*)gru_seq_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  gru_seq_bwd_kernel<<<B, 1024, smem, static_cast<cudaStream_t>(stream)>>>(dys, gates, ys,
                                                                           w_hh_t, dxg, T, H);
  return (int)cudaGetLastError();
}
