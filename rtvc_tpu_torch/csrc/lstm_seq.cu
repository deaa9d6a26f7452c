// LSTM sequence forward over hoisted input gates.
//
// Replaces: rtvc_tpu/ops/pallas/lstm_train_kernel.py:lstm_seq_fused (forward
// half, _fwd_kernel), which runs the speaker encoder's 3 x LSTM-768 over
// 160-frame partials on the TPU.
//
// What bounds it on the H100: every step multiplies W_hh (4H x H f32, 9.4 MB
// at H = 768) by one hidden vector per batch row. That is 2 FLOP per 4 bytes
// read, far below the card's balance point, so the step is bound by how fast
// one SM can stream W_hh out of the 50 MB L2, where it stays resident after
// the first step.
//
// Design: one CTA per batch row runs the whole sequence in one launch (batch
// rows are independent recurrences). h, c and the 4H gate pre-activations
// live in shared memory; W_hh is re-read through L2 every step by warps that
// each own four gate rows at a time with 16-byte loads (common.cuh:matvec),
// which keeps enough loads in flight to hide L2 latency. Splitting the gate
// rows of one batch row over several SMs (with a grid barrier per step) is
// the next step for speed; it is not done here.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(1024)
lstm_seq_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
                                const float* __restrict__ h0, const float* __restrict__ c0,
                                float* __restrict__ ys, float* __restrict__ hT,
                                float* __restrict__ cT, int T, int H) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* h = sm;           // H
  float* c = sm + H;       // H
  float* g = sm + 2 * H;   // 4H
  const int b = blockIdx.x;
  const int G = 4 * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    h[j] = h0[(size_t)b * H + j];
    c[j] = c0[(size_t)b * H + j];
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* xgt = xg + ((size_t)b * T + t) * G;
    // g = h · W_hhᵀ + xg_t   (both biases are folded into xg by the caller)
    rtvc::matvec<1>(w_hh, H, G, h, 0, H, 1, g, 0, nullptr, xgt, 0, false, rtvc::kNone);
    __syncthreads();
    float* yt = ys + ((size_t)b * T + t) * H;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float i_g = rtvc::sigmoidf_(g[j]);
      const float f_g = rtvc::sigmoidf_(g[H + j]);
      const float g_g = tanhf(g[2 * H + j]);
      const float o_g = rtvc::sigmoidf_(g[3 * H + j]);
      const float cj = f_g * c[j] + i_g * g_g;
      const float hj = o_g * tanhf(cj);
      c[j] = cj;
      h[j] = hj;
      yt[j] = hj;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    hT[(size_t)b * H + j] = h[j];
    cT[(size_t)b * H + j] = c[j];
  }
}

}  // namespace

// xg (B, T, 4H), w_hh (4H, H) in torch layout, h0/c0 (B, H) → ys (B, T, H),
// hT/cT (B, H). All f32, contiguous, on the current device. Returns the
// launch's cudaError_t.
extern "C" int rtvc_lstm_seq_fwd(const float* xg, const float* w_hh, const float* h0,
                                 const float* c0, float* ys, float* hT, float* cT, int B,
                                 int T, int H, void* stream) {
  const size_t smem = (size_t)6 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lstm_seq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lstm_seq_kernel<<<B, 1024, smem, static_cast<cudaStream_t>(stream)>>>(xg, w_hh, h0, c0, ys,
                                                                        hT, cT, T, H);
  return (int)cudaGetLastError();
}
