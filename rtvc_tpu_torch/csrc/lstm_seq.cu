// LSTM sequence over hoisted input gates: forward (with optional training
// residuals) and backward.
//
// Replaces: rtvc_tpu/ops/pallas/lstm_train_kernel.py:lstm_seq_fused, both
// halves (_fwd_kernel and _bwd_kernel), which run the speaker encoder's
// 3 x LSTM-768 over 160-frame partials on the TPU.
//
// What bounds it on the H100: every step multiplies W_hh (4H x H f32, 9.4 MB
// at H = 768) by one vector per batch row: h in the forward, dxg in the
// backward. That is 2 FLOP per 4 bytes read, far below the card's balance
// point, so a step is bound by how fast one SM can stream W_hh out of the
// 50 MB L2, where it stays resident after the first step.
//
// Design: one CTA per batch row runs the whole sequence in one launch (batch
// rows are independent recurrences). The state and the step's 4H gate
// vector live in shared memory; the weights are re-read through L2 every
// step by warps that each own four rows at a time with 16-byte loads
// (common.cuh:matvec), which keeps enough loads in flight to hide L2
// latency. At the training batch (640 rows) this is about five waves of 132
// SMs that each walk all T steps, with 132 CTAs streaming W_hh from L2 at
// once. Two next steps, neither taken here: let one CTA apply each weight
// row to several batch rows (matvec<NB>, as tacotron_decode.cu does), which
// divides the L2 traffic by the rows per CTA; and split the gate rows of
// one batch row over several SMs with a grid barrier per step.
//
// The backward's carry needs dh = dxg · W_hh, the transpose of the
// forward's product. The kernel reads it from a one-off transposed copy
// W_hhᵀ (H x 4H, contiguous) that the wrapper makes once per backward call
// (ops/lstm_seq.py), so the same row-streaming matvec serves both
// directions. The weight gradient Σ_t h_{t-1}ᵀ · dxg_t is a batched
// reduction over (B·T) and stays outside the kernel, as in the JAX package.
//
// The backward walks exactly t = T-1 … 0; there are no pad steps (the TPU
// kernel pads T to its time tile and neutralises the pad steps).
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(1024)
lstm_seq_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
                const float* __restrict__ h0, const float* __restrict__ c0,
                float* __restrict__ ys, float* __restrict__ hT,
                float* __restrict__ cT, float* __restrict__ cs,
                float* __restrict__ gates, int T, int H) {
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
    const size_t bt = (size_t)b * T + t;
    const float* xgt = xg + bt * G;
    // g = h · W_hhᵀ + xg_t   (both biases are folded into xg by the caller)
    rtvc::matvec<1>(w_hh, H, G, h, 0, H, 1, g, 0, nullptr, xgt, 0, false, rtvc::kNone);
    __syncthreads();
    float* yt = ys + bt * H;
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
      if (cs) {  // training residuals: the cell and the activated gates
        cs[bt * H + j] = cj;
        float* gt = gates + bt * G;
        gt[j] = i_g;
        gt[H + j] = f_g;
        gt[2 * H + j] = g_g;
        gt[3 * H + j] = o_g;
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    hT[(size_t)b * H + j] = h[j];
    cT[(size_t)b * H + j] = c[j];
  }
}

// Reverse walk carrying (dh, dc), the math of lstm_train_kernel.py:172-191.
// c_{t-1} is read from cs one step back, and from c0 at t = 0.
__global__ void __launch_bounds__(1024)
lstm_seq_bwd_kernel(const float* __restrict__ dys, const float* __restrict__ dhT,
                    const float* __restrict__ dcT, const float* __restrict__ gates,
                    const float* __restrict__ cs, const float* __restrict__ c0,
                    const float* __restrict__ w_hh_t, float* __restrict__ dxg,
                    float* __restrict__ dh0, float* __restrict__ dc0, int T, int H) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* dh = sm;          // H: the carry dh_{t} from step t+1
  float* dc = sm + H;      // H: the carry dc_{t} from step t+1
  float* dg = sm + 2 * H;  // 4H: this step's dxg
  const int b = blockIdx.x;
  const int G = 4 * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    dh[j] = dhT[(size_t)b * H + j];
    dc[j] = dcT[(size_t)b * H + j];
  }
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const size_t bt = (size_t)b * T + t;
    const float* gt = gates + bt * G;
    float* dxt = dxg + bt * G;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float i_g = gt[j];
      const float f_g = gt[H + j];
      const float g_g = gt[2 * H + j];
      const float o_g = gt[3 * H + j];
      const float c = cs[bt * H + j];
      const float c_prev = t > 0 ? cs[(bt - 1) * H + j] : c0[(size_t)b * H + j];
      const float tanhc = tanhf(c);
      const float dhj = dys[bt * H + j] + dh[j];
      const float d_o = dhj * tanhc * o_g * (1.0f - o_g);
      const float dcj = dc[j] + dhj * o_g * (1.0f - tanhc * tanhc);
      const float d_i = dcj * g_g * i_g * (1.0f - i_g);
      const float d_f = dcj * c_prev * f_g * (1.0f - f_g);
      const float d_g = dcj * i_g * (1.0f - g_g * g_g);
      dg[j] = d_i;
      dg[H + j] = d_f;
      dg[2 * H + j] = d_g;
      dg[3 * H + j] = d_o;
      dxt[j] = d_i;
      dxt[H + j] = d_f;
      dxt[2 * H + j] = d_g;
      dxt[3 * H + j] = d_o;
      dc[j] = dcj * f_g;
    }
    __syncthreads();
    // dh_{t-1} = dxg_t · W_hh, i.e. rows of W_hhᵀ against dxg_t
    rtvc::matvec<1>(w_hh_t, G, H, dg, 0, G, 1, dh, 0, nullptr, nullptr, 0, false,
                    rtvc::kNone);
    __syncthreads();
  }
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    dh0[(size_t)b * H + j] = dh[j];
    dc0[(size_t)b * H + j] = dc[j];
  }
}

}  // namespace

// xg (B, T, 4H), w_hh (4H, H) in torch layout, h0/c0 (B, H) → ys (B, T, H),
// hT/cT (B, H), and, when cs is not null, the training residuals cs (B, T, H)
// and gates (B, T, 4H) = [i, f, g, o] after their nonlinearities. All f32,
// contiguous, on the current device. Returns the launch's cudaError_t.
extern "C" int rtvc_lstm_seq_fwd(const float* xg, const float* w_hh, const float* h0,
                                 const float* c0, float* ys, float* hT, float* cT,
                                 float* cs, float* gates, int B, int T, int H,
                                 void* stream) {
  const size_t smem = (size_t)6 * H * sizeof(float);
  cudaError_t e = rtvc::allow_smem((const void*)lstm_seq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  lstm_seq_kernel<<<B, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
      xg, w_hh, h0, c0, ys, hT, cT, cs, gates, T, H);
  return (int)cudaGetLastError();
}

// dys (B, T, H), dhT/dcT (B, H), the forward's residuals gates (B, T, 4H) and
// cs (B, T, H), c0 (B, H), w_hh_t (H, 4H) = W_hhᵀ contiguous → dxg (B, T, 4H),
// dh0/dc0 (B, H). All f32, contiguous. Returns the launch's cudaError_t.
extern "C" int rtvc_lstm_seq_bwd(const float* dys, const float* dhT, const float* dcT,
                                 const float* gates, const float* cs, const float* c0,
                                 const float* w_hh_t, float* dxg, float* dh0, float* dc0,
                                 int B, int T, int H, void* stream) {
  const size_t smem = (size_t)6 * H * sizeof(float);
  cudaError_t e = rtvc::allow_smem((const void*)lstm_seq_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  lstm_seq_bwd_kernel<<<B, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
      dys, dhT, dcT, gates, cs, c0, w_hh_t, dxg, dh0, dc0, T, H);
  return (int)cudaGetLastError();
}
