// WaveRNN autoregressive sample loop, runtimeracer variant, RAW categorical
// head.
//
// Replaces: rtvc_tpu/ops/pallas/wavernn_kernel.py:generate_core_pallas
// (body _make_kernel), the whole per-sample loop of the vocoder.
//
// What bounds it on the H100: each step runs 4 GRUs (W_ih and W_hh of
// 768 x 256 each) and 5 FCs (256 x 256, then 256 x 1024 for the logits):
// about 2.1M weights, 8.4 MB in f32, read once per step per fold row for
// 2 FLOP per 4 bytes. That is far too large for one SM's 227 KB of shared
// memory but fits in the 50 MB L2, so a step is bound by how fast an SM
// streams the weights out of L2, and by the ~25 barriers between the
// dependent layers of one step.
//
// Design: one launch for the whole loop and one CTA per fold row (fold rows
// are independent recurrences). The four GRU states, the running input x,
// the gate and FC activations, the logits and the previous sample live in
// shared memory. The weights are re-read through L2 every step by warps
// that each own four output rows (common.cuh:matvec). The conditioning
// streams (i_cond, rnn3_aux, fc1_aux, fc3_aux: hoisted outside as full-
// sequence matmuls) are read once per step as the additive term of the
// layer that uses them. Sampling is a Gumbel-argmax over the classes with
// Philox-4x32-10 noise keyed by (seed, fold, step, class group), reduced
// inside the block; `argmax` turns the noise off (greedy decode).
// Sharing the weights across SMs (persistent CTAs that each own a slice,
// with a grid barrier per layer), bf16 weights and bf16 streams are later
// steps for speed.
#include <cfloat>

#include "common.cuh"

namespace {

struct Weights {
  const float *i_col;
  const float *rnn1_wih, *rnn1_bih, *rnn1_whh, *rnn1_bhh;
  const float *rnn2_wih, *rnn2_bih, *rnn2_whh, *rnn2_bhh;
  const float *rnn3_wx, *rnn3_whh, *rnn3_bhh;
  const float *rnn4_wih, *rnn4_bih, *rnn4_whh, *rnn4_bhh;
  const float *fc1_wx, *fc2_w, *fc2_b, *fc3_wx, *fc4_w, *fc4_b, *fc5_w, *fc5_b;
};
constexpr int kNumWeights = 24;

struct Streams {
  const float *i_cond, *rnn3_aux, *fc1_aux, *fc3_aux;
};

// h ← GRU(x, h) with torch gate semantics, then x ← x + h.
// xg = x·W_ihᵀ + bih + add (add: a streamed row, or null), hg = h·W_hhᵀ + bhh.
__device__ void gru_residual(const float* wih, const float* bih, const float* add,
                             const float* whh, const float* bhh, float* h, float* x,
                             float* xg, float* hg, int R) {
  rtvc::matvec<1>(wih, R, 3 * R, x, 0, R, 1, xg, 0, bih, add, 0, false, rtvc::kNone);
  rtvc::matvec<1>(whh, R, 3 * R, h, 0, R, 1, hg, 0, bhh, nullptr, 0, false, rtvc::kNone);
  __syncthreads();
  for (int j = threadIdx.x; j < R; j += blockDim.x) {
    const float r = rtvc::sigmoidf_(xg[j] + hg[j]);
    const float z = rtvc::sigmoidf_(xg[R + j] + hg[R + j]);
    const float n = tanhf(xg[2 * R + j] + r * hg[2 * R + j]);
    const float hn = (1.0f - z) * n + z * h[j];
    h[j] = hn;
    x[j] += hn;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(1024)
wavernn_kernel(Weights w, Streams s, int T, int R, int Fd, int C, int argmax, uint2 key,
               float* __restrict__ out, float* __restrict__ logits_out) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* x = sm;                 // R
  float* h = x + R;              // 4R: h1..h4
  float* xg = h + 4 * R;         // 3R
  float* hg = xg + 3 * R;        // 3R
  float* f1 = hg + 3 * R;        // Fd
  float* f2 = f1 + Fd;           // Fd
  float* logits = f2 + Fd;       // C
  float* red_val = logits + C;   // 32
  int* red_idx = reinterpret_cast<int*>(red_val + 32);  // 32
  float* prev = reinterpret_cast<float*>(red_idx + 32);  // 1

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int j = tid; j < 4 * R; j += blockDim.x) h[j] = 0.0f;
  if (tid == 0) *prev = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t row = (size_t)b * T + t;
    const float* ic = s.i_cond + row * R;
    const float p = *prev;
    for (int j = tid; j < R; j += blockDim.x) x[j] = ic[j] + p * w.i_col[j];
    __syncthreads();

    gru_residual(w.rnn1_wih, w.rnn1_bih, nullptr, w.rnn1_whh, w.rnn1_bhh, h, x, xg, hg, R);
    gru_residual(w.rnn2_wih, w.rnn2_bih, nullptr, w.rnn2_whh, w.rnn2_bhh, h + R, x, xg, hg, R);
    gru_residual(w.rnn3_wx, nullptr, s.rnn3_aux + row * 3 * R, w.rnn3_whh, w.rnn3_bhh,
                 h + 2 * R, x, xg, hg, R);
    gru_residual(w.rnn4_wih, w.rnn4_bih, nullptr, w.rnn4_whh, w.rnn4_bhh, h + 3 * R, x, xg, hg,
                 R);

    rtvc::matvec<1>(w.fc1_wx, R, Fd, x, 0, R, 1, f1, 0, nullptr, s.fc1_aux + row * Fd, 0, false,
                    rtvc::kNone);
    __syncthreads();
    rtvc::matvec<1>(w.fc2_w, Fd, Fd, f1, 0, Fd, 1, f2, 0, w.fc2_b, nullptr, 0, false,
                    rtvc::kRelu);
    __syncthreads();
    rtvc::matvec<1>(w.fc3_wx, Fd, Fd, f2, 0, Fd, 1, f1, 0, nullptr, s.fc3_aux + row * Fd, 0,
                    false, rtvc::kNone);
    __syncthreads();
    rtvc::matvec<1>(w.fc4_w, Fd, Fd, f1, 0, Fd, 1, f2, 0, w.fc4_b, nullptr, 0, false,
                    rtvc::kRelu);
    __syncthreads();
    rtvc::matvec<1>(w.fc5_w, Fd, C, f2, 0, Fd, 1, logits, 0, w.fc5_b, nullptr, 0, false,
                    rtvc::kNone);
    __syncthreads();
    if (logits_out)
      for (int c = tid; c < C; c += blockDim.x) logits_out[row * C + c] = logits[c];

    // Gumbel-argmax over the classes; ties go to the lowest class index.
    float best = -FLT_MAX;
    int best_i = 0x7fffffff;
    for (int c4 = tid; c4 * 4 < C; c4 += blockDim.x) {
      uint4 rnd = make_uint4(0u, 0u, 0u, 0u);
      if (!argmax) rnd = rtvc::philox4x32(make_uint4((uint32_t)c4, (uint32_t)t, (uint32_t)b, 0u), key);
      const uint32_t bits[4] = {rnd.x, rnd.y, rnd.z, rnd.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c4 * 4 + i;
        if (c < C) {
          float v = logits[c];
          if (!argmax) v -= logf(-logf(rtvc::u01(bits[i])));
          if (v > best || (v == best && c < best_i)) {
            best = v;
            best_i = c;
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      if (ov > best || (ov == best && oi < best_i)) {
        best = ov;
        best_i = oi;
      }
    }
    if (lane == 0) {
      red_val[warp] = best;
      red_idx[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? red_val[lane] : -FLT_MAX;
      best_i = lane < nwarps ? red_idx[lane] : 0x7fffffff;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
        if (ov > best || (ov == best && oi < best_i)) {
          best = ov;
          best_i = oi;
        }
      }
      if (lane == 0) {
        const float sample = 2.0f * (float)best_i / ((float)C - 1.0f) - 1.0f;
        *prev = sample;
        out[row] = sample;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// weights: kNumWeights device pointers in the order of struct Weights;
// streams: i_cond (B, T, R), rnn3_aux (B, T, 3R), fc1_aux (B, T, F),
// fc3_aux (B, T, F); dims: B, T, R, F, C. out: (B, T) samples in [-1, 1];
// logits_out: null, or (B, T, C) for the logits each step sampled from.
extern "C" int rtvc_wavernn_generate(const void* const* weights, const void* const* streams,
                                     const int* dims, int argmax, unsigned long long seed,
                                     float* out, float* logits_out, void* stream) {
  Weights w;
  const float** wp = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < kNumWeights; ++i) wp[i] = static_cast<const float*>(weights[i]);
  Streams s{static_cast<const float*>(streams[0]), static_cast<const float*>(streams[1]),
            static_cast<const float*>(streams[2]), static_cast<const float*>(streams[3])};
  const int B = dims[0], T = dims[1], R = dims[2], Fd = dims[3], C = dims[4];
  const size_t smem = (size_t)(11 * R + 2 * Fd + C + 32 + 32 + 4) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(wavernn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const uint2 key = make_uint2((uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32));
  wavernn_kernel<<<B, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
      w, s, T, R, Fd, C, argmax, key, out, logits_out);
  return (int)cudaGetLastError();
}
