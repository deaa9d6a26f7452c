// WaveRNN autoregressive sample loop: the fatchord, geneing and runtimeracer
// variants, each with the categorical (RAW / BITS), mixture-of-logistics
// (MOL) or two-parameter beta (geneing RAW) sampling head.
//
// Replaces: rtvc_tpu/ops/pallas/wavernn_kernel.py:generate_core_pallas
// (body _make_kernel), the whole per-sample loop of the vocoder.
//
// What bounds it on the H100: a step is a chain of matrix-vector products,
// one to four GRUs (W_ih and W_hh of 3R x R each) and two to five FCs. Per
// step and fold row that is 4.2M weights (16.8 MB in f32) for fatchord
// (R = F = 512), 2.1M (8.4 MB) for runtimeracer (R = F = 256, four GRUs) and
// 0.56M (2.2 MB) for geneing (R = 256, F = 128), read once for 2 FLOP per
// 4 bytes. That is far too large for one SM's 227 KB of shared memory but
// fits in the 50 MB L2, so a step is bound by how fast an SM streams the
// weights out of L2, and by the barriers between the dependent layers of
// one step (7 for geneing, 25 for runtimeracer).
//
// Design: one launch for the whole loop and one CTA per fold row (fold rows
// are independent recurrences). The layer list is a table in the kernel's
// parameters (struct Layers): the GRUs in order, then the FCs, each with
// either its own bias or a conditioning stream as its additive term; loops
// over it are unrolled so every pointer is read from parameter space. The
// GRU states, the running input x, the gate and FC activations, the head's
// inputs and the previous sample live in shared memory. The weights are
// re-read through L2 every step by warps that each own four output rows
// (common.cuh:matvec). The conditioning streams (hoisted outside as full-
// sequence matmuls) are read once per step. The head is a template
// parameter: the categorical head is a Gumbel-argmax over up to 1024
// classes reduced inside the block; the MOL head (30 columns) and the beta
// head (2 columns) are the work of one warp and of one thread. Noise is
// Philox-4x32-10 keyed by (seed, fold, step, draw group), so a draw does
// not depend on the launch shape; `argmax` turns the noise off (greedy
// decode). The heads use expf/logf and explicitly rounded multiplies and
// adds (no fused multiply-add), so that the sample that is fed back agrees
// with the plain PyTorch version to the last bit where the head's inputs
// do. Sharing the weights across SMs (persistent CTAs that each own a
// slice, with a grid barrier per layer), bf16 weights and bf16 streams are
// later steps for speed.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kMaxRnn = 4;
constexpr int kMaxFc = 5;

enum Head { kCategorical = 0, kMol = 1, kBeta = 2 };

// The step's layers. A GRU with a conditioning stream has rnn_aux set and
// rnn_bih null (b_ih is folded into the stream), and its rnn_wih holds only
// the state's columns; likewise fc_aux / fc_b / fc_w. FC k maps
// (k == 0 ? R : F) inputs to (k == n_fc - 1 ? C : F) outputs.
struct Layers {
  const float* i_col;
  const float* rnn_wih[kMaxRnn];
  const float* rnn_bih[kMaxRnn];
  const float* rnn_whh[kMaxRnn];
  const float* rnn_bhh[kMaxRnn];
  const float* fc_w[kMaxFc];
  const float* fc_b[kMaxFc];
  const float* i_cond;
  const float* rnn_aux[kMaxRnn];
  const float* fc_aux[kMaxFc];
  int n_rnn, n_fc;
  int fc_relu[kMaxFc];
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

template <int HEAD>
__global__ void __launch_bounds__(1024)
wavernn_kernel(Layers L, int T, int R, int Fd, int C, int argmax, uint2 key,
               float* __restrict__ out, float* __restrict__ logits_out) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* x = sm;                 // R
  float* h = x + R;              // kMaxRnn·R: the GRU states
  float* xg = h + kMaxRnn * R;   // 3R
  float* hg = xg + 3 * R;        // 3R
  float* f1 = hg + 3 * R;        // Fd
  float* f2 = f1 + Fd;           // Fd
  float* logits = f2 + Fd;       // C: the head's inputs
  float* red_val = logits + C;   // 32
  int* red_idx = reinterpret_cast<int*>(red_val + 32);  // 32
  float* prev = reinterpret_cast<float*>(red_idx + 32);  // 1

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int j = tid; j < kMaxRnn * R; j += blockDim.x) h[j] = 0.0f;
  if (tid == 0) *prev = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t row = (size_t)b * T + t;
    const float* ic = L.i_cond + row * R;
    const float p = *prev;
    for (int j = tid; j < R; j += blockDim.x) x[j] = ic[j] + p * L.i_col[j];
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kMaxRnn; ++k) {
      if (k < L.n_rnn)
        gru_residual(L.rnn_wih[k], L.rnn_bih[k],
                     L.rnn_aux[k] ? L.rnn_aux[k] + row * 3 * R : nullptr, L.rnn_whh[k],
                     L.rnn_bhh[k], h + k * R, x, xg, hg, R);
    }

    // FC k reads x (k = 0) or the buffer FC k - 1 wrote: f1 and f2 in turn
#pragma unroll
    for (int k = 0; k < kMaxFc; ++k) {
      if (k < L.n_fc) {
        const bool last = k == L.n_fc - 1;
        const int rows = last ? C : Fd;
        const int n_in = k == 0 ? R : Fd;
        const float* in = k == 0 ? x : ((k & 1) ? f1 : f2);
        float* o = last ? logits : ((k & 1) ? f2 : f1);
        rtvc::matvec<1>(L.fc_w[k], n_in, rows, in, 0, n_in, 1, o, 0, L.fc_b[k],
                        L.fc_aux[k] ? L.fc_aux[k] + row * rows : nullptr, 0, false,
                        L.fc_relu[k] ? rtvc::kRelu : rtvc::kNone);
        __syncthreads();
      }
    }
    if (logits_out)
      for (int c = tid; c < C; c += blockDim.x) logits_out[row * C + c] = logits[c];

    if constexpr (HEAD == kCategorical) {
      // Gumbel-argmax over the classes; ties go to the lowest class index.
      float best = -FLT_MAX;
      int best_i = 0x7fffffff;
      for (int c4 = tid; c4 * 4 < C; c4 += blockDim.x) {
        uint4 rnd = make_uint4(0u, 0u, 0u, 0u);
        if (!argmax)
          rnd = rtvc::philox4x32(make_uint4((uint32_t)c4, (uint32_t)t, (uint32_t)b, 0u), key);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = c4 * 4 + i;
          if (c < C) {
            float v = logits[c];
            if (!argmax) v -= logf(-logf(pick(rnd, i)));
            if (v > best || (v == best && c < best_i)) {
              best = v;
              best_i = c;
            }
          }
        }
      }
      warp_argmax(best, best_i);
      if (lane == 0) {
        red_val[warp] = best;
        red_idx[warp] = best_i;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < nwarps ? red_val[lane] : -FLT_MAX;
        best_i = lane < nwarps ? red_idx[lane] : 0x7fffffff;
        warp_argmax(best, best_i);
        if (lane == 0) {
          const float sample = 2.0f * (float)best_i / ((float)C - 1.0f) - 1.0f;
          *prev = sample;
          out[row] = sample;
        }
      }
    } else if constexpr (HEAD == kMol) {
      // Columns [logit_probs | means | log_scales] x k_mix: the component by
      // (Gumbel) argmax, then an inverse-CDF logistic draw around its mean.
      // Draw groups 0 .. ceil(k_mix / 4) - 1 feed the Gumbel noise, the next
      // one the logistic draw.
      if (warp == 0) {
        const int k_mix = C / 3;
        float best = -FLT_MAX;
        int comp = 0x7fffffff;
        for (int c = lane; c < k_mix; c += 32) {
          float v = logits[c];
          if (!argmax) {
            const uint4 rnd = rtvc::philox4x32(
                make_uint4((uint32_t)(c >> 2), (uint32_t)t, (uint32_t)b, 0u), key);
            v -= logf(-logf(clampf(pick(rnd, c & 3), 1e-5f, 1.0f - 1e-5f)));
          }
          if (v > best || (v == best && c < comp)) {
            best = v;
            comp = c;
          }
        }
        warp_argmax(best, comp);
        if (lane == 0) {
          float sample = logits[k_mix + comp];
          if (!argmax) {
            const float log_scale = fmaxf(logits[2 * k_mix + comp], -32.23619130191664f);
            const uint4 rnd = rtvc::philox4x32(
                make_uint4((uint32_t)((k_mix + 3) >> 2), (uint32_t)t, (uint32_t)b, 0u), key);
            const float u = clampf(pick(rnd, 0), 1e-5f, 1.0f - 1e-5f);
            sample = __fadd_rn(sample, __fmul_rn(expf(log_scale),
                                                 __fsub_rn(logf(u), logf(1.0f - u))));
          }
          sample = clampf(sample, -1.0f, 1.0f);
          *prev = sample;
          out[row] = sample;
        }
      }
    } else {
      // Columns [log α | log β] of a Beta(α, β) over [0, 1], mapped to
      // [-1, 1]. Greedy: the mode where it exists (α, β > 1), else the mean.
      // Sampled: Gα / (Gα + Gβ) from 14 uniforms, draw groups 0 .. 3.
      if (tid == 0) {
        const float alpha = expf(clampf(logits[0], -30.0f, 30.0f));
        const float beta = expf(clampf(logits[1], -30.0f, 30.0f));
        float m;
        if (argmax) {
          m = (alpha > 1.0f && beta > 1.0f)
                  ? __fdiv_rn(alpha - 1.0f, __fsub_rn(__fadd_rn(alpha, beta), 2.0f))
                  : __fdiv_rn(alpha, __fadd_rn(alpha, beta));
        } else {
          float u[16];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const uint4 rnd = rtvc::philox4x32(
                make_uint4((uint32_t)g, (uint32_t)t, (uint32_t)b, 0u), key);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              u[4 * g + i] = clampf(pick(rnd, i), 1e-7f, 1.0f - 1e-7f);
          }
          const float ga = gamma_draw(alpha, u);
          const float gb = gamma_draw(beta, u + 7);
          m = __fdiv_rn(ga, __fadd_rn(ga, gb));
        }
        const float sample = clampf(__fsub_rn(__fmul_rn(2.0f, m), 1.0f), -1.0f, 1.0f);
        *prev = sample;
        out[row] = sample;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// weights: 1 + 4·kMaxRnn + 2·kMaxFc device pointers: i_col, then for each of kMaxRnn GRU
// slots (wih, bih, whh, bhh), then for each of kMaxFc FC slots (w, b); null
// for an absent layer and for the bias of a layer that takes a stream.
// streams: 1 + kMaxRnn + kMaxFc pointers: i_cond (B, T, R), then one per GRU slot
// (B, T, 3R) and one per FC slot (B, T, F), null where the layer has its
// own bias. dims: B, T, R, F, C, n_rnn, n_fc, head (0 categorical, 1 MOL,
// 2 beta), then kMaxFc relu flags. out: (B, T) samples in [-1, 1];
// logits_out: null, or (B, T, C) for the head's inputs at each step.
extern "C" int rtvc_wavernn_generate(const void* const* weights, const void* const* streams,
                                     const int* dims, int argmax, unsigned long long seed,
                                     float* out, float* logits_out, void* stream) {
  Layers L;
  auto w = [&](int i) { return static_cast<const float*>(weights[i]); };
  auto s = [&](int i) { return static_cast<const float*>(streams[i]); };
  L.i_col = w(0);
  L.i_cond = s(0);
  for (int k = 0; k < kMaxRnn; ++k) {
    L.rnn_wih[k] = w(1 + 4 * k);
    L.rnn_bih[k] = w(2 + 4 * k);
    L.rnn_whh[k] = w(3 + 4 * k);
    L.rnn_bhh[k] = w(4 + 4 * k);
    L.rnn_aux[k] = s(1 + k);
  }
  for (int k = 0; k < kMaxFc; ++k) {
    L.fc_w[k] = w(1 + 4 * kMaxRnn + 2 * k);
    L.fc_b[k] = w(2 + 4 * kMaxRnn + 2 * k);
    L.fc_aux[k] = s(1 + kMaxRnn + k);
    L.fc_relu[k] = dims[8 + k];
  }
  const int B = dims[0], T = dims[1], R = dims[2], Fd = dims[3], C = dims[4];
  L.n_rnn = dims[5];
  L.n_fc = dims[6];
  const int head = dims[7];
  if (L.n_rnn < 1 || L.n_rnn > kMaxRnn || L.n_fc < 1 || L.n_fc > kMaxFc || head < 0 ||
      head > 2 || (head == kMol && (C % 3 != 0 || C < 3)) || (head == kBeta && C != 2))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)((1 + kMaxRnn + 6) * R + 2 * Fd + C + 32 + 32 + 4) * sizeof(float);
  const void* kernel = head == kCategorical ? (const void*)wavernn_kernel<kCategorical>
                       : head == kMol       ? (const void*)wavernn_kernel<kMol>
                                            : (const void*)wavernn_kernel<kBeta>;
  cudaError_t e = rtvc::allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const uint2 key = make_uint2((uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head == kCategorical)
    wavernn_kernel<kCategorical><<<B, 1024, smem, st>>>(L, T, R, Fd, C, argmax, key, out,
                                                        logits_out);
  else if (head == kMol)
    wavernn_kernel<kMol><<<B, 1024, smem, st>>>(L, T, R, Fd, C, argmax, key, out, logits_out);
  else
    wavernn_kernel<kBeta><<<B, 1024, smem, st>>>(L, T, R, Fd, C, argmax, key, out, logits_out);
  return (int)cudaGetLastError();
}
