// Shared device helpers for the hand-written recurrence kernels.
//
// Every kernel of this package is a matrix-vector recurrence: each step
// multiplies a handful of weight matrices (a few MB, read through the 50 MB
// L2) by state vectors of a few hundred floats. The helper below is the
// workhorse: one warp owns four output rows at a time, each lane streams
// 16-byte pieces of those rows, and the dot products are reduced with warp
// shuffles. Four rows per warp keep four independent loads in flight per
// lane, which is what hides the L2 latency when a single CTA walks MBs of
// weights per step.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rtvc {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

enum Act { kNone = 0, kRelu = 1 };

// out[b * os + r] = act(init + sum_k W[r * ldw + k] * x[b * xs + k])
// for r < rows, b < nb (nb <= NB), where init is
//   out[b * os + r]            when accumulate,
//   bias[r] (or 0) + add[b * as + r] (add may be null) otherwise.
// Rows are split over the warps of the block; the caller synchronises
// before reading `out`. `accumulate` lets a second call add the product of
// another input segment into the same rows: the row→warp→lane mapping is
// the same in both calls, so no synchronisation is needed between them.
template <int NB>
__device__ void matvec(const float* __restrict__ W, int ldw, int rows,
                       const float* x, int xs, int n, int nb,
                       float* out, int os, const float* __restrict__ bias,
                       const float* add, int as, bool accumulate, int act) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool vec = ((n & 3) == 0) && ((ldw & 3) == 0) && ((xs & 3) == 0) &&
                   ((reinterpret_cast<uintptr_t>(W) & 15) == 0) &&
                   ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  for (int r0 = warp * 4; r0 < rows; r0 += nwarps * 4) {
    float acc[4][NB];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[i][b] = 0.0f;
    const int nr = rows - r0 < 4 ? rows - r0 : 4;
    if (vec) {
      for (int k = lane * 4; k < n; k += 128) {
        float4 w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = i < nr ? __ldg(reinterpret_cast<const float4*>(W + (size_t)(r0 + i) * ldw + k))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (b < nb) {
            const float4 v = *reinterpret_cast<const float4*>(x + (size_t)b * xs + k);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[i][b] += w[i].x * v.x + w[i].y * v.y + w[i].z * v.z + w[i].w * v.w;
          }
        }
      }
    } else {
      for (int k = lane; k < n; k += 32) {
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = i < nr ? __ldg(W + (size_t)(r0 + i) * ldw + k) : 0.0f;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (b < nb) {
            const float v = x[(size_t)b * xs + k];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][b] += w[i] * v;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float s = warp_sum(acc[i][b]);
        if (lane == 0 && i < nr && b < nb) {
          const int r = r0 + i;
          float* o = out + (size_t)b * os + r;
          float v;
          if (accumulate) {
            v = *o + s;
          } else {
            v = s + (bias ? bias[r] : 0.0f) + (add ? add[(size_t)b * as + r] : 0.0f);
          }
          if (act == kRelu) v = fmaxf(v, 0.0f);
          *o = v;
        }
      }
    }
  }
}

// Philox-4x32-10 (Salmon et al., SC'11): a counter-based generator, so a
// draw depends only on (key, counter) and needs no state between steps.
__device__ __forceinline__ uint4 philox4x32(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// 24 random bits → a float strictly inside (0, 1).
__device__ __forceinline__ float u01(uint32_t bits) {
  return ((float)(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

}  // namespace rtvc
