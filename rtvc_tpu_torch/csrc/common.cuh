// Shared device helpers for the hand-written recurrence kernels.
//
// Every kernel of this package is a matrix-vector recurrence: each step
// multiplies a handful of weight matrices (a few MB) by state vectors of a
// few hundred floats. The weights live in the shared memory of the whole
// card: every CTA owns a slice of the hidden units (or of a layer's rows),
// all CTAs advance one time step together, and grid_barrier separates the
// steps. slice_product, the partition and the cooperative launch below serve
// K3 (lstm_seq.cu), K4 (gru_seq.cu) and K1 (wavernn_generate.cu);
// grid_barrier and warp_transpose_sum also serve K2 (tacotron_decode.cu) and
// K5 (tacotron_train.cu).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace rtvc {

// Element types of a recurrence's streams: f32, or bf16 under the bf16
// training policy (ops/precision.py), where the arithmetic and the carried
// state stay f32 and only what is stored is rounded.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S from_f(float v) {
  if constexpr (std::is_same<S, float>::value) return v;
  else return __float2bfloat16_rn(v);
}

// v as a stream of type S would hold it: the identity for f32, bf16's
// rounding otherwise.
template <typename S>
__device__ __forceinline__ float round_as(float v) { return to_f(from_f<S>(v)); }

// Four consecutive weights from shared memory as floats: one 16-byte load of
// f32, one 8-byte load of bf16 (the address is a multiple of four elements).
__device__ __forceinline__ float4 load_w4(const float* w) {
  return *reinterpret_cast<const float4*>(w);
}
__device__ __forceinline__ float4 load_w4(const bf16* w) {
  const uint2 raw = *reinterpret_cast<const uint2*>(w);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// Lets `kernel` take `smem` bytes of dynamic shared memory: past the
// default 48 KB a launch needs the opt-in attribute.
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Grid-wide barrier for a kernel whose CTAs are all resident at once (launch
// it with cudaLaunchCooperativeKernel, which refuses a grid that does not
// fit, where a spin on a CTA that never starts would hang). `counter` is a
// zeroed word in device memory that only grows: the n-th barrier of a launch
// over `ctas` CTAs waits for `target` = n * ctas arrivals. Thread 0 arrives
// with a release and polls with an acquire, both at device scope; the two
// __syncthreads extend that order to the block's other threads, so what any
// CTA wrote before the barrier is visible after it to loads that go to L2
// (__ldcg: the L1 of an SM is not coherent with the other SMs' stores). The
// atomic only orders the steps; no sum goes through it.
__device__ __forceinline__ void grid_barrier(unsigned int* counter, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// One round of warp_transpose_sum over the first N of v's values: lanes whose
// bit `o` is set go on with the odd ones, the others with the even ones.
template <int N, int M>
__device__ __forceinline__ void warp_transpose_round(float (&v)[M], int o) {
  const bool up = (threadIdx.x & o) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float keep = up ? v[2 * i + 1] : v[2 * i];
    const float send = up ? v[2 * i] : v[2 * i + 1];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// Sums each of the N values (N a multiple of 32) that every lane of a warp
// holds over the 32 lanes, with N - N/32 shuffles instead of 5 N: each round
// halves the values a lane keeps, the lane's bit choosing which of a pair it
// goes on summing. Afterwards v[m], m < N/32, of lane l is the full sum of
// the value that had index 32 m + bitrev5(l). Every index is a compile-time
// constant, so v stays in registers (nvcc does not unroll a loop over the
// rounds, and picking v[i] at run time then costs a branch per value: 20 times
// the time of the whole product).
template <int N>
__device__ __forceinline__ void warp_transpose_sum(float (&v)[N]) {
  static_assert(N % 32 == 0, "N must be a multiple of the warp size");
  warp_transpose_round<N>(v, 16);
  warp_transpose_round<N / 2>(v, 8);
  warp_transpose_round<N / 4>(v, 4);
  warp_transpose_round<N / 8>(v, 2);
  warp_transpose_round<N / 16>(v, 1);
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

// 23 random bits → a float strictly inside (0, 1): k + 0.5 for k < 2^23 is
// exact in f32, so the result lies in [2^-24, 1 - 2^-24]. (With 24 bits the
// top values round up to 1.0, and -log(-log(1)) is infinite.)
__device__ __forceinline__ float u01(uint32_t bits) {
  return ((float)(bits >> 9) + 0.5f) * (1.0f / 8388608.0f);
}

// ---------------------------------------------------------------------------
// Persistent recurrences: weights resident in shared memory, one cooperative
// launch, a grid barrier a step.
// ---------------------------------------------------------------------------

constexpr int kRecThreads = 256;  // threads of a CTA of a persistent recurrence
constexpr int kRecWarps = kRecThreads / 32;

__host__ __device__ constexpr int padded(int n) { return (n + 31) / 32 * 32; }

__device__ __forceinline__ float dot4(const float4 w, const float4 v, float acc) {
  acc = fmaf(w.x, v.x, acc);
  acc = fmaf(w.y, v.y, acc);
  acc = fmaf(w.z, v.z, acc);
  return fmaf(w.w, v.w, acc);
}

// out[r * NB + b] = Σ_k W[r * ld + k] · x[b * xs + k] for r < R, b < NB (zero
// for b >= nb), computed by one warp: W in shared memory (f32, or bf16 widened
// at use), x in device memory (f32), read through L2 (other CTAs wrote it
// before the last grid barrier). `vec` says that n and xs are multiples of 4
// and x is 16-byte aligned. `out` is the warp's own padded(R * NB) floats of
// shared memory; the caller runs __syncwarp before reading it.
template <int R, int NB, typename Tw>
__device__ __forceinline__ void slice_product(const Tw* W, int ld, int n, const float* x,
                                              size_t xs, int nb, bool vec, float* out) {
  constexpr int N = padded(R * NB);
  const int lane = threadIdx.x & 31;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  if (vec) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 cur[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b)
      cur[b] = (b < nb && lane * 4 < n)
                   ? __ldcg(reinterpret_cast<const float4*>(x + b * xs + lane * 4))
                   : zero;
    for (int k = lane * 4; k < n; k += 128) {
      float4 nxt[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b)
        nxt[b] = (b < nb && k + 128 < n)
                     ? __ldcg(reinterpret_cast<const float4*>(x + b * xs + k + 128))
                     : zero;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 w = load_w4(W + r * ld + k);
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[r * NB + b] = dot4(w, cur[b], acc[r * NB + b]);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) cur[b] = nxt[b];
    }
  } else {
    for (int k = lane; k < n; k += 32) {
      float v[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) v[b] = b < nb ? __ldcg(x + b * xs + k) : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float w = to_f(W[r * ld + k]);
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[r * NB + b] = fmaf(w, v[b], acc[r * NB + b]);
      }
    }
  }
  warp_transpose_sum<N>(acc);
  const int x5 = (int)(__brev((unsigned)lane) >> 27);
#pragma unroll
  for (int m = 0; m < N / 32; ++m) out[32 * m + x5] = acc[m];
}

// A sequence recurrence's grid: blockIdx.x = group * slices + slice. A CTA's
// hidden units are [slice * U, slice * U + nu), its batch rows [b_lo, b_hi).
struct Part {
  int u0, nu, b_lo, b_hi;
  unsigned int* counter;
  unsigned int slices;
};

__device__ __forceinline__ Part partition(int U, int B, int H, int slices, int rows,
                                          unsigned int* sync) {
  const int group = blockIdx.x / slices, slice = blockIdx.x % slices;
  Part p;
  p.u0 = slice * U;
  p.nu = min(U, H - p.u0);
  p.b_lo = group * rows;
  p.b_hi = min(B, p.b_lo + rows);
  p.counter = sync + group * 32;  // one 128-byte line per group
  p.slices = (unsigned int)slices;
  return p;
}

// The plan a sequence wrapper hands over (ops/lstm_seq.py, ops/gru_seq.py):
// groups, slices, units a CTA, batch rows a warp takes at a time, batch rows
// a group, bytes of shared memory a CTA.
struct SeqPlan {
  int groups, slices, units, nb, rows, smem;
};

inline SeqPlan seq_plan(const int* v) { return {v[0], v[1], v[2], v[3], v[4], v[5]}; }

// The plan covers (B, H) and its smem is what a CTA takes: weight_rows rows of
// weight_ld weights of weight_bytes each, a warp's padded(weight_rows * nb)
// float sums, and `extra` floats.
inline bool seq_plan_ok(const SeqPlan& p, int B, int H, int weight_rows, int weight_ld,
                        int extra = 0, int weight_bytes = 4) {
  const int smem = weight_bytes * weight_rows * weight_ld +
                   (int)sizeof(float) * (kRecWarps * padded(weight_rows * p.nb) + extra);
  return p.groups >= 1 && p.slices * p.units >= H && (p.slices - 1) * p.units < H &&
         (long long)p.groups * p.rows >= B && p.smem == smem;
}

// A cooperative launch of `ctas` CTAs of kRecThreads threads with `smem` bytes
// of dynamic shared memory: all CTAs resident at once, or the launch is
// refused (cudaErrorCooperativeLaunchTooLarge) instead of hanging at a barrier.
template <typename Kernel>
int launch_cooperative(Kernel kernel, int ctas, int smem, void** args, cudaStream_t stream) {
  cudaError_t e = allow_smem((const void*)kernel, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(ctas), dim3(kRecThreads), args,
                                  (size_t)smem, stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace rtvc
