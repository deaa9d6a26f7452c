// K3's bf16 instantiation on Hopper's tensor cores: the LSTM sequence over
// hoisted input gates, forward (with optional training residuals) and
// backward, with the recurrent product issued by wgmma on a bf16 W_hh slice
// resident in shared memory.
//
// Replaces: rtvc_tpu/ops/pallas/lstm_train_kernel.py:lstm_seq_fused under the
// bf16 training policy (_fwd_kernel :115, _bwd_kernel :158), for the shapes
// where ops/lstm_seq.py:plan names this mode (the GE2E step, B 640 x 160 x
// 768). csrc/lstm_seq.cu keeps the f32 kernels and the earlier bf16 design.
//
// The contract is the JAX kernel's: the carried h (forward) and dxg
// (backward) are f32 inside the product (lstm_train_kernel.py:127-134,
// :186-190), W_hh is bf16. A bf16 tensor-core product of bf16(h) would round
// the state every step, so the f32 operand x is split into two bf16 halves,
// hi = bf16(x) and lo = bf16(x - hi), which carry x to about 2^-17 of its
// size; hi·W and lo·W are exact products summed in the f32 accumulator. The
// split doubles the tensor work (2 · 2 · B · 4H · H a step) while the
// function, and so its bound, stays one product.
//
// What bounds it on the H100: at B 640 x H 768 a step is 3 GFLOP of product
// (6 with the split: ≈ 6.7 µs at the dense bf16 rate over 120 SMs), the
// carried state every CTA reads from L2, and the grid barrier between steps.
// The earlier bf16 design (lstm_seq.cu) ran the product as f32 FMAs on the
// CUDA cores, with 6-unit slices whose 128 CTAs each read the whole h from
// L2 every step (252 MB a step): 21.5 ms forward and 19.9 backward at the
// GE2E shape on an NVIDIA H100 80GB HBM3 at 700 W, where this design takes
// 2.5 and 3.9 (PERF.md section 6; a step is then ≈ 40-60 % split product, the
// rest the cell update, the barriers and, backward, the partial sums).
//
// Design. The grid is `groups` x `slices` CTAs, all resident at once (a
// cooperative launch). CTA (g, s) owns `tiles` tiles of 64 batch rows (one
// warpgroup a tile) and U hidden units (U = 32 at the GE2E shape: 24 slices
// x 5 groups of 128 rows = 120 CTAs) for the whole sequence. The split
// operand goes between CTAs through device memory (L2) already in the layout
// of wgmma's A fragments (a warp's 16-row band, 16 columns: 32 lanes x 16
// bytes, one plane for hi and one for lo), so each thread loads its own
// fragments with one 16-byte load a plane and k16 step and hands them to
// wgmma from registers, two batches of 4 steps in flight; B, the W slice,
// stays in shared memory in wgmma's unswizzled K-major layout (8 x 8 core
// matrices of 128 contiguous bytes).
//
// - Forward: the CTA keeps the 4U gate rows of its units over all of H
//   (N = 4U = 128 product columns, 192 KB at H 768). The columns are ordered
//   so that one thread's accumulator holds i, f, g and o of the same (row,
//   unit): unit q·U/4 + p of quad lane q sits in 8-column blocks 2p (i, f)
//   and 2p + 1 (g, o). The cell update runs on the accumulator in registers,
//   c stays in registers for the whole sequence, each thread's U/4 units are
//   contiguous (its xg, ys and residual accesses are vectors), and it writes
//   its h's hi and lo into the next step's fragments. One grid barrier per
//   batch group a step (common.cuh:grid_barrier).
// - Backward: the CTA computes the dxg of its own cells, in the forward's
//   accumulator layout, which is also the layout of wgmma's A fragments, so
//   it writes dxg's hi and lo fragments as they are. dh = dxg · W_hh sums
//   over 4H columns: the slices form K-groups of `kgroup` (4 at the GE2E
//   shape), each CTA multiplies its K-group's 4U · kgroup columns of dxg
//   (gathered from its mates after a barrier of the K-group) by W_hh's rows
//   of them over H / kgroup columns of dh (its member index picks which;
//   192 KB of W resident), writes that partial (f32), and after the group's
//   barrier each CTA sums the partials of its own cells over the K-groups in
//   their order. Gathering every slice's dxg (kgroup = slices) would read
//   1.6 MB a CTA a step from L2, a partial over all of H from each slice
//   (kgroup = 1) 94 MB a step, more than L2 holds; groups of 4 read ≈ 0.45
//   MB a CTA. No sum goes through an atomic, so two runs give equal bits.
//
// hT, cT, dh0 and dc0 come from the f32 values, never from hi + lo; dxg and c
// stay f32. The weight gradient Σ_t h_{t-1}ᵀ · dxg_t stays one product
// outside the kernel (ops/lstm_seq.py:LSTMSeqFn), as in the JAX package.
#include "common.cuh"

namespace {

using rtvc::bf16;

constexpr int kWarpgroup = 128;  // threads of a warpgroup: one 64-row tile
constexpr int kTileRows = 64;    // rows of a wgmma tile
constexpr int kBatch = 4;        // k16 steps a batch of fragment loads holds

// Phase clocks: profile_lstm --bf16's "clock" variant defines these to sum
// clock64() differences by phase and write them out; here they are nothing.
#ifndef RTVC_MMA_CLOCK
#define RTVC_MMA_CLOCK_INIT
#define RTVC_MMA_CLOCK(phase)
#define RTVC_MMA_CLOCK_DONE(out)
#endif

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The weights a thread copied into shared memory made visible to the async
// proxy that wgmma reads shared memory through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma operand descriptor: a K-major bf16 matrix in shared memory in the
// unswizzled (interleaved) layout, whose 8 x 8 core matrices are 128
// contiguous bytes (8 rows of 16 bytes); `lbo` bytes apart along K, `sbo`
// bytes apart along N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x N f32, the warpgroup's accumulator fragments) += A · Bᵀ over a k16
// step: A in registers (the fragments of mma.m16n8k16's A, one warp a 16-row
// band: a[0] row l/4, columns 2(l%4) + {0, 1}; a[1] eight rows below; a[2],
// a[3] the same eight columns on), B K-major in shared memory; `scale_d` 0
// overwrites d. Thread l of warp w holds, for each 8-column block j, d[4j],
// d[4j+1] at row 16w + l/4, columns 8j + 2(l%4) + {0, 1}, and d[4j+2],
// d[4j+3] eight rows below.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
// An accumulator's registers pinned in place: the compiler moves no access
// to them across this point (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One plane of a fragment exchange, in 32-bit words: 16-row bands, then k16
// steps, then 32 lanes of 4 words (each word two bf16 values, the lower
// column in the low half).
__device__ __forceinline__ size_t frag_word(int row, int k, int ksteps) {
  return ((size_t)(row >> 4) * ksteps + (k >> 4)) * 128 + (row & 7) * 16 + ((k & 7) >> 1) * 4 +
         ((row >> 3) & 1) + 2 * ((k >> 3) & 1);
}

// One batch of kBatch k16 steps' A fragments, hi and lo of each, from the
// thread's own 16 bytes of each step (32 uint4 apart), read through L2.
__device__ __forceinline__ void load_batch(uint32_t (&a)[2 * kBatch][4], const uint4* hi,
                                           const uint4* lo, int batch) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int s = 32 * (batch * kBatch + i);
    const uint4 h = __ldcg(hi + s), l = __ldcg(lo + s);
    a[2 * i][0] = h.x, a[2 * i][1] = h.y, a[2 * i][2] = h.z, a[2 * i][3] = h.w;
    a[2 * i + 1][0] = l.x, a[2 * i + 1][1] = l.y, a[2 * i + 1][2] = l.z, a[2 * i + 1][3] = l.w;
  }
}

// d += the batch's steps: hi · Bᵀ and lo · Bᵀ a step, B's step s at the
// descriptor of w_addr + 256 s; waited for before it returns, so that its
// registers may be loaded again.
template <int N>
__device__ __forceinline__ void run_batch(float (&d)[N / 2], const uint32_t (&a)[2 * kBatch][4],
                                          uint32_t w_addr, uint32_t sbo, int batch) {
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const uint64_t b = make_desc(w_addr + (batch * kBatch + i) * 256, 128, sbo);
    wgmma_rs(d, a[2 * i], b, 1);
    wgmma_rs(d, a[2 * i + 1], b, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin(d);
}

// d (64 x N) = Σ over `ksteps` k16 steps of (hi + lo) · Bᵀ: the warpgroup's
// A fragments for step s at hi[32 s] and lo[32 s] (written by other CTAs
// before the last barrier), B's step s in shared memory (core matrices
// `sbo` bytes apart along N). Two buffers of kBatch steps: while the tensor
// cores take one batch, the loads of the next are in flight. ksteps is a
// multiple of 2 kBatch.
template <int N>
__device__ __forceinline__ void split_product(float (&d)[N / 2], const uint4* hi, const uint4* lo,
                                              int ksteps, uint32_t w_addr, uint32_t sbo) {
  uint32_t a0[2 * kBatch][4], a1[2 * kBatch][4];
  const int batches = ksteps / kBatch;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  load_batch(a0, hi, lo, 0);
  load_batch(a1, hi, lo, 1);
  for (int j = 0; j < batches; j += 2) {
    run_batch<N>(d, a0, w_addr, sbo, j);
    load_batch(a0, hi, lo, min(j + 2, batches - 1));  // the last loads repeat a batch: no branch
    run_batch<N>(d, a1, w_addr, sbo, j + 1);
    load_batch(a1, hi, lo, min(j + 3, batches - 1));
  }
}

// ---------------------------------------------------------------------------
// Vectors of a thread's U/4 contiguous units
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// N (2 or 8: a thread's U/4 units) bf16 values of a read-only input as
// N / 2 packed words, aligned to N; bf_at<i> reads value i back as a float.
template <int N>
__device__ __forceinline__ void load_words(const bf16* src, uint32_t (&w)[N / 2]) {
  static_assert(N == 2 || N == 8, "2 or 8 values");
  if constexpr (N == 8) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(src));
    w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
  }
}
template <int I, int M>
__device__ __forceinline__ float bf_at(const uint32_t (&w)[M]) {
  return I % 2 ? bf_hi(w[I / 2]) : bf_lo(w[I / 2]);
}

template <int N>
__device__ __forceinline__ void store_bf16(bf16* dst, const float (&v)[N]) {
  static_assert(N == 2 || N == 8, "2 or 8 values");
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else {
    *reinterpret_cast<unsigned int*>(dst) = pack_bf16(v[0], v[1]);
  }
}

// N (2 or 8) consecutive f32 values, aligned to N; `cg` reads through L2
// (values other CTAs wrote before the last grid barrier).
template <int N, bool cg = false>
__device__ __forceinline__ void load_f32(const float* src, float (&v)[N]) {
  static_assert(N == 2 || N == 8, "2 or 8 values");
  if constexpr (N == 8) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 r = cg ? __ldcg(reinterpret_cast<const float4*>(src + i))
                          : __ldg(reinterpret_cast<const float4*>(src + i));
      v[i] = r.x, v[i + 1] = r.y, v[i + 2] = r.z, v[i + 3] = r.w;
    }
  } else {
    const float2 r = cg ? __ldcg(reinterpret_cast<const float2*>(src))
                        : __ldg(reinterpret_cast<const float2*>(src));
    v[0] = r.x, v[1] = r.y;
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* dst, const float (&v)[N]) {
  static_assert(N == 2 || N == 8, "2 or 8 values");
  if constexpr (N == 8) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  }
}

// 1 / (1 + e^-x) with the fast exponential and reciprocal (a few ulp, where
// common.cuh:sigmoidf_ rounds exactly): the forward's update takes three a
// cell, and with 8 warps a SM its instructions are a quarter of a step.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

// hi = bf16(x) and lo = bf16(x - hi) of two values, each pair packed.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const float h0 = __bfloat162float(__float2bfloat16_rn(x0));
  const float h1 = __bfloat162float(__float2bfloat16_rn(x1));
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(x0 - h0, x1 - h1);
}

// ---------------------------------------------------------------------------
// Layouts
// ---------------------------------------------------------------------------

// The row of W_hh (torch layout, gate-major [i, f, g, o]) behind column n of
// a CTA's 4U gate columns: 8-column block j = n / 8 holds the units q·uq +
// j/2 of its four quad lanes q = (n % 8) / 2, gates i and f in even blocks,
// g and o in odd ones (n % 2 picks the second of each pair).
__device__ __forceinline__ int gate_row(int n, int uq, int H, int u0) {
  const int j = n >> 3, c = n & 7;
  const int gate = 2 * (j & 1) + (c & 1), unit = (c >> 1) * uq + (j >> 1);
  return gate * H + u0 + unit;
}

// A thread's cells: rows r0 and r0 + 8 of its warp's 16-row band, units
// col .. col + U/4 - 1 (quad lane q owns the U/4 units from u0 + q·U/4).
struct Cells {
  int r0, col, band, lane;
};

__device__ __forceinline__ Cells cells(int row0, int u0, int uq) {
  const int band = (row0 + (threadIdx.x / kWarpgroup) * kTileRows) / 16 + ((threadIdx.x >> 5) & 3);
  const int lane = threadIdx.x & 31;
  return {band * 16 + (lane >> 2), u0 + (lane & 3) * uq, band, lane};
}

// The W slice (the B operand, `n_rows` x `k_cols` bf16, K-major) into shared
// memory at [n/8][k/8][n%8][k%8]: element (n, k) is src(n, k), read with n
// (kFastN) or k running fastest across the threads, whichever is contiguous
// in W_hh.
template <bool kFastN, typename Src>
__device__ __forceinline__ void load_weights(bf16* W, int n_rows, int k_cols, Src src) {
  for (int i = threadIdx.x; i < n_rows * k_cols; i += blockDim.x) {
    const int n = kFastN ? i % n_rows : i / k_cols, k = kFastN ? i / n_rows : i % k_cols;
    W[((n >> 3) * (k_cols / 8) + (k >> 3)) * 64 + (n & 7) * 8 + (k & 7)] = src(n, k);
  }
  fence_async_shared();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// hx: the exchange of the carried h, two slots (step t writes t & 1, reads
// (t + 1) & 1) of two planes (hi, lo) of Bp x H bf16 in fragments (Bp =
// groups x tiles x 64), zeroed by the caller (rows past B stay zero).
// Threads: `tiles` warpgroups.
template <int U, int MT>
__global__ void __launch_bounds__(MT * kWarpgroup, 1)
lstm_mma_fwd_kernel(const bf16* __restrict__ xg, const bf16* __restrict__ w_hh,
                    const float* __restrict__ h0, const float* __restrict__ c0, bf16* ys,
                    float* hT, float* cT, bf16* cs, bf16* gates, uint32_t* hx, int B, int T,
                    int H, int slices, unsigned int* sync) {
  constexpr int N = 4 * U, UQ = U / 4, ACC = N / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int slice = blockIdx.x % slices, group = blockIdx.x / slices;
  const int u0 = slice * U, row0 = group * MT * kTileRows;
  const int Bp = gridDim.x / slices * MT * kTileRows, G = 4 * H, ksteps = H / 16;
  unsigned int* counter = sync + group * 32;
  const size_t plane = (size_t)Bp * H / 2;  // words
  // W slice: element (n, k) is W_hh[gate_row(n), k], N x H
  load_weights<false>(reinterpret_cast<bf16*>(smem), N, H, [&](int n, int k) {
    return w_hh[(size_t)gate_row(n, UQ, H, u0) * H + k];
  });
  const Cells me = cells(row0, u0, UQ);
  // a row past B reads row B - 1 and stores nothing
  const int rows[2] = {me.r0, me.r0 + 8};
  const int src_rows[2] = {min(rows[0], B - 1), min(rows[1], B - 1)};
  float c[2][UQ];
  // step 0 reads h0 from slot 1
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float h[UQ];
    load_f32(c0 + (size_t)src_rows[rh] * H + me.col, c[rh]);
    load_f32(h0 + (size_t)src_rows[rh] * H + me.col, h);
    if (rows[rh] < B) {
#pragma unroll
      for (int i = 0; i < UQ / 2; ++i) {
        const size_t w = 2 * plane + frag_word(rows[rh], me.col + 2 * i, ksteps);
        split2(h[2 * i], h[2 * i + 1], hx[w], hx[w + plane]);
      }
    }
  }
  rtvc::grid_barrier(counter, slices);

  float acc[ACC];
  const uint32_t w_addr = smem_u32(smem);
  const size_t my_frags = (size_t)me.band * ksteps * 128 + me.lane * 4;  // words
  RTVC_MMA_CLOCK_INIT
  for (int t = 0; t < T; ++t) {
    const int rd = (t + 1) & 1, wr = t & 1;
    RTVC_MMA_CLOCK(4)
    // this step's input gates, fetched before the product they do not need,
    // kept as packed bf16
    uint32_t x[2][4][UQ / 2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        load_words<UQ>(xg + ((size_t)src_rows[rh] * T + t) * G + gate * H + me.col, x[rh][gate]);
    RTVC_MMA_CLOCK(0)
    const uint32_t* in = hx + rd * 2 * plane + my_frags;
    split_product<N>(acc, reinterpret_cast<const uint4*>(in),
                     reinterpret_cast<const uint4*>(in + plane), ksteps, w_addr, 16 * H);
    RTVC_MMA_CLOCK(1)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float h[UQ], gi[UQ], gf[UQ], gg[UQ], go[UQ];
#define RTVC_CELL(P)                                                              \
  if constexpr (P < UQ) {                                                         \
    gi[P] = sigmoid_fast(acc[8 * P + 2 * rh] + bf_at<P>(x[rh][0]));               \
    gf[P] = sigmoid_fast(acc[8 * P + 2 * rh + 1] + bf_at<P>(x[rh][1]));           \
    gg[P] = tanhf(acc[8 * P + 4 + 2 * rh] + bf_at<P>(x[rh][2]));                  \
    go[P] = sigmoid_fast(acc[8 * P + 5 + 2 * rh] + bf_at<P>(x[rh][3]));           \
    c[rh][P] = gf[P] * c[rh][P] + gi[P] * gg[P];                                  \
    h[P] = go[P] * tanhf(c[rh][P]);                                               \
  }
      RTVC_CELL(0) RTVC_CELL(1) RTVC_CELL(2) RTVC_CELL(3)
      RTVC_CELL(4) RTVC_CELL(5) RTVC_CELL(6) RTVC_CELL(7)
#undef RTVC_CELL
      if (rows[rh] >= B) continue;
      const size_t bt = (size_t)rows[rh] * T + t;
      store_bf16(ys + bt * H + me.col, h);
      if (t + 1 < T) {  // the next step's fragments
#pragma unroll
        for (int i = 0; i < UQ / 2; ++i) {
          const size_t w = wr * 2 * plane + frag_word(rows[rh], me.col + 2 * i, ksteps);
          split2(h[2 * i], h[2 * i + 1], hx[w], hx[w + plane]);
        }
      }
      if (cs) {  // training residuals: the cell and the activated gates
        store_bf16(cs + bt * H + me.col, c[rh]);
        bf16* gt = gates + bt * G + me.col;
        store_bf16(gt, gi);
        store_bf16(gt + H, gf);
        store_bf16(gt + 2 * H, gg);
        store_bf16(gt + 3 * H, go);
      }
      if (t == T - 1) {
        store_f32(hT + (size_t)rows[rh] * H + me.col, h);
        store_f32(cT + (size_t)rows[rh] * H + me.col, c[rh]);
      }
    }
    RTVC_MMA_CLOCK(2)
    if (t + 1 < T) rtvc::grid_barrier(counter, slices * (unsigned int)(t + 2));
    RTVC_MMA_CLOCK(3)
  }
  RTVC_MMA_CLOCK_DONE(sync + 32 * gridDim.x)
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// dx: the exchange of dxg, two slots (step t writes t & 1) of two planes of
// Bp x 4H bf16 in fragments, whose k16 step slice · U/4 + p holds the
// fragment a thread of that slice builds for its units' step p. part: two
// slots of the K-groups' partial dh, each (slices / kgroup) x Bp x H f32.
// sync: 32 words a group (its barrier), then 32 a K-group. Threads: `tiles`
// warpgroups. NC = H / kgroup, the dh columns a CTA's partial covers.
template <int U, int MT, int NC>
__global__ void __launch_bounds__(MT * kWarpgroup, 1)
lstm_mma_bwd_kernel(const bf16* __restrict__ dys, const float* __restrict__ dhT,
                    const float* __restrict__ dcT, const bf16* __restrict__ gates,
                    const bf16* __restrict__ cs, const float* __restrict__ c0,
                    const bf16* __restrict__ w_hh, float* dxg, float* dh0, float* dc0,
                    uint32_t* dx, float* part, int B, int T, int H, int slices, int kgroup,
                    unsigned int* sync) {
  constexpr int UQ = U / 4, ACC = NC / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int slice = blockIdx.x % slices, group = blockIdx.x / slices;
  const int kg = slice / kgroup, member = slice % kgroup, kgroups = slices / kgroup;
  const int groups = gridDim.x / slices;
  const int u0 = slice * U, row0 = group * MT * kTileRows;
  const int Bp = groups * MT * kTileRows, G = 4 * H, ksteps = H / 4, K = kgroup * 4 * U;
  unsigned int* counter = sync + group * 32;
  unsigned int* kcounter = sync + (groups + group * kgroups + kg) * 32;
  const size_t plane = (size_t)Bp * G / 2;     // words
  const size_t part_rows = (size_t)Bp * H;     // one K-group's partial
  const size_t part_slot = (size_t)kgroups * part_rows;
  // W slice: element (n, k) of the NC x K operand is W_hh[row of column k of
  // the K-group's slices, member · NC + n]
  load_weights<true>(reinterpret_cast<bf16*>(smem), NC, K, [&](int n, int k) {
    const int s = kg * kgroup + k / (4 * U);
    return w_hh[(size_t)gate_row(k % (4 * U), UQ, H, s * U) * H + member * NC + n];
  });
  const Cells me = cells(row0, u0, UQ);
  const int rows[2] = {me.r0, me.r0 + 8};
  const int src_rows[2] = {min(rows[0], B - 1), min(rows[1], B - 1)};
  float dc[2][UQ], dh[2][UQ];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    load_f32(dcT + (size_t)src_rows[rh] * H + me.col, dc[rh]);
    load_f32(dhT + (size_t)src_rows[rh] * H + me.col, dh[rh]);
  }
  float acc[ACC];
  const uint32_t w_addr = smem_u32(smem);
  // this thread's fragments: written at its slice's steps, read at its
  // K-group's (the same rows and lane in every CTA of the group)
  const size_t my_frags = (size_t)me.band * ksteps * 128 + me.lane * 4;
  const int out_col = member * NC + 2 * (me.lane & 3);
  RTVC_MMA_CLOCK_INIT
  for (int t = T - 1; t >= 0; --t) {
    RTVC_MMA_CLOCK(4)
    // the step's residuals from device memory, issued first: their latency
    // runs beside the partials' sums
    uint32_t gw[2][4][UQ / 2], cw[2][UQ / 2], pw[2][UQ / 2], yw[2][UQ / 2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const size_t bt = (size_t)src_rows[rh] * T + t;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        load_words<UQ>(gates + bt * G + gate * H + me.col, gw[rh][gate]);
      load_words<UQ>(cs + bt * H + me.col, cw[rh]);
      load_words<UQ>(dys + bt * H + me.col, yw[rh]);
      if (t > 0) {
        load_words<UQ>(cs + (bt - 1) * H + me.col, pw[rh]);
      } else {  // c0, rounded as cs is
        float c0v[UQ];
        load_f32(c0 + (size_t)src_rows[rh] * H + me.col, c0v);
#pragma unroll
        for (int i = 0; i < UQ / 2; ++i) pw[rh][i] = pack_bf16(c0v[2 * i], c0v[2 * i + 1]);
      }
    }
    // dh of the cells: dhT, or the K-groups' partials of step t + 1 (written
    // before the last grid barrier) summed in their order
    if (t < T - 1) {
      const float* in = part + ((t + 1) & 1) * part_slot + me.col;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
#pragma unroll
        for (int p = 0; p < UQ; ++p) dh[rh][p] = 0.0f;
      // unrolled so that the loads go out together; the sums keep their order
#pragma unroll 6
      for (int g = 0; g < kgroups; ++g) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          float v[UQ];
          load_f32<UQ, true>(in + g * part_rows + (size_t)src_rows[rh] * H, v);
#pragma unroll
          for (int p = 0; p < UQ; ++p) dh[rh][p] += v[p];
        }
      }
    }
    RTVC_MMA_CLOCK(0)
    // the cell's cotangents (lstm_train_kernel.py:172-191), the dxg stores,
    // and dxg's hi and lo fragments: k-step p holds (i, f) of unit p at rows
    // r0, r0 + 8, then (g, o) at both
    uint32_t* out = dx + (t & 1) * 2 * plane + my_frags + (size_t)slice * UQ * 128;
    uint32_t f_hi[UQ][4], f_lo[UQ][4];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float d[4][UQ];
#define RTVC_CELL(P)                                                                  \
  if constexpr (P < UQ) {                                                             \
    const float i_g = bf_at<P>(gw[rh][0]), f_g = bf_at<P>(gw[rh][1]);                 \
    const float g_g = bf_at<P>(gw[rh][2]), o_g = bf_at<P>(gw[rh][3]);                 \
    const float tanhc = tanhf(bf_at<P>(cw[rh]));                                      \
    const float dhj = bf_at<P>(yw[rh]) + dh[rh][P];                                   \
    const float dcj = dc[rh][P] + dhj * o_g * (1.0f - tanhc * tanhc);                 \
    d[0][P] = dcj * g_g * i_g * (1.0f - i_g);                                         \
    d[1][P] = dcj * bf_at<P>(pw[rh]) * f_g * (1.0f - f_g);                            \
    d[2][P] = dcj * i_g * (1.0f - g_g * g_g);                                         \
    d[3][P] = dhj * tanhc * o_g * (1.0f - o_g);                                       \
    dc[rh][P] = dcj * f_g;                                                            \
  }
      RTVC_CELL(0) RTVC_CELL(1) RTVC_CELL(2) RTVC_CELL(3)
      RTVC_CELL(4) RTVC_CELL(5) RTVC_CELL(6) RTVC_CELL(7)
#undef RTVC_CELL
      if (rows[rh] < B) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          store_f32(dxg + ((size_t)rows[rh] * T + t) * G + gate * H + me.col, d[gate]);
      } else {  // a row past B adds nothing to the product
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
#pragma unroll
          for (int p = 0; p < UQ; ++p) d[gate][p] = 0.0f;
      }
#pragma unroll
      for (int p = 0; p < UQ; ++p) {
        split2(d[0][p], d[1][p], f_hi[p][rh], f_lo[p][rh]);          // (i, f)
        split2(d[2][p], d[3][p], f_hi[p][2 + rh], f_lo[p][2 + rh]);  // (g, o)
      }
    }
#pragma unroll
    for (int p = 0; p < UQ; ++p) {
      uint4* o = reinterpret_cast<uint4*>(out + p * 128);
      o[0] = make_uint4(f_hi[p][0], f_hi[p][1], f_hi[p][2], f_hi[p][3]);
      o[plane / 4] = make_uint4(f_lo[p][0], f_lo[p][1], f_lo[p][2], f_lo[p][3]);
    }
    RTVC_MMA_CLOCK(1)
    rtvc::grid_barrier(kcounter, kgroup * (unsigned int)(T - t));
    RTVC_MMA_CLOCK(2)
    // the K-group's partial dh over this member's NC columns
    const uint32_t* in = dx + (t & 1) * 2 * plane + my_frags + (size_t)kg * kgroup * UQ * 128;
    split_product<NC>(acc, reinterpret_cast<const uint4*>(in),
                      reinterpret_cast<const uint4*>(in + plane), kgroup * UQ, w_addr, 16 * K);
    float* po = part + (t & 1) * part_slot + kg * part_rows + out_col;
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      if (rows[rh] >= B) continue;
      float* o = po + (size_t)rows[rh] * H;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[4 * j + 2 * rh], acc[4 * j + 2 * rh + 1]);
    }
    RTVC_MMA_CLOCK(3)
    rtvc::grid_barrier(counter, slices * (unsigned int)(T - t));
  }
  RTVC_MMA_CLOCK_DONE(sync + 32 * gridDim.x)
  // dh0 = dxg_0 · W_hh: the partials of step 0
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    if (rows[rh] >= B) continue;
    const size_t at = (size_t)rows[rh] * H + me.col;
    float s[UQ];
#pragma unroll
    for (int p = 0; p < UQ; ++p) s[p] = 0.0f;
    for (int g = 0; g < kgroups; ++g) {
      float v[UQ];
      load_f32<UQ, true>(part + g * part_rows + at, v);
#pragma unroll
      for (int p = 0; p < UQ; ++p) s[p] += v[p];
    }
    store_f32(dh0 + at, s);
    store_f32(dc0 + at, dc[rh]);
  }
}

// ---------------------------------------------------------------------------
// Plans and launches
// ---------------------------------------------------------------------------

// The plan ops/lstm_seq.py:mma_plan hands over: groups, slices, units a CTA,
// 64-row tiles a CTA, the backward's K-group (slices whose dxg a CTA
// multiplies; 0 for the forward), bytes of shared memory a CTA.
struct MmaPlan {
  int groups, slices, units, tiles, kgroup, smem;
};

// The plan covers (B, H) exactly as the kernels cut it (every unit in one
// slice, every row in one tile, the product's k16 steps in whole pairs of
// batches) and its smem is the W slice's, 4U x H bf16.
bool mma_plan_ok(const MmaPlan& p, int B, int H, bool backward) {
  if (p.groups < 1 || p.slices < 1 || p.units < 8 || p.units % 8 || p.tiles < 1 || H % 128 ||
      p.slices * p.units != H)
    return false;
  const long long rows = (long long)p.tiles * kTileRows;
  if (p.groups * rows < B || (p.groups - 1) * rows >= B) return false;
  if (backward ? p.kgroup < 1 || p.slices % p.kgroup || p.kgroup * p.units / 4 % (2 * kBatch)
               : p.kgroup != 0)
    return false;
  return 8LL * p.units * H == p.smem;
}

// A cooperative launch of `ctas` CTAs of `threads` threads with `smem` bytes
// of dynamic shared memory: all CTAs resident at once, or refused.
template <typename Kernel>
int launch(Kernel kernel, int ctas, int threads, int smem, void** args, void* stream) {
  cudaError_t e = rtvc::allow_smem((const void*)kernel, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(ctas), dim3(threads), args,
                                  (size_t)smem, static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// The instantiations (ops/lstm_seq.py:MMA_KINDS): (units, tiles) = (32, 2)
// for the GE2E step's B 640, (32, 1) where one tile a CTA keeps more SMs busy
// (B 320), (8, 1) for a small batch; the backward's also by the dh columns
// of a partial, H / kgroup (192 at H 768 in K-groups of 4, 128 at H 512).
#define RTVC_MMA_FWD(UNITS, TILES)                                                     \
  if (plan.units == UNITS && plan.tiles == TILES)                                      \
    return launch(lstm_mma_fwd_kernel<UNITS, TILES>, plan.groups * plan.slices,        \
                  TILES * kWarpgroup, plan.smem, args, stream);
#define RTVC_MMA_BWD(UNITS, TILES, NC)                                                  \
  if (plan.units == UNITS && plan.tiles == TILES && H == NC * plan.kgroup)              \
    return launch(lstm_mma_bwd_kernel<UNITS, TILES, NC>, plan.groups * plan.slices,     \
                  TILES * kWarpgroup, plan.smem, args, stream);

// xg (B, T, 4H) and w_hh (4H, H) bf16, h0/c0 (B, H) f32 → ys (B, T, H) bf16,
// hT/cT (B, H) f32, and, when cs is not null, the residuals cs (B, T, H) and
// gates (B, T, 4H) bf16; hx is the zeroed exchange (2, 2, Bp, H / 2) of
// 32-bit words, Bp = groups x tiles x 64. plan_v = {groups, slices, units,
// tiles, kgroup (0), smem}; sync is 32 zeroed words a group. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a plan it does not take).
extern "C" int rtvc_lstm_mma_fwd_bf16(const bf16* xg, const bf16* w_hh, const float* h0,
                                      const float* c0, bf16* ys, float* hT, float* cT,
                                      bf16* cs, bf16* gates, uint32_t* hx, int B, int T, int H,
                                      const int* plan_v, unsigned int* sync, void* stream) {
  const MmaPlan plan{plan_v[0], plan_v[1], plan_v[2], plan_v[3], plan_v[4], plan_v[5]};
  if (B < 1 || T < 1 || !mma_plan_ok(plan, B, H, false) || (cs == nullptr) != (gates == nullptr))
    return (int)cudaErrorInvalidValue;
  int slices = plan.slices;
  void* args[] = {&xg, &w_hh, &h0, &c0, &ys, &hT, &cT, &cs, &gates, &hx,
                  &B,  &T,    &H,  &slices, &sync};
  RTVC_MMA_FWD(32, 2)
  RTVC_MMA_FWD(32, 1)
  RTVC_MMA_FWD(8, 1)
  return (int)cudaErrorInvalidValue;
}

// dys (B, T, H), gates (B, T, 4H), cs (B, T, H) and w_hh (4H, H) bf16; dhT,
// dcT and c0 (B, H) f32 → dxg (B, T, 4H), dh0/dc0 (B, H) f32; dx is the
// exchange (2, 2, Bp, 2H) of 32-bit words, part f32 scratch of (2, slices /
// kgroup, Bp, H). plan_v as for the forward, with the K-group; sync is 32
// zeroed words a group, then 32 a K-group of every group. Returns the
// launch's cudaError_t.
extern "C" int rtvc_lstm_mma_bwd_bf16(const bf16* dys, const float* dhT, const float* dcT,
                                      const bf16* gates, const bf16* cs, const float* c0,
                                      const bf16* w_hh, float* dxg, float* dh0, float* dc0,
                                      uint32_t* dx, float* part, int B, int T, int H,
                                      const int* plan_v, unsigned int* sync, void* stream) {
  const MmaPlan plan{plan_v[0], plan_v[1], plan_v[2], plan_v[3], plan_v[4], plan_v[5]};
  if (B < 1 || T < 1 || !mma_plan_ok(plan, B, H, true)) return (int)cudaErrorInvalidValue;
  int slices = plan.slices, kgroup = plan.kgroup;
  void* args[] = {&dys, &dhT, &dcT, &gates, &cs, &c0, &w_hh, &dxg, &dh0, &dc0, &dx, &part,
                  &B,   &T,   &H,   &slices, &kgroup, &sync};
  RTVC_MMA_BWD(32, 2, 192)
  RTVC_MMA_BWD(32, 1, 192)
  RTVC_MMA_BWD(8, 1, 128)
  return (int)cudaErrorInvalidValue;
}
