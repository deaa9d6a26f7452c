// Mel-filterbank projection of |STFT| magnitudes fused with the dB
// conversion, the reference-level shift and the normalisation:
//   out = norm(20·log10(max(basis · mag, min_level)) - ref_level_db).
//
// Replaces: rtvc_tpu/ops/pallas/mel_kernel.py:mel_project_normalize (body
// _kernel), the last stage of the synthesizer-format mel spectrogram.
//
// The filterbank is banded: each mel row's non-zero weights form one run of
// bins (4 to 37 of 513 at the synthesizer's 16 kHz, n_fft 1024, 80 mels;
// 997 of the 41,040 entries), and neighbouring rows overlap by about half a
// run. The wrapper derives each row's run [first, first + width) from the
// basis it is given (ops/mel_project.py:mel_bands) and passes the runs'
// weights packed row after row, so correctness rests on the basis and not on
// its shape: a row of zeros is an empty run and gives min_level.
//
// What bounds it on the H100: with the band, the work is 2·T·Σwidth FLOP
// (9.6 MFLOP for a minute of audio, 4801 frames) against the bytes of the
// magnitudes read once and the mel written once (9.85 + 1.54 MB): bound by
// bytes, at ≈ 3.4 µs, where the dense product (0.39 GFLOP) would be bound
// by operations at 5.9 µs. What is left is the memory traffic and the
// latency of one launch.
//
// Design: a CTA takes a tile of 32 consecutive frames and a group of
// `mels_per_cta` consecutive mel rows, one warp a row and one lane a frame.
// It stages the group's joint band of magnitudes (its bins x 32 frames, rows
// of 128 contiguous bytes of the (n_bins, T) input) and the group's band
// weights in shared memory with cp.async, all issued before one wait, so a
// CTA pays one round trip to device memory; groups overlap only at their
// edges, so each magnitude is read about 1.1 times at 8 rows a group. Then
// each lane sums its row's band in bin order (fmaf, the weight a broadcast,
// the magnitude its own bank) and runs the epilogue in registers with the
// plain version's order of operations. The wrapper picks the group size from
// the frame count so that there are at least two CTAs an SM (8 rows a group
// at 4801 frames: 1510 CTAs; 2 at 302 frames: 400). The exact (n_bins, T)
// input is taken and (num_mels, T) written: ragged tiles are masked, nothing
// is padded, no atomics, and two runs give the same bits. f32 FFMA only:
// the product is small now, and TF32 would not hold the 2e-4 tolerance on
// the normalised scale.
#include "common.cuh"

namespace {

constexpr int kFrames = 32;  // frames per CTA: one a lane
constexpr int kMaxWarps = 32;

struct Epilogue {
  float min_level, ref_level_db, min_level_db, max_abs;
  int symmetric, clip;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// bands[m] = (first bin, width, offset of the run in `weights`, unused).
__global__ void __launch_bounds__(kFrames * kMaxWarps)
mel_project_kernel(const float* __restrict__ mag, const float* __restrict__ weights,
                   const int4* __restrict__ bands, float* __restrict__ out, int n_bins, int T,
                   int num_mels, Epilogue ep) {
  extern __shared__ float4 smem4[];
  const int mpc = blockDim.x / kFrames;
  const int m0 = blockIdx.y * mpc;
  const int m_end = min(m0 + mpc, num_mels);
  const int t0 = blockIdx.x * kFrames;
  const int lane = threadIdx.x % kFrames;
  const int warp = threadIdx.x / kFrames;

  // the group's joint band and its weights, which are contiguous in `weights`
  int lo = n_bins, hi = 0;
  for (int m = m0; m < m_end; ++m) {
    const int4 b = __ldg(bands + m);
    if (b.y > 0) {
      lo = min(lo, b.x);
      hi = max(hi, b.x + b.y);
    }
  }
  const int rows = max(hi - lo, 0);
  const int4 b_first = __ldg(bands + m0), b_last = __ldg(bands + m_end - 1);
  const int w_begin = b_first.z, n_w = b_last.z + b_last.y - b_first.z;

  float* s_w = reinterpret_cast<float*>(smem4);  // n_w weights
  float* s_mag = s_w + (n_w + 3) / 4 * 4;        // rows x kFrames magnitudes
  for (int i = threadIdx.x; i < n_w; i += blockDim.x)
    cp_async4(s_w + i, weights + w_begin + i);
  if (t0 + lane < T) {
    const float* src = mag + (size_t)lo * T + t0 + lane;
    for (int r = warp; r < rows; r += mpc)
      cp_async4(s_mag + r * kFrames + lane, src + (size_t)r * T);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int m = m0 + warp, t = t0 + lane;
  if (m >= m_end || t >= T) return;
  const int4 b = __ldg(bands + m);
  const float* w = s_w + (b.z - w_begin);
  const float* x = s_mag + (b.x - lo) * kFrames + lane;
  float acc = 0.0f;
#pragma unroll 4
  for (int k = 0; k < b.y; ++k) acc = fmaf(w[k], x[k * kFrames], acc);

  // each step rounded on its own, as the plain version's are
  const float span = -ep.min_level_db;
  const float db =
      __fsub_rn(__fmul_rn(20.0f, log10f(fmaxf(acc, ep.min_level))), ep.ref_level_db);
  const float scaled = __fdiv_rn(__fsub_rn(db, ep.min_level_db), span);
  float v, lo_v, hi_v;
  if (ep.symmetric) {
    v = __fsub_rn(__fmul_rn(2.0f * ep.max_abs, scaled), ep.max_abs);
    lo_v = -ep.max_abs;
    hi_v = ep.max_abs;
  } else {
    v = __fmul_rn(ep.max_abs, scaled);
    lo_v = 0.0f;
    hi_v = ep.max_abs;
  }
  if (ep.clip) v = fminf(fmaxf(v, lo_v), hi_v);
  out[(size_t)m * T + t] = v;
}

}  // namespace

// mag (n_bins, T) magnitudes → out (num_mels, T), f32, contiguous, on the
// current device. weights: the rows' band weights packed row after row;
// bands (num_mels, 4) int32: each row's first bin, width and offset into
// weights (ops/mel_project.py:mel_bands). mels_per_cta (1 to 32) rows a CTA,
// smem its bytes of shared memory: the largest group's weights (rounded up
// to 4) plus its joint band x 32 frames. min_level = 10^(min_level_db / 20).
// Returns the launch's cudaError_t.
extern "C" int rtvc_mel_project(const float* mag, const float* weights, const int* bands,
                                float* out, int n_bins, int T, int num_mels, int mels_per_cta,
                                int smem, float min_level, float ref_level_db,
                                float min_level_db, float max_abs, int symmetric, int clip,
                                void* stream) {
  if (num_mels < 1 || T < 1 || n_bins < 1 || mels_per_cta < 1 || mels_per_cta > kMaxWarps ||
      smem < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = rtvc::allow_smem((const void*)mel_project_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const Epilogue ep{min_level, ref_level_db, min_level_db, max_abs, symmetric, clip};
  const dim3 grid((T + kFrames - 1) / kFrames, (num_mels + mels_per_cta - 1) / mels_per_cta);
  mel_project_kernel<<<grid, kFrames * mels_per_cta, smem, static_cast<cudaStream_t>(stream)>>>(
      mag, weights, reinterpret_cast<const int4*>(bands), out, n_bins, T, num_mels, ep);
  return (int)cudaGetLastError();
}
