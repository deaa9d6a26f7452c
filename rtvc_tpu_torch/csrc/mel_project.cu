// Mel-filterbank projection of |STFT| magnitudes fused with the dB
// conversion, the reference-level shift and the normalisation:
//   out = norm(20·log10(max(basis · mag, min_level)) - ref_level_db).
//
// Replaces: rtvc_tpu/ops/pallas/mel_kernel.py:mel_project_normalize (body
// _kernel), the last stage of the synthesizer-format mel spectrogram.
//
// What bounds it on the H100: the product is 2·T·n_bins·num_mels FLOP
// (0.39 GFLOP for a minute of audio: 4801 frames x 513 bins x 80 mels)
// over (n_bins + num_mels)·T·4 bytes plus the 164 KB filterbank, about
// 35 FLOP a byte, above the card's f32 ridge of 20 FLOP a byte: bound by
// operations, at a few microseconds. At that size the launch and the tiles'
// fill and drain matter more than either rate.
//
// Design: one CTA per tile of 32 frames, so a minute of audio fills the
// card (151 CTAs on 132 SMs) and each magnitude is read from device memory
// once and each output written once. The bins are walked in chunks of 32:
// the chunk's magnitudes (32 bins x 32 frames, rows of 128 contiguous bytes
// in the (n_bins, T) input) and the chunk's filterbank columns (transposed
// to bin-major, so a bin's num_mels weights are neighbours) are staged in
// shared memory; the filterbank comes from L2, where all CTAs share it. The
// 128 threads form 8 frame quads x 16 mel groups; a thread owns 4 frames x
// up to 8 mels (mel m belongs to group m mod 16) in registers, so one
// 16-byte and up to 8 4-byte shared loads feed up to 32 multiply-adds. The
// epilogue runs in registers with the plain version's order of operations.
// The exact (n_bins, T) input is taken and (num_mels, T) written: ragged
// tiles are masked, nothing is padded.
#include "common.cuh"

namespace {

constexpr int kFrames = 32;           // frames per CTA
constexpr int kBins = 32;             // bins per staged chunk
constexpr int kMelGroups = 16;        // thread groups along the mel axis
constexpr int kMaxMelsPerThread = 8;  // num_mels <= 128
constexpr int kThreads = (kFrames / 4) * kMelGroups;

struct Epilogue {
  float min_level, ref_level_db, min_level_db, max_abs;
  int symmetric, clip;
};

__global__ void __launch_bounds__(kThreads)
mel_project_kernel(const float* __restrict__ mag, const float* __restrict__ basis,
                   float* __restrict__ out, int n_bins, int T, int num_mels, Epilogue ep) {
  extern __shared__ float4 smem4[];
  float* s_mag = reinterpret_cast<float*>(smem4);  // kBins x kFrames
  float* s_basis = s_mag + kBins * kFrames;        // kBins x (num_mels + 1)
  const int pitch = num_mels + 1;
  const int tid = threadIdx.x;
  const int fq = tid % (kFrames / 4);  // frame quad: frames 4·fq .. 4·fq + 3 of the tile
  const int mg = tid / (kFrames / 4);  // mel group: mels mg, mg + 16, ...
  const int t0 = blockIdx.x * kFrames;

  float acc[kMaxMelsPerThread][4];
#pragma unroll
  for (int j = 0; j < kMaxMelsPerThread; ++j)
#pragma unroll
    for (int f = 0; f < 4; ++f) acc[j][f] = 0.0f;

  for (int k0 = 0; k0 < n_bins; k0 += kBins) {
    for (int i = tid; i < kBins * kFrames; i += kThreads) {
      const int kk = i / kFrames, f = i % kFrames;
      const int k = k0 + kk, t = t0 + f;
      s_mag[i] = (k < n_bins && t < T) ? mag[(size_t)k * T + t] : 0.0f;
    }
    for (int i = tid; i < kBins * num_mels; i += kThreads) {
      const int m = i / kBins, kk = i % kBins;
      const int k = k0 + kk;
      s_basis[kk * pitch + m] = k < n_bins ? __ldg(basis + (size_t)m * n_bins + k) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBins; ++kk) {
      const float4 v = *reinterpret_cast<const float4*>(s_mag + kk * kFrames + 4 * fq);
#pragma unroll
      for (int j = 0; j < kMaxMelsPerThread; ++j) {
        const int m = mg + kMelGroups * j;
        if (m < num_mels) {
          const float w = s_basis[kk * pitch + m];
          acc[j][0] += w * v.x;
          acc[j][1] += w * v.y;
          acc[j][2] += w * v.z;
          acc[j][3] += w * v.w;
        }
      }
    }
    __syncthreads();
  }

  const float span = -ep.min_level_db;
#pragma unroll
  for (int j = 0; j < kMaxMelsPerThread; ++j) {
    const int m = mg + kMelGroups * j;
    if (m >= num_mels) continue;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int t = t0 + 4 * fq + f;
      if (t >= T) continue;
      // each step rounded on its own, as the plain version's are
      const float db = __fsub_rn(__fmul_rn(20.0f, log10f(fmaxf(acc[j][f], ep.min_level))),
                                 ep.ref_level_db);
      const float scaled = __fdiv_rn(__fsub_rn(db, ep.min_level_db), span);
      float v, lo, hi;
      if (ep.symmetric) {
        v = __fsub_rn(__fmul_rn(2.0f * ep.max_abs, scaled), ep.max_abs);
        lo = -ep.max_abs;
        hi = ep.max_abs;
      } else {
        v = __fmul_rn(ep.max_abs, scaled);
        lo = 0.0f;
        hi = ep.max_abs;
      }
      if (ep.clip) v = fminf(fmaxf(v, lo), hi);
      out[(size_t)m * T + t] = v;
    }
  }
}

}  // namespace

// mag (n_bins, T) magnitudes, basis (num_mels, n_bins) filterbank → out
// (num_mels, T), all f32, contiguous, on the current device; num_mels <= 128.
// min_level = 10^(min_level_db / 20). Returns the launch's cudaError_t.
extern "C" int rtvc_mel_project(const float* mag, const float* basis, float* out, int n_bins,
                                int T, int num_mels, float min_level, float ref_level_db,
                                float min_level_db, float max_abs, int symmetric, int clip,
                                void* stream) {
  if (num_mels < 1 || num_mels > kMelGroups * kMaxMelsPerThread || T < 1 || n_bins < 1)
    return (int)cudaErrorInvalidValue;
  const Epilogue ep{min_level, ref_level_db, min_level_db, max_abs, symmetric, clip};
  const size_t smem = (size_t)(kBins * kFrames + kBins * (num_mels + 1)) * sizeof(float);
  const int tiles = (T + kFrames - 1) / kFrames;
  mel_project_kernel<<<tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mag, basis, out, n_bins, T, num_mels, ep);
  return (int)cudaGetLastError();
}
