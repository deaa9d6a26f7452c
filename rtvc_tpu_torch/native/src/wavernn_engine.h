// Native WaveRNN inference engine — CPU fallback / deployment runtime.
//
// Capability parity with the reference's "libwavernn" C++/Eigen engine
// (ref: vocoder/libwavernn/{fatchord,geneing,runtimeracer}_version/src/),
// designed fresh:
//   * one engine, all three variants (the reference builds three separate
//     binaries selected at compile time, ref: build.sh:4);
//   * batch-norm folded into conv weights at export time (the reference
//     executes BN at runtime, ref: wavernn.cpp:294-304);
//   * group-of-4 sparse GEMV over a CSR-of-groups layout with uint16 column
//     indices (the reference uses uint8 indices with a 255 row marker,
//     ref: convert.py:61-84) — plain C++ inner loops the compiler
//     autovectorizes, no Eigen dependency;
//   * per-instance RNG (the reference shares a function-static RNG across
//     threads — a latent race, ref: net_impl.cpp:136-137; SURVEY.md §5.2).
#pragma once

#include <cstdint>
#include <random>
#include <string>
#include <vector>

namespace rtvc {

enum Variant : int32_t { FATCHORD = 0, GENEING = 1, RUNTIMERACER = 2 };
enum Mode : int32_t { RAW = 0, BITS = 1, MOL = 2 };
enum TensorKind : int32_t { DENSE = 0, GROUP_SPARSE = 1 };

struct DenseMat {
  int rows = 0, cols = 0;
  bool f16 = false;        // weights held as IEEE half (w16), else f32 (w)
  std::vector<float> w;    // row-major (f32 storage)
  std::vector<uint16_t> w16;  // row-major (f16 storage)
  const float* row(int r) const { return w.data() + (size_t)r * cols; }
  const uint16_t* row16(int r) const { return w16.data() + (size_t)r * cols; }
};

// CSR-of-groups: each row stores a list of group-column indices and a
// contiguous block of group_size weights per group.
// f16 storage (round 4): the per-sample loop is DRAM-bandwidth-bound on
// one core (bytes/sample × samples/s ≈ the single-core DRAM ceiling in
// the round-4 measurements), so halving the streamed weight bytes ≈
// halves the wall time; the GEMV converts half→float in registers.
struct SparseMat {
  int rows = 0, cols = 0, group = 4;
  bool f16 = false;
  std::vector<int32_t> row_ptr;    // rows+1 entries into groups/vals
  std::vector<uint16_t> group_col; // per group: column/group index
  std::vector<float> vals;         // per group: group contiguous weights
  std::vector<uint16_t> vals16;    // f16 storage variant
};

// A weight matrix that is either dense or group-sparse.
struct Mat {
  TensorKind kind = DENSE;
  DenseMat dense;
  SparseMat sparse;
  int rows() const { return kind == DENSE ? dense.rows : sparse.rows; }
  int cols() const { return kind == DENSE ? dense.cols : sparse.cols; }
};

struct Linear {
  Mat w;
  std::vector<float> b;  // may be empty
};

struct Gru {
  Mat w_ih;  // (3H, I)
  Mat w_hh;  // (3H, H)
  std::vector<float> b_ih, b_hh;
  int hidden = 0;
};

// y += W x  (y has W.rows entries)
void gemv_acc(const Mat& m, const float* x, float* y);
// y = Wx + b
void gemv(const Linear& lin, const float* x, float* y);
// ys[b] += W xs[b] for b < B, traversing the weights ONCE (the batched
// sample loop's kernel: the per-sample chain is latency-bound, so B
// independent chains fill the FMA pipe and amortize weight loads)
void gemv_acc_multi(const Mat& m, const float* const* xs, float* const* ys,
                    int B);

struct ResBlock {
  // 1x1 convs with folded BN: y = W2(relu(W1 x + b1)) + b2 + x
  DenseMat w1, w2;
  std::vector<float> b1, b2;
};

struct UpsampleNet {
  // conv_in (folded BN) VALID over 2*pad+1 frames
  DenseMat conv_in_w;            // (compute, feat*(2p+1))
  std::vector<float> conv_in_b;
  std::vector<ResBlock> blocks;
  DenseMat conv_out_w;           // (res_out, compute)
  std::vector<float> conv_out_b;
  std::vector<int> factors;           // upsample factors
  std::vector<std::vector<float>> smooth;  // per factor: kernel (2s+1)
};

struct Model {
  int32_t variant = RUNTIMERACER;
  int32_t mode = RAW;
  int32_t n_classes = 1024, rnn_dims = 256, fc_dims = 256;
  int32_t feat_dims = 80, aux_dims = 32, res_blocks = 10, pad = 2, hop = 200;
  UpsampleNet upsample;
  Linear I;
  std::vector<Gru> rnns;     // variant-dependent count
  std::vector<Linear> fcs;   // variant-dependent count

  bool load(const std::string& path, std::string* err);

  // mel: (n_mels, n_frames) row-major, normalized to [-1, 1].
  // Returns float samples in [-1, 1] *before* mu-law decode / de-emphasis
  // (the Python wrapper applies those, matching the JAX path).
  std::vector<float> generate(const float* mel, int n_frames,
                              bool argmax_sampling);

  // Batched sample loop (round 4): mels = n_batch contiguous
  // (n_mels, n_frames) blocks (the fold-with-overlap chunks); all chunks
  // advance in LOCKSTEP so every weight matrix is traversed once per
  // step for the whole batch — B independent recurrent chains fill the
  // FMA pipe the single-chain loop leaves idle (the CPU analogue of the
  // TPU fold batching). Returns (n_batch, T) concatenated; with
  // n_batch=1 this is bit-identical to generate().
  std::vector<float> generate_batch(const float* mels, int n_batch,
                                    int n_frames, bool argmax_sampling);

  void set_seed(uint64_t seed) { rng_.seed(seed); }

 private:
  std::mt19937_64 rng_{0x5eed};
  std::vector<float> softmax_scratch_;
  int sample_categorical(const float* logits, int n, bool argmax);
  float sample_mol(const float* logits, bool argmax);
  float sample_beta(const float* logits, bool argmax);
};

}  // namespace rtvc
