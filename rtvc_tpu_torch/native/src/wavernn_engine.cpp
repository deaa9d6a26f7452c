// Native WaveRNN engine implementation. See header for design notes.
#include "wavernn_engine.h"

#include <algorithm>
#include <cassert>
#include <cmath>
#include <cstdio>
#include <cstring>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace rtvc {

namespace {

constexpr char kMagic[8] = {'R', 'T', 'V', 'C', 'N', 'A', 'T', '1'};

struct Reader {
  FILE* f;
  bool ok = true;
  template <typename T>
  T scalar() {
    T v{};
    ok = ok && fread(&v, sizeof(T), 1, f) == 1;
    return v;
  }
  void bytes(void* dst, size_t n) { ok = ok && fread(dst, 1, n, f) == n; }
  std::string str() {
    int32_t n = scalar<int32_t>();
    std::string s(ok ? n : 0, '\0');
    if (ok && n) bytes(s.data(), n);
    return s;
  }
};

Mat read_mat(Reader& r) {
  Mat m;
  // kinds: 0 dense f32 | 1 sparse f32 | 2 dense f16 | 3 sparse f16
  const int32_t kind_raw = r.scalar<int32_t>();
  const bool f16 = kind_raw >= 2;
  m.kind = (kind_raw % 2 == 0) ? DENSE : GROUP_SPARSE;
  int rows = r.scalar<int32_t>();
  int cols = r.scalar<int32_t>();
  if (m.kind == DENSE) {
    m.dense.rows = rows;
    m.dense.cols = cols;
    m.dense.f16 = f16;
    if (f16) {
      m.dense.w16.resize((size_t)rows * cols);
      r.bytes(m.dense.w16.data(), m.dense.w16.size() * sizeof(uint16_t));
    } else {
      m.dense.w.resize((size_t)rows * cols);
      r.bytes(m.dense.w.data(), m.dense.w.size() * sizeof(float));
    }
  } else {
    m.sparse.rows = rows;
    m.sparse.cols = cols;
    m.sparse.f16 = f16;
    m.sparse.group = r.scalar<int32_t>();
    int32_t n_groups = r.scalar<int32_t>();
    m.sparse.row_ptr.resize(rows + 1);
    r.bytes(m.sparse.row_ptr.data(), (rows + 1) * sizeof(int32_t));
    m.sparse.group_col.resize(n_groups);
    r.bytes(m.sparse.group_col.data(), n_groups * sizeof(uint16_t));
    if (f16) {
      m.sparse.vals16.resize((size_t)n_groups * m.sparse.group);
      r.bytes(m.sparse.vals16.data(),
              m.sparse.vals16.size() * sizeof(uint16_t));
    } else {
      m.sparse.vals.resize((size_t)n_groups * m.sparse.group);
      r.bytes(m.sparse.vals.data(), m.sparse.vals.size() * sizeof(float));
    }
  }
  return m;
}

std::vector<float> read_vec(Reader& r) {
  int32_t n = r.scalar<int32_t>();
  std::vector<float> v(r.ok ? n : 0);
  if (r.ok && n) r.bytes(v.data(), n * sizeof(float));
  return v;
}

// Fast branchless expf (Cephes-style polynomial + exponent bit splice,
// ~2 ulp over the gate range). The GRU gate loops call exp/tanh ~3000×
// per audio sample; the scalar libm calls were the engine's single
// largest cost (measured: sparse-vs-dense speedup was capped at 1.3×
// until these were replaced with something the compiler can vectorize).
inline float fast_expf(float x) {
  x = std::min(std::max(x, -87.0f), 88.0f);
  const float log2e = 1.442695040f;
  float z = x * log2e;
  float n = std::floor(z + 0.5f);
  // r = x - n·ln2 in two pieces for accuracy
  float r = x - n * 0.693359375f;
  r -= n * -2.12194440e-4f;
  // degree-5 minimax polynomial for exp(r), r ∈ [-ln2/2, ln2/2]
  float p = 1.9875691500e-4f;
  p = p * r + 1.3981999507e-3f;
  p = p * r + 8.3334519073e-3f;
  p = p * r + 4.1665795894e-2f;
  p = p * r + 1.6666665459e-1f;
  p = p * r + 5.0000001201e-1f;
  p = p * r * r + r + 1.0f;
  int32_t e = (int32_t)n;
  int32_t bits;
  std::memcpy(&bits, &p, 4);
  bits += e << 23;  // scale by 2^n
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

inline float sigmoidf(float x) { return 1.0f / (1.0f + fast_expf(-x)); }

inline float fast_tanhf(float x) {
  // tanh(x) = 1 - 2/(e^{2x}+1); fast_expf saturates safely at the clamp
  return 1.0f - 2.0f / (fast_expf(2.0f * x) + 1.0f);
}

}  // namespace

// scalar IEEE half → float (fallback when F16C is unavailable)
inline float half_to_float(uint16_t h) {
  const uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ffu;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;  // ±0
    } else {        // subnormal: normalize
      exp = 127 - 15 + 1;
      while ((man & 0x400u) == 0) {
        man <<= 1;
        --exp;
      }
      man &= 0x3ffu;
      bits = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (man << 13);  // inf/nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

void gemv_acc(const Mat& m, const float* x, float* y) {
  if (m.kind == DENSE) {
    const int rows = m.dense.rows, cols = m.dense.cols;
    if (m.dense.f16) {
      for (int r = 0; r < rows; ++r) {
        const uint16_t* w = m.dense.row16(r);
        float acc = 0.f;
#if defined(__F16C__) && defined(__AVX2__)
        __m256 vacc = _mm256_setzero_ps();
        int c = 0;
        for (; c + 8 <= cols; c += 8) {
          const __m256 wf = _mm256_cvtph_ps(
              _mm_loadu_si128(reinterpret_cast<const __m128i*>(w + c)));
          vacc = _mm256_fmadd_ps(wf, _mm256_loadu_ps(x + c), vacc);
        }
        alignas(32) float lanes[8];
        _mm256_store_ps(lanes, vacc);
        acc = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])) +
              ((lanes[4] + lanes[5]) + (lanes[6] + lanes[7]));
        for (; c < cols; ++c) acc += half_to_float(w[c]) * x[c];
#else
        for (int c = 0; c < cols; ++c) acc += half_to_float(w[c]) * x[c];
#endif
        y[r] += acc;
      }
      return;
    }
    for (int r = 0; r < rows; ++r) {
      const float* w = m.dense.row(r);
      float acc = 0.f;
      for (int c = 0; c < cols; ++c) acc += w[c] * x[c];
      y[r] += acc;
    }
  } else {
    const auto& s = m.sparse;
    const int g = s.group;
    if (s.f16 && g == 4) {
      // f16 group-4 kernel: two groups per 256-bit FMA — one 128-bit
      // load of 8 halfs (the bandwidth win), F16C convert in registers,
      // x gathered as two 128-bit lane loads.
      const uint16_t* vals = s.vals16.data();
      const uint16_t* gcol = s.group_col.data();
      for (int r = 0; r < s.rows; ++r) {
        const int32_t p0 = s.row_ptr[r], p1 = s.row_ptr[r + 1];
        float acc = 0.f;
        int32_t p = p0;
#if defined(__F16C__) && defined(__AVX2__)
        __m256 vacc = _mm256_setzero_ps();
        for (; p + 2 <= p1; p += 2) {
          const __m256 wf = _mm256_cvtph_ps(_mm_loadu_si128(
              reinterpret_cast<const __m128i*>(vals + (size_t)p * 4)));
          const __m128 x0 = _mm_loadu_ps(x + (size_t)gcol[p] * 4);
          const __m128 x1 = _mm_loadu_ps(x + (size_t)gcol[p + 1] * 4);
          const __m256 xv =
              _mm256_insertf128_ps(_mm256_castps128_ps256(x0), x1, 1);
          vacc = _mm256_fmadd_ps(wf, xv, vacc);
        }
        alignas(32) float lanes[8];
        _mm256_store_ps(lanes, vacc);
        acc = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])) +
              ((lanes[4] + lanes[5]) + (lanes[6] + lanes[7]));
#endif
        for (; p < p1; ++p) {
          const uint16_t* w = vals + (size_t)p * 4;
          const float* xv = x + (size_t)gcol[p] * 4;
          acc += half_to_float(w[0]) * xv[0] + half_to_float(w[1]) * xv[1] +
                 half_to_float(w[2]) * xv[2] + half_to_float(w[3]) * xv[3];
        }
        y[r] += acc;
      }
      return;
    }
    if (s.f16) {  // generic group size, f16
      for (int r = 0; r < s.rows; ++r) {
        float acc = 0.f;
        for (int32_t p = s.row_ptr[r]; p < s.row_ptr[r + 1]; ++p) {
          const uint16_t* w = s.vals16.data() + (size_t)p * g;
          const float* xv = x + (size_t)s.group_col[p] * g;
          for (int k = 0; k < g; ++k) acc += half_to_float(w[k]) * xv[k];
        }
        y[r] += acc;
      }
      return;
    }
    if (g == 4) {
      // the production group size. AVX2 path: TWO groups per 256-bit FMA
      // (weights for consecutive groups are contiguous — one 256-bit
      // load), with two independent accumulators to hide FMA latency in
      // the dependent chain; scalar-4-lane fallback otherwise.
      const float* vals = s.vals.data();
      const uint16_t* gcol = s.group_col.data();
      for (int r = 0; r < s.rows; ++r) {
        const int32_t p0 = s.row_ptr[r], p1 = s.row_ptr[r + 1];
        float acc = 0.f;
        int32_t p = p0;
#if defined(__AVX2__) && defined(__FMA__)
        __m256 vacc0 = _mm256_setzero_ps();
        __m256 vacc1 = _mm256_setzero_ps();
        for (; p + 4 <= p1; p += 4) {
          const float* w = vals + (size_t)p * 4;
          const __m256 xv0 = _mm256_insertf128_ps(
              _mm256_castps128_ps256(_mm_loadu_ps(x + (size_t)gcol[p] * 4)),
              _mm_loadu_ps(x + (size_t)gcol[p + 1] * 4), 1);
          const __m256 xv1 = _mm256_insertf128_ps(
              _mm256_castps128_ps256(
                  _mm_loadu_ps(x + (size_t)gcol[p + 2] * 4)),
              _mm_loadu_ps(x + (size_t)gcol[p + 3] * 4), 1);
          vacc0 = _mm256_fmadd_ps(_mm256_loadu_ps(w), xv0, vacc0);
          vacc1 = _mm256_fmadd_ps(_mm256_loadu_ps(w + 8), xv1, vacc1);
        }
        alignas(32) float lanes[8];
        _mm256_store_ps(lanes, _mm256_add_ps(vacc0, vacc1));
        acc = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])) +
              ((lanes[4] + lanes[5]) + (lanes[6] + lanes[7]));
        for (; p < p1; ++p) {
          const float* w = vals + (size_t)p * 4;
          const float* xv = x + (size_t)gcol[p] * 4;
          acc += w[0] * xv[0] + w[1] * xv[1] + w[2] * xv[2] + w[3] * xv[3];
        }
#else
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (; p < p1; ++p) {
          const float* w = vals + (size_t)p * 4;
          const float* xv = x + (size_t)gcol[p] * 4;
          a0 += w[0] * xv[0];
          a1 += w[1] * xv[1];
          a2 += w[2] * xv[2];
          a3 += w[3] * xv[3];
        }
        acc = (a0 + a1) + (a2 + a3);
#endif
        y[r] += acc;
      }
    } else {
      for (int r = 0; r < s.rows; ++r) {
        float acc = 0.f;
        for (int32_t p = s.row_ptr[r]; p < s.row_ptr[r + 1]; ++p) {
          const float* w = s.vals.data() + (size_t)p * g;
          const float* xv = x + (size_t)s.group_col[p] * g;
          for (int k = 0; k < g; ++k) acc += w[k] * xv[k];
        }
        y[r] += acc;
      }
    }
  }
}

void gemv_acc_multi(const Mat& m, const float* const* xs, float* const* ys,
                    int B) {
  if (B == 1) {  // keep the single-x kernels' tuning
    gemv_acc(m, xs[0], ys[0]);
    return;
  }
  constexpr int kMaxB = 8;
  if (m.kind == GROUP_SPARSE && m.sparse.group == 4 && !m.sparse.f16 &&
      B <= kMaxB) {
    const auto& s = m.sparse;
    const float* vals = s.vals.data();
    const uint16_t* gcol = s.group_col.data();
    for (int r = 0; r < s.rows; ++r) {
      const int32_t p0 = s.row_ptr[r], p1 = s.row_ptr[r + 1];
#if defined(__AVX2__) && defined(__FMA__)
      __m128 acc[kMaxB];
      for (int b = 0; b < B; ++b) acc[b] = _mm_setzero_ps();
      for (int32_t p = p0; p < p1; ++p) {
        const __m128 w = _mm_loadu_ps(vals + (size_t)p * 4);
        const size_t off = (size_t)gcol[p] * 4;
        for (int b = 0; b < B; ++b)
          acc[b] = _mm_fmadd_ps(w, _mm_loadu_ps(xs[b] + off), acc[b]);
      }
      for (int b = 0; b < B; ++b) {
        alignas(16) float l[4];
        _mm_store_ps(l, acc[b]);
        ys[b][r] += (l[0] + l[1]) + (l[2] + l[3]);
      }
#else
      float acc[kMaxB] = {0};
      for (int32_t p = p0; p < p1; ++p) {
        const float* w = vals + (size_t)p * 4;
        const size_t off = (size_t)gcol[p] * 4;
        for (int b = 0; b < B; ++b) {
          const float* xv = xs[b] + off;
          acc[b] += w[0] * xv[0] + w[1] * xv[1] + w[2] * xv[2] + w[3] * xv[3];
        }
      }
      for (int b = 0; b < B; ++b) ys[b][r] += acc[b];
#endif
    }
    return;
  }
  if (m.kind == DENSE && !m.dense.f16 && B <= kMaxB) {
    const int rows = m.dense.rows, cols = m.dense.cols;
    for (int r = 0; r < rows; ++r) {
      const float* w = m.dense.row(r);
#if defined(__AVX2__) && defined(__FMA__)
      __m256 acc[kMaxB];
      for (int b = 0; b < B; ++b) acc[b] = _mm256_setzero_ps();
      int c = 0;
      for (; c + 8 <= cols; c += 8) {
        const __m256 wv = _mm256_loadu_ps(w + c);
        for (int b = 0; b < B; ++b)
          acc[b] = _mm256_fmadd_ps(wv, _mm256_loadu_ps(xs[b] + c), acc[b]);
      }
      for (int b = 0; b < B; ++b) {
        alignas(32) float l[8];
        _mm256_store_ps(l, acc[b]);
        float a = ((l[0] + l[1]) + (l[2] + l[3])) +
                  ((l[4] + l[5]) + (l[6] + l[7]));
        for (int cc = c; cc < cols; ++cc) a += w[cc] * xs[b][cc];
        ys[b][r] += a;
      }
#else
      for (int b = 0; b < B; ++b) {
        float a = 0.f;
        for (int c = 0; c < cols; ++c) a += w[c] * xs[b][c];
        ys[b][r] += a;
      }
#endif
    }
    return;
  }
  if (m.kind == GROUP_SPARSE && m.sparse.group == 4 && m.sparse.f16 &&
      B <= kMaxB) {
    // f16 × lockstep: one 64-bit load of 4 halfs per group, converted
    // once, FMA'd against every chain's gather
    const auto& s = m.sparse;
    const uint16_t* vals = s.vals16.data();
    const uint16_t* gcol = s.group_col.data();
    for (int r = 0; r < s.rows; ++r) {
      const int32_t p0 = s.row_ptr[r], p1 = s.row_ptr[r + 1];
#if defined(__F16C__) && defined(__AVX2__)
      __m128 acc[kMaxB];
      for (int b = 0; b < B; ++b) acc[b] = _mm_setzero_ps();
      for (int32_t p = p0; p < p1; ++p) {
        const __m128 w = _mm_cvtph_ps(_mm_loadl_epi64(
            reinterpret_cast<const __m128i*>(vals + (size_t)p * 4)));
        const size_t off = (size_t)gcol[p] * 4;
        for (int b = 0; b < B; ++b)
          acc[b] = _mm_fmadd_ps(w, _mm_loadu_ps(xs[b] + off), acc[b]);
      }
      for (int b = 0; b < B; ++b) {
        alignas(16) float l[4];
        _mm_store_ps(l, acc[b]);
        ys[b][r] += (l[0] + l[1]) + (l[2] + l[3]);
      }
#else
      for (int32_t p = p0; p < p1; ++p) {
        const uint16_t* w = vals + (size_t)p * 4;
        float wf[4] = {half_to_float(w[0]), half_to_float(w[1]),
                       half_to_float(w[2]), half_to_float(w[3])};
        const size_t off = (size_t)gcol[p] * 4;
        for (int b = 0; b < B; ++b) {
          const float* xv = xs[b] + off;
          ys[b][r] +=
              wf[0] * xv[0] + wf[1] * xv[1] + wf[2] * xv[2] + wf[3] * xv[3];
        }
      }
#endif
    }
    return;
  }
  // uncommon kinds (dense f16, generic group): per-batch fallback
  for (int b = 0; b < B; ++b) gemv_acc(m, xs[b], ys[b]);
}

void gemv(const Linear& lin, const float* x, float* y) {
  const int rows = lin.w.rows();
  if (!lin.b.empty())
    std::memcpy(y, lin.b.data(), rows * sizeof(float));
  else
    std::memset(y, 0, rows * sizeof(float));
  gemv_acc(lin.w, x, y);
}

bool Model::load(const std::string& path, std::string* err) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    if (err) *err = "cannot open " + path;
    return false;
  }
  Reader r{f};
  char magic[8];
  r.bytes(magic, 8);
  if (!r.ok || std::memcmp(magic, kMagic, 8) != 0) {
    if (err) *err = "bad magic in " + path;
    fclose(f);
    return false;
  }
  variant = r.scalar<int32_t>();
  mode = r.scalar<int32_t>();
  n_classes = r.scalar<int32_t>();
  rnn_dims = r.scalar<int32_t>();
  fc_dims = r.scalar<int32_t>();
  feat_dims = r.scalar<int32_t>();
  aux_dims = r.scalar<int32_t>();
  res_blocks = r.scalar<int32_t>();
  pad = r.scalar<int32_t>();
  hop = r.scalar<int32_t>();
  int32_t n_up = r.scalar<int32_t>();
  upsample.factors.resize(n_up);
  for (int i = 0; i < n_up; ++i) upsample.factors[i] = r.scalar<int32_t>();

  // upsample network (BN pre-folded by the exporter)
  auto dense_of = [&](Mat&& m) { return std::move(m.dense); };
  upsample.conv_in_w = dense_of(read_mat(r));
  upsample.conv_in_b = read_vec(r);
  upsample.blocks.resize(res_blocks);
  for (auto& blk : upsample.blocks) {
    blk.w1 = dense_of(read_mat(r));
    blk.b1 = read_vec(r);
    blk.w2 = dense_of(read_mat(r));
    blk.b2 = read_vec(r);
  }
  upsample.conv_out_w = dense_of(read_mat(r));
  upsample.conv_out_b = read_vec(r);
  upsample.smooth.resize(n_up);
  for (auto& k : upsample.smooth) k = read_vec(r);

  I.w = read_mat(r);
  I.b = read_vec(r);

  int n_rnns = variant == FATCHORD ? 2 : variant == GENEING ? 1 : 4;
  int n_fcs = variant == FATCHORD ? 3 : variant == GENEING ? 2 : 5;
  rnns.resize(n_rnns);
  for (auto& g : rnns) {
    g.w_ih = read_mat(r);
    g.w_hh = read_mat(r);
    g.b_ih = read_vec(r);
    g.b_hh = read_vec(r);
    g.hidden = g.w_hh.cols();
  }
  fcs.resize(n_fcs);
  for (auto& l : fcs) {
    l.w = read_mat(r);
    l.b = read_vec(r);
  }
  fclose(f);
  if (!r.ok && err) *err = "truncated file " + path;
  return r.ok;
}

int Model::sample_categorical(const float* logits, int n, bool argmax) {
  if (argmax)
    return (int)(std::max_element(logits, logits + n) - logits);
  // softmax + CDF inverse sampling (float fast-exp into a reused scratch —
  // the old per-call double vector + libm exp cost ~6% of the sample loop)
  float mx = *std::max_element(logits, logits + n);
  softmax_scratch_.resize(n);
  float* p = softmax_scratch_.data();
  float total = 0;
  for (int i = 0; i < n; ++i) {
    p[i] = fast_expf(logits[i] - mx);
    total += p[i];
  }
  std::uniform_real_distribution<double> U(0.0, 1.0);
  double u = U(rng_) * (double)total, c = 0;
  for (int i = 0; i < n; ++i) {
    c += p[i];
    if (u <= c) return i;
  }
  return n - 1;
}

float Model::sample_mol(const float* logits, bool argmax) {
  // 10-component logistic mixture: [logit_probs | means | log_scales]
  const int k = n_classes / 3;
  int comp;
  if (argmax) {
    comp = (int)(std::max_element(logits, logits + k) - logits);
  } else {
    comp = sample_categorical(logits, k, false);
  }
  float mean = logits[k + comp];
  float log_scale = std::max(logits[2 * k + comp], -32.23619f);
  if (argmax) return std::clamp(mean, -1.f, 1.f);
  std::uniform_real_distribution<double> U(1e-5, 1.0 - 1e-5);
  double u = U(rng_);
  float x = mean + std::exp(log_scale) * (float)(std::log(u) - std::log1p(-u));
  return std::clamp(x, -1.f, 1.f);
}

float Model::sample_beta(const float* logits, bool argmax) {
  // Beta(exp(a), exp(b)) rescaled to [-1, 1] (geneing RAW head)
  float alpha = std::exp(logits[0]), beta = std::exp(logits[1]);
  if (argmax) {
    // distribution mode (fallback to mean for a/b <= 1)
    float m = (alpha > 1 && beta > 1)
                  ? (alpha - 1) / (alpha + beta - 2)
                  : alpha / (alpha + beta);
    return 2.f * m - 1.f;
  }
  std::gamma_distribution<double> ga(alpha, 1.0), gb(beta, 1.0);
  double x = ga(rng_), y = gb(rng_);
  return (float)(2.0 * (x / (x + y)) - 1.0);
}

// Conditioning prep shared by the (batched) sample loop: pad the mel,
// run the aux resnet, stretch+smooth upsample. Fills `cur` (t_cur, F)
// and `aux` (n_frames, res_out); returns T = samples to generate.
static int prepare_conditioning(const Model& mo, const float* mel,
                                int n_frames, std::vector<float>& cur,
                                std::vector<float>& aux) {
  const int F = mo.feat_dims;
  const int pad = mo.pad;
  int scale = 1;
  for (int s : mo.upsample.factors) scale *= s;

  // ---- pad mel by `pad` frames on both sides -----------------------------
  const int padded = n_frames + 2 * pad;
  std::vector<float> mel_p((size_t)padded * F, 0.f);  // (T, F) frame-major
  for (int t = 0; t < n_frames; ++t)
    for (int c = 0; c < F; ++c)
      mel_p[(size_t)(t + pad) * F + c] = mel[(size_t)c * n_frames + t];

  // ---- aux resnet (VALID conv_in + 1x1 blocks) ----------------------------
  const int k_in = 2 * pad + 1;
  const int t_aux = padded - k_in + 1;  // == n_frames
  const int compute = mo.upsample.conv_in_w.rows;
  std::vector<float> h((size_t)t_aux * compute);
  for (int t = 0; t < t_aux; ++t) {
    float* out = h.data() + (size_t)t * compute;
    for (int rrow = 0; rrow < compute; ++rrow) {
      const float* w = mo.upsample.conv_in_w.row(rrow);  // (F*k_in)
      float acc = mo.upsample.conv_in_b[rrow];
      for (int k = 0; k < k_in; ++k) {
        const float* xt = mel_p.data() + (size_t)(t + k) * F;
        const float* wk = w + (size_t)k * F;
        for (int c = 0; c < F; ++c) acc += wk[c] * xt[c];
      }
      out[rrow] = std::max(acc, 0.f);  // conv_in -> BN -> relu (BN folded)
    }
  }
  std::vector<float> tmp(compute);
  for (const auto& blk : mo.upsample.blocks) {
    for (int t = 0; t < t_aux; ++t) {
      float* x = h.data() + (size_t)t * compute;
      for (int rrow = 0; rrow < compute; ++rrow) {
        const float* w = blk.w1.row(rrow);
        float acc = blk.b1[rrow];
        for (int c = 0; c < compute; ++c) acc += w[c] * x[c];
        tmp[rrow] = std::max(acc, 0.f);
      }
      for (int rrow = 0; rrow < compute; ++rrow) {
        const float* w = blk.w2.row(rrow);
        float acc = blk.b2[rrow];
        for (int c = 0; c < compute; ++c) acc += w[c] * tmp[c];
        x[rrow] += acc;  // residual
      }
    }
  }
  const int res_out = mo.upsample.conv_out_w.rows;
  aux.assign((size_t)t_aux * res_out, 0.f);
  for (int t = 0; t < t_aux; ++t) {
    const float* x = h.data() + (size_t)t * compute;
    float* out = aux.data() + (size_t)t * res_out;
    for (int rrow = 0; rrow < res_out; ++rrow) {
      const float* w = mo.upsample.conv_out_w.row(rrow);
      float acc = mo.upsample.conv_out_b[rrow];
      for (int c = 0; c < compute; ++c) acc += w[c] * x[c];
      out[rrow] = acc;
    }
  }

  // ---- mel upsampling: stretch + channel-shared smoothing ------------------
  cur = mel_p;  // (T, F)
  int t_cur = padded;
  for (size_t s_i = 0; s_i < mo.upsample.factors.size(); ++s_i) {
    const int s = mo.upsample.factors[s_i];
    const auto& kern = mo.upsample.smooth[s_i];
    const int K = (int)kern.size();
    const int t_new = t_cur * s;
    std::vector<float> stretched((size_t)t_new * F);
    for (int t = 0; t < t_new; ++t)
      std::memcpy(stretched.data() + (size_t)t * F,
                  cur.data() + (size_t)(t / s) * F, F * sizeof(float));
    // conv along time, pad s both sides (K == 2s+1 keeps length)
    std::vector<float> conv((size_t)t_new * F, 0.f);
    const int lpad = (K - 1) / 2;
    for (int t = 0; t < t_new; ++t) {
      float* out = conv.data() + (size_t)t * F;
      for (int k = 0; k < K; ++k) {
        int src = t + k - lpad;
        if (src < 0 || src >= t_new) continue;
        const float* xt = stretched.data() + (size_t)src * F;
        const float wk = kern[k];
        for (int c = 0; c < F; ++c) out[c] += wk * xt[c];
      }
    }
    cur.swap(conv);
    t_cur = t_new;
  }
  return t_cur - 2 * pad * scale;  // samples to generate
}

std::vector<float> Model::generate(const float* mel, int n_frames,
                                   bool argmax_sampling) {
  return generate_batch(mel, 1, n_frames, argmax_sampling);
}

std::vector<float> Model::generate_batch(const float* mels, int n_batch,
                                         int n_frames,
                                         bool argmax_sampling) {
  const int B = n_batch;
  const int F = feat_dims;
  const int R = rnn_dims;
  const int A = aux_dims;
  int scale = 1;
  for (int s : upsample.factors) scale *= s;
  const int indent = pad * scale;
  const int res_out = upsample.conv_out_w.rows;

  std::vector<std::vector<float>> cur(B), aux(B);
  int T = 0;
  for (int b = 0; b < B; ++b)
    T = prepare_conditioning(*this, mels + (size_t)b * F * n_frames,
                             n_frames, cur[b], aux[b]);

  // ---- AR sample loop: B chunks in lockstep --------------------------------
  const int i_in = I.w.cols();  // 1 + F + (A-1)
  const size_t fci_s = (size_t)std::max({R + A, fc_dims + A, fc_dims});
  const size_t fcb_s = (size_t)std::max(n_classes, fc_dims + A);
  std::vector<float> x_in((size_t)B * i_in), xI((size_t)B * R);
  std::vector<float> xg((size_t)B * 3 * R), hh((size_t)B * 3 * R);
  std::vector<float> fc_in((size_t)B * fci_s), fc_buf((size_t)B * fcb_s);
  std::vector<float> logits((size_t)B * n_classes);
  std::vector<std::vector<float>> hs(rnns.size(),
                                     std::vector<float>((size_t)B * R, 0.f));
  std::vector<const float*> xp(B);
  std::vector<float*> yp(B);
  std::vector<float> wav((size_t)B * T);
  std::vector<float> sample(B, 0.f);

  auto fc_multi = [&](int fi, const float* in_base, size_t in_s,
                      float* out_base, size_t out_s) {
    const Linear& L = fcs[fi];
    const int rows = L.w.rows();
    for (int b = 0; b < B; ++b) {
      float* o = out_base + (size_t)b * out_s;
      if (!L.b.empty())
        std::memcpy(o, L.b.data(), rows * sizeof(float));
      else
        std::memset(o, 0, rows * sizeof(float));
      xp[b] = in_base + (size_t)b * in_s;
      yp[b] = o;
    }
    gemv_acc_multi(L.w, xp.data(), yp.data(), B);
  };

  // xg = W_ih · concat(xI, extra) + b_ih; hh = W_hh · h + b_hh; gates
  // + the residual add into the running activation (every variant adds
  // each GRU's output).
  auto run_gru_multi = [&](int gi, int extra_n,
                           const float* const* extras) {
    const Gru& g = rnns[gi];
    for (int b = 0; b < B; ++b) {
      float* in_b = fc_in.data() + (size_t)b * fci_s;
      std::memcpy(in_b, xI.data() + (size_t)b * R, R * sizeof(float));
      if (extra_n)
        std::memcpy(in_b + R, extras[b], extra_n * sizeof(float));
      float* xg_b = xg.data() + (size_t)b * 3 * R;
      if (!g.b_ih.empty())
        std::memcpy(xg_b, g.b_ih.data(), 3 * R * sizeof(float));
      else
        std::memset(xg_b, 0, 3 * R * sizeof(float));
      xp[b] = in_b;
      yp[b] = xg_b;
    }
    gemv_acc_multi(g.w_ih, xp.data(), yp.data(), B);
    for (int b = 0; b < B; ++b) {
      float* hh_b = hh.data() + (size_t)b * 3 * R;
      if (!g.b_hh.empty())
        std::memcpy(hh_b, g.b_hh.data(), 3 * R * sizeof(float));
      else
        std::memset(hh_b, 0, 3 * R * sizeof(float));
      xp[b] = hs[gi].data() + (size_t)b * R;
      yp[b] = hh_b;
    }
    gemv_acc_multi(g.w_hh, xp.data(), yp.data(), B);
    const int H = g.hidden;
    for (int b = 0; b < B; ++b) {
      const float* xg_b = xg.data() + (size_t)b * 3 * R;
      const float* hh_b = hh.data() + (size_t)b * 3 * R;
      float* h = hs[gi].data() + (size_t)b * R;
      float* x = xI.data() + (size_t)b * R;
      for (int i = 0; i < H; ++i) {
        float r = sigmoidf(xg_b[i] + hh_b[i]);
        float z = sigmoidf(xg_b[H + i] + hh_b[H + i]);
        float n = fast_tanhf(xg_b[2 * H + i] + r * hh_b[2 * H + i]);
        h[i] = (1.f - z) * n + z * h[i];
        x[i] += h[i];  // residual add (every variant adds the GRU output)
      }
    }
  };

  std::vector<const float*> extras(B);
  auto aux_ptrs = [&](int t, int seg) {
    const int frame = t / scale;
    for (int b = 0; b < B; ++b)
      extras[b] = aux[b].data() + (size_t)frame * res_out + (size_t)seg * A;
    return extras.data();
  };
  auto relu_block = [&](float* base, size_t stride, int n) {
    for (int b = 0; b < B; ++b) {
      float* v = base + (size_t)b * stride;
      for (int i = 0; i < n; ++i) v[i] = std::max(v[i], 0.f);
    }
  };
  auto append_aux = [&](float* base, size_t stride, int at, int t, int seg) {
    const int frame = t / scale;
    for (int b = 0; b < B; ++b)
      std::memcpy(base + (size_t)b * stride + at,
                  aux[b].data() + (size_t)frame * res_out + (size_t)seg * A,
                  A * sizeof(float));
  };

  for (int t = 0; t < T; ++t) {
    const int frame = t / scale;  // aux frame index
    for (int b = 0; b < B; ++b) {
      const float* m_t = cur[b].data() + (size_t)(t + indent) * F;
      const float* a1 = aux[b].data() + (size_t)frame * res_out;
      float* in_b = x_in.data() + (size_t)b * i_in;
      // input vector [sample, mel_t, a1[:-1]]
      in_b[0] = sample[b];
      std::memcpy(in_b + 1, m_t, F * sizeof(float));
      std::memcpy(in_b + 1 + F, a1, (A - 1) * sizeof(float));
      float* o = xI.data() + (size_t)b * R;
      if (!I.b.empty())
        std::memcpy(o, I.b.data(), R * sizeof(float));
      else
        std::memset(o, 0, R * sizeof(float));
      xp[b] = in_b;
      yp[b] = o;
    }
    gemv_acc_multi(I.w, xp.data(), yp.data(), B);

    if (variant == FATCHORD) {
      run_gru_multi(0, 0, nullptr);
      run_gru_multi(1, A, aux_ptrs(t, 1));
      for (int b = 0; b < B; ++b)
        std::memcpy(fc_in.data() + (size_t)b * fci_s,
                    xI.data() + (size_t)b * R, R * sizeof(float));
      append_aux(fc_in.data(), fci_s, R, t, 2);
      fc_multi(0, fc_in.data(), fci_s, fc_buf.data(), fcb_s);
      relu_block(fc_buf.data(), fcb_s, fc_dims);
      for (int b = 0; b < B; ++b)
        std::memcpy(fc_in.data() + (size_t)b * fci_s,
                    fc_buf.data() + (size_t)b * fcb_s,
                    fc_dims * sizeof(float));
      append_aux(fc_in.data(), fci_s, fc_dims, t, 3);
      fc_multi(1, fc_in.data(), fci_s, fc_buf.data(), fcb_s);
      relu_block(fc_buf.data(), fcb_s, fc_dims);
      fc_multi(2, fc_buf.data(), fcb_s, logits.data(), (size_t)n_classes);
    } else if (variant == GENEING) {
      run_gru_multi(0, 0, nullptr);
      for (int b = 0; b < B; ++b)
        std::memcpy(fc_in.data() + (size_t)b * fci_s,
                    xI.data() + (size_t)b * R, R * sizeof(float));
      append_aux(fc_in.data(), fci_s, R, t, 1);
      fc_multi(0, fc_in.data(), fci_s, fc_buf.data(), fcb_s);
      relu_block(fc_buf.data(), fcb_s, fc_dims);
      fc_multi(1, fc_buf.data(), fcb_s, logits.data(), (size_t)n_classes);
    } else {  // RUNTIMERACER
      run_gru_multi(0, 0, nullptr);
      run_gru_multi(1, 0, nullptr);
      run_gru_multi(2, A, aux_ptrs(t, 1));
      run_gru_multi(3, 0, nullptr);
      for (int b = 0; b < B; ++b)
        std::memcpy(fc_in.data() + (size_t)b * fci_s,
                    xI.data() + (size_t)b * R, R * sizeof(float));
      append_aux(fc_in.data(), fci_s, R, t, 2);
      fc_multi(0, fc_in.data(), fci_s, fc_buf.data(), fcb_s);  // fc1: no relu
      fc_multi(1, fc_buf.data(), fcb_s, fc_in.data(), fci_s);  // fc2
      relu_block(fc_in.data(), fci_s, fc_dims);
      for (int b = 0; b < B; ++b)
        std::memcpy(fc_buf.data() + (size_t)b * fcb_s,
                    fc_in.data() + (size_t)b * fci_s,
                    fc_dims * sizeof(float));
      append_aux(fc_buf.data(), fcb_s, fc_dims, t, 3);
      fc_multi(2, fc_buf.data(), fcb_s, fc_in.data(), fci_s);  // fc3: no relu
      fc_multi(3, fc_in.data(), fci_s, fc_buf.data(), fcb_s);  // fc4
      relu_block(fc_buf.data(), fcb_s, fc_dims);
      fc_multi(4, fc_buf.data(), fcb_s, logits.data(), (size_t)n_classes);
    }

    // ---- sampling (per chunk, sequential draws from the instance rng) ----
    for (int b = 0; b < B; ++b) {
      float* lg = logits.data() + (size_t)b * n_classes;
      float s;
      if (mode == MOL) {
        s = sample_mol(lg, argmax_sampling);
      } else if (mode == RAW && variant == GENEING) {
        s = sample_beta(lg, argmax_sampling);
      } else {
        int label = sample_categorical(lg, n_classes, argmax_sampling);
        s = 2.f * label / (n_classes - 1.f) - 1.f;
      }
      sample[b] = s;
      wav[(size_t)b * T + t] = s;
    }
  }
  return wav;
}

}  // namespace rtvc

// ---------------------------------------------------------------------------
// C API (ctypes binding surface; same capabilities as the reference's
// pybind11 module Vocoder{loadWeights,setRandomSeed,melToWav},
// ref: WaveRNNVocoder.cpp:51-84)
// ---------------------------------------------------------------------------

extern "C" {

void* rtvc_vocoder_create() { return new rtvc::Model(); }

void rtvc_vocoder_destroy(void* m) { delete static_cast<rtvc::Model*>(m); }

int rtvc_vocoder_load(void* m, const char* path) {
  std::string err;
  bool ok = static_cast<rtvc::Model*>(m)->load(path, &err);
  if (!ok) fprintf(stderr, "rtvc_vocoder_load: %s\n", err.c_str());
  return ok ? 0 : 1;
}

void rtvc_vocoder_set_seed(void* m, uint64_t seed) {
  static_cast<rtvc::Model*>(m)->set_seed(seed);
}

int rtvc_vocoder_hop(void* m) { return static_cast<rtvc::Model*>(m)->hop; }
int rtvc_vocoder_n_classes(void* m) {
  return static_cast<rtvc::Model*>(m)->n_classes;
}
int rtvc_vocoder_mode(void* m) { return static_cast<rtvc::Model*>(m)->mode; }

// mel: (n_mels, n_frames) row-major. Writes up to out_capacity samples,
// returns the number written (== (n_frames)*hop upsampled interior).
long rtvc_vocoder_mel_to_wav(void* m, const float* mel, int n_mels,
                             int n_frames, float* out, long out_capacity,
                             int argmax) {
  auto* model = static_cast<rtvc::Model*>(m);
  if (n_mels != model->feat_dims) {
    fprintf(stderr, "rtvc_vocoder_mel_to_wav: expected %d mel bins, got %d\n",
            model->feat_dims, n_mels);
    return -1;
  }
  std::vector<float> wav = model->generate(mel, n_frames, argmax != 0);
  long n = std::min<long>((long)wav.size(), out_capacity);
  std::memcpy(out, wav.data(), n * sizeof(float));
  return n;
}

// mels: n_batch contiguous (n_mels, n_frames) blocks (fold chunks).
// Writes (n_batch, T) concatenated; returns samples PER CHUNK (T), or -1.
long rtvc_vocoder_mel_to_wav_batch(void* m, const float* mels, int n_batch,
                                   int n_mels, int n_frames, float* out,
                                   long out_capacity, int argmax) {
  auto* model = static_cast<rtvc::Model*>(m);
  if (n_mels != model->feat_dims || n_batch < 1) {
    fprintf(stderr,
            "rtvc_vocoder_mel_to_wav_batch: bad args (n_mels=%d, B=%d)\n",
            n_mels, n_batch);
    return -1;
  }
  std::vector<float> wav =
      model->generate_batch(mels, n_batch, n_frames, argmax != 0);
  if ((long)wav.size() > out_capacity) return -1;
  std::memcpy(out, wav.data(), wav.size() * sizeof(float));
  return (long)(wav.size() / n_batch);
}

}  // extern "C"
