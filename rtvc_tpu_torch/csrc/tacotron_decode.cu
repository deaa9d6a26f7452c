// Tacotron inference decoder loop.
//
// Replaces: rtvc_tpu/ops/pallas/tacotron_kernel.py:decode_pallas (body
// _make_kernel, weights _prepare_weights), the autoregressive decoder of the
// synthesizer.
//
// What bounds it on the H100: each iteration runs prenet (2 x 512 rows),
// the attention GRU (2 x 768 rows over 1408 + 256 inputs), the location-
// sensitive attention, rnn_input (512 x 1152), two residual LSTMs
// (2 x 2048 x 1024) and the r mel rows plus the stop row: about 7.3M
// weights, 29 MB in f32, for a batch of a few texts. That is a handful of
// FLOP per byte, so an iteration is bound by streaming the weights out of
// the 50 MB L2 (where they stay resident across iterations) and by the
// ~15 dependent phases of one iteration, each ending in a barrier.
//
// Design: one persistent launch of one CTA runs every iteration. The batch
// is processed together: a warp owns four weight rows at a time and applies
// them to up to eight batch rows' inputs (common.cuh:matvec<8>), so the
// weights are read once per iteration whatever the batch. The recurrent
// state (GRU and LSTM states, context, cumulative attention, previous frame)
// lives in a workspace the wrapper allocates; with a single CTA, a
// __syncthreads() orders every phase. The location term is the 31-tap
// convolution over the cumulative attention computed directly, followed by
// the 32 → D projection: the TPU kernel's banded (T, T·D) matrix is a trick
// for its matrix unit and is not built here. The pad-mask multiplies the
// logits, as in the reference. The stop rule spans the batch: a flag in
// shared memory ends the loop in the iteration where every stop token
// exceeds 0.5 (after step 10), and the outputs past it are written as
// zeros. Prenet dropout stays on unless disabled, with Philox-4x32-10
// noise keyed by (seed, iteration, batch row, layer). Splitting the rows
// of each phase over many SMs, with a grid barrier per phase, is the next
// step for speed.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kNumWeights = 27;

struct Weights {
  const float *pre_w1, *pre_b1, *pre_w2, *pre_b2;
  const float *gru_wih, *gru_bih, *gru_whh, *gru_bhh;
  const float *conv_w, *conv_b, *L_w, *W_w, *W_b, *v_w;
  const float *ri_w, *ri_b;
  const float *l1_wih, *l1_whh, *l1_bih, *l1_bhh;
  const float *l2_wih, *l2_whh, *l2_bih, *l2_bhh;
  const float *mel_w, *stop_w, *stop_b;
};

struct Dims {
  int B, T, E, D, L, P, M, max_r, r, max_iters, NF, KS, dropout, drop_thr, work;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Per batch row workspace segments (floats, each a multiple of 4).
struct Layout {
  int pre1, pre2, xg, hg, ah, q, loc, u, cum, ctx, x, h1, c1, h2, c2, gates, prev, melv, stop, WS;
  __host__ __device__ static int seg(int& o, int n) {
    const int at = o;
    o += round4(n);
    return at;
  }
  __host__ __device__ explicit Layout(const Dims& d) {
    int o = 0;
    pre1 = seg(o, d.P); pre2 = seg(o, d.P); xg = seg(o, 3 * d.D); hg = seg(o, 3 * d.D);
    ah = seg(o, d.D); q = seg(o, d.D); loc = seg(o, d.T * d.NF); u = seg(o, d.T);
    cum = seg(o, d.T); ctx = seg(o, d.E); x = seg(o, d.L); h1 = seg(o, d.L);
    c1 = seg(o, d.L); h2 = seg(o, d.L); c2 = seg(o, d.L); gates = seg(o, 4 * d.L);
    prev = seg(o, d.M); melv = seg(o, d.r * d.M); stop = seg(o, 1);
    WS = o;
  }
};

// out rows for every batch row, in chunks of up to 8 batch rows (a small
// batch takes a narrower instantiation, which needs fewer registers).
__device__ void mv(const float* W, int ldw, int rows, const float* x, int n, float* out,
                   const float* bias, bool accumulate, int act, int B, int WS) {
  if (B <= 2) {
    rtvc::matvec<2>(W, ldw, rows, x, WS, n, B, out, WS, bias, nullptr, 0, accumulate, act);
    return;
  }
  if (B <= 4) {
    rtvc::matvec<4>(W, ldw, rows, x, WS, n, B, out, WS, bias, nullptr, 0, accumulate, act);
    return;
  }
  for (int b0 = 0; b0 < B; b0 += 8) {
    const int nb = B - b0 < 8 ? B - b0 : 8;
    rtvc::matvec<8>(W, ldw, rows, x + (size_t)b0 * WS, WS, n, nb, out + (size_t)b0 * WS, WS,
                    bias, nullptr, 0, accumulate, act);
  }
}

// Always-on prenet dropout on seg[b * WS + j], j < n.
__device__ void dropout(float* ws, int seg, int n, const Dims& d, int WS, int it, int layer,
                        uint2 key) {
  const int groups = (n + 3) / 4;
  const float scale = 1.0f / (1.0f - (float)d.drop_thr * (1.0f / 16777216.0f));
  for (int idx = threadIdx.x; idx < d.B * groups; idx += blockDim.x) {
    const int b = idx / groups, g4 = idx % groups;
    const uint4 rnd = rtvc::philox4x32(
        make_uint4((uint32_t)g4, (uint32_t)it, (uint32_t)b, (uint32_t)layer), key);
    const uint32_t bits[4] = {rnd.x, rnd.y, rnd.z, rnd.w};
    float* p = ws + (size_t)b * WS + seg;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = g4 * 4 + i;
      if (j < n) p[j] = (bits[i] >> 8) >= (uint32_t)d.drop_thr ? p[j] * scale : 0.0f;
    }
  }
}

// LSTM cell update from gates (bias_ih already in, bias_hh added here), then
// the residual x ← x + h.
__device__ void lstm_update(float* ws, const Layout& lo, int hseg, int cseg, const float* bhh,
                            int B, int L, int WS) {
  for (int idx = threadIdx.x; idx < B * L; idx += blockDim.x) {
    const int b = idx / L, j = idx % L;
    float* w = ws + (size_t)b * WS;
    const float* g = w + lo.gates;
    const float i_g = rtvc::sigmoidf_(g[j] + bhh[j]);
    const float f_g = rtvc::sigmoidf_(g[L + j] + bhh[L + j]);
    const float g_g = tanhf(g[2 * L + j] + bhh[2 * L + j]);
    const float o_g = rtvc::sigmoidf_(g[3 * L + j] + bhh[3 * L + j]);
    const float c = f_g * w[cseg + j] + i_g * g_g;
    const float h = o_g * tanhf(c);
    w[cseg + j] = c;
    w[hseg + j] = h;
    w[lo.x + j] += h;
  }
}

__global__ void __launch_bounds__(1024)
tacotron_decode_kernel(Weights w, Dims d, uint2 key, const float* __restrict__ enc_seq,
                       const float* __restrict__ enc_proj, const float* __restrict__ char_mask,
                       float* __restrict__ mel, float* __restrict__ attn,
                       float* __restrict__ stops, float* __restrict__ ws) {
  __shared__ int done;
  __shared__ int n_iters;
  const Layout lo(d);
  const int WS = lo.WS;
  const int B = d.B, T = d.T, E = d.E, D = d.D, L = d.L, P = d.P, M = d.M, r = d.r;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int pad = (d.KS - 1) / 2;

  for (int idx = tid; idx < B * WS; idx += blockDim.x) ws[idx] = 0.0f;
  if (tid == 0) {
    done = 0;
    n_iters = d.max_iters;
  }
  __syncthreads();

  for (int it = 0; it < d.max_iters; ++it) {
    if (done) break;  // uniform: read after a barrier

    // Prenet: relu(fc1) → dropout → relu(fc2) → dropout
    mv(w.pre_w1, M, P, ws + lo.prev, M, ws + lo.pre1, w.pre_b1, false, rtvc::kRelu, B, WS);
    __syncthreads();
    if (d.dropout) {
      dropout(ws, lo.pre1, P, d, WS, it, 0, key);
      __syncthreads();
    }
    mv(w.pre_w2, P, P, ws + lo.pre1, P, ws + lo.pre2, w.pre_b2, false, rtvc::kRelu, B, WS);
    __syncthreads();
    if (d.dropout) {
      dropout(ws, lo.pre2, P, d, WS, it, 1, key);
      __syncthreads();
    }

    // Attention GRU over [context | prenet]
    mv(w.gru_wih, E + P, 3 * D, ws + lo.ctx, E, ws + lo.xg, w.gru_bih, false, rtvc::kNone, B, WS);
    mv(w.gru_wih + E, E + P, 3 * D, ws + lo.pre2, P, ws + lo.xg, nullptr, true, rtvc::kNone, B,
       WS);
    mv(w.gru_whh, D, 3 * D, ws + lo.ah, D, ws + lo.hg, w.gru_bhh, false, rtvc::kNone, B, WS);
    __syncthreads();
    for (int idx = tid; idx < B * D; idx += blockDim.x) {
      const int b = idx / D, j = idx % D;
      float* p = ws + (size_t)b * WS;
      const float* xg = p + lo.xg;
      const float* hg = p + lo.hg;
      const float rg = rtvc::sigmoidf_(xg[j] + hg[j]);
      const float zg = rtvc::sigmoidf_(xg[D + j] + hg[D + j]);
      const float ng = tanhf(xg[2 * D + j] + rg * hg[2 * D + j]);
      p[lo.ah + j] = (1.0f - zg) * ng + zg * p[lo.ah + j];
    }
    __syncthreads();

    // Location-sensitive attention: query, then the 31-tap conv over cum
    mv(w.W_w, D, D, ws + lo.ah, D, ws + lo.q, w.W_b, false, rtvc::kNone, B, WS);
    for (int idx = tid; idx < B * T * d.NF; idx += blockDim.x) {
      const int b = idx / (T * d.NF), rem = idx % (T * d.NF), t = rem / d.NF, f = rem % d.NF;
      const float* cum = ws + (size_t)b * WS + lo.cum;
      float acc = w.conv_b[f];
      for (int k = 0; k < d.KS; ++k) {
        const int tt = t + k - pad;
        if (tt >= 0 && tt < T) acc += w.conv_w[f * d.KS + k] * cum[tt];
      }
      ws[(size_t)b * WS + lo.loc + t * d.NF + f] = acc;
    }
    __syncthreads();
    // u[t] = v · tanh(q + enc_proj[t] + L·loc[t]), times the char mask
    for (int bt = warp; bt < B * T; bt += nwarps) {
      const int b = bt / T, t = bt % T;
      const float* p = ws + (size_t)b * WS;
      const float* loc = p + lo.loc + t * d.NF;
      const float* ep = enc_proj + ((size_t)b * T + t) * D;
      float acc = 0.0f;
      for (int j = lane; j < D; j += 32) {
        float pl = 0.0f;
        for (int f = 0; f < d.NF; ++f) pl += w.L_w[j * d.NF + f] * loc[f];
        acc += w.v_w[j] * tanhf(p[lo.q + j] + ep[j] + pl);
      }
      acc = rtvc::warp_sum(acc);
      if (lane == 0) ws[(size_t)b * WS + lo.u + t] = acc * char_mask[(size_t)b * T + t];
    }
    __syncthreads();
    // softmax over characters; cumulative attention; attention output
    for (int b = warp; b < B; b += nwarps) {
      float* p = ws + (size_t)b * WS;
      float mx = -FLT_MAX;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, p[lo.u + t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.0f;
      for (int t = lane; t < T; t += 32) {
        const float e = expf(p[lo.u + t] - mx);
        p[lo.u + t] = e;
        sum += e;
      }
      sum = rtvc::warp_sum(sum);
      for (int t = lane; t < T; t += 32) {
        const float s = p[lo.u + t] / sum;
        p[lo.u + t] = s;
        p[lo.cum + t] += s;
        attn[((size_t)b * d.max_iters + it) * T + t] = s;
      }
    }
    __syncthreads();
    // context = scores · encoder_seq
    for (int idx = tid; idx < B * E; idx += blockDim.x) {
      const int b = idx / E, e = idx % E;
      const float* p = ws + (size_t)b * WS;
      const float* es = enc_seq + (size_t)b * T * E + e;
      float acc = 0.0f;
      for (int t = 0; t < T; ++t) acc += p[lo.u + t] * es[(size_t)t * E];
      ws[(size_t)b * WS + lo.ctx + e] = acc;
    }
    __syncthreads();

    // rnn_input over [context | attention hidden]
    mv(w.ri_w, E + D, L, ws + lo.ctx, E, ws + lo.x, w.ri_b, false, rtvc::kNone, B, WS);
    mv(w.ri_w + E, E + D, L, ws + lo.ah, D, ws + lo.x, nullptr, true, rtvc::kNone, B, WS);
    __syncthreads();

    // Two residual LSTMs
    mv(w.l1_wih, L, 4 * L, ws + lo.x, L, ws + lo.gates, w.l1_bih, false, rtvc::kNone, B, WS);
    mv(w.l1_whh, L, 4 * L, ws + lo.h1, L, ws + lo.gates, nullptr, true, rtvc::kNone, B, WS);
    __syncthreads();
    lstm_update(ws, lo, lo.h1, lo.c1, w.l1_bhh, B, L, WS);
    __syncthreads();
    mv(w.l2_wih, L, 4 * L, ws + lo.x, L, ws + lo.gates, w.l2_bih, false, rtvc::kNone, B, WS);
    mv(w.l2_whh, L, 4 * L, ws + lo.h2, L, ws + lo.gates, nullptr, true, rtvc::kNone, B, WS);
    __syncthreads();
    lstm_update(ws, lo, lo.h2, lo.c2, w.l2_bhh, B, L, WS);
    __syncthreads();

    // Mel frames s < r (mel_proj rows c·max_r + s) and the stop token over
    // [x | context]
    for (int s = 0; s < r; ++s)
      mv(w.mel_w + (size_t)s * L, d.max_r * L, M, ws + lo.x, L, ws + lo.melv + s * M, nullptr,
         false, rtvc::kNone, B, WS);
    mv(w.stop_w, L + E, 1, ws + lo.x, L, ws + lo.stop, w.stop_b, false, rtvc::kNone, B, WS);
    mv(w.stop_w + L, L + E, 1, ws + lo.ctx, E, ws + lo.stop, nullptr, true, rtvc::kNone, B, WS);
    __syncthreads();
    for (int idx = tid; idx < B * r * M; idx += blockDim.x) {
      const int b = idx / (r * M), rem = idx % (r * M), s = rem / M, c = rem % M;
      float* p = ws + (size_t)b * WS;
      const float v = p[lo.melv + s * M + c];
      mel[((size_t)b * M + c) * ((size_t)d.max_iters * r) + (size_t)it * r + s] = v;
      if (s == r - 1) p[lo.prev + c] = v;
    }
    if (tid < B) {
      const float sv = rtvc::sigmoidf_(ws[(size_t)tid * WS + lo.stop]);
      ws[(size_t)tid * WS + lo.stop] = sv;
      stops[(size_t)tid * d.max_iters + it] = sv;
    }
    __syncthreads();
    if (tid == 0) {
      bool all = it * r > 10;
      for (int b = 0; b < B; ++b) all = all && ws[(size_t)b * WS + lo.stop] > 0.5f;
      if (all) {
        done = 1;
        n_iters = it + 1;
      }
    }
    __syncthreads();
  }

  // Past the stop: zeros, as the reference's while_loop leaves them.
  const int n = n_iters;
  const int rest = d.max_iters - n;
  for (int idx = tid; idx < B * M * rest * r; idx += blockDim.x) {
    const int bc = idx / (rest * r), k = idx % (rest * r);
    mel[(size_t)bc * ((size_t)d.max_iters * r) + (size_t)n * r + k] = 0.0f;
  }
  for (int idx = tid; idx < B * rest * T; idx += blockDim.x) {
    const int b = idx / (rest * T), k = idx % (rest * T);
    attn[((size_t)b * d.max_iters + n) * T + k] = 0.0f;
  }
  for (int idx = tid; idx < B * rest; idx += blockDim.x) {
    const int b = idx / rest, k = idx % rest;
    stops[(size_t)b * d.max_iters + n + k] = 0.0f;
  }
}

}  // namespace

// Floats of workspace the decoder needs for batch B at these dims.
extern "C" int rtvc_tacotron_workspace(const int* dims) {
  Dims d;
  int* dp = reinterpret_cast<int*>(&d);
  for (int i = 0; i < (int)(sizeof(Dims) / sizeof(int)); ++i) dp[i] = dims[i];
  return d.B * Layout(d).WS;
}

// weights: kNumWeights device pointers in the order of struct Weights, torch
// layout, contiguous. dims: B, T, E, D, L, P, M, max_r, r, max_iters, NF, KS,
// dropout, drop_thr, work (floats in `work`). enc_seq (B, T, E),
// enc_proj (B, T, D), char_mask (B, T) → mel (B, M, max_iters·r),
// attn (B, max_iters, T), stops (B, max_iters).
extern "C" int rtvc_tacotron_decode(const void* const* weights, const int* dims,
                                    unsigned long long seed, const float* enc_seq,
                                    const float* enc_proj, const float* char_mask, float* mel,
                                    float* attn, float* stops, float* work, void* stream) {
  Weights w;
  const float** wp = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < kNumWeights; ++i) wp[i] = static_cast<const float*>(weights[i]);
  Dims d;
  int* dp = reinterpret_cast<int*>(&d);
  for (int i = 0; i < (int)(sizeof(Dims) / sizeof(int)); ++i) dp[i] = dims[i];
  if (d.work < d.B * Layout(d).WS) return (int)cudaErrorInvalidValue;
  const uint2 key = make_uint2((uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32));
  tacotron_decode_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      w, d, key, enc_seq, enc_proj, char_mask, mel, attn, stops, work);
  return (int)cudaGetLastError();
}
