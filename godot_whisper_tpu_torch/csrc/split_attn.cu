// K7: beam self-attention over a split prompt / live cache, one online
// softmax across both.
//
// Replaces the TPU kernel `_split_beam_kernel` of
// godot_whisper_tpu/ops/split_attention.py (reached through
// `split_beam_attention`):
//
//   q (B, S) with B = G * R (G beam groups of R beams);
//   the PROMPT cache kp, vp (L, G, CP, S) is stored once per group (the R
//   beams of a group share their prompt), slot c of beam b valid iff
//   c < lo[b];
//   the LIVE cache kl, vl (L, B, NL, S) holds the autoregressive slots,
//   valid below hi_live, and beam b's slot t lives in row
//   g * R + rowmap[b, t] of its group (the zero-copy beam merge permutes
//   this (B, NL) map instead of moving cache bytes);
//   per-head softmax of q . k / sqrt(D) over both regions; out (B, S) f32.
//
// Both caches enter as the full stacked tensors, the layer selected by
// pointer offset.  The TPU kernel's 128-lane packing of R x H heads into one
// score tile and its one-hot row-map matmul are Mosaic workarounds: here a
// block indexes its head's D columns and reads the row map directly.
//
// Bound on an H100: bytes.  The group's prompt K/V up to max(lo) once and
// every beam's live K/V up to hi_live: 2 * max(lo) * S + 2 * B * hi_live * S
// elements; at tiny.en beam 5 (S = 384, prompt <= 232 slots, <= 220 live
// slots) under 2 MB per layer, under 1 us at 3.35 TB/s.  The math is a few
// FLOP per byte.
//
// Design: grid (G, n_head), 128 threads, tiles of 64 slots staged in shared
// memory as f32.  Phase 1 streams the group's prompt tiles [0, max lo) once
// and scores all R beams against each tile (as K3/K4 do), masking c >= lo[b].
// Phase 2 walks the live slots [0, hi_live) beam by beam, gathering each
// tile's rows through the row map.  One online-softmax state (m, l) and one
// accumulator per (beam, dim) carry across both phases.  Phase 2 reads a
// live row once per beam that maps to it, not once per group: simple first.
#include "common.cuh"

namespace {

constexpr int kTC = 64;  // slots per tile (two per lane in the softmax)
constexpr int kThreads = 128;
constexpr int kMaxGroup = 8;  // MAX_DECODERS

// Online-softmax update of one beam from its tile scores p[0, kTC), by one
// warp: p becomes exp(s - m_new) (exactly 0 on masked slots, as
// exp(-1e30 - m) is), and m, l and corr (the factor on the old sums) are
// updated in shared memory.
__device__ __forceinline__ void online_update(float* p, float* m, float* l,
                                              float* corr, int lane) {
  const float a = p[lane], b = p[lane + 32];
  const float m_old = *m;
  const float m_new = fmaxf(m_old, warp_max(fmaxf(a, b)));
  const float pa = a > 0.5f * GWT_NEG ? expf(a - m_new) : 0.f;
  const float pb = b > 0.5f * GWT_NEG ? expf(b - m_new) : 0.f;
  p[lane] = pa;
  p[lane + 32] = pb;
  const float ps = warp_sum(pa + pb);
  if (lane == 0) {
    const float c = expf(m_old - m_new);
    *corr = c;
    *l = *l * c + ps;
    *m = m_new;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    split_beam_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp, const T* __restrict__ kl,
                      const T* __restrict__ vl, const int* __restrict__ lo,
                      const int* __restrict__ rowmap, float* __restrict__ out,
                      int layer, int G, int CP, int NL, int S, int R,
                      int hi_live, float scale) {
  constexpr int kPer = kMaxGroup * D / kThreads;  // (beam, dim) pairs / thread
  __shared__ float s_k[kTC][D + 1];  // padded: conflict-free column reads
  __shared__ float s_v[kTC][D];
  __shared__ float s_q[kMaxGroup][D];
  __shared__ float s_p[kMaxGroup][kTC];
  __shared__ float s_m[kMaxGroup], s_l[kMaxGroup], s_corr[kMaxGroup];
  __shared__ int s_lo[kMaxGroup];
  __shared__ int s_row[kTC];  // live row of each slot of the tile
  __shared__ int s_end;

  const int g = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int B = G * R;
  const size_t p_base = ((size_t)layer * G + g) * CP * S + h * D;

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    s_q[r][d] = to_f32(q[(size_t)(g * R + r) * S + h * D + d]);
  }
  if (tid == 0) {
    int end = 0;
    for (int r = 0; r < R; ++r) {
      s_lo[r] = lo[g * R + r];
      s_m[r] = GWT_NEG;
      s_l[r] = 0.f;
      end = max(end, s_lo[r]);
    }
    s_end = min(end, CP);
  }
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  __syncthreads();
  const int p_end = s_end;

  // ---- phase 1: the group's shared prompt slots, all beams per tile
  for (int c0 = 0; c0 < p_end; c0 += kTC) {
    for (int i = tid; i < kTC * D; i += kThreads) {
      const int j = i / D, d = i % D, c = c0 + j;
      float kk = 0.f, vv = 0.f;
      if (c < p_end) {
        const size_t o = p_base + (size_t)c * S + d;
        kk = to_f32(kp[o]);
        vv = to_f32(vp[o]);
      }
      s_k[j][d] = kk;
      s_v[j][d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < R * kTC; i += kThreads) {
      const int r = i / kTC, j = i % kTC, c = c0 + j;
      float s = GWT_NEG;
      if (c < p_end && c < s_lo[r]) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(s_q[r][d], s_k[j][d], dot);
        s = dot * scale;
      }
      s_p[r][j] = s;
    }
    __syncthreads();
    for (int r = warp; r < R; r += kThreads / 32)
      online_update(s_p[r], &s_m[r], &s_l[r], &s_corr[r], lane);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < R * D) {
        const int r = idx / D, d = idx % D;
        float a = acc[i] * s_corr[r];
#pragma unroll 16
        for (int j = 0; j < kTC; ++j) a = fmaf(s_p[r][j], s_v[j][d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  // ---- phase 2: each beam's live slots, gathered through the row map
  for (int r = 0; r < R; ++r) {
    const int b = g * R + r;
    const int* rm = rowmap + (size_t)b * NL;
    for (int t0 = 0; t0 < hi_live; t0 += kTC) {
      if (tid < kTC)
        s_row[tid] = t0 + tid < hi_live ? g * R + rm[t0 + tid] : 0;
      __syncthreads();
      for (int i = tid; i < kTC * D; i += kThreads) {
        const int j = i / D, d = i % D, t = t0 + j;
        float kk = 0.f, vv = 0.f;
        if (t < hi_live) {
          const size_t o =
              (((size_t)layer * B + s_row[j]) * NL + t) * S + h * D + d;
          kk = to_f32(kl[o]);
          vv = to_f32(vl[o]);
        }
        s_k[j][d] = kk;
        s_v[j][d] = vv;
      }
      __syncthreads();
      for (int j = tid; j < kTC; j += kThreads) {
        float s = GWT_NEG;
        if (t0 + j < hi_live) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot = fmaf(s_q[r][d], s_k[j][d], dot);
          s = dot * scale;
        }
        s_p[r][j] = s;
      }
      __syncthreads();
      if (warp == 0) online_update(s_p[r], &s_m[r], &s_l[r], &s_corr[r], lane);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = tid + i * kThreads;
        if (idx < R * D && idx / D == r) {
          const int d = idx % D;
          float a = acc[i] * s_corr[r];
#pragma unroll 16
          for (int j = 0; j < kTC; ++j) a = fmaf(s_p[r][j], s_v[j][d], a);
          acc[i] = a;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < R * D) {
      const int r = idx / D, d = idx % D;
      out[(size_t)(g * R + r) * S + h * D + d] =
          acc[i] / fmaxf(s_l[r], 1e-30f);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* kl,
           const void* vl, const void* lo, const void* rowmap, void* out,
           int layer, int G, int CP, int NL, int S, int n_head, int R,
           int hi_live, float scale, cudaStream_t stream) {
  const dim3 grid(G, n_head);
  split_beam_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const T*)kl, (const T*)vl,
      (const int*)lo, (const int*)rowmap, (float*)out, layer, G, CP, NL, S, R,
      hi_live, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32 or 64.  R (beams per
// group) <= 8.  rowmap values must lie in [0, R).
extern "C" int gwt_split_beam_attn(const void* q, const void* kp,
                                   const void* vp, const void* kl,
                                   const void* vl, const void* lo,
                                   const void* rowmap, void* out, int layer,
                                   int G, int CP, int NL, int S, int n_head,
                                   int R, int hi_live, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int hd = S / n_head;
  if (R < 1 || R > kMaxGroup) return (int)cudaErrorInvalidValue;
#define GWT_SPLIT(T, D)                                                     \
  return launch<T, D>(q, kp, vp, kl, vl, lo, rowmap, out, layer, G, CP, NL, \
                      S, n_head, R, hi_live, scale, s)
  if (dtype == 0 && hd == 64) GWT_SPLIT(float, 64);
  if (dtype == 0 && hd == 32) GWT_SPLIT(float, 32);
  if (dtype == 1 && hd == 64) GWT_SPLIT(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 32) GWT_SPLIT(__nv_bfloat16, 32);
#undef GWT_SPLIT
  return (int)cudaErrorInvalidValue;
}
