// K3/K4: single-query decode attention over a stacked merged-head cache.
//
// Replaces BOTH TPU kernels of godot_whisper_tpu/ops/decode_attention.py:
// `_decode_attn_kernel` (one K/V row per query row, and its `shared_kv`
// variant) and `_decode_attn_group_packed_kernel` (kv_group query rows --
// the best_of decoders of one stream -- sharing one K/V row).  They compute
// one function, so on Hopper they are one kernel with `kv_group` a runtime
// argument:
//
//   q (B, S); k, v the full stacked caches (L, B / kv_group, C, S) read at
//   `layer` by pointer offset (never a per-layer copy); slot c of row b is
//   valid iff c < lo[b] or split <= c < hi; per-head softmax of
//   q . k / sqrt(D); out (B, S) f32.
//
// Self-attention passes lo = prompt length, split = prompt capacity,
// hi = split + step + 1; cross-attention passes lo = t_valid, split = C,
// hi = 0.  The TPU kernels' segment matrix and 128-lane head padding are
// lane-layout artefacts: here each block indexes its head's D columns.
//
// Bound on an H100: bytes.  Each live K/V byte of the group is read once:
// 2 * (live slots) * S * sizeof(T) per group, 2.4 MB for tiny.en's bf16
// cross-attention (1536 slots x 384), ~0.7 us at 3.35 TB/s; the math is a
// few FLOP per byte.
//
// Design: grid (B / kv_group, n_head), 128 threads.  A block streams its
// head's D columns of K/V in tiles of 64 slots, only up to its group's live
// prefix max(hi, max lo) (blocks of the cache past it are never read), and
// scores ALL kv_group query rows against each tile, so every K/V byte is
// read once per group -- the point of the TPU's group-packed kernel.  Per
// tile: scores to shared memory, one warp per row updates the online softmax
// (m, l), then (row, dim) pairs accumulate p @ V in registers.
#include "common.cuh"

namespace {

constexpr int kTC = 64;  // cache slots per tile (two per lane in the softmax)
constexpr int kThreads = 128;
constexpr int kMaxGroup = 8;  // MAX_DECODERS

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ lo,
                       float* __restrict__ out, int layer, int n_groups,
                       int C, int S, int R, int split, int hi, float scale) {
  constexpr int kPer = kMaxGroup * D / kThreads;  // (row, dim) pairs / thread
  __shared__ float s_k[kTC][D + 1];  // padded: conflict-free column reads
  __shared__ float s_v[kTC][D];
  __shared__ float s_q[kMaxGroup][D];
  __shared__ float s_p[kMaxGroup][kTC];
  __shared__ float s_m[kMaxGroup], s_l[kMaxGroup], s_corr[kMaxGroup];
  __shared__ int s_lo[kMaxGroup];
  __shared__ int s_end;

  const int g = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const size_t kv_base = ((size_t)layer * n_groups + g) * C * S + h * D;

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    s_q[r][d] = to_f32(q[(size_t)(g * R + r) * S + h * D + d]);
  }
  if (tid == 0) {
    int end = hi;
    for (int r = 0; r < R; ++r) {
      s_lo[r] = lo[g * R + r];
      s_m[r] = GWT_NEG;
      s_l[r] = 0.f;
      end = max(end, s_lo[r]);
    }
    s_end = min(end, C);
  }
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  __syncthreads();
  const int c_end = s_end;

  for (int c0 = 0; c0 < c_end; c0 += kTC) {
    for (int i = tid; i < kTC * D; i += kThreads) {
      const int j = i / D, d = i % D, c = c0 + j;
      float kk = 0.f, vv = 0.f;
      if (c < c_end) {
        const size_t o = kv_base + (size_t)c * S + d;
        kk = to_f32(k[o]);
        vv = to_f32(v[o]);
      }
      s_k[j][d] = kk;
      s_v[j][d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < R * kTC; i += kThreads) {
      const int r = i / kTC, j = i % kTC, c = c0 + j;
      float s = GWT_NEG;
      if (c < c_end && (c < s_lo[r] || (c >= split && c < hi))) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(s_q[r][d], s_k[j][d], dot);
        s = dot * scale;
      }
      s_p[r][j] = s;
    }
    __syncthreads();

    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < R; r += kThreads / 32) {
      const float a = s_p[r][lane], b = s_p[r][lane + 32];
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, b)));
      // masked slots contribute exactly 0, as exp(-1e30 - m) does
      const float pa = a > 0.5f * GWT_NEG ? expf(a - m_new) : 0.f;
      const float pb = b > 0.5f * GWT_NEG ? expf(b - m_new) : 0.f;
      s_p[r][lane] = pa;
      s_p[r][lane + 32] = pb;
      const float ps = warp_sum(pa + pb);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_corr[r] = corr;
        s_l[r] = s_l[r] * corr + ps;
        s_m[r] = m_new;
      }
    }
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
int launch(const void* q, const void* k, const void* v, const void* lo,
           void* out, int layer, int n_groups, int C, int S, int n_head,
           int R, int split, int hi, float scale, cudaStream_t stream) {
  const dim3 grid(n_groups, n_head);
  decode_attn_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lo, (float*)out,
      layer, n_groups, C, S, R, split, hi, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32 or 64.  kv_group <= 8.
extern "C" int gwt_decode_attn(const void* q, const void* k, const void* v,
                               const void* lo, void* out, int layer,
                               int n_groups, int C, int S, int n_head,
                               int kv_group, int split, int hi, float scale,
                               int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int hd = S / n_head;
  if (kv_group < 1 || kv_group > kMaxGroup) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, lo, out, layer, n_groups, C, S, n_head,
                             kv_group, split, hi, scale, s);
  if (dtype == 0 && hd == 32)
    return launch<float, 32>(q, k, v, lo, out, layer, n_groups, C, S, n_head,
                             kv_group, split, hi, scale, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, lo, out, layer, n_groups, C, S,
                                     n_head, kv_group, split, hi, scale, s);
  if (dtype == 1 && hd == 32)
    return launch<__nv_bfloat16, 32>(q, k, v, lo, out, layer, n_groups, C, S,
                                     n_head, kv_group, split, hi, scale, s);
  return (int)cudaErrorInvalidValue;
}
