// K11/K12: single-query cross-attention over an int8 merged-head cache.
//
// Replaces the TPU kernels of godot_whisper_tpu/ops/cross_attention.py:
//   K11 `_xattn_q_kernel` (exact mode; one K/V row per query row, or with
//       `shared_kv` a beam group's rows sharing one K/V row; the route when
//       kv_group * n_head > 128), softmax blocks of 256 slots;
//   K12 `_xattn_q_group_packed_kernel` (kv_group * n_head <= 128, kv_group 1
//       included), softmax blocks of 512 slots when T % 512 == 0, in exact
//       mode or the default W8A8 mode.
// The TPU kernels' segment matrices, 128-lane head padding and row packing
// are lane-layout artefacts; both compute one function per (query row,
// head), so on Hopper they are one kernel template with kv_group, the
// softmax block and the mode as arguments, as K3/K4 share decode_attn.cu.
//
//   q (B, S) bf16; k_q, v_q (L, G, T, S) int8 read at `layer` by pointer
//   offset; k_s (L, G, T, 128) bf16, one scale per (slot, head); v_s
//   (L, G, 128) f32, one per head; lo (B,) int32: slot c of row b is valid
//   iff c < lo[b].  Rows g*kv_group .. g*kv_group + kv_group - 1 read K/V
//   row g.  out (B, S) f32.
//
// The rounding points are the TPU kernels', per softmax block of `blk`
// slots with the block's running max m:
//   exact: s = (sum_d bf16(q) * k_q) / sqrt(D) * k_s;  p = exp(s - m)
//          rounded to bf16 before P.V (V int8 widened exactly);
//   W8A8:  per (row, head) qs = max(absmax(q), 1e-20) * f32(1/127) (XLA
//          compiles the TPU kernel's division by the constant 127 to this
//          product) and qi = rint(q / qs) (true division, ties to even);
//          s = int32(sum_d qi * k_q) * (qs / sqrt(D)) * k_s;
//          p_q = rint(127 * p); acc = acc * corr + int(sum p_q * v_q) / 127;
// l sums the unrounded f32 p; out = acc / max(l, 1e-30) * v_s[h].
// Integer sums stay below 2^24 (64 * 127^2 and 512 * 127^2), so they are
// exact in f32 as in int32.
//
// Bound on an H100: bytes.  Each live K/V byte of a group is read once: at
// tiny.en (T 1536, S 384, bf16 k_s) 2 * 1536 * 384 + 1536 * 128 * 2 =
// 1.57 MB per layer, ~0.5 us at 3.35 TB/s.  Design: grid (G, n_head), 128
// threads; a block walks its head's D columns of K, then of V, in tiles of
// 64 slots within each softmax block, scores all kv_group rows against each
// tile (every K/V byte read once per group), keeps the block's scores in
// shared memory for the max / exp / rounding pass, and accumulates P.V for
// (row, dim) pairs in registers.  W8A8 scores use __dp4a on packed int8.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;      // slots per shared-memory tile
constexpr int kMaxRows = 8;    // MAX_DECODERS
constexpr int kMaxBlk = 512;   // largest softmax block (K12)
constexpr int kScalePad = 128; // k_s / v_s head axis (the TPU lane tile)

// A tile of kTile slots x D int8 values (4-byte word loads, D % 4 == 0) into
// shared memory as floats.
template <int D>
__device__ __forceinline__ void load_tile_f32(const int8_t* __restrict__ src,
                                              int S, float (*dst)[D + 1]) {
  constexpr int D4 = D / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kTile * D4; i += kThreads) {
    const int j = i / D4, d4 = i % D4;
    const int word = __ldg(reinterpret_cast<const int*>(src + (size_t)j * S
                                                        + 4 * d4));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[j][4 * d4 + e] = (float)(int8_t)((word >> (8 * e)) & 0xFF);
  }
}

template <int D, bool W8A8>
__global__ void __launch_bounds__(kThreads)
    xattn_q_kernel(const __nv_bfloat16* __restrict__ q,
                   const int8_t* __restrict__ kq,
                   const __nv_bfloat16* __restrict__ ks,
                   const int8_t* __restrict__ vq, const float* __restrict__ vs,
                   const int* __restrict__ lo, float* __restrict__ out,
                   int layer, int n_groups, int T, int S, int R, int blk,
                   float scale) {
  constexpr int kPer = kMaxRows * D / kThreads;  // (row, dim) pairs / thread
  constexpr int D4 = D / 4;
  __shared__ float s_q[kMaxRows][D];
  __shared__ int s_qi[kMaxRows][D4];
  __shared__ float s_qss[kMaxRows];
  __shared__ float s_p[kMaxRows][kMaxBlk];
  __shared__ float s_kv[kTile][D + 1];
  __shared__ int s_k4[kTile][D4 + 1];
  __shared__ float s_m[kMaxRows], s_l[kMaxRows], s_corr[kMaxRows];
  __shared__ int s_lo[kMaxRows];
  __shared__ int s_end;

  const int g = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t lg = (size_t)layer * n_groups + g;
  const size_t kv_base = lg * T * S + (size_t)h * D;
  const size_t ks_base = lg * T * kScalePad + h;
  const float v_scale = vs[lg * kScalePad + h];

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
    // softmax blocks up to the group's live prefix (at least one block)
    s_end = min(max((end + blk - 1) / blk, 1) * blk, T);
  }
  __syncthreads();
  if (W8A8) {
    for (int r = warp; r < R; r += kThreads / 32) {
      float a = 0.f;
      for (int d = lane; d < D; d += 32) a = fmaxf(a, fabsf(s_q[r][d]));
      a = warp_max(a);
      const float qs = fmaxf(a, 1e-20f) * (1.0f / 127.0f);
      for (int d4 = lane; d4 < D4; d4 += 32) {
        int packed = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = (int)rintf(s_q[r][4 * d4 + j] / qs);
          packed |= (v & 0xFF) << (8 * j);
        }
        s_qi[r][d4] = packed;
      }
      if (lane == 0) s_qss[r] = qs * scale;
    }
    __syncthreads();
  }
  const int c_end = s_end;

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < c_end; c0 += blk) {
    // ---- scores of the block's slots for every row of the group
    for (int t0 = 0; t0 < blk; t0 += kTile) {
      if (W8A8) {
#pragma unroll
        for (int i = tid; i < kTile * D4; i += kThreads) {
          const int j = i / D4, d4 = i % D4;
          s_k4[j][d4] = __ldg(reinterpret_cast<const int*>(
              kq + kv_base + (size_t)(c0 + t0 + j) * S + 4 * d4));
        }
      } else {
        load_tile_f32<D>(kq + kv_base + (size_t)(c0 + t0) * S, S, s_kv);
      }
      __syncthreads();
      for (int i = tid; i < R * kTile; i += kThreads) {
        const int r = i / kTile, j = i % kTile, c = c0 + t0 + j;
        float sc;
        if (W8A8) {
          int dot = 0;
#pragma unroll
          for (int d4 = 0; d4 < D4; ++d4) dot = __dp4a(s_qi[r][d4], s_k4[j][d4],
                                                       dot);
          sc = (float)dot * s_qss[r];
        } else {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot = fmaf(s_q[r][d], s_kv[j][d], dot);
          sc = dot * scale;
        }
        sc = sc * __bfloat162float(ks[ks_base + (size_t)c * kScalePad]);
        s_p[r][t0 + j] = c < s_lo[r] ? sc : GWT_NEG;
      }
      __syncthreads();
    }

    // ---- online softmax over the block: running max, f32 sum of the
    // unrounded p, p rounded for P.V (bf16, or 127 * p to an integer)
    for (int r = warp; r < R; r += kThreads / 32) {
      float mx = GWT_NEG;
      for (int j = lane; j < blk; j += 32) mx = fmaxf(mx, s_p[r][j]);
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < blk; j += 32) {
        const float p = expf(s_p[r][j] - m_new);
        sum += p;
        s_p[r][j] = W8A8 ? rintf(p * 127.0f)
                         : __bfloat162float(__float2bfloat16(p));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_corr[r] = corr;
        s_l[r] = s_l[r] * corr + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // ---- P.V over the block, then acc = acc * corr + block sum
    float pb[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) pb[i] = 0.f;
    for (int t0 = 0; t0 < blk; t0 += kTile) {
      load_tile_f32<D>(vq + kv_base + (size_t)(c0 + t0) * S, S, s_kv);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = tid + i * kThreads;
        if (idx < R * D) {
          const int r = idx / D, d = idx % D;
          float a = pb[i];
#pragma unroll 16
          for (int j = 0; j < kTile; ++j) a = fmaf(s_p[r][t0 + j], s_kv[j][d], a);
          pb[i] = a;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < R * D) {
        const int r = idx / D;
        acc[i] = acc[i] * s_corr[r] + (W8A8 ? pb[i] * (1.0f / 127.0f) : pb[i]);
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
          acc[i] / fmaxf(s_l[r], 1e-30f) * v_scale;
    }
  }
}

template <int D>
int launch(bool w8a8, const void* q, const void* kq, const void* ks,
           const void* vq, const void* vs, const void* lo, void* out,
           int layer, int n_groups, int T, int S, int n_head, int R, int blk,
           float scale, cudaStream_t stream) {
  const dim3 grid(n_groups, n_head);
  if (w8a8)
    xattn_q_kernel<D, true><<<grid, kThreads, 0, stream>>>(
        (const __nv_bfloat16*)q, (const int8_t*)kq, (const __nv_bfloat16*)ks,
        (const int8_t*)vq, (const float*)vs, (const int*)lo, (float*)out,
        layer, n_groups, T, S, R, blk, scale);
  else
    xattn_q_kernel<D, false><<<grid, kThreads, 0, stream>>>(
        (const __nv_bfloat16*)q, (const int8_t*)kq, (const __nv_bfloat16*)ks,
        (const int8_t*)vq, (const float*)vs, (const int*)lo, (float*)out,
        layer, n_groups, T, S, R, blk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// head_dim 16, 32 or 64; kv_group <= 8; blk 256 or 512 dividing T;
// n_head <= 128; w8a8 0 = exact, 1 = W8A8.
extern "C" int gwt_xattn_q(const void* q, const void* kq, const void* ks,
                           const void* vq, const void* vs, const void* lo,
                           void* out, int layer, int n_groups, int T, int S,
                           int n_head, int kv_group, int blk, int w8a8,
                           float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int hd = S / n_head;
  if (kv_group < 1 || kv_group > kMaxRows || n_head > kScalePad ||
      (blk != 256 && blk != 512) || T % blk || S % 4)
    return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return launch<64>(w8a8, q, kq, ks, vq, vs, lo, out, layer, n_groups, T, S,
                      n_head, kv_group, blk, scale, st);
  if (hd == 32)
    return launch<32>(w8a8, q, kq, ks, vq, vs, lo, out, layer, n_groups, T, S,
                      n_head, kv_group, blk, scale, st);
  if (hd == 16)
    return launch<16>(w8a8, q, kq, ks, vq, vs, lo, out, layer, n_groups, T, S,
                      n_head, kv_group, blk, scale, st);
  return (int)cudaErrorInvalidValue;
}
