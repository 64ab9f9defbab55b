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
// head) with kv_group, the softmax block and the mode as arguments.
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
// tiny.en (T 1536, S 384, bf16 k_s) 2 * 1500 * 384 + 1500 * 6 * 2 = 1.17
// MB per layer, ~0.35 us at 3.35 TB/s; what a call costs is latency.
//
// K12 (`xattn_packed_kernel`): a thread-block cluster of blk / 64 CTAs of
// 256 threads (8 CTAs for 512-slot blocks, 4 for 256) per (group, head),
// grid (cluster, heads, groups): 48 CTAs for one tiny.en stream, 160 at
// large-v3 widths (one CTA per (group, head) would give 6 and 20).
// CTA r of a cluster takes slots [64 r, 64 r + 64) of every softmax block
// and loads its slices of up to 3 blocks at once by 16-byte cp.async (one
// memory round trip after lo and q); a slice no row may attend is
// not loaded (it contributes exactly 0: p = exp(-1e30 - m) with m finite
// once slot 0 is seen; every slice is loaded when some row has lo <= 0).
//   1. scores of the CTA's slots for every row of the group: lanes split a
//      slot's D bytes in 16-byte pieces (dp4a on int8 in W8A8), then a
//      shuffle sum; each slice maximum is stored into the shared memory of
//      every CTA of the cluster (distributed shared memory);
//   2. cluster barrier; each CTA has every slice maximum of every block, so
//      each computes the blocks' running maxima, the values the one-CTA
//      kernel has; p, its rounding, the slice's f32 sum of the unrounded p
//      (stored into every CTA);
//   3. P.V of each slice: W8A8 as dp4a on the rounded p and V (a 4 x 4 byte
//      transpose in registers; exact int32), exact mode f32 FMA on the bf16
//      p; each (row, dim) partial is stored into the CTA that owns the pair
//      (CTA r owns 1 / cluster of them);
//   4. cluster barrier; an owner adds the cluster's partials in rank order,
//      block by block: W8A8 the exact integer sum, then one `/ 127` (`*
//      f32(1/127)`), so acc = acc * corr + pv rounds as in the one-CTA
//      kernel; l likewise from the slices' sums.
// Two cluster barriers per call up to 3 blocks (T <= 1536), no read of
// another CTA's memory, so no CTA waits before it exits.  Only l and exact
// mode's f32 P.V and score dot change their order of summation.  Results
// are bitwise equal from call to call, and the kernel keeps no state
// between calls (a CUDA graph replays it).
//
// K11 (`xattn_q_kernel`, exact mode): grid (G,
// n_head), 128 threads; a block walks its head's D columns of K, then of
// V, in tiles of 64 slots within each softmax block, scores all kv_group
// rows against each tile, keeps the block's scores in shared memory for
// the max / exp / rounding pass, and accumulates P.V for (row, dim) pairs
// in registers.
#include <cooperative_groups.h>
#include <limits.h>

#include "int8_async.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;      // slots per shared-memory tile
constexpr int kMaxRows = 8;    // MAX_DECODERS
constexpr int kMaxBlk = 512;   // largest softmax block
constexpr int kScalePad = 128; // k_s / v_s head axis (the TPU lane tile)
constexpr int kMaxCluster = 8; // K12: CTAs per (group, head)

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    xattn_q_kernel(const __nv_bfloat16* __restrict__ q,
                   const int8_t* __restrict__ kq,
                   const __nv_bfloat16* __restrict__ ks,
                   const int8_t* __restrict__ vq, const float* __restrict__ vs,
                   const int* __restrict__ lo, float* __restrict__ out,
                   int layer, int n_groups, int T, int S, int R, int blk,
                   float scale) {
  constexpr int kPer = kMaxRows * D / kThreads;  // (row, dim) pairs / thread
  __shared__ float s_q[kMaxRows][D];
  __shared__ float s_p[kMaxRows][kMaxBlk];
  __shared__ float s_kv[kTile][D + 1];
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
  const int c_end = s_end;

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < c_end; c0 += blk) {
    // ---- scores of the block's slots for every row of the group
    for (int t0 = 0; t0 < blk; t0 += kTile) {
      load_tile_f32<D>(kq + kv_base + (size_t)(c0 + t0) * S, S, s_kv);
      __syncthreads();
      for (int i = tid; i < R * kTile; i += kThreads) {
        const int r = i / kTile, j = i % kTile, c = c0 + t0 + j;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(s_q[r][d], s_kv[j][d], dot);
        float sc = dot * scale;
        sc = sc * __bfloat162float(ks[ks_base + (size_t)c * kScalePad]);
        s_p[r][t0 + j] = c < s_lo[r] ? sc : GWT_NEG;
      }
      __syncthreads();
    }

    // ---- online softmax over the block: running max, f32 sum of the
    // unrounded p, p rounded to bf16 for P.V
    for (int r = warp; r < R; r += kThreads / 32) {
      float mx = GWT_NEG;
      for (int j = lane; j < blk; j += 32) mx = fmaxf(mx, s_p[r][j]);
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < blk; j += 32) {
        const float p = expf(s_p[r][j] - m_new);
        sum += p;
        s_p[r][j] = __bfloat162float(__float2bfloat16(p));
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
        acc[i] = acc[i] * s_corr[r] + pb[i];
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
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* lo, void* out, int layer, int n_groups,
           int T, int S, int n_head, int R, int blk, float scale,
           cudaStream_t stream) {
  xattn_q_kernel<D><<<dim3(n_groups, n_head), kThreads, 0, stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)kq, (const __nv_bfloat16*)ks,
      (const int8_t*)vq, (const float*)vs, (const int*)lo, (float*)out,
      layer, n_groups, T, S, R, blk, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- K12: a cluster --
namespace k12 {

namespace cg = cooperative_groups;
using namespace gwt_q8;
constexpr int kSlice = 64;  // slots of each softmax block per CTA
constexpr int kGroup = 3;   // softmax blocks a CTA holds at once
constexpr int kT12 = 256;   // threads of a CTA

// Sum over the 16 lanes of a half warp.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid (blk / kSlice, n_head, G), one cluster of blk / kSlice CTAs per
// (group, head); see the header.  A CTA holds its slices of up to kGroup
// softmax blocks at once; per such group of blocks, two cluster barriers:
// after every CTA has stored its slices' maxima into every CTA's shared
// memory, and after it has stored its P.V and p-sum partials into the
// shared memory of the CTA that owns each (row, dim) pair.  Nothing is read
// from another CTA's shared memory, so no CTA waits before it exits.
template <int D, bool W8A8>
__global__ void __launch_bounds__(kT12)
    xattn_packed_kernel(const __nv_bfloat16* __restrict__ q,
                        const int8_t* __restrict__ kq,
                        const __nv_bfloat16* __restrict__ ks,
                        const int8_t* __restrict__ vq,
                        const float* __restrict__ vs,
                        const int* __restrict__ lo, float* __restrict__ out,
                        int layer, int n_groups, int T, int S, int R, int blk,
                        float scale) {
  constexpr int D4 = D / 4, kCh = D / 16;  // words, 16-byte pieces a slot
  constexpr int kSpi = 32 / kCh;           // slots a warp scores at once
  __shared__ __align__(16) int8_t s_k[kGroup][kSlice][D];
  __shared__ __align__(16) int8_t s_v[kGroup][kSlice][D];
  __shared__ uint32_t s_ksw[kGroup][kSlice];  // bf16 pair holding k_s[h]
  __shared__ __align__(16) float s_q[kMaxRows][D];
  __shared__ __align__(16) int s_qi[kMaxRows][D4];
  __shared__ float s_qss[kMaxRows];
  // scores, then (exact mode) the bf16-rounded p
  __shared__ __align__(16) float s_p[kGroup][kMaxRows][kSlice];
  __shared__ __align__(4) uint8_t s_pq[kGroup][kMaxRows][kSlice];  // W8A8
  __shared__ float s_corr[kGroup][kMaxRows];
  __shared__ float s_l[kMaxRows];
  __shared__ int s_lo[kMaxRows];
  __shared__ int s_info[3];  // blocks, max lo, min lo
  // stored by the cluster's CTAs: slice maxima and p sums of every rank,
  // the P.V partials of the (row, dim) pairs this CTA owns
  __shared__ float s_max_in[kGroup][kMaxCluster][kMaxRows];
  __shared__ float s_l_in[kGroup][kMaxCluster][kMaxRows];
  __shared__ float s_pv_in[kGroup][kMaxRows * D + kMaxCluster];

  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nc = (int)cluster.num_blocks();
  const int h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t lg = (size_t)layer * n_groups + g;
  const int8_t* kbase = kq + lg * T * S + (size_t)h * D;
  const int8_t* vbase = vq + lg * T * S + (size_t)h * D;
  const __nv_bfloat16* ksbase = ks + lg * T * kScalePad + (h & ~1);

  constexpr int kQv = (kMaxRows * D + kT12 - 1) / kT12;
  float qv[kQv];
#pragma unroll
  for (int i = 0; i < kQv; ++i) {
    const int idx = tid + i * kT12, r = idx / D, d = idx % D;
    qv[i] = r < R ? to_f32(q[(size_t)(g * R + r) * S + h * D + d]) : 0.f;
  }
  const float v_scale = vs[lg * kScalePad + h];
  if (warp == 0) {
    const int v = lane < R ? lo[g * R + lane] : 0;
    int mx = lane < R ? v : INT_MIN, mn = lane < R ? v : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    if (lane < R) {
      s_lo[lane] = v;
      s_l[lane] = 0.f;
    }
    if (lane == 0) {
      // softmax blocks up to the group's live prefix (at least one block)
      s_info[0] = min(max((mx + blk - 1) / blk, 1), T / blk);
      s_info[1] = mx;
      s_info[2] = mn;
    }
  }
  __syncthreads();
  const int nb = s_info[0], lo_max = s_info[1], lo_min = s_info[2];
  auto live = [&](int c0) { return c0 < lo_max || lo_min <= 0; };
  // this CTA's slice of block b into buffer gb: K, V, the k_s words
  auto issue = [&](int b, int gb) {
    const int c0 = b * blk + rank * kSlice;
    if (!live(c0)) return;
    for (int i = tid; i < kSlice * kCh; i += kT12) {
      const int j = i / kCh, c = i % kCh;
      const size_t off = (size_t)(c0 + j) * S + 16 * c;
      cp_async16(&s_k[gb][j][16 * c], kbase + off);
      cp_async16(&s_v[gb][j][16 * c], vbase + off);
    }
    if (tid < kSlice)
      cp_async4(&s_ksw[gb][tid], ksbase + (size_t)(c0 + tid) * kScalePad);
  };
  for (int gb = 0; gb < min(kGroup, nb); ++gb) issue(gb, gb);
  cp_async_commit();

#pragma unroll
  for (int i = 0; i < kQv; ++i) {
    const int idx = tid + i * kT12;
    if (idx < kMaxRows * D) s_q[idx / D][idx % D] = qv[i];
  }
  __syncthreads();
  if (W8A8) {
    for (int r = warp; r < R; r += kT12 / 32) {
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
  }

  // half warp (row pr, slots 4 * l16 .. + 4) in the softmax steps; thread
  // (row, 4 dims) in P.V; the (row, dim) pairs this CTA owns, one a thread
  const int pr = tid >> 4, l16 = tid & 15;
  const int per = (R * D + nc - 1) / nc;
  const int own = rank * per + tid;
  const bool owner = tid < per && own < R * D;
  const int o_r = owner ? own / D : 0;
  float acc = 0.f, m_run = GWT_NEG;

  for (int b0 = 0; b0 < nb; b0 += kGroup) {
    const int ng = min(kGroup, nb - b0);
    if (b0 > 0) {
      for (int gb = 0; gb < ng; ++gb) issue(b0 + gb, gb);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();

    // ---- 1. scores of the slices' slots for every row of the group
    for (int gb = 0; gb < ng; ++gb) {
      const int c0 = (b0 + gb) * blk + rank * kSlice;
      if (!live(c0)) {
        for (int i = tid; i < kMaxRows * kSlice; i += kT12)
          s_p[gb][i / kSlice][i % kSlice] = GWT_NEG;
        continue;
      }
      for (int j0 = warp * kSpi; j0 < kSlice; j0 += kSpi * (kT12 / 32)) {
        const int j = j0 + lane / kCh, c = lane % kCh, slot = c0 + j;
        const uint4 kv =
            *reinterpret_cast<const uint4*>(&s_k[gb][j][16 * c]);
        const uint32_t kw = s_ksw[gb][j];
        const float ksv = __uint_as_float((h & 1) ? kw & 0xFFFF0000u
                                                  : kw << 16);
        float kf[4][4];
        if (!W8A8) {
          i8x4_f32(kv.x, kf[0]);
          i8x4_f32(kv.y, kf[1]);
          i8x4_f32(kv.z, kf[2]);
          i8x4_f32(kv.w, kf[3]);
        }
        // all kMaxRows rows unconditionally (rows past R are never
        // stored), so the rows' dependency chains interleave
        float sc[kMaxRows];
        if (W8A8) {
          int dot[kMaxRows];
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            const int4 qq = *reinterpret_cast<const int4*>(&s_qi[r][4 * c]);
            dot[r] = __dp4a(qq.w, (int)kv.w,
                            __dp4a(qq.z, (int)kv.z,
                                   __dp4a(qq.y, (int)kv.y,
                                          __dp4a(qq.x, (int)kv.x, 0))));
          }
#pragma unroll
          for (int o = 1; o < kCh; o <<= 1)
#pragma unroll
            for (int r = 0; r < kMaxRows; ++r)
              dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) sc[r] = (float)dot[r] * s_qss[r];
        } else {
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < 16; ++e)
              dot = fmaf(s_q[r][16 * c + e], kf[e >> 2][e & 3], dot);
            sc[r] = dot;
          }
#pragma unroll
          for (int o = 1; o < kCh; o <<= 1)
#pragma unroll
            for (int r = 0; r < kMaxRows; ++r)
              sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) sc[r] = sc[r] * scale;
        }
        if (c == 0) {
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r)
            if (r < R)
              s_p[gb][r][j] = slot < s_lo[r] ? sc[r] * ksv : GWT_NEG;
        }
      }
    }
    __syncthreads();
    if (b0 == 0) cluster_wait();  // every CTA of the cluster has started
    // every slice maximum into every CTA of the cluster (blocks past ng
    // hold stale values and are never stored); half warps 0..7 are rows
    const bool row_thread = tid < kMaxRows * 16;
    float mx[kGroup];
#pragma unroll
    for (int gb = 0; gb < kGroup; ++gb) {
      const float4 v4 =
          row_thread ? *reinterpret_cast<const float4*>(&s_p[gb][pr][4 * l16])
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      mx[gb] = fmaxf(fmaxf(v4.x, v4.y), fmaxf(v4.z, v4.w));
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
#pragma unroll
      for (int gb = 0; gb < kGroup; ++gb)
        mx[gb] = fmaxf(mx[gb], __shfl_xor_sync(0xffffffffu, mx[gb], o));
    if (row_thread && pr < R && l16 < nc) {
#pragma unroll
      for (int gb = 0; gb < kGroup; ++gb)
        if (gb < ng)
          cluster.map_shared_rank(&s_max_in[gb][rank][pr], l16)[0] = mx[gb];
    }
    cluster.sync();

    // ---- 2. each block's running max; p, its rounding, the slice's p sum
    float bm[kGroup];
#pragma unroll
    for (int gb = 0; gb < kGroup; ++gb)
      bm[gb] = row_thread && gb < ng && l16 < nc && pr < R
                   ? s_max_in[gb][l16][pr]
                   : GWT_NEG;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
#pragma unroll
      for (int gb = 0; gb < kGroup; ++gb)
        bm[gb] = fmaxf(bm[gb], __shfl_xor_sync(0xffffffffu, bm[gb], o));
#pragma unroll
    for (int gb = 0; gb < kGroup; ++gb) {
      if (gb >= ng || !row_thread) break;  // whole warps leave together
      const float m_new = fmaxf(m_run, bm[gb]);
      float4 v4 = *reinterpret_cast<const float4*>(&s_p[gb][pr][4 * l16]);
      float p[4] = {expf(v4.x - m_new), expf(v4.y - m_new),
                    expf(v4.z - m_new), expf(v4.w - m_new)};
      const float sum = sum16((p[0] + p[1]) + (p[2] + p[3]));
      if (pr < R) {
        if (W8A8) {
          uint32_t pk = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pk |= (uint32_t)(int)rintf(p[e] * 127.0f) << (8 * e);
          *reinterpret_cast<uint32_t*>(&s_pq[gb][pr][4 * l16]) = pk;
        } else {
          v4 = make_float4(__bfloat162float(__float2bfloat16(p[0])),
                           __bfloat162float(__float2bfloat16(p[1])),
                           __bfloat162float(__float2bfloat16(p[2])),
                           __bfloat162float(__float2bfloat16(p[3])));
          *reinterpret_cast<float4*>(&s_p[gb][pr][4 * l16]) = v4;
        }
        if (l16 < nc)
          cluster.map_shared_rank(&s_l_in[gb][rank][pr], l16)[0] = sum;
        if (l16 == 0) s_corr[gb][pr] = expf(m_run - m_new);
      }
      m_run = m_new;
    }
    __syncthreads();

    // ---- 3. P.V of every slice, to the owners of its (row, dim) pairs
    if (tid < R * D4) {
      const int r = tid / D4, dq = tid % D4;
      for (int gb = 0; gb < ng; ++gb) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        if (live((b0 + gb) * blk + rank * kSlice)) {
          if (W8A8) {
            int a[4] = {0, 0, 0, 0};
#pragma unroll 4
            for (int j = 0; j < kSlice; j += 4) {
              const uint32_t w0 =
                  *reinterpret_cast<const uint32_t*>(&s_v[gb][j][4 * dq]);
              const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
                  &s_v[gb][j + 1][4 * dq]);
              const uint32_t w2 = *reinterpret_cast<const uint32_t*>(
                  &s_v[gb][j + 2][4 * dq]);
              const uint32_t w3 = *reinterpret_cast<const uint32_t*>(
                  &s_v[gb][j + 3][4 * dq]);
              const int pp = *reinterpret_cast<const int*>(&s_pq[gb][r][j]);
              // 4 slots x 4 dims -> 4 dims x 4 slots
              const uint32_t t01 = __byte_perm(w0, w1, 0x5140);
              const uint32_t t23 = __byte_perm(w2, w3, 0x5140);
              const uint32_t u01 = __byte_perm(w0, w1, 0x7362);
              const uint32_t u23 = __byte_perm(w2, w3, 0x7362);
              a[0] = __dp4a(pp, (int)__byte_perm(t01, t23, 0x5410), a[0]);
              a[1] = __dp4a(pp, (int)__byte_perm(t01, t23, 0x7632), a[1]);
              a[2] = __dp4a(pp, (int)__byte_perm(u01, u23, 0x5410), a[2]);
              a[3] = __dp4a(pp, (int)__byte_perm(u01, u23, 0x7632), a[3]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) pv[e] = (float)a[e];
          } else {
#pragma unroll 8
            for (int j = 0; j < kSlice; ++j) {
              float f[4];
              i8x4_f32(
                  *reinterpret_cast<const uint32_t*>(&s_v[gb][j][4 * dq]), f);
              const float pj = s_p[gb][r][j];
#pragma unroll
              for (int e = 0; e < 4; ++e) pv[e] = fmaf(pj, f[e], pv[e]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pair = r * D + 4 * dq + e, dst = pair / per;
          cluster.map_shared_rank(&s_pv_in[gb][0], dst)
              [rank * per + pair - dst * per] = pv[e];
        }
      }
    }
    cluster.sync();

    // ---- 4. the owned pairs: the cluster's partials in rank order
    for (int gb = 0; gb < ng; ++gb) {
      if (owner) {
        float part[kMaxCluster];
#pragma unroll
        for (int k = 0; k < kMaxCluster; ++k)
          part[k] = k < nc ? s_pv_in[gb][k * per + tid] : 0.f;
        float tot = part[0];
#pragma unroll
        for (int k = 1; k < kMaxCluster; ++k)
          if (k < nc) tot += part[k];
        acc = acc * s_corr[gb][o_r] + (W8A8 ? tot * (1.0f / 127.0f) : tot);
      }
      if (tid < R) {
        float part[kMaxCluster];
#pragma unroll
        for (int k = 0; k < kMaxCluster; ++k)
          part[k] = k < nc ? s_l_in[gb][k][tid] : 0.f;
        float tot = part[0];
#pragma unroll
        for (int k = 1; k < kMaxCluster; ++k)
          if (k < nc) tot += part[k];
        s_l[tid] = s_l[tid] * s_corr[gb][tid] + tot;
      }
    }
  }
  __syncthreads();
  if (owner)
    out[(size_t)(g * R + o_r) * S + h * D + own % D] =
        acc / fmaxf(s_l[o_r], 1e-30f) * v_scale;
}

template <int D>
int launch(bool w8a8, const void* q, const void* kq, const void* ks,
           const void* vq, const void* vs, const void* lo, void* out,
           int layer, int n_groups, int T, int S, int n_head, int R, int blk,
           float scale, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blk / kSlice, n_head, n_groups);
  cfg.blockDim = dim3(kT12);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blk / kSlice;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto* qb = (const __nv_bfloat16*)q;
  const auto* ksb = (const __nv_bfloat16*)ks;
  const cudaError_t e =
      w8a8 ? cudaLaunchKernelEx(&cfg, xattn_packed_kernel<D, true>, qb,
                                (const int8_t*)kq, ksb, (const int8_t*)vq,
                                (const float*)vs, (const int*)lo, (float*)out,
                                layer, n_groups, T, S, R, blk, scale)
           : cudaLaunchKernelEx(&cfg, xattn_packed_kernel<D, false>, qb,
                                (const int8_t*)kq, ksb, (const int8_t*)vq,
                                (const float*)vs, (const int*)lo, (float*)out,
                                layer, n_groups, T, S, R, blk, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace k12

}  // namespace

// K11 (exact mode): head_dim 16, 32 or 64; kv_group <= 8; blk 256 or 512
// dividing T; n_head <= 128.
extern "C" int gwt_xattn_q(const void* q, const void* kq, const void* ks,
                           const void* vq, const void* vs, const void* lo,
                           void* out, int layer, int n_groups, int T, int S,
                           int n_head, int kv_group, int blk, float scale,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int hd = S / n_head;
  if (kv_group < 1 || kv_group > kMaxRows || n_head > kScalePad ||
      (blk != 256 && blk != 512) || T % blk || S % 4)
    return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return launch<64>(q, kq, ks, vq, vs, lo, out, layer, n_groups, T, S,
                      n_head, kv_group, blk, scale, st);
  if (hd == 32)
    return launch<32>(q, kq, ks, vq, vs, lo, out, layer, n_groups, T, S,
                      n_head, kv_group, blk, scale, st);
  if (hd == 16)
    return launch<16>(q, kq, ks, vq, vs, lo, out, layer, n_groups, T, S,
                      n_head, kv_group, blk, scale, st);
  return (int)cudaErrorInvalidValue;
}

// K12: head_dim 16, 32 or 64; kv_group <= 8 with kv_group * n_head <= 128;
// blk 256 or 512 dividing T (a cluster of blk / 64 CTAs per group and head,
// ops/cross_attention.py::cluster_plan); w8a8 0 = exact, 1 = W8A8; k_q and
// v_q 16-byte aligned, k_s 4-byte aligned.
extern "C" int gwt_xattn_packed(const void* q, const void* kq, const void* ks,
                                const void* vq, const void* vs,
                                const void* lo, void* out, int layer,
                                int n_groups, int T, int S, int n_head,
                                int kv_group, int blk, int w8a8, float scale,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int hd = S / n_head;
  if (kv_group < 1 || kv_group > kMaxRows || kv_group * n_head > kScalePad ||
      (blk != 256 && blk != 512) || T % blk || S % n_head ||
      ((uintptr_t)kq & 15) || ((uintptr_t)vq & 15) || ((uintptr_t)ks & 3))
    return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return k12::launch<64>(w8a8, q, kq, ks, vq, vs, lo, out, layer, n_groups,
                           T, S, n_head, kv_group, blk, scale, st);
  if (hd == 32)
    return k12::launch<32>(w8a8, q, kq, ks, vq, vs, lo, out, layer, n_groups,
                           T, S, n_head, kv_group, blk, scale, st);
  if (hd == 16)
    return k12::launch<16>(w8a8, q, kq, ks, vq, vs, lo, out, layer, n_groups,
                           T, S, n_head, kv_group, blk, scale, st);
  return (int)cudaErrorInvalidValue;
}
