// K11/K12: single-query cross-attention over an int8 merged-head cache.
//
// Replaces the TPU kernels of godot_whisper_tpu/ops/cross_attention.py:
//   K11 `_xattn_q_kernel` (exact mode; with `shared_kv` a beam group's rows
//       share one K/V row; the route when kv_group * n_head > 128), softmax
//       blocks of 256 slots;
//   K12 `_xattn_q_group_packed_kernel` (kv_group * n_head <= 128, kv_group 1
//       included), softmax blocks of 512 slots when T % 512 == 0, in exact
//       mode or the default W8A8 mode.
// The TPU kernels' segment matrices, 128-lane head padding and row packing
// are lane-layout artefacts; both compute one function per (query row,
// head) with kv_group, the softmax block and the mode as arguments, and
// one kernel template, `xattn_packed_kernel`, computes it for both.
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
// `xattn_packed_kernel`: a thread-block cluster of blk / 64 CTAs of 256
// threads per (group, head) (8 CTAs for 512-slot blocks, 4 for 256), grid
// (cluster, heads, groups): K12 at tiny.en 48 CTAs for one stream, K11 at
// large-v3 widths and beam 8 80 (one CTA per (group, head) would give 6
// and 20).  Up to 8 rows of a group share each CTA, so nothing depends on
// kv_group * n_head.  CTA r of a cluster takes slots [64 r, 64 r + 64) of
// every softmax block and loads its slices of up to 3 blocks at once by
// 16-byte cp.async (one memory round trip after lo and q); a slice no row
// may attend is not loaded (it contributes exactly 0: p = exp(-1e30 - m)
// with m finite once slot 0 is seen; every slice is loaded when some row
// has lo <= 0).
//   1. scores of the CTA's slots for every row of the group.  W8A8: lanes
//      split a slot's D bytes in 16-byte pieces (dp4a), then a shuffle sum.
//      Exact: mma.sync m16n8k16 (bf16 in, f32 sums), 16 slots of K as A
//      (int8 widened exactly to bf16 in registers) and the group's rows as
//      B (N = 8, rows past kv_group zero); the d order within every k-step
//      is permuted alike in A and B, so a lane's A fragments are D / 4
//      contiguous bytes of a K row and its B fragments D / 4 contiguous
//      bf16 of q, held in registers for the whole call.  Each slice
//      maximum is stored into the shared memory of every CTA of the
//      cluster (distributed shared memory);
//   2. cluster barrier; each CTA has every slice maximum of every block, so
//      each computes the blocks' running maxima, the values the one-CTA
//      kernel has; p, its rounding, the slice's f32 sum of the unrounded p
//      (stored into every CTA);
//   3. P.V of each slice.  W8A8: dp4a on the rounded p and V (a 4 x 4 byte
//      transpose in registers; exact int32).  Exact: mma.sync with 16 dims
//      of V as A (M), the slots as K and the bf16 p as B; `ldmatrix.trans`
//      reads V's int8 bytes as 16-bit pairs, so mma row m of a 16-dim tile
//      holds dim 2m (m < 8) or 2 (m - 8) + 1, and V rows are padded to an
//      odd number of 16-byte units (no bank conflicts).  Each (row, dim)
//      partial is stored into the CTA that owns the pair (CTA r owns 1 /
//      cluster of them);
//   4. cluster barrier; an owner adds the cluster's partials in rank order,
//      block by block: W8A8 the exact integer sum, then one `/ 127` (`*
//      f32(1/127)`), so acc = acc * corr + pv rounds as in the one-CTA
//      kernel; l likewise from the slices' sums.
// Two cluster barriers per group of up to 3 blocks (T <= 1536 at 512-slot
// blocks, T <= 768 at 256), no read of another CTA's memory, so no CTA
// waits before it exits.  Only l, W8A8's P.V across the cluster, and exact
// mode's two contractions change their order of summation.  Results are
// bitwise equal from call to call, and the kernel keeps no state between
// calls (a CUDA graph replays it).
#include <cooperative_groups.h>
#include <limits.h>

#include "int8_async.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace gwt_q8;

constexpr int kMaxRows = 8;     // MAX_DECODERS: rows of a group, mma's N
constexpr int kScalePad = 128;  // k_s / v_s head axis (the TPU lane tile)
constexpr int kMaxCluster = 8;  // CTAs per (group, head)
constexpr int kSlice = 64;      // slots of each softmax block per CTA
constexpr int kGroup = 3;       // softmax blocks a CTA holds at once
constexpr int kThreads = 256;   // threads of a CTA
constexpr int kPbS = kSlice + 8;  // bf16 per row of the rounded p (exact)

// Bytes per V row in shared memory: an odd number of 16-byte units, so the
// 8 rows an ldmatrix phase reads fall on distinct banks.
__host__ __device__ constexpr int v_stride(int d) {
  return d == 16 ? 16 : d + 16;
}

// Sum over the 16 lanes of a half warp.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Four 8 x 8 matrices of 16-bit elements, transposed: lane l addresses row
// l % 8 of matrix l / 8; lane (g, t) = (l / 4, l % 4) gets elements (2t, g)
// and (2t + 1, g) of each.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// N 32-bit words from shared memory at p (aligned to 4 N bytes).
template <int N>
__device__ __forceinline__ void lds_words(const int8_t* p,
                                          uint32_t (&w)[N]) {
  if constexpr (N == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// Grid (blk / kSlice, n_head, G), one cluster of blk / kSlice CTAs per
// (group, head); see the header.  A CTA holds its slices of up to kGroup
// softmax blocks at once; per such group of blocks, two cluster barriers:
// after every CTA has stored its slices' maxima into every CTA's shared
// memory, and after it has stored its P.V and p-sum partials into the
// shared memory of the CTA that owns each (row, dim) pair.  Nothing is read
// from another CTA's shared memory, so no CTA waits before it exits.
template <int D, bool W8A8>
__global__ void __launch_bounds__(kThreads, 2)
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
  constexpr int kVS = v_stride(D);
  constexpr int kWarps = kThreads / 32;
  // W8A8 keeps q in shared memory (to quantize it) and round(127 p) as
  // bytes; exact mode keeps q in registers and p as bf16
  constexpr int kQR = W8A8 ? kMaxRows : 1;
  constexpr int kPqG = W8A8 ? kGroup : 1, kPbG = W8A8 ? 1 : kGroup;
  __shared__ __align__(16) int8_t s_k[kGroup][kSlice][D];
  __shared__ __align__(16) int8_t s_v[kGroup][kSlice][kVS];
  __shared__ uint32_t s_ksw[kGroup][kSlice];  // bf16 pair holding k_s[h]
  __shared__ __align__(16) float s_q[kQR][D];
  __shared__ __align__(16) int s_qi[kQR][D4];
  __shared__ float s_qss[kQR];
  __shared__ __align__(16) float s_p[kGroup][kMaxRows][kSlice];  // scores
  __shared__ __align__(4) uint8_t s_pq[kPqG][kMaxRows][kSlice];
  __shared__ __align__(16) uint16_t s_pb[kPbG][kMaxRows][kPbS];
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
  const int gid = lane >> 2, tig = lane & 3;
  const size_t lg = (size_t)layer * n_groups + g;
  const int8_t* kbase = kq + lg * T * S + (size_t)h * D;
  const int8_t* vbase = vq + lg * T * S + (size_t)h * D;
  const __nv_bfloat16* ksbase = ks + lg * T * kScalePad + (h & ~1);

  // W8A8: q of every row as floats; exact: this lane's B fragments of the
  // score product, D / 4 bf16 of row gid from dim D / 4 * tig
  constexpr int kQv = W8A8 ? (kMaxRows * D + kThreads - 1) / kThreads : 1;
  float qv[kQv];
  uint32_t qf[D / 8];
  if constexpr (W8A8) {
#pragma unroll
    for (int i = 0; i < kQv; ++i) {
      const int idx = tid + i * kThreads, r = idx / D, d = idx % D;
      qv[i] = r < R ? to_f32(q[(size_t)(g * R + r) * S + h * D + d]) : 0.f;
    }
  } else {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        q + (size_t)(g * R + gid) * S + h * D + D4 * tig);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) qf[i] = gid < R ? __ldg(src + i) : 0u;
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
    for (int i = tid; i < kSlice * kCh; i += kThreads) {
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

  if constexpr (W8A8) {
#pragma unroll
    for (int i = 0; i < kQv; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < kMaxRows * D) s_q[idx / D][idx % D] = qv[i];
    }
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {
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

  // half warp (row pr, slots 4 * l16 .. + 4) in the softmax steps; the
  // (row, dim) pairs this CTA owns, one a thread
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
    if constexpr (W8A8) {
      for (int gb = 0; gb < ng; ++gb) {
        const int c0 = (b0 + gb) * blk + rank * kSlice;
        if (!live(c0)) {
          for (int i = tid; i < kMaxRows * kSlice; i += kThreads)
            s_p[gb][i / kSlice][i % kSlice] = GWT_NEG;
          continue;
        }
        for (int j0 = warp * kSpi; j0 < kSlice; j0 += kSpi * kWarps) {
          const int j = j0 + lane / kCh, c = lane % kCh, slot = c0 + j;
          const uint4 kv =
              *reinterpret_cast<const uint4*>(&s_k[gb][j][16 * c]);
          const uint32_t kw = s_ksw[gb][j];
          const float ksv = __uint_as_float((h & 1) ? kw & 0xFFFF0000u
                                                    : kw << 16);
          // all kMaxRows rows unconditionally (rows past R are never
          // stored), so the rows' dependency chains interleave
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
          if (c == 0) {
#pragma unroll
            for (int r = 0; r < kMaxRows; ++r)
              if (r < R)
                s_p[gb][r][j] = slot < s_lo[r]
                                    ? (float)dot[r] * s_qss[r] * ksv
                                    : GWT_NEG;
          }
        }
      }
    } else {
      // a warp's item: 16 slots (mma's M) of one slice against the rows
      for (int it = warp; it < ng * (kSlice / 16); it += kWarps) {
        const int gb = it / (kSlice / 16), j0 = (it % (kSlice / 16)) * 16;
        const int c0 = (b0 + gb) * blk + rank * kSlice;
        if (!live(c0)) {
          for (int i = lane; i < kMaxRows * 16; i += 32)
            s_p[gb][i / 16][j0 + i % 16] = GWT_NEG;
          continue;
        }
        uint32_t k0w[kCh], k8w[kCh];  // slots j0 + gid and j0 + gid + 8
        lds_words<kCh>(&s_k[gb][j0 + gid][D4 * tig], k0w);
        lds_words<kCh>(&s_k[gb][j0 + gid + 8][D4 * tig], k8w);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        // k-step st: mma k 2 tig + {0, 1} is dim D4 tig + 4 st + {0, 1},
        // k 2 tig + 8 + {0, 1} is dim D4 tig + 4 st + {2, 3}, in A and B
#pragma unroll
        for (int st = 0; st < kCh; ++st) {
          float f0[4], f1[4];
          i8x4_f32(k0w[st], f0);
          i8x4_f32(k8w[st], f1);
          const uint32_t a[4] = {bf16x2_exact(f0[0], f0[1]),
                                 bf16x2_exact(f1[0], f1[1]),
                                 bf16x2_exact(f0[2], f0[3]),
                                 bf16x2_exact(f1[2], f1[3])};
          const uint32_t b[2] = {qf[2 * st], qf[2 * st + 1]};
          mma_bf16(c, a, b);
        }
        // c: slots j0 + gid (c[0], c[1]) and + 8 (c[2], c[3]); rows 2 tig
        // and 2 tig + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + gid + (e >= 2 ? 8 : 0), r = 2 * tig + (e & 1);
          if (r < R) {
            const uint32_t kw = s_ksw[gb][j];
            const float ksv = __uint_as_float((h & 1) ? kw & 0xFFFF0000u
                                                      : kw << 16);
            s_p[gb][r][j] = c0 + j < s_lo[r] ? (c[e] * scale) * ksv
                                             : GWT_NEG;
          }
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
      const float4 v4 =
          *reinterpret_cast<const float4*>(&s_p[gb][pr][4 * l16]);
      float p[4] = {expf(v4.x - m_new), expf(v4.y - m_new),
                    expf(v4.z - m_new), expf(v4.w - m_new)};
      const float sum = sum16((p[0] + p[1]) + (p[2] + p[3]));
      if (pr < R) {
        if constexpr (W8A8) {
          uint32_t pk = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pk |= (uint32_t)(int)rintf(p[e] * 127.0f) << (8 * e);
          *reinterpret_cast<uint32_t*>(&s_pq[gb][pr][4 * l16]) = pk;
        } else {
          uint32_t pk[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pk[e] = __bfloat16_as_ushort(__float2bfloat16(p[e]));
          *reinterpret_cast<uint2*>(&s_pb[gb][pr][4 * l16]) =
              make_uint2(pk[0] | pk[1] << 16, pk[2] | pk[3] << 16);
        }
        if (l16 < nc)
          cluster.map_shared_rank(&s_l_in[gb][rank][pr], l16)[0] = sum;
        if (l16 == 0) s_corr[gb][pr] = expf(m_run - m_new);
      } else if constexpr (!W8A8) {
        // rows past R are mma's zero columns
        *reinterpret_cast<uint2*>(&s_pb[gb][pr][4 * l16]) = make_uint2(0, 0);
      }
      m_run = m_new;
    }
    __syncthreads();

    // ---- 3. P.V of every slice, to the owners of its (row, dim) pairs
    if constexpr (W8A8) {
      if (tid < R * D4) {
        const int r = tid / D4, dq = tid % D4;
        for (int gb = 0; gb < ng; ++gb) {
          int a[4] = {0, 0, 0, 0};
          if (live((b0 + gb) * blk + rank * kSlice)) {
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
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pair = r * D + 4 * dq + e, dst = pair / per;
            cluster.map_shared_rank(&s_pv_in[gb][0], dst)
                [rank * per + pair - dst * per] = (float)a[e];
          }
        }
      }
    } else {
      // a warp's item: 16 dims (mma's M) of one slice, the slots as K
      for (int it = warp; it < ng * kCh; it += kWarps) {
        const int gb = it / kCh, d0 = (it % kCh) * 16;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        if (live((b0 + gb) * blk + rank * kSlice)) {
#pragma unroll
          for (int k0 = 0; k0 < kSlice; k0 += 32) {
            // slots k0 + lane: matrix i holds slots k0 + 8 i .. + 8 of
            // dims d0 .. d0 + 16 as 16-bit pairs; lane (gid, tig) gets
            // bytes (2 tig, 2 gid), (2 tig, 2 gid + 1), (2 tig + 1, 2 gid),
            // (2 tig + 1, 2 gid + 1) of each
            uint32_t t[4];
            ldmatrix_x4_trans(t, &s_v[gb][k0 + lane][d0]);
#pragma unroll
            for (int hs = 0; hs < 2; ++hs) {
              const int kb = k0 + 16 * hs;
              float f0[4], f1[4];
              i8x4_f32(t[2 * hs], f0);
              i8x4_f32(t[2 * hs + 1], f1);
              // mma row gid is dim d0 + 2 gid, row gid + 8 dim d0 + 2 gid + 1
              const uint32_t a[4] = {bf16x2_exact(f0[0], f0[2]),
                                     bf16x2_exact(f0[1], f0[3]),
                                     bf16x2_exact(f1[0], f1[2]),
                                     bf16x2_exact(f1[1], f1[3])};
              const uint32_t b[2] = {
                  *reinterpret_cast<const uint32_t*>(
                      &s_pb[gb][gid][kb + 2 * tig]),
                  *reinterpret_cast<const uint32_t*>(
                      &s_pb[gb][gid][kb + 8 + 2 * tig])};
              mma_bf16(c, a, b);
            }
          }
        }
        // c: dims d0 + 2 gid (c[0], c[1]) and d0 + 2 gid + 1 (c[2], c[3]);
        // rows 2 tig and 2 tig + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * tig + (e & 1);
          if (r < R) {
            const int pair = r * D + d0 + 2 * gid + (e >> 1),
                      dst = pair / per;
            cluster.map_shared_rank(&s_pv_in[gb][0], dst)
                [rank * per + pair - dst * per] = c[e];
          }
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
  cfg.blockDim = dim3(kThreads);
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

// The checks both entries share, then the launch for the head size.
int dispatch(bool w8a8, const void* q, const void* kq, const void* ks,
             const void* vq, const void* vs, const void* lo, void* out,
             int layer, int n_groups, int T, int S, int n_head, int kv_group,
             int blk, float scale, cudaStream_t st) {
  if (n_head < 1 || kv_group < 1 || kv_group > kMaxRows ||
      n_head > kScalePad || (blk != 256 && blk != 512) || T % blk ||
      S % n_head || ((uintptr_t)kq & 15) || ((uintptr_t)vq & 15) ||
      ((uintptr_t)ks & 3) || ((uintptr_t)q & 3))
    return (int)cudaErrorInvalidValue;
  const int hd = S / n_head;
  if (hd == 64)
    return launch<64>(w8a8, q, kq, ks, vq, vs, lo, out, layer, n_groups, T,
                      S, n_head, kv_group, blk, scale, st);
  if (hd == 32)
    return launch<32>(w8a8, q, kq, ks, vq, vs, lo, out, layer, n_groups, T,
                      S, n_head, kv_group, blk, scale, st);
  if (hd == 16)
    return launch<16>(w8a8, q, kq, ks, vq, vs, lo, out, layer, n_groups, T,
                      S, n_head, kv_group, blk, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Both entries: head_dim 16, 32 or 64; kv_group <= 8; n_head <= 128; blk
// 256 or 512 dividing T, a cluster of blk / 64 CTAs per (group, head)
// (ops/cross_attention.py::cluster_plan, wide_cluster_plan); k_q and v_q
// 16-byte aligned, k_s and q 4-byte aligned.
// K11: exact mode, any kv_group * n_head (the wide route).
extern "C" int gwt_xattn_q(const void* q, const void* kq, const void* ks,
                           const void* vq, const void* vs, const void* lo,
                           void* out, int layer, int n_groups, int T, int S,
                           int n_head, int kv_group, int blk, float scale,
                           void* stream) {
  return dispatch(false, q, kq, ks, vq, vs, lo, out, layer, n_groups, T, S,
                  n_head, kv_group, blk, scale, (cudaStream_t)stream);
}

// K12: kv_group * n_head <= 128; w8a8 0 = exact, 1 = W8A8.
extern "C" int gwt_xattn_packed(const void* q, const void* kq, const void* ks,
                                const void* vq, const void* vs,
                                const void* lo, void* out, int layer,
                                int n_groups, int T, int S, int n_head,
                                int kv_group, int blk, int w8a8, float scale,
                                void* stream) {
  if (kv_group * n_head > kScalePad) return (int)cudaErrorInvalidValue;
  return dispatch(w8a8 != 0, q, kq, ks, vq, vs, lo, out, layer, n_groups, T,
                  S, n_head, kv_group, blk, scale, (cudaStream_t)stream);
}
