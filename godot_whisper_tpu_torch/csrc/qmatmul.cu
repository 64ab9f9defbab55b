// K9/K10: weight-only quantized matmuls, x (M, S) bf16 @ W -> (M, O) f32.
//
// Replaces the TPU kernels of godot_whisper_tpu/ops/qmatmul.py:
//   K9  `_qmm_kernel` (via `_qmm_2d`): int8 W with one f32 scale per output
//       column, in two layouts -- `io` W (S, O) for the x @ W projections,
//       `oi` W (O, S) for the logits against the int8 token embedding;
//   K10 `_q4mm_kernel` (via `_q4mm_2d`): int4 W nibble-packed along S in
//       groups of G rows (byte row r of group g holds row gG + r in its low
//       nibble and gG + G/2 + r in its high one, stored +8), one f32 scale
//       per (group, column) applied to that group's f32 partial product --
//       never a bf16-rounded q * s.
//
// bf16 x int8 (or int4) products are exact in f32, so only the order of the
// f32 sums differs from the plain version.  No dequantized weight is ever
// written to device memory: bytes become floats (or bf16) in registers or
// shared memory right before the multiply, by byte permutes
// (int8_async.cuh).
//
// K9 has three routes on an H100, each with its bound and design.  A call
// moves few bytes, so what it costs is latency: the launch, one memory
// round trip (about 1700 cycles from a kernel's start on the card) and the
// instructions each warp issues in dependent chains; the designs cut the
// round trips and the instructions per warp.
//  - `io`, M <= 16 (the decode step's projections, 96% of K9's launches):
//    bytes, S * O int8 read once (tiny.en: 0.15-0.59 MB, 0.04-0.18 us at
//    3.35 TB/s).  `qmm_io_rows8`: a CTA owns 16 columns, one 16-byte vector
//    of every weight row, and 512 threads (256 above 5 rows) take one row
//    each per pass: at tiny.en 24-96 CTAs instead of 6-24, one pass each.
//    Each thread issues its weight loads and its x values (registers)
//    before the first FMA; rows are templated on their count (dead rows
//    cost nothing).  The sum over a warp's 32 rows is a reduce-scatter by
//    shuffles, then the warps' sums in shared memory in a fixed order.
//    Where a CTA would take more than 512 rows, `ops/qmatmul.py::
//    io_rows_plan` also cuts the contraction axis into at most 8 slices,
//    one cluster of CTAs per column tile: each CTA stores its slice's sums
//    into the shared memory of the CTA that owns each (row, column), and
//    after one cluster barrier the owners add them in slice order.  One
//    launch, bitwise repeatable, no state between calls.
//  - `oi`, M <= 16 (the logits against the int8 embedding): bytes, 19.9
//    MB at tiny.en, ~6 us.  `qmm_oi_mma`: the weight is mma.sync's A
//    operand (16 vocabulary rows x 16 k), the x rows its N = 8 columns
//    (two tiles of 8 above 8 rows).  A lane loads 16 contiguous k of its
//    two weight rows as one 16-byte vector each; the k order inside every
//    64-k block is permuted identically in A and B (the sum does not care)
//    so that those 16 bytes are exactly the lane's A fragments of four
//    k-steps, and its B fragments are 32 contiguous bytes of x, read from
//    padded shared memory without bank conflicts.  One wave of 2 CTAs per
//    SM; each warp strides over the 16-column tiles with six (tile,
//    k-block) loads in flight.
//  - `io`, M > 16 (the 1500-row cross-K/V projections, the prompt pass):
//    operations, 2 M S O (0.44 GFLOP at tiny.en, ~0.45 us at 989 TFLOP/s
//    beside 3.6 MB of bytes, ~1.1 us).  `qmm_io_tc`: 32 x 64 output tiles
//    of 4 warps (mma.sync m16n8k16 bf16, f32 accumulate; 282 CTAs at
//    1500 x 384), a 4-stage cp.async ring of 16-byte copies of the bf16 x
//    tile and the int8 weight tile.  Each warp turns its B fragments from
//    int8 to bf16 in registers, reading 4 columns of a weight row as one
//    word (the warp's columns are permuted so that a lane's four n-tiles
//    are adjacent, and its results leave as float4 stores), one k-step
//    ahead of the mma.sync that use them.  Shapes whose rows are not
//    16-byte aligned take the one-stage `qmm_tc` below.
// K10 (int4, groups of G rows) has two routes, built on K9's designs.  The
// rounding point is the TPU kernel's: a group's f32 partial product over
// the exact integer weights, times the group's f32 column scales, the
// groups added in order (a slice of groups first, then the slices, as the
// TPU kernel adds its weight slabs).
//  - M <= 16 (about 24 calls a decode step at int4): bytes, S * O / 2
//    plus the scales (tiny.en (384, 1536): 0.3 MB, 0.1 us).
//    `q4mm_io_rows`: `qmm_io_rows8`'s 16-column CTAs, one packed byte row
//    (two k of one group, from its two nibbles) per thread and pass, as
//    many threads as the slice has byte rows (128 to 512); nibbles become
//    floats by byte permutes.  A group's byte rows are whole warps: after
//    each pass's reduce-scatter the owner of each (row, column) adds the
//    group's warp sums in order, scales and adds the groups in order (the
//    pass's scales arrive by cp.async beside its weight loads).  Past
//    512 byte rows the axis is cut on group boundaries over a cluster
//    (`ops/qmatmul.py::io4_rows_plan`), merged as K9's.
//  - M > 16 (the 1500-row cross-K/V projections, the prompt pass):
//    operations, as K9's.  `q4mm_io_tc`: `qmm_io_tc`'s 32 x 64 tiles and
//    4-stage cp.async ring over 32 packed byte rows a stage (half a group
//    at G 128, half the weight bytes of K9's stage); a lane's weight word
//    gives the B fragments of two k-steps (low and high nibbles) by a
//    byte permute, a mask and one bf16x2 FMA each; per-group accumulators
//    scaled into the output's at each group's end.  Unaligned shapes take
//    the same tiles through plain loads.
#include <cooperative_groups.h>

#include "int8_async.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace gwt_q8;

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

// Bytes p[0 .. 16) as one vector, zero past n_valid.  vec: p is 16-byte
// aligned and n_valid is either >= 16 or <= 0 (one 16-byte load).
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p,
                                        int n_valid, int vec) {
  if (vec) return n_valid >= 16 ? __ldg(reinterpret_cast<const uint4*>(p))
                                : zero4();
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < n_valid) w[j >> 2] |= (uint32_t)p[j] << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ------------------------------------------- K9 io, decode rows (M <= 16) --
// Threads of a CTA: one weight row each per pass, 512 while the rows of x
// leave registers for it (up to 5), else 256.
__host__ __device__ constexpr int rows_threads(int nr) {
  return nr <= 5 ? 512 : 256;
}
constexpr int kCW = 16;           // output columns per CTA: one 16-byte vector
constexpr int kChunkRows = 8;     // x rows per register chunk
constexpr int kMaxSplit = 8;      // slices: CTAs of a portable cluster

// One reduce-scatter round: lanes l and l ^ (2 * HALF) each keep one half
// of columns 0 .. 2 * HALF of every row (the upper half where that lane bit
// is set) and add the other lane's copy of it.
template <int NR, int HALF>
__device__ __forceinline__ void scatter_half(float (&acc)[NR][16], int lane) {
  const bool up = lane & (2 * HALF);
#pragma unroll
  for (int m = 0; m < NR; ++m)
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const float lo = acc[m][j], hi = acc[m][j + HALF];
      acc[m][j] = (up ? hi : lo) +
                  __shfl_xor_sync(0xffffffffu, up ? lo : hi, 2 * HALF);
    }
}

// Rows m0 .. m0 + NR of x against the CTA's slice [k0, k1) of its 16
// columns: the CTA's f32 sum per (row, column), scaled into out when the
// slice is the whole axis (n_split 1), else stored into the shared memory
// of the cluster rank that adds that (row, column) up: inbox[rank * per +
// i] of the owner of pair (row * 16 + column) = owner * per + i.
template <int NR, int T>
__device__ __forceinline__ void io_rows_chunk(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ out_scale, float* __restrict__ out,
    float* inbox, int S, int O, int m0, int k0, int k1, int n_split,
    int per, int vec, float (*red)[kChunkRows][kCW]) {
  constexpr int kB = 2;  // passes of T rows whose loads fly together
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, col = tile * kCW;
  float acc[NR][16];
#pragma unroll
  for (int m = 0; m < NR; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  for (int kb = k0; kb < k1; kb += T * kB) {
    uint4 wv[kB];
    float xv[kB][NR];
#pragma unroll
    for (int u = 0; u < kB; ++u) {  // passes past k1 (uniform) are skipped
      const int k = kb + u * T + tid;
      if (kb + u * T < k1)
        wv[u] = k < k1 ? load16(w + (size_t)k * O + col, O - col, vec)
                       : zero4();
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int k = kb + u * T + tid;
      if (kb + u * T < k1) {
#pragma unroll
        for (int m = 0; m < NR; ++m)
          xv[u][m] = k < k1 ? to_f32(x[(size_t)(m0 + m) * S + k]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (kb + u * T < k1) {
        const uint32_t wd[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float f[4];
          i8x4_f32(wd[q], f);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int m = 0; m < NR; ++m)
              acc[m][4 * q + e] = fmaf(xv[u][m], f[e], acc[m][4 * q + e]);
        }
      }
    }
  }

  // The warp's 32 lanes share the 16 columns: reduce-scatter 16 -> 8 -> 4
  // -> 2 -> 1 columns a lane, then lanes l and l ^ 1 add (fixed order).
  scatter_half<NR, 8>(acc, lane);
  scatter_half<NR, 4>(acc, lane);
  scatter_half<NR, 2>(acc, lane);
  scatter_half<NR, 1>(acc, lane);
#pragma unroll
  for (int m = 0; m < NR; ++m)
    acc[m][0] += __shfl_xor_sync(0xffffffffu, acc[m][0], 1);
  const int c_lane = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                     ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
  if (!(lane & 1)) {
#pragma unroll
    for (int m = 0; m < NR; ++m) red[warp][m][c_lane] = acc[m][0];
  }
  __syncthreads();
  if (n_split > 1 && m0 == 0) cluster_wait();
  if (tid < NR * kCW) {
    const int m = tid / kCW, c = tid % kCW, gc = col + c;
    float t = red[0][m][c];
#pragma unroll
    for (int v = 1; v < T / 32; ++v) t += red[v][m][c];
    if (n_split == 1) {
      if (gc < O) out[(size_t)(m0 + m) * O + gc] = t * out_scale[gc];
    } else {
      const int pair = (m0 + m) * kCW + c, owner = pair / per;
      cg::this_cluster().map_shared_rank(
          inbox, owner)[blockIdx.y * per + pair - owner * per] = t;
    }
  }
  __syncthreads();  // red is reused by the next chunk
}

// Grid (ceil(O / 16), n_split) in clusters of (1, n_split): NR1 rows in the
// first register chunk and NR2 (0 or 1..8) in the second.  With n_split >
// 1, rank r adds pairs [r * per, r * per + per) of the tile's M x 16 sums
// over the cluster in rank order after one cluster barrier; no CTA reads
// another's shared memory after it, so none waits to exit.
template <int NR1, int NR2>
__global__ void __launch_bounds__(rows_threads(NR1))
    qmm_io_rows8(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ w, const float* __restrict__ s,
                 float* __restrict__ out, int M, int S, int O, int slice,
                 int n_split, int vec) {
  constexpr int T = rows_threads(NR1);
  __shared__ float red[T / 32][kChunkRows][kCW];
  __shared__ float inbox[2 * kChunkRows * kCW + kMaxSplit];
  if (n_split > 1) cluster_arrive_relaxed();
  const int k0 = blockIdx.y * slice, k1 = min(S, k0 + slice);
  const int per = (M * kCW + n_split - 1) / n_split;
  // the scale of the column this thread writes at the end
  const int own = blockIdx.y * per + threadIdx.x;
  const float sc = n_split > 1 && threadIdx.x < per && own < M * kCW &&
                           blockIdx.x * kCW + own % kCW < O
                       ? s[blockIdx.x * kCW + own % kCW]
                       : 0.f;
  io_rows_chunk<NR1, T>(x, w, s, out, inbox, S, O, 0, k0, k1, n_split, per,
                     vec, red);
  if constexpr (NR2 > 0)
    io_rows_chunk<NR2, T>(x, w, s, out, inbox, S, O, kChunkRows, k0, k1,
                       n_split, per, vec, red);
  if (n_split == 1) return;
  cg::this_cluster().sync();
  if (threadIdx.x < per && own < M * kCW) {
    float part[kMaxSplit];
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k)
      part[k] = k < n_split ? inbox[k * per + threadIdx.x] : 0.f;
    float t = part[0];
#pragma unroll
    for (int k = 1; k < kMaxSplit; ++k)
      if (k < n_split) t += part[k];
    const int gc = blockIdx.x * kCW + own % kCW;
    if (gc < O) out[(size_t)(own / kCW) * O + gc] = t * sc;
  }
}

using RowsKernel = void (*)(const __nv_bfloat16*, const uint8_t*,
                            const float*, float*, int, int, int, int, int,
                            int);
const RowsKernel kRowsKernels[17] = {
    nullptr,              qmm_io_rows8<1, 0>, qmm_io_rows8<2, 0>,
    qmm_io_rows8<3, 0>,   qmm_io_rows8<4, 0>, qmm_io_rows8<5, 0>,
    qmm_io_rows8<6, 0>,   qmm_io_rows8<7, 0>, qmm_io_rows8<8, 0>,
    qmm_io_rows8<8, 1>,   qmm_io_rows8<8, 2>, qmm_io_rows8<8, 3>,
    qmm_io_rows8<8, 4>,   qmm_io_rows8<8, 5>, qmm_io_rows8<8, 6>,
    qmm_io_rows8<8, 7>,   qmm_io_rows8<8, 8>};

int launch_io_rows(const __nv_bfloat16* x, const uint8_t* w, const float* s,
                   float* out, int M, int S, int O, int slice, int n_split,
                   int vec, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((O + kCW - 1) / kCW, n_split);
  // kRowsKernels[M] has NR1 = min(M, 8) rows in its first chunk
  cfg.blockDim = dim3(M <= 5 ? rows_threads(5) : rows_threads(8));
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kRowsKernels[M], x, w, s, out, M, S,
                                 O, slice, n_split, vec);
}

// ------------------------------------------- K9 oi, decode rows (M <= 16) --
constexpr int kOiThreads = 256;
constexpr int kOiCtasPerSm = 2;  // the grid: one wave of this many per SM
constexpr int kOiRing = 6;       // (tile, k-block) loads in flight per lane
constexpr int kOiMaxSmem = 200 * 1024;

// x rows (NT * 8, padded with zeros past M) in shared memory, row stride
// ceil(S / 64) * 64 + 8 bf16: a lane's 32-byte B reads of one k-block hit
// 8 distinct 16-byte bank groups per quarter warp.
template <int NT>
__global__ void __launch_bounds__(kOiThreads, kOiCtasPerSm)
    qmm_oi_mma(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ w, const float* __restrict__ s,
               float* __restrict__ out, int M, int S, int O, int vec,
               int xvec) {
  extern __shared__ __align__(16) unsigned char oi_smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(oi_smem);
  const int nkb = (S + 63) / 64, ldx = nkb * 64 + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_tiles = (O + 15) / 16;
  // warp gw takes tiles gw, gw + W, gw + 2W, ... (W warps in the grid)
  const int gw = blockIdx.x * (kOiThreads / 32) + warp;
  const int n_warps = gridDim.x * (kOiThreads / 32);
  const int n_items =
      (gw < n_tiles ? (n_tiles - gw + n_warps - 1) / n_warps : 0) * nkb;

  // item = (tile, k-block): this lane's 16 bytes of weight rows o and o + 8
  auto issue = [&](int item, uint4 (&dst)[2]) {
    const int tile = gw + (item / nkb) * n_warps, kb = item % nkb;
    const int o = tile * 16 + gid, k = kb * 64 + tig * 16;
    dst[0] = o < O ? load16(w + (size_t)o * S + k, S - k, vec) : zero4();
    dst[1] = o + 8 < O ? load16(w + (size_t)(o + 8) * S + k, S - k, vec)
                       : zero4();
  };
  // x into shared memory by 16-byte chunks (cp.async where a chunk is
  // whole and aligned; zeros past M and S)
  const int nch = ldx / 8;
  for (int i = tid; i < NT * 8 * nch; i += kOiThreads) {
    const int m = i / nch, k = (i % nch) * 8;
    uint4* dst = reinterpret_cast<uint4*>(xs + m * ldx + k);
    if (m < M && k + 8 <= S && xvec) {
      cp_async16(dst, x + (size_t)m * S + k, 16);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (m < M)
        for (int e = 0; e < 8 && k + e < S; ++e)
          v[e >> 1] |= (uint32_t)__bfloat16_as_ushort(x[(size_t)m * S + k + e])
                       << (16 * (e & 1));
      *dst = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  cp_async_commit();
  uint4 ring[kOiRing][2];
#pragma unroll
  for (int r = 0; r < kOiRing; ++r)
    if (r < n_items) issue(r, ring[r]);
  cp_async_wait<0>();
  __syncthreads();

  float acc[NT][4];
  float sc0 = 0.f, sc1 = 0.f;
  for (int base = 0; base < n_items; base += kOiRing) {
#pragma unroll
    for (int r = 0; r < kOiRing; ++r) {
      const int item = base + r;
      if (item < n_items) {
        const uint4 a0 = ring[r][0], a1 = ring[r][1];
        if (item + kOiRing < n_items) issue(item + kOiRing, ring[r]);
        const int kb = item % nkb;
        const int o = (gw + (item / nkb) * n_warps) * 16 + gid;
        if (kb == 0) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
          sc0 = o < O ? s[o] : 0.f;
          sc1 = o + 8 < O ? s[o + 8] : 0.f;
        }
        uint32_t bw[NT][8];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4* p = reinterpret_cast<const uint4*>(
              xs + (nt * 8 + gid) * ldx + kb * 64 + tig * 16);
          const uint4 lo = p[0], hi = p[1];
          bw[nt][0] = lo.x; bw[nt][1] = lo.y; bw[nt][2] = lo.z;
          bw[nt][3] = lo.w; bw[nt][4] = hi.x; bw[nt][5] = hi.y;
          bw[nt][6] = hi.z; bw[nt][7] = hi.w;
        }
        const uint32_t wa[4] = {a0.x, a0.y, a0.z, a0.w};
        const uint32_t wb[4] = {a1.x, a1.y, a1.z, a1.w};
        // k-step st takes real k = tig*16 + 4st + {0,1} for the mma's
        // k = 2tig + {0,1} and + {2,3} for 2tig + 8 + {0,1}, in A and B
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          float f0[4], f1[4];
          i8x4_f32(wa[st], f0);
          i8x4_f32(wb[st], f1);
          const uint32_t a[4] = {bf16x2_exact(f0[0], f0[1]),
                                 bf16x2_exact(f1[0], f1[1]),
                                 bf16x2_exact(f0[2], f0[3]),
                                 bf16x2_exact(f1[2], f1[3])};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint32_t b[2] = {bw[nt][2 * st], bw[nt][2 * st + 1]};
            mma_bf16(acc[nt], a, b);
          }
        }
        if (kb == nkb - 1) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = nt * 8 + 2 * tig + e;
              if (m < M) {
                if (o < O) out[(size_t)m * O + o] = acc[nt][e] * sc0;
                if (o + 8 < O)
                  out[(size_t)m * O + o + 8] = acc[nt][2 + e] * sc1;
              }
            }
        }
      }
    }
  }
}

template <int NT>
int launch_oi(const __nv_bfloat16* x, const uint8_t* w, const float* s,
              float* out, int M, int S, int O, int vec, int xvec, size_t smem,
              cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_oi_mma<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  static int n_sm[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !n_sm[dev])
    cudaDeviceGetAttribute(&n_sm[dev], cudaDevAttrMultiProcessorCount, dev);
  const int warps = kOiThreads / 32, tiles = (O + 15) / 16;
  const int grid = min((tiles + warps - 1) / warps,
                       kOiCtasPerSm * (dev < 64 ? n_sm[dev] : 132));
  qmm_oi_mma<NT><<<grid, kOiThreads, smem, st>>>(x, w, s, out, M, S, O, vec,
                                                 xvec);
  return 0;
}

// ------------------------------------------------ K9 io, M > 16 (pipelined) --
constexpr int TBM = 32, TBN = 64, TBK = 64, kStages = 4, kTcThreads = 128;
constexpr int kXS = TBK + 8;   // bf16 per x row in shared memory (144 bytes)
constexpr int kWS = TBN + 16;  // bytes per int8 weight row in shared memory

struct TcStage {
  uint16_t x[TBM][kXS];  // bf16 bits
  uint8_t w[TBK][kWS];
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Needs S % 8 == 0, O % 16 == 0 and 16-byte aligned x and W.  4 warps (2 x
// 2) of 16 rows x 32 columns; warp column j of n-tile ni is tile column wn
// + 4j + ni, so a lane's B fragments of all four n-tiles come from one
// 32-bit word per weight row, and its results leave as float4 stores.
// The next k-step's fragments are read before this one's mma.sync issue
// (the asm statements keep their order), so shared-memory latency overlaps
// the tensor-core work.
__global__ void __launch_bounds__(kTcThreads)
    qmm_io_tc(const __nv_bfloat16* __restrict__ x,
              const uint8_t* __restrict__ w, const float* __restrict__ s,
              float* __restrict__ out, int M, int S, int O) {
  __shared__ __align__(16) TcStage sm[kStages];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 32;
  const int m_base = blockIdx.y * TBM, n_base = blockIdx.x * TBN;
  const int nk = (S + TBK - 1) / TBK;

  auto load_stage = [&](int st, int kt) {
    const int k0 = kt * TBK;
#pragma unroll
    for (int i = tid; i < TBM * (TBK / 8); i += kTcThreads) {
      const int r = i / (TBK / 8), c = i % (TBK / 8);
      const int gm = m_base + r, gk = k0 + c * 8;
      const bool ok = gm < M && gk < S;
      cp_async16(&sm[st].x[r][c * 8], ok ? x + (size_t)gm * S + gk : x,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = tid; i < TBK * (TBN / 16); i += kTcThreads) {
      const int r = i / (TBN / 16), c = i % (TBN / 16);
      const int gk = k0 + r, gn = n_base + c * 16;
      const bool ok = gk < S && gn < O;
      cp_async16(&sm[st].w[r][c * 16], ok ? w + (size_t)gk * O + gn : w,
                 ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  // this lane's output columns n_base + wn + 4 * (2 * tig + h) + ni
  float sc[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n_base + wn + 4 * (2 * tig + h) + ni;
      sc[h][ni] = col < O ? s[col] : 0.f;
    }
  float acc[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nt = kt + kStages - 1;
    if (nt < nk) load_stage(nt % kStages, nt);
    cp_async_commit();
    const TcStage& t = sm[kt % kStages];
    // fragments of k-step kk: A by ldmatrix, B as 4 weight words (rows kk
    // + 2 tig + {0, 1, 8, 9}, columns wn + 4 gid ..) turned into bf16 pairs
    auto frag = [&](int kk, uint32_t (&a)[4], uint32_t (&b)[4][2]) {
      ldmatrix_x4(a, &t.x[wm + (lane & 15)][kk + (lane >> 4) * 8]);
      const uint8_t* wr = &t.w[kk + 2 * tig][wn + 4 * gid];
      float r0[4], r1[4], r8[4], r9[4];
      i8x4_f32(*reinterpret_cast<const uint32_t*>(wr), r0);
      i8x4_f32(*reinterpret_cast<const uint32_t*>(wr + kWS), r1);
      i8x4_f32(*reinterpret_cast<const uint32_t*>(wr + 8 * kWS), r8);
      i8x4_f32(*reinterpret_cast<const uint32_t*>(wr + 9 * kWS), r9);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        b[ni][0] = bf16x2_exact(r0[ni], r1[ni]);
        b[ni][1] = bf16x2_exact(r8[ni], r9[ni]);
      }
    };
    uint32_t a[2][4], b[2][4][2];
    frag(0, a[0], b[0]);
#pragma unroll
    for (int ks = 0; ks < TBK / 16; ++ks) {
      const int cur = ks & 1, nxt = cur ^ 1;
      if (ks + 1 < TBK / 16) frag((ks + 1) * 16, a[nxt], b[nxt]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[ni], a[cur], b[cur][ni]);
    }
  }
  cp_async_wait<0>();
  // for a fixed e the four n-tiles are four adjacent columns
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int gm = m_base + wm + gid + (e >= 2 ? 8 : 0);
    const int gn = n_base + wn + 4 * (2 * tig + (e & 1));
    const float* c = sc[e & 1];
    if (gm < M && gn < O)
      *reinterpret_cast<float4*>(out + (size_t)gm * O + gn) =
          make_float4(acc[0][e] * c[0], acc[1][e] * c[1], acc[2][e] * c[2],
                      acc[3][e] * c[3]);
  }
}

// ------------------------------------------- K10 int4 io, decode rows --
// The eight int4 of a word as exact floats (stored +8): lo[e] from the low
// nibble of byte e, hi[e] from its high nibble; the float with bits
// 0x4B0000nn is 2^23 + nn (one byte permute), minus 2^23 + 8.
__device__ __forceinline__ void u4x8_f32(uint32_t u, float (&lo)[4],
                                         float (&hi)[4]) {
  const uint32_t l = u & 0x0F0F0F0Fu, h = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lo[e] = __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7540 + e)) -
            8388616.f;
    hi[e] = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7540 + e)) -
            8388616.f;
  }
}

// Rows m0 .. m0 + NR of x against the CTA's slice [b0, b1) of packed byte
// rows (whole groups) of its 16 columns.  A pass gives each thread one
// byte row (two k of one group, its x values in registers); a group's
// G / 2 byte rows are whole warps, so after a warp's reduce-scatter the
// owner of each (row, column) adds the group's warp sums in order,
// multiplies by the group's scale and adds the groups in order.  The sum
// over the slice is written into out (n_split 1) or stored into the shared
// memory of the cluster rank that adds that (row, column) up, as K9's.
template <int NR>
__device__ __forceinline__ void q4_rows_chunk(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ s, float* __restrict__ out, float* inbox,
    int S, int O, int m0, int b0, int b1, int group, int n_split, int per,
    int vec, float (*red)[kChunkRows][kCW], float (*s_sc)[kCW]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = blockIdx.x * kCW;
  const int hg = group / 2;                      // byte rows of a group
  const int pass = ((int)blockDim.x / hg) * hg;  // whole groups a pass
  const int wpg = hg / 32;                       // warps of a group
  const bool pair_owner = tid < NR * kCW;
  const int om = tid / kCW, oc = tid % kCW, gc = col + oc;
  auto load = [&](int pb) {
    const int br = pb + tid;
    return tid < pass && br < b1
               ? load16(w + (size_t)br * O + col, O - col, vec)
               : zero4();
  };
  float tot = 0.f;  // the owner's (row, column): scaled groups, in order
  uint4 wv = load(b0);
  for (int pb = b0; pb < b1; pb += pass) {
    const uint4 wn = pb + pass < b1 ? load(pb + pass) : zero4();
    // the scales of this pass's groups at the CTA's columns, in flight
    // with the loads
    const int g0 = pb / hg, ng = min(pass, b1 - pb) / hg;
    if (tid < ng * kCW) {
      const int gi = tid / kCW, c = tid % kCW;
      if (col + c < O)
        cp_async4(&s_sc[gi][c], s + (size_t)(g0 + gi) * O + col + c);
      else
        s_sc[gi][c] = 0.f;
    }
    cp_async_commit();
    const int br = pb + tid;
    const bool act = tid < pass && br < b1;
    const int g = br / hg, kl = g * group + br - g * hg;  // low nibble's k
    float xl[NR], xh[NR];
#pragma unroll
    for (int m = 0; m < NR; ++m) {
      const __nv_bfloat16* xr = x + (size_t)(m0 + m) * S + kl;
      xl[m] = act ? to_f32(xr[0]) : 0.f;
      xh[m] = act ? to_f32(xr[hg]) : 0.f;
    }
    float acc[NR][16];
#pragma unroll
    for (int m = 0; m < NR; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;
    const uint32_t wd[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float lo[4], hi[4];
      u4x8_f32(wd[q], lo, hi);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int m = 0; m < NR; ++m) {
          acc[m][4 * q + e] = fmaf(xl[m], lo[e], acc[m][4 * q + e]);
          acc[m][4 * q + e] = fmaf(xh[m], hi[e], acc[m][4 * q + e]);
        }
    }
    // the warp's 32 byte rows: reduce-scatter as K9's
    scatter_half<NR, 8>(acc, lane);
    scatter_half<NR, 4>(acc, lane);
    scatter_half<NR, 2>(acc, lane);
    scatter_half<NR, 1>(acc, lane);
#pragma unroll
    for (int m = 0; m < NR; ++m)
      acc[m][0] += __shfl_xor_sync(0xffffffffu, acc[m][0], 1);
    const int c_lane = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                       ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
    if (!(lane & 1)) {
#pragma unroll
      for (int m = 0; m < NR; ++m) red[warp][m][c_lane] = acc[m][0];
    }
    cp_async_wait<0>();
    __syncthreads();
    if (pair_owner) {
      for (int i = 0; i < ng; ++i) {
        float t = red[i * wpg][om][oc];
        for (int v = 1; v < wpg; ++v) t += red[i * wpg + v][om][oc];
        tot += t * s_sc[i][oc];
      }
    }
    __syncthreads();  // red and s_sc are reused by the next pass
    wv = wn;
  }
  if (n_split > 1 && m0 == 0) cluster_wait();
  if (!pair_owner) return;
  if (n_split == 1) {
    if (gc < O) out[(size_t)(m0 + om) * O + gc] = tot;
  } else {
    const int pair = (m0 + om) * kCW + oc, owner = pair / per;
    cg::this_cluster().map_shared_rank(
        inbox, owner)[blockIdx.y * per + pair - owner * per] = tot;
  }
}

// Grid (ceil(O / 16), n_split) in clusters of (1, n_split), blockDim.x
// threads (at least 128, at most T; a multiple of 32): NR1 rows in the
// first chunk and NR2 (0 or 1..8) in the second, slices of `slice` byte
// rows (whole groups; ops/qmatmul.py::io4_rows_plan).  With n_split > 1,
// rank r adds pairs [r * per, r * per + per) over the cluster in rank
// order after one cluster barrier.
template <int NR1, int NR2>
__global__ void __launch_bounds__(rows_threads(NR1))
    q4mm_io_rows(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ w, const float* __restrict__ s,
                 float* __restrict__ out, int M, int S, int O, int group,
                 int slice, int n_split, int vec) {
  constexpr int T = rows_threads(NR1);
  __shared__ float red[T / 32][kChunkRows][kCW];
  __shared__ float s_sc[T / 32][kCW];  // a pass's group scales
  __shared__ float inbox[2 * kChunkRows * kCW + kMaxSplit];
  if (n_split > 1) cluster_arrive_relaxed();
  const int b0 = blockIdx.y * slice, b1 = min(S / 2, b0 + slice);
  const int per = (M * kCW + n_split - 1) / n_split;
  q4_rows_chunk<NR1>(x, w, s, out, inbox, S, O, 0, b0, b1, group, n_split,
                     per, vec, red, s_sc);
  if constexpr (NR2 > 0)
    q4_rows_chunk<NR2>(x, w, s, out, inbox, S, O, kChunkRows, b0, b1, group,
                       n_split, per, vec, red, s_sc);
  if (n_split == 1) return;
  cg::this_cluster().sync();
  const int own = blockIdx.y * per + threadIdx.x;
  if (threadIdx.x < per && own < M * kCW) {
    float part[kMaxSplit];
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k)
      part[k] = k < n_split ? inbox[k * per + threadIdx.x] : 0.f;
    float t = part[0];
#pragma unroll
    for (int k = 1; k < kMaxSplit; ++k)
      if (k < n_split) t += part[k];
    const int gc = blockIdx.x * kCW + own % kCW;
    if (gc < O) out[(size_t)(own / kCW) * O + gc] = t;
  }
}

using Rows4Kernel = void (*)(const __nv_bfloat16*, const uint8_t*,
                             const float*, float*, int, int, int, int, int,
                             int, int);
const Rows4Kernel kRows4Kernels[17] = {
    nullptr,              q4mm_io_rows<1, 0>, q4mm_io_rows<2, 0>,
    q4mm_io_rows<3, 0>,   q4mm_io_rows<4, 0>, q4mm_io_rows<5, 0>,
    q4mm_io_rows<6, 0>,   q4mm_io_rows<7, 0>, q4mm_io_rows<8, 0>,
    q4mm_io_rows<8, 1>,   q4mm_io_rows<8, 2>, q4mm_io_rows<8, 3>,
    q4mm_io_rows<8, 4>,   q4mm_io_rows<8, 5>, q4mm_io_rows<8, 6>,
    q4mm_io_rows<8, 7>,   q4mm_io_rows<8, 8>};

int launch_io4_rows(const __nv_bfloat16* x, const uint8_t* w,
                    const float* s, float* out, int M, int S, int O,
                    int group, int slice, int n_split, int vec,
                    cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((O + kCW - 1) / kCW, n_split);
  // enough threads for the slice (one byte row each) and the 128 owners
  const int t = M <= 5 ? rows_threads(5) : rows_threads(8);
  cfg.blockDim = dim3(min(t, max(128, slice)));
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kRows4Kernels[M], x, w, s, out, M, S,
                                 O, group, slice, n_split, vec);
}

// ------------------------------------------------ K10 int4 io, M > 16 --
// qmm_io_tc's tiles and ring over the packed weight: a stage holds 32 byte
// rows of one group (byte rows r0 .. r0 + 32 of group g) and the 64 x
// columns they multiply, gG + r0 + [0, 32) (their low nibbles) then gG +
// G/2 + r0 + [0, 32) (their high nibbles).
constexpr int kBR = 32;  // packed byte rows a stage

struct Tc4Stage {
  uint16_t x[TBM][kXS];  // bf16 bits
  uint8_t w[kBR][kWS];
};

// Two nibbles (bits 0-3 and 16-19 of t, stored +8) as a bf16 pair: the
// bf16 with bits 0x430n is 128 + n exactly, minus 136 by one bf16x2 FMA.
__device__ __forceinline__ uint32_t nib_bf16x2(uint32_t t) {
  const uint32_t v = (t & 0x000F000Fu) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// VEC: x and W 16-byte aligned and O % 16 == 0 (16-byte cp.async, float4
// stores); else the same tiles by plain loads.  4 warps (2 x 2) of 16 rows
// x 32 columns, the column order of qmm_io_tc.  Per stage and 16 byte
// rows, a lane reads one word (4 columns) of 4 weight rows and turns it
// into the B fragments of two k-steps: the low nibbles against x columns
// 16 hs .., the high ones against 32 + 16 hs ..; the next half's words
// are read before this one's mma.sync.  The mma.sync sums go into a
// group's accumulators, which are scaled by the group's f32 scales and
// added into the output's at the group's end (the TPU kernel's rounding
// point: G = 128 is two stages, 8 k-steps).
template <bool VEC>
__global__ void __launch_bounds__(kTcThreads)
    q4mm_io_tc(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ w, const float* __restrict__ s,
               float* __restrict__ out, int M, int S, int O, int group) {
  __shared__ __align__(16) Tc4Stage sm[kStages];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 32;
  const int m_base = blockIdx.y * TBM, n_base = blockIdx.x * TBN;
  const int hg = group / 2, nk = S / 2 / kBR;

  auto load_stage = [&](int st, int kt) {
    const int br0 = kt * kBR, g = br0 / hg;
    const int klo = g * group + br0 - g * hg;
#pragma unroll
    for (int i = tid; i < TBM * 8; i += kTcThreads) {
      const int r = i / 8, c = i % 8, gm = m_base + r;
      const int gk = (c < 4 ? klo : klo + hg) + 8 * (c & 3);
      if (VEC) {
        cp_async16(&sm[st].x[r][8 * c], gm < M ? x + (size_t)gm * S + gk : x,
                   gm < M ? 16 : 0);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (gm < M)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e >> 1] |= (uint32_t)__bfloat16_as_ushort(
                             x[(size_t)gm * S + gk + e]) << (16 * (e & 1));
        *reinterpret_cast<uint4*>(&sm[st].x[r][8 * c]) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
#pragma unroll
    for (int i = tid; i < kBR * (TBN / 16); i += kTcThreads) {
      const int r = i / (TBN / 16), c = i % (TBN / 16), gn = n_base + 16 * c;
      const uint8_t* src = w + (size_t)(br0 + r) * O + gn;
      if (VEC)
        cp_async16(&sm[st].w[r][16 * c], gn < O ? src : w, gn < O ? 16 : 0);
      else
        *reinterpret_cast<uint4*>(&sm[st].w[r][16 * c]) =
            load16(src, O - gn, 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  float acc[4][4], part[4][4], sc[2][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = part[ni][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nt = kt + kStages - 1;
    if (nt < nk) load_stage(nt % kStages, nt);
    cp_async_commit();
    const Tc4Stage& t = sm[kt % kStages];
    const int br0 = kt * kBR, g = br0 / hg, r0 = br0 - g * hg;
    if (r0 == 0) {
      // this lane's columns n_base + wn + 4 * (2 * tig + h) + ni
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = n_base + wn + 4 * (2 * tig + h) + ni;
          sc[h][ni] = col < O ? s[(size_t)g * O + col] : 0.f;
        }
    }
    // words of byte rows 16 hs + 2 tig + {0, 1, 8, 9}, columns wn + 4 gid
    auto words = [&](int hs, uint32_t (&wd)[4]) {
      const uint8_t* wr = &t.w[16 * hs + 2 * tig][wn + 4 * gid];
      wd[0] = *reinterpret_cast<const uint32_t*>(wr);
      wd[1] = *reinterpret_cast<const uint32_t*>(wr + kWS);
      wd[2] = *reinterpret_cast<const uint32_t*>(wr + 8 * kWS);
      wd[3] = *reinterpret_cast<const uint32_t*>(wr + 9 * kWS);
    };
    uint32_t wd[2][4];
    words(0, wd[0]);
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      if (hs == 0) words(1, wd[1]);
      uint32_t alo[4], ahi[4];
      ldmatrix_x4(alo, &t.x[wm + (lane & 15)][16 * hs + (lane >> 4) * 8]);
      ldmatrix_x4(ahi,
                  &t.x[wm + (lane & 15)][32 + 16 * hs + (lane >> 4) * 8]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // byte ni of rows (0, 1) and (8, 9): one column, two k each
        const uint32_t sel = 0x4400u + 0x1111u * ni;
        const uint32_t t01 = __byte_perm(wd[hs][0], wd[hs][1], sel);
        const uint32_t t89 = __byte_perm(wd[hs][2], wd[hs][3], sel);
        const uint32_t blo[2] = {nib_bf16x2(t01), nib_bf16x2(t89)};
        const uint32_t bhi[2] = {nib_bf16x2(t01 >> 4), nib_bf16x2(t89 >> 4)};
        mma_bf16(part[ni], alo, blo);
        mma_bf16(part[ni], ahi, bhi);
      }
    }
    if (r0 + kBR == hg) {
      // the group's f32 partial product times its f32 column scales
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[ni][e] += part[ni][e] * sc[e & 1][ni];
          part[ni][e] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
  // for a fixed e the four n-tiles are four adjacent columns
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int gm = m_base + wm + gid + (e >= 2 ? 8 : 0);
    const int gn = n_base + wn + 4 * (2 * tig + (e & 1));
    if (gm >= M) continue;
    if (VEC) {
      if (gn < O)
        *reinterpret_cast<float4*>(out + (size_t)gm * O + gn) =
            make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
    } else {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        if (gn + ni < O) out[(size_t)gm * O + gn + ni] = acc[ni][e];
    }
  }
}

// ------------------------------------------- one-stage tensor-core tiles --
// K9's oi route above 16 rows, and K9's io route for shapes the pipelined
// kernel does not take (unaligned rows).
constexpr int BM = 64, BN = 64, BK = 32, kPad = 8;
enum { kIO8 = 0, kOI8 = 1, kIO4 = 2 };

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A block computes a 64 x 64 output tile with 4 warps (2 x 2, 32 x 32
// each: 2 m16 x 4 n8 mma tiles).  sA holds x[m][k], sB holds W as [n][k]
// (k contiguous, the layout of mma's column-major B fragment); rows are
// padded by 8 bf16 so fragment loads hit distinct banks.
template <int LAYOUT>
__global__ void __launch_bounds__(kTcThreads)
    qmm_tc(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ s, float* __restrict__ out, int M, int S,
           int O) {
  __shared__ __align__(16) __nv_bfloat16 sA[BM][BK + kPad];
  __shared__ __align__(16) __nv_bfloat16 sB[BN][BK + kPad];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m_base = blockIdx.y * BM, n_base = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kTcThreads) {
      const int r = i / BK, c = i % BK, gm = m_base + r, gk = k0 + c;
      sA[r][c] = (gm < M && gk < S) ? x[(size_t)gm * S + gk] : zero;
    }
    if (LAYOUT == kOI8) {
      for (int i = tid; i < BN * BK; i += kTcThreads) {
        const int n = i / BK, c = i % BK, gn = n_base + n, gk = k0 + c;
        const int v = (gn < O && gk < S) ? (int)(int8_t)w[(size_t)gn * S + gk]
                                         : 0;
        sB[n][c] = __int2bfloat16_rn(v);
      }
    } else {
      // io: rows of W along k, columns along n (coalesced across n)
      for (int i = tid; i < BN * BK; i += kTcThreads) {
        const int kk = i / BN, n = i % BN, gn = n_base + n;
        const int v = (gn < O && k0 + kk < S)
                          ? (int)(int8_t)w[(size_t)(k0 + kk) * O + gn]
                          : 0;
        sB[n][kk] = __int2bfloat16_rn(v);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = wm + mi * 16 + gid;
        a[mi][0] = lds32(&sA[row][kk + tig * 2]);
        a[mi][1] = lds32(&sA[row + 8][kk + tig * 2]);
        a[mi][2] = lds32(&sA[row][kk + tig * 2 + 8]);
        a[mi][3] = lds32(&sA[row + 8][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn + ni * 8 + gid;
        b[ni][0] = lds32(&sB[col][kk + tig * 2]);
        b[ni][1] = lds32(&sB[col][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m_base + wm + mi * 16 + gid + (e >= 2 ? 8 : 0);
        const int col = n_base + wn + ni * 8 + tig * 2 + (e & 1);
        if (row < M && col < O)
          out[(size_t)row * O + col] = acc[mi][ni][e] * s[col];
      }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// layout: 0 = int8 io (W (S, O)), 1 = int8 oi (W (O, S)), 2 = int4 io
// (packed (S/2, O), scales (S/group, O), group % 64 == 0).  x (M, S) bf16,
// s f32, out (M, O) f32.  With M <= 16, int8 io and int4 take n_split <=
// 8 slices of `slice` rows (int8: weight rows, ops/qmatmul.py::
// io_rows_plan; int4: packed byte rows of whole groups, io4_rows_plan), a
// cluster of them per 16 columns.
extern "C" int gwt_qmatmul(const void* x, const void* w, const void* s,
                           void* out, int M, int S, int O, int layout,
                           int group, int slice, int n_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const uint8_t* wb = (const uint8_t*)w;
  const float* sf = (const float*)s;
  float* o = (float*)out;
  if (M <= 0 || S <= 0 || O <= 0 || layout < 0 || layout > 2)
    return (int)cudaErrorInvalidValue;
  if (layout == kIO4 && (group <= 0 || group % 64 || S % group))
    return (int)cudaErrorInvalidValue;
  // the rows kernels' slices: rows (int8) or byte rows (int4) of the axis
  const int axis = layout == kIO4 ? S / 2 : S;
  if (M <= 16 && layout != kOI8 &&
      (slice <= 0 || n_split <= 0 || n_split > kMaxSplit ||
       (long long)slice * (n_split - 1) >= axis ||
       (long long)slice * n_split < axis ||
       (layout == kIO4 && slice % (group / 2))))
    return (int)cudaErrorInvalidValue;
  if (M <= 16) {
    if (layout == kIO8) {
      const int vec = aligned16(w) && O % 16 == 0;
      const int e = launch_io_rows(xb, wb, sf, o, M, S, O, slice, n_split,
                                   vec, st);
      if (e) return e;
    } else if (layout == kIO4) {
      const int vec = aligned16(w) && O % 16 == 0;
      const int e = launch_io4_rows(xb, wb, sf, o, M, S, O, group, slice,
                                    n_split, vec, st);
      if (e) return e;
    } else {
      const int nt = M <= 8 ? 1 : 2;
      const size_t smem =
          (size_t)nt * 8 * (((S + 63) / 64) * 64 + 8) * sizeof(__nv_bfloat16);
      if (smem > kOiMaxSmem) {
        const dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM);
        qmm_tc<kOI8><<<grid, kTcThreads, 0, st>>>(xb, wb, sf, o, M, S, O);
      } else {
        const int vec = aligned16(w) && S % 16 == 0;
        const int xvec = aligned16(x) && S % 8 == 0;
        const int e = nt == 1 ? launch_oi<1>(xb, wb, sf, o, M, S, O, vec,
                                             xvec, smem, st)
                              : launch_oi<2>(xb, wb, sf, o, M, S, O, vec,
                                             xvec, smem, st);
        if (e) return e;
      }
    }
  } else {
    const dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM);
    const dim3 tc_grid((O + TBN - 1) / TBN, (M + TBM - 1) / TBM);
    const bool vec = aligned16(x) && aligned16(w) && O % 16 == 0;
    if (layout == kIO8 && vec && S % 8 == 0)
      qmm_io_tc<<<tc_grid, kTcThreads, 0, st>>>(xb, wb, sf, o, M, S, O);
    else if (layout == kIO8)
      qmm_tc<kIO8><<<grid, kTcThreads, 0, st>>>(xb, wb, sf, o, M, S, O);
    else if (layout == kOI8)
      qmm_tc<kOI8><<<grid, kTcThreads, 0, st>>>(xb, wb, sf, o, M, S, O);
    else if (vec)
      q4mm_io_tc<true><<<tc_grid, kTcThreads, 0, st>>>(xb, wb, sf, o, M, S,
                                                       O, group);
    else
      q4mm_io_tc<false><<<tc_grid, kTcThreads, 0, st>>>(xb, wb, sf, o, M, S,
                                                        O, group);
  }
  return (int)cudaGetLastError();
}
