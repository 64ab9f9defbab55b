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
// K10 (int4) has its own kernels: `q4mm_rows` (M <= 16; a block owns 64
// columns, 4-byte loads, x staged in shared memory) and `qmm_tc<kIO4>`.
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

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// ------------------------------------------------ K10 int4 io, decode rows --
constexpr int kRT = 8;         // x rows per pass over the weight
constexpr int kThreads = 256;
constexpr int kKC = 256;       // x columns staged per chunk (>= the int4 G)
constexpr int kU = 8;          // weight words a thread has in flight

// x[m0 + m][k0 + k] for m < kRT, k < kKC into xs as f32: a fixed number of
// independent loads per thread (all in flight together), zeros past the mr
// live rows and the kc live columns.
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ x,
                                        float (*xs)[kKC], int m0, int mr,
                                        int k0, int kc, int S) {
#pragma unroll
  for (int it = 0; it < kRT * kKC / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int m = i / kKC, k = i % kKC;
    xs[m][k] = m < mr && k < kc
                   ? to_f32(x[(size_t)(m0 + m) * S + k0 + k]) : 0.f;
  }
}

// Four consecutive bytes at p, zero past n_valid; one 32-bit load when the
// caller knows p is 4-byte aligned (vec).
__device__ __forceinline__ void load4(const uint8_t* __restrict__ p,
                                      int n_valid, int vec, uint8_t b[4]) {
  if (vec && n_valid >= 4) {
    const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = (u >> (8 * j)) & 0xFF;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = j < n_valid ? p[j] : 0;
  }
}

// A block owns 64 output columns: 16 column quads x 16 slices of the
// contraction axis; the slices' sums meet in shared memory at the end.
// Each thread issues kU weight loads before it uses any of them, so a pass
// costs a few memory latencies rather than one per row.
__global__ void __launch_bounds__(kThreads)
    q4mm_rows(const __nv_bfloat16* __restrict__ x,
              const uint8_t* __restrict__ w, const float* __restrict__ s,
              float* __restrict__ out, int M, int S, int O, int group,
              int vec) {
  __shared__ float xs[kRT][kKC];
  __shared__ float red[16][kRT][64];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * 64 + tx * 4;
  const int chunk = group;

  for (int m0 = 0; m0 < M; m0 += kRT) {
    const int mr = min(kRT, M - m0);
    float acc[kRT][4];
#pragma unroll
    for (int m = 0; m < kRT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

    for (int k0 = 0; k0 < S; k0 += chunk) {
      const int kc = min(chunk, S - k0);
      __syncthreads();
      stage_x(x, xs, m0, mr, k0, kc, S);
      __syncthreads();
      // this group's byte rows start at k0 / 2; its f32 partial product
      // is scaled by the group's scales once, then added in
      const int h = group / 2;
      float part[kRT][4];
#pragma unroll
      for (int m = 0; m < kRT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[m][j] = 0.f;
      for (int r = ty; r < h; r += 16 * kU) {
        uint8_t b[kU][4];
#pragma unroll
        for (int u = 0; u < kU; ++u)
          load4(w + (size_t)(k0 / 2 + r + 16 * u) * O + c0,
                r + 16 * u < h ? O - c0 : 0, vec, b[u]);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (r + 16 * u < h) {
            const int rr = r + 16 * u;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float lo = (float)((int)(b[u][j] & 0xF) - 8);
              const float hi = (float)((int)(b[u][j] >> 4) - 8);
#pragma unroll
              for (int m = 0; m < kRT; ++m) {
                part[m][j] = fmaf(xs[m][rr], lo, part[m][j]);
                part[m][j] = fmaf(xs[m][rr + h], hi, part[m][j]);
              }
            }
          }
        }
      }
      const int g = k0 / group;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sc = c0 + j < O ? s[(size_t)g * O + c0 + j] : 0.f;
#pragma unroll
        for (int m = 0; m < kRT; ++m) acc[m][j] += part[m][j] * sc;
      }
    }

#pragma unroll
    for (int m = 0; m < kRT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[ty][m][tx * 4 + j] = acc[m][j];
    __syncthreads();
    for (int i = tid; i < kRT * 64; i += kThreads) {
      const int m = i / 64, c = i % 64, col = blockIdx.x * 64 + c;
      float t = 0.f;
#pragma unroll
      for (int y = 0; y < 16; ++y) t += red[y][m][c];
      if (m < mr && col < O) out[(size_t)(m0 + m) * O + col] = t;
    }
  }
}

// ------------------------------------------- one-stage tensor-core tiles --
// K10's int4 io route, K9's oi route above 16 rows, and K9's io route for
// shapes the pipelined kernel does not take (unaligned rows).
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
           int O, int group) {
  __shared__ __align__(16) __nv_bfloat16 sA[BM][BK + kPad];
  __shared__ __align__(16) __nv_bfloat16 sB[BN][BK + kPad];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m_base = blockIdx.y * BM, n_base = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = part[mi][ni][e] = 0.f;

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
      // io: rows of W along k, columns along n (coalesced across n).  int4:
      // a 32-row tile lies in one half of one group (G % 64 == 0), so it
      // reads one nibble of G/2-aligned byte rows.
      const int g = LAYOUT == kIO4 ? k0 / group : 0;
      const int r = LAYOUT == kIO4 ? k0 - g * group : 0;
      const bool high = LAYOUT == kIO4 && r >= group / 2;
      const size_t brow = LAYOUT == kIO4
                              ? (size_t)g * (group / 2) + (high ? r - group / 2
                                                                : r)
                              : (size_t)k0;
      for (int i = tid; i < BN * BK; i += kTcThreads) {
        const int kk = i / BN, n = i % BN, gn = n_base + n;
        int v = 0;
        if (gn < O && k0 + kk < S) {
          const uint8_t b = w[(brow + kk) * O + gn];
          v = LAYOUT == kIO4 ? (int)(high ? b >> 4 : b & 0xF) - 8
                             : (int)(int8_t)b;
        }
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
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(LAYOUT == kIO4 ? part[mi][ni] : acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();

    if (LAYOUT == kIO4 && (k0 + BK) % group == 0) {
      // the group's f32 partial product times its f32 column scales
      const int g = k0 / group;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n_base + wn + ni * 8 + tig * 2 + e;
          const float sc = col < O ? s[(size_t)g * O + col] : 0.f;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            acc[mi][ni][e] += part[mi][ni][e] * sc;
            acc[mi][ni][e + 2] += part[mi][ni][e + 2] * sc;
            part[mi][ni][e] = part[mi][ni][e + 2] = 0.f;
          }
        }
    }
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
          out[(size_t)row * O + col] =
              LAYOUT == kIO4 ? acc[mi][ni][e] : acc[mi][ni][e] * s[col];
      }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// layout: 0 = int8 io (W (S, O)), 1 = int8 oi (W (O, S)), 2 = int4 io
// (packed (S/2, O), scales (S/group, O), group % 64 == 0, group <= 256).
// x (M, S) bf16, s f32, out (M, O) f32.  int8 io with M <= 16: n_split <= 8
// slices of `slice` rows (ops/qmatmul.py::io_rows_plan), a cluster of them
// per 64 columns.
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
  if (layout == kIO4 && (group <= 0 || group % 64 || group > kKC || S % group))
    return (int)cudaErrorInvalidValue;
  if (M <= 16) {
    if (layout == kIO8) {
      if (slice <= 0 || n_split <= 0 || n_split > kMaxSplit ||
          (long long)slice * (n_split - 1) >= S ||
          (long long)slice * n_split < S)
        return (int)cudaErrorInvalidValue;
      const int vec = aligned16(w) && O % 16 == 0;
      const int e = launch_io_rows(xb, wb, sf, o, M, S, O, slice, n_split,
                                   vec, st);
      if (e) return e;
    } else if (layout == kOI8) {
      const int nt = M <= 8 ? 1 : 2;
      const size_t smem =
          (size_t)nt * 8 * (((S + 63) / 64) * 64 + 8) * sizeof(__nv_bfloat16);
      if (smem > kOiMaxSmem) {
        const dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM);
        qmm_tc<kOI8><<<grid, kTcThreads, 0, st>>>(xb, wb, sf, o, M, S, O, 0);
      } else {
        const int vec = aligned16(w) && S % 16 == 0;
        const int xvec = aligned16(x) && S % 8 == 0;
        const int e = nt == 1 ? launch_oi<1>(xb, wb, sf, o, M, S, O, vec,
                                             xvec, smem, st)
                              : launch_oi<2>(xb, wb, sf, o, M, S, O, vec,
                                             xvec, smem, st);
        if (e) return e;
      }
    } else {
      const int vec = ((uintptr_t)w & 3) == 0 && O % 4 == 0;
      q4mm_rows<<<(O + 63) / 64, kThreads, 0, st>>>(xb, wb, sf, o, M, S, O,
                                                    group, vec);
    }
  } else {
    const dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM);
    if (layout == kIO8 && aligned16(x) && aligned16(w) && S % 8 == 0 &&
        O % 16 == 0)
      qmm_io_tc<<<dim3((O + TBN - 1) / TBN, (M + TBM - 1) / TBM), kTcThreads,
                  0, st>>>(xb, wb, sf, o, M, S, O);
    else if (layout == kIO8)
      qmm_tc<kIO8><<<grid, kTcThreads, 0, st>>>(xb, wb, sf, o, M, S, O, 0);
    else if (layout == kOI8)
      qmm_tc<kOI8><<<grid, kTcThreads, 0, st>>>(xb, wb, sf, o, M, S, O, 0);
    else
      qmm_tc<kIO4><<<grid, kTcThreads, 0, st>>>(xb, wb, sf, o, M, S, O,
                                                group);
  }
  return (int)cudaGetLastError();
}
