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
// shared memory right before the multiply.
//
// Bound on an H100, and what the design does about it:
//  - decode (M <= 16 rows: the best_of / beam rows of one step): bytes.  The
//    weight is read once: S * O bytes (int8) or S * O / 2 (int4), e.g. the
//    tiny.en logits `oi` (51864 x 384) = 19.9 MB, ~6 us at 3.35 TB/s.  The
//    "rows" kernels make one pass over the weight with coalesced 4-byte
//    loads, x staged in shared memory, every row of the step scored against
//    each loaded weight byte (8 rows per pass).
//  - the cross-K/V projection (M = 1500 encoder rows) and the prompt pass:
//    operations (2 * M * S * O; 1.77 GFLOP per tiny.en projection).  The
//    "tc" kernel tiles 64 x 64 outputs per block and runs bf16 tensor-core
//    mma.sync m16n8k16 with f32 accumulation; int8 and int4 values are exact
//    in bf16, so the products are the plain version's.  Tiles are converted
//    from int8 / int4 to bf16 while they are staged in shared memory.  One
//    stage, no cp.async pipeline: right first, fast later.
#include "common.cuh"

namespace {

// ------------------------------------------------------ decode-shaped rows --
constexpr int kRT = 8;         // x rows per pass over the weight
constexpr int kThreads = 256;
constexpr int kKC = 256;       // x columns staged per chunk (>= the int4 G)
constexpr int kU = 8;          // weight words a thread has in flight
constexpr int kNC = 4;         // oi: output columns per warp

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

// io layout, int8 (Q4 false) or int4 (Q4 true).  A block owns 64 output
// columns: 16 column quads x 16 slices of the contraction axis; the slices'
// sums meet in shared memory at the end.  Each thread issues kU weight
// loads before it uses any of them, so a pass costs a few memory latencies
// rather than one per row.
template <bool Q4>
__global__ void __launch_bounds__(kThreads)
    qmm_io_rows(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ w, const float* __restrict__ s,
                float* __restrict__ out, int M, int S, int O, int group,
                int vec) {
  __shared__ float xs[kRT][kKC];
  __shared__ float red[16][kRT][64];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * 64 + tx * 4;
  const int chunk = Q4 ? group : kKC;

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
      if (!Q4) {
        for (int k = ty; k < kc; k += 16 * kU) {
          uint8_t b[kU][4];
#pragma unroll
          for (int u = 0; u < kU; ++u)
            load4(w + (size_t)(k0 + k + 16 * u) * O + c0,
                  k + 16 * u < kc ? O - c0 : 0, vec, b[u]);
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            // past kc the weights are 0 and x is read at a valid column
            const int kk = min(k + 16 * u, kc - 1);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float wv = (float)(int8_t)b[u][j];
#pragma unroll
              for (int m = 0; m < kRT; ++m)
                acc[m][j] = fmaf(xs[m][kk], wv, acc[m][j]);
            }
          }
        }
      } else {
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
      if (m < mr && col < O)
        out[(size_t)(m0 + m) * O + col] = Q4 ? t : t * s[col];
    }
  }
}

// oi layout, int8: a warp owns kNC output columns (rows of W, contiguous
// along S), lanes on consecutive 4-byte words; all of a chunk's weight
// words are loaded before they are used, x staged once per block serves
// the block's 8 * kNC columns; a warp sum per (x row, column) at the end.
__global__ void __launch_bounds__(kThreads)
    qmm_oi_rows(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ w, const float* __restrict__ s,
                float* __restrict__ out, int M, int S, int O, int vec) {
  constexpr int kPerLane = kKC / 128;  // 4-byte words per lane per chunk
  __shared__ __align__(16) float xs[kRT][kKC];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int o0 = (blockIdx.x * (kThreads / 32) + warp) * kNC;

  for (int m0 = 0; m0 < M; m0 += kRT) {
    const int mr = min(kRT, M - m0);
    float acc[kRT][kNC];
#pragma unroll
    for (int m = 0; m < kRT; ++m)
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[m][c] = 0.f;
    for (int k0 = 0; k0 < S; k0 += kKC) {
      const int kc = min(kKC, S - k0);
      __syncthreads();
      stage_x(x, xs, m0, mr, k0, kc, S);
      __syncthreads();
      uint8_t b[kPerLane][kNC][4];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const int k = lane * 4 + 128 * i;
          load4(w + (size_t)(o0 + c) * S + k0 + k,
                o0 + c < O && k < kc ? kc - k : 0, vec, b[i][c]);
        }
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int k = lane * 4 + 128 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k + j < kc) {
#pragma unroll
            for (int c = 0; c < kNC; ++c) {
              const float wv = (float)(int8_t)b[i][c][j];
#pragma unroll
              for (int m = 0; m < kRT; ++m)
                acc[m][c] = fmaf(xs[m][k + j], wv, acc[m][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kRT; ++m)
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const float t = warp_sum(acc[m][c]);
        if (lane == 0 && o0 + c < O && m < mr)
          out[(size_t)(m0 + m) * O + o0 + c] = t * s[o0 + c];
      }
  }
}

// ---------------------------------------------------------- tensor cores --
constexpr int BM = 64, BN = 64, BK = 32, kPad = 8, kTCThreads = 128;
enum { kIO8 = 0, kOI8 = 1, kIO4 = 2 };

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A block computes a 64 x 64 output tile with 4 warps (2 x 2, 32 x 32
// each: 2 m16 x 4 n8 mma tiles).  sA holds x[m][k], sB holds W as [n][k]
// (k contiguous, the layout of mma's column-major B fragment); rows are
// padded by 8 bf16 so fragment loads hit distinct banks.
template <int LAYOUT>
__global__ void __launch_bounds__(kTCThreads)
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
    for (int i = tid; i < BM * BK; i += kTCThreads) {
      const int r = i / BK, c = i % BK, gm = m_base + r, gk = k0 + c;
      sA[r][c] = (gm < M && gk < S) ? x[(size_t)gm * S + gk] : zero;
    }
    if (LAYOUT == kOI8) {
      for (int i = tid; i < BN * BK; i += kTCThreads) {
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
      for (int i = tid; i < BN * BK; i += kTCThreads) {
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

}  // namespace

// layout: 0 = int8 io (W (S, O)), 1 = int8 oi (W (O, S)), 2 = int4 io
// (packed (S/2, O), scales (S/group, O), group % 64 == 0, group <= 256).
// x (M, S) bf16, s f32, out (M, O) f32.
extern "C" int gwt_qmatmul(const void* x, const void* w, const void* s,
                           void* out, int M, int S, int O, int layout,
                           int group, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const uint8_t* wb = (const uint8_t*)w;
  const float* sf = (const float*)s;
  float* o = (float*)out;
  if (M <= 0 || S <= 0 || O <= 0 || layout < 0 || layout > 2)
    return (int)cudaErrorInvalidValue;
  if (layout == kIO4 && (group <= 0 || group % 64 || group > kKC || S % group))
    return (int)cudaErrorInvalidValue;
  const int aligned = ((uintptr_t)w & 3) == 0;
  if (M <= 16) {
    if (layout == kOI8) {
      const int vec = aligned && S % 4 == 0;
      const int cols = (kThreads / 32) * kNC;
      qmm_oi_rows<<<(O + cols - 1) / cols, kThreads, 0, st>>>(xb, wb, sf, o,
                                                              M, S, O, vec);
    } else {
      const int vec = aligned && O % 4 == 0;
      const dim3 grid((O + 63) / 64);
      if (layout == kIO8)
        qmm_io_rows<false><<<grid, kThreads, 0, st>>>(xb, wb, sf, o, M, S, O,
                                                      0, vec);
      else
        qmm_io_rows<true><<<grid, kThreads, 0, st>>>(xb, wb, sf, o, M, S, O,
                                                     group, vec);
    }
  } else {
    const dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM);
    if (layout == kIO8)
      qmm_tc<kIO8><<<grid, kTCThreads, 0, st>>>(xb, wb, sf, o, M, S, O, 0);
    else if (layout == kOI8)
      qmm_tc<kOI8><<<grid, kTCThreads, 0, st>>>(xb, wb, sf, o, M, S, O, 0);
    else
      qmm_tc<kIO4><<<grid, kTCThreads, 0, st>>>(xb, wb, sf, o, M, S, O,
                                                group);
  }
  return (int)cudaGetLastError();
}
