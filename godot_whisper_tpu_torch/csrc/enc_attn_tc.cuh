// Encoder self-attention on Hopper's tensor cores (bf16): the shared
// template of K2 (enc_attn.cu, the single-pass function of the TPU kernel
// `_flash_sp_kernel`) and K13 (enc_attn_long.cu, the blockwise function of
// `_flash_kernel`), both in godot_whisper_tpu/ops/attention.py.
//
// Both products run as `wgmma` (warpgroup MMA, sm_90a) with f32
// accumulation: S = Q K^T with Q and K from shared memory, then O += P V
// with P (bf16) in registers and V from shared memory.  The two functions
// differ only in their rounding points:
//   K13 (SP = false), for each 512-key block:
//     s = (q . k^T) * scale, keys >= t_valid at -1e30
//     m_new = max(m, rowmax over the block); p = exp(s - m_new) in f32
//     l = l * exp(m - m_new) + sum(p)        (the f32 p)
//     acc = acc * exp(m - m_new) + bf16(p) . v
//   K2 (SP = true):
//     q' = bf16(q * bf16(scale)); s = q' . k^T, keys >= t_valid at -1e30
//     m = max over all of the row's keys (a first pass over K)
//     p = bf16(exp(s - m)); l = sum of the rounded p; acc = p . v
//   out = acc / max(l, 1e-30), in bf16.
//
// Bound: operations, 4 * BH * T_valid^2 * D (989 TFLOP/s bf16 on an H100),
// about 1000x the bytes.  What holds the kernel back on the card is the
// softmax on the CUDA cores (an accurate expf per score at 8 warps per SM),
// not the tensor cores (PERF.md).  Design: one CTA of two warpgroups per
// (64-query tile, bh).  Keys run in 512-key blocks; warpgroup w owns keys
// [256 w, 256 w + 256) of every block, holds their 64 x 256 f32 scores in
// registers (one m64n256k16 per 16 of D) and its own 64 x D f32
// accumulator.  K13's block row max crosses between the two warpgroups
// through shared memory (its row sums and accumulators stay apart: they
// share the correction factor and are added once at the end); K2 takes the
// row max in a first pass over K and needs no rescaling in the second.
// Each warpgroup streams its K and V tiles (256 keys) through a ring of two
// shared-memory buffers with 16-byte cp.async copies (keys past T are zero
// filled), written in the 128-byte (D 64) or 64-byte (D 32) swizzle that
// the wgmma descriptors name.  Blocks wholly past t_valid are skipped: in
// both functions they add exact zeros.
#pragma once

#include "common.cuh"

namespace gwt_tc {

using bf16 = __nv_bfloat16;

constexpr int kTQ = 64;             // queries per CTA (wgmma M)
constexpr int kWG = 2;              // warpgroups per CTA
constexpr int kThreads = 128 * kWG;
constexpr int kBK = 512;            // keys per block (K13's _BLOCK_K)
constexpr int kWK = kBK / kWG;      // keys per warpgroup per block

template <int D>
struct Layout {
  static constexpr int kRowBytes = D * 2;                 // one bf16 row
  static constexpr int kChunks = D / 8;                   // 16-byte chunks
  static constexpr int kAtom = 8 * kRowBytes;             // 8-row swizzle atom
  static constexpr int kQBytes = kTQ * kRowBytes;
  static constexpr int kTileBytes = kWK * kRowBytes;
  static constexpr int kRedOff = kQBytes + 2 * kWG * kTileBytes;
  static constexpr int kBytes = kRedOff + 2 * kWG * kTQ * 4 + 1024;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kSwizzle = D == 64 ? 1 : 2;
};

// Byte offset of 16-byte chunk c of row r in a swizzled tile: the chunk
// index XOR the address bits above the row (Swizzle<3,4,3> for 128-byte
// rows, Swizzle<2,4,3> for 64-byte rows), as wgmma reads it.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int RB = D * 2;
  return (uint32_t)(r * RB + ((c ^ ((r * RB >> 7) & (RB / 16 - 1))) << 4));
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (>> 4), swizzle mode.  The tile base is aligned to the atom.
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (Layout<D>::kSwizzle << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving register reads or writes across a wgmma
// wait or fence
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D(64 x 256) (+)= A(64 x 16, shared, K-major) . B(16 x 256, shared,
// K-major); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128],
                                                 uint64_t da,
                                                 uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64) += A(64 x 16, registers) . B(16 x 64, shared, N-major:
// transposed).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                 uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D(64 x 32) += A(64 x 16, registers) . B(16 x 32, shared, N-major:
// transposed).
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                 uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  wgmma_m64n64k16_rs(o, a0, a1, a2, a3, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&o)[16], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  wgmma_m64n32k16_rs(o, a0, a1, a2, a3, db);
}

// S (64 x 256 keys, f32) = Q (64 x D) . K^T: both K-major in shared
// memory; each 16-wide slice of D advances the descriptors by 32 bytes
// inside the swizzled rows.
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[128], uint32_t sq,
                                        uint32_t sk) {
  constexpr uint32_t kAtom = Layout<D>::kAtom;
  pin(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n256k16_ss(s, desc<D>(sq + kk * 32, 16, kAtom),
                        desc<D>(sk + kk * 32, 16, kAtom), kk > 0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait0();
  pin(s);
}

// O (64 x D, f32) += P (64 x 256 keys, bf16 in registers) . V (256 x D,
// N-major in shared memory: the transposed B operand).  Each 16-key slice
// is two 8-row swizzle atoms.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2],
                                        uint32_t (&pa)[64], uint32_t sv) {
  constexpr uint32_t kAtom = Layout<D>::kAtom;
  pin(o);
  pin(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWK / 16; ++kk)
    wgmma_pv<D>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                pa[4 * kk + 3], desc<D>(sv + kk * 2 * kAtom, kAtom, kAtom));
  wgmma_commit();
  wgmma_wait0();
  pin(o);
}

// Scale (K13) and mask the scores of one warpgroup's 256 keys starting at
// key0: register e holds row r0 + 8 ((e >> 1) & 1) and key key0 +
// 8 (e >> 2) + 2 quad + (e & 1).
template <bool SP>
__device__ __forceinline__ void mask_scores(float (&s)[128], int key0,
                                            int quad, int t_valid,
                                            float scale) {
  if (key0 + kWK <= t_valid) {  // every key valid (uniform branch)
    if (!SP) {
#pragma unroll
      for (int e = 0; e < 128; ++e) s[e] *= scale;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 128; ++e) {
    const int key = key0 + 8 * (e >> 2) + 2 * quad + (e & 1);
    const float x = SP ? s[e] : s[e] * scale;
    s[e] = key < t_valid ? x : GWT_NEG;
  }
}

// Row max of the scores (rows r0 and r0 + 8): over the thread's registers,
// the quad, then both warpgroups through `red` slot `par`.
__device__ __forceinline__ void row_max(const float (&s)[128], float (&mx)[2],
                                        float* red, int par, int wg, int r0,
                                        int quad) {
  mx[0] = GWT_NEG;
  mx[1] = GWT_NEG;
#pragma unroll
  for (int e = 0; e < 128; ++e)
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  float* rw = red + (par * kWG + wg) * kTQ;
  if (quad == 0) {
    rw[r0] = mx[0];
    rw[r0 + 8] = mx[1];
  }
  __syncthreads();
  const float* ro = red + (par * kWG + (wg ^ 1)) * kTQ;
  mx[0] = fmaxf(mx[0], ro[r0]);
  mx[1] = fmaxf(mx[1], ro[r0 + 8]);
}

// One CTA per (64-query tile, bh); two warpgroups.  SP selects K2's
// single-pass function, otherwise K13's blockwise one (see the top).
template <int D, bool SP>
__global__ void __launch_bounds__(kThreads, 1)
    enc_attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int n_t, int t_valid, float scale) {
  using L = Layout<D>;
  constexpr int CH = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (sbase - raw);
  float* red = reinterpret_cast<float*>(gbase + L::kRedOff);  // [2][kWG][kTQ]

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31, quad = lane & 3;
  const int r0 = ((wtid >> 5) << 4) + (lane >> 2);  // rows r0 and r0 + 8
  const int bh = blockIdx.y, q0 = blockIdx.x * kTQ;
  const size_t base = (size_t)bh * n_t * D;
  const uint32_t sq = sbase;
  const uint32_t sbuf = sbase + L::kQBytes + wg * 2 * L::kTileBytes;

  // ---- Q tile, swizzled; K2 rounds q * bf16(scale) to bf16 here
  const float qscale = __bfloat162float(__float2bfloat16(scale));
  for (int i = tid; i < kTQ * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < n_t)
      val = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * D +
                                            c * 8);
    if (SP) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
    }
    *reinterpret_cast<uint4*>(gbase + swz<D>(r, c)) = val;
  }

  // ---- the tile sequence of this warpgroup: K13 K0 V0 K1 V1 ...; K2 first
  // K0 .. K(nb-1) (the max pass), then K0 V0 K1 V1 ...
  const int nb = (t_valid + kBK - 1) / kBK;
  const int n_tiles = SP ? 3 * nb : 2 * nb;
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int j = SP ? i - nb : i;
      const bf16* src = (SP && i < nb) ? k : ((j & 1) ? v : k);
      const int blk = (SP && i < nb) ? i : (j >> 1);
      const int key0 = blk * kBK + wg * kWK;
      const uint32_t dst = sbuf + (i & 1) * L::kTileBytes;
#pragma unroll 4
      for (int x = wtid; x < kWK * CH; x += 128) {
        const int r = x / CH, c = x % CH, key = key0 + r;
        const bool in = key < n_t;
        cp_async16(dst + swz<D>(r, c),
                   src + base + (size_t)(in ? key : 0) * D + c * 8, in);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  issue(0);
  issue(1);
  fence_async_shared();  // the Q tile
  __syncthreads();

  float s[128], o[D / 2];
  uint32_t pa[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {GWT_NEG, GWT_NEG}, l[2] = {0.f, 0.f};
  int it = 0;  // tiles consumed

  // wait for tile `it` (tile it + 1 may still be in flight)
  auto ready = [&]() {
    cp_async_wait1();
    fence_async_shared();
    wg_barrier(wg);
  };
  // tile `it` consumed by the whole warpgroup: refill its buffer
  auto done = [&]() {
    wg_barrier(wg);
    issue(it + 2);
    ++it;
  };
  const int wkey0 = wg * kWK;  // this warpgroup's keys in a block
  if (SP) {  // pass 1: the row max over all keys
    float run[2] = {GWT_NEG, GWT_NEG};
    for (int b = 0; b < nb; ++b) {
      ready();
      qk_tile<D>(s, sq, sbuf + (it & 1) * L::kTileBytes);
      done();
      mask_scores<SP>(s, b * kBK + wkey0, quad, t_valid, scale);
#pragma unroll
      for (int e = 0; e < 128; ++e)
        run[(e >> 1) & 1] = fmaxf(run[(e >> 1) & 1], s[e]);
    }
#pragma unroll
    for (int e = 0; e < 128; ++e) s[e] = run[(e >> 1) & 1];
    row_max(s, m, red, 0, wg, r0, quad);
  }

  for (int b = 0; b < nb; ++b) {
    ready();
    qk_tile<D>(s, sq, sbuf + (it & 1) * L::kTileBytes);
    done();
    mask_scores<SP>(s, b * kBK + wkey0, quad, t_valid, scale);
    if (!SP) {
      float mx[2];
      row_max(s, mx, red, b & 1, wg, r0, quad);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], mx[h]);
        const float corr = expf(m[h] - m_new);
        l[h] *= corr;
        m[h] = m_new;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          o[4 * c + 2 * h] *= corr;
          o[4 * c + 2 * h + 1] *= corr;
        }
      }
    }
    // p = exp(s - m); K13 sums the f32 p, K2 the bf16-rounded p
#pragma unroll
    for (int e = 0; e < 128; e += 2) {
      const int h = (e >> 1) & 1;
      const float p0 = expf(s[e] - m[h]), p1 = expf(s[e + 1] - m[h]);
      const uint32_t pk = pack_bf16(p0, p1);
      if (SP) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&pk));
        l[h] += f.x + f.y;
      } else {
        l[h] += p0 + p1;
      }
      // A fragment of 16-key slice kk = e / 8: registers (row, keys
      // 16 kk + 2 quad), (row + 8, same), (row, + 8), (row + 8, + 8)
      const int c8 = e >> 2;  // 8-key chunk
      pa[4 * (c8 >> 1) + 2 * (c8 & 1) + h] = pk;
    }
    ready();
    pv_tile<D>(o, pa, sbuf + (it & 1) * L::kTileBytes);
    done();
  }

  // ---- epilogue: add the two warpgroups' row sums and accumulators
  cp_async_wait0();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();  // every tile consumed: the buffers hold the partials
  constexpr int OS = D + 4;  // row stride of the f32 partials
  float* xo = reinterpret_cast<float*>(gbase + L::kQBytes);  // [kWG][64][OS]
  float* xl = xo + kWG * kTQ * OS;                             // [kWG][64]
  float* mo = xo + wg * kTQ * OS;
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(&mo[(r0 + 8 * h) * OS + 8 * c + 2 * quad]) =
          make_float2(o[4 * c + 2 * h], o[4 * c + 2 * h + 1]);
  if (quad == 0) {
    xl[wg * kTQ + r0] = l[0];
    xl[wg * kTQ + r0 + 8] = l[1];
  }
  __syncthreads();
  for (int i = tid; i < kTQ * D / 2; i += kThreads) {
    const int r = i / (D / 2), c = 2 * (i % (D / 2));
    if (q0 + r >= n_t) continue;
    const float den = fmaxf(xl[r] + xl[kTQ + r], 1e-30f);
    const float a = xo[r * OS + c] + xo[(kTQ + r) * OS + c];
    const float bb = xo[r * OS + c + 1] + xo[(kTQ + r) * OS + c + 1];
    *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)(q0 + r) * D +
                                       c) = __floats2bfloat162_rn(a / den,
                                                                  bb / den);
  }
}

template <int D, bool SP>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int n_t, int t_valid, float scale, cudaStream_t stream) {
  constexpr int smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      enc_attn_tc_kernel<D, SP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_t + kTQ - 1) / kTQ, bh);
  enc_attn_tc_kernel<D, SP><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, n_t,
      t_valid, scale);
  return (int)cudaGetLastError();
}

}  // namespace gwt_tc
