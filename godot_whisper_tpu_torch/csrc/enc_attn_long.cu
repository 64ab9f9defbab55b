// K13: encoder self-attention for long audio contexts (padded T > 1536),
// head-major (BH, T, D), keys >= t_valid masked.
//
// Replaces the TPU kernel `_flash_kernel` (godot_whisper_tpu/ops/
// attention.py, reached through `_flash_bthd` when the 512-padded T
// exceeds 1536).  Its function, rounding points included:
//   for each 512-key block (the TPU kernel's _BLOCK_K):
//     s     = (q . k^T in f32) * scale, keys >= t_valid set to -1e30
//     m_new = max(m, rowmax(s))
//     p     = exp(s - m_new)                        (f32)
//     l     = l * exp(m - m_new) + sum(p)           (the f32 p)
//     acc   = acc * exp(m - m_new) + round(p) . v   (p rounded to bf16 when
//                                                    the inputs are bf16)
//   out = acc / max(l, 1e-30), in q's dtype.
// bf16 rounding of p is not invariant to the running max, so the 512-key
// blocks are part of the function and kept; the TPU kernel's 256-query
// blocks are not (query rows are independent).  K2 (enc_attn.cu) computes
// `_flash_sp_kernel`'s other function: q rounded after scaling, one row
// max over all keys, p rounded against it and l summed from the rounded p.
//
// Bound on an H100: 4 * BH * T_valid^2 * D operations; BH 6, T 2000, D 64
// is 6.1 GFLOP, 6.2 us at the 989 TFLOP/s bf16 tensor-core rate.  Bytes (q,
// k, v in, out once) are ~1000x below that: bound by operations.
//
// bf16 inputs run on the tensor cores (`wgmma`, enc_attn_tc.cuh, SP =
// false): two warpgroups hold a 512-key block's 64 x 512 f32 scores in
// registers, 256 keys each, and exchange the block's row max through
// shared memory.  f32 inputs keep the CUDA-core kernel below (full f32,
// no TF32).
//
// f32 design: one block of 256 threads per (64-query tile, bh),
// dynamic shared memory holding the tile's q (f32), the scores of one
// 512-key block (64 x 512 f32 = 128 KB) and one 64-key K or V tile.  Per key
// block: (A) each thread computes a 4 x 4 micro-tile of q.k for every
// 64-key tile; (B) each warp runs the softmax update of 8 rows (warp max,
// exp, warp sum) and overwrites the scores with p, rounded as above;
// (C) each thread rescales its 4 x (D/16) accumulators and adds p . v over
// the V tiles.  All arithmetic is f32 FMA on the CUDA cores.  Any T is
// taken: keys past T load as zeros and are masked, query rows past T are
// not written.
#include "common.cuh"
#include "enc_attn_tc.cuh"

namespace {

constexpr int kTQ = 64;          // queries per block
constexpr int kBK = 512;         // keys per softmax block (_BLOCK_K)
constexpr int kTK = 64;          // keys per shared-memory tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTQ / kWarps;  // 8
constexpr int kSStride = kBK + 4;  // score row stride: the two row groups
                                   // of a warp land 16 banks apart

template <int D>
constexpr int smem_floats() {
  return kTQ * kSStride + kTQ * (D + 1) + kTK * (D + 1) + kTQ;
}

template <typename T>
__device__ __forceinline__ float round_p(float p);
template <>
__device__ __forceinline__ float round_p<float>(float p) {
  return p;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    enc_attn_long_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         int n_t, int t_valid, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_s = smem;                          // kTQ x kSStride scores / p
  float* s_q = s_s + kTQ * kSStride;          // kTQ x (D + 1)
  float* s_kv = s_q + kTQ * (D + 1);          // kTK x (D + 1)
  float* s_corr = s_kv + kTK * (D + 1);       // kTQ (then l at the end)
  constexpr int kC = D / 16;                  // output columns per thread

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const size_t base = (size_t)bh * n_t * D;
  const int tid = threadIdx.x;
  const int lane16 = tid & 15;
  const int r0 = (tid >> 4) * 4;              // first of this thread's 4 rows
  const int warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < kTQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    s_q[r * (D + 1) + d] =
        q0 + r < n_t ? to_f32(q[base + (size_t)(q0 + r) * D + d]) : 0.f;
  }
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_run[rr] = GWT_NEG;
    l_run[rr] = 0.f;
  }
  float acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;

  for (int kb0 = 0; kb0 < n_t; kb0 += kBK) {
    // ---- (A) scores of this 512-key block
    for (int sub = 0; sub < kBK / kTK; ++sub) {
      const int key0 = kb0 + sub * kTK;
      __syncthreads();  // s_kv free (previous tile / phase C done)
      for (int i = tid; i < kTK * D; i += kThreads) {
        const int j = i / D, d = i % D, key = key0 + j;
        s_kv[j * (D + 1) + d] =
            key < n_t ? to_f32(k[base + (size_t)key * D + d]) : 0.f;
      }
      __syncthreads();
      float dot[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dot[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = s_q[(r0 + i) * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = s_kv[(lane16 + 16 * j) * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dot[i][j] = fmaf(qv[i], kv[j], dot[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = sub * kTK + lane16 + 16 * j;
        const bool keep = kb0 + col < t_valid;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s_s[(r0 + i) * kSStride + col] = keep ? dot[i][j] * scale : GWT_NEG;
      }
    }
    __syncthreads();

    // ---- (B) online-softmax update, one warp per 8 rows
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int row = warp * kRowsPerWarp + rr;
      float* srow = s_s + row * kSStride;
      float mx = GWT_NEG;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) mx = fmaxf(mx, srow[lane + 32 * i]);
      const float m_new = fmaxf(m_run[rr], warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const float p = expf(srow[lane + 32 * i] - m_new);
        psum += p;
        srow[lane + 32 * i] = round_p<T>(p);
      }
      const float corr = expf(m_run[rr] - m_new);
      l_run[rr] = l_run[rr] * corr + warp_sum(psum);
      m_run[rr] = m_new;
      if (lane == 0) s_corr[row] = corr;
    }
    __syncthreads();

    // ---- (C) acc = acc * corr + p . v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = s_corr[r0 + i];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= corr;
    }
    for (int sub = 0; sub < kBK / kTK; ++sub) {
      const int key0 = kb0 + sub * kTK;
      __syncthreads();  // s_kv free
      for (int i = tid; i < kTK * D; i += kThreads) {
        const int j = i / D, d = i % D, key = key0 + j;
        s_kv[j * (D + 1) + d] =
            key < n_t ? to_f32(v[base + (size_t)key * D + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kTK; ++kk) {
        float pv[4], vv[kC];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] = s_s[(r0 + i) * kSStride + sub * kTK + kk];
#pragma unroll
        for (int c = 0; c < kC; ++c) vv[c] = s_kv[kk * (D + 1) + lane16 + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
    // the next block's phase A starts with a barrier before s_kv is
    // rewritten; its score writes touch s_s, which phase C of this block
    // has finished reading only after that barrier
  }

  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
      s_corr[warp * kRowsPerWarp + rr] = l_run[rr];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= n_t) continue;
    const float l = fmaxf(s_corr[r0 + i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kC; ++c)
      out[base + (size_t)row * D + lane16 + 16 * c] = from_f32<T>(acc[i][c] / l);
  }
}

template <typename T, int D>
int launch_fma(const void* q, const void* k, const void* v, void* out,
               int bh, int n_t, int t_valid, float scale,
               cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      enc_attn_long_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_t + kTQ - 1) / kTQ, bh);
  enc_attn_long_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, n_t, t_valid, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32 or 64.
extern "C" int gwt_enc_attn_long(const void* q, const void* k, const void* v,
                                 void* out, int bh, int n_t, int head_dim,
                                 int t_valid, float scale, int dtype,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && head_dim == 64)
    return launch_fma<float, 64>(q, k, v, out, bh, n_t, t_valid, scale, s);
  if (dtype == 0 && head_dim == 32)
    return launch_fma<float, 32>(q, k, v, out, bh, n_t, t_valid, scale, s);
  if (dtype == 1 && head_dim == 64)
    return gwt_tc::launch<64, false>(q, k, v, out, bh, n_t, t_valid, scale,
                                     s);
  if (dtype == 1 && head_dim == 32)
    return gwt_tc::launch<32, false>(q, k, v, out, bh, n_t, t_valid, scale,
                                     s);
  return (int)cudaErrorInvalidValue;
}
