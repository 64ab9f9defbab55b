// K2: encoder self-attention, head-major (BH, T, D), keys >= t_valid masked.
//
// Replaces the TPU kernel `_flash_sp_kernel` (godot_whisper_tpu/ops/
// attention.py, reached through `_flash_sp` / `flash_attention_bh`).  Its
// function is single-pass: q' = q * scale (rounded to bf16 for bf16
// inputs, with the scale rounded first), s = q' k^T in f32 with key columns
// >= t_valid at -1e30, ONE row max m over all keys, p = exp(s - m) (rounded
// to bf16 for bf16 inputs), l = sum of those p, out = (p . v) / max(l,
// 1e-30).  The TPU kernel's extra contraction column and ones block are
// Mosaic workarounds for the mask and the row sum, not part of the
// function.
//
// Bound on an H100: 4 * BH * T^2 * D operations; tiny.en at T = 1536 is
// 3.6 GFLOP per layer, 3.7 us at the 989 TFLOP/s bf16 tensor-core rate.
// Bytes (q, k, v in and o out, 4 * BH * T * D elements) are ~1000x below
// that, so the kernel is bound by operations.
//
// bf16 inputs run on the tensor cores (`wgmma`, enc_attn_tc.cuh, SP =
// true): a first pass over K takes each row's max, a second one computes
// the rounded p, their sum and P . V, so every p is rounded against the
// row's final max as the TPU kernel rounds it.  f32 inputs keep the
// CUDA-core kernel below: full f32 without TF32 (the nano goldens need
// it), one block of 128 threads per (64-query tile, bh); thread t owns
// query t % 64 with its q row and f32 accumulator in registers, and half
// t / 64 of every 64-key tile with its own online softmax (running max m,
// sum l); K and V tiles are staged in shared memory as f32 and read as
// broadcasts; the two halves merge through shared memory at the end.  In
// f32 the online softmax equals the single-pass function up to f32
// rounding.  Any T is handled: keys past T load as zeros and are masked,
// queries past T are not written.
#include "common.cuh"
#include "enc_attn_tc.cuh"

namespace {

constexpr int kTQ = 64;  // queries per block
constexpr int kTK = 64;  // keys per tile
constexpr int kThreads = 2 * kTQ;
constexpr int kHalf = kTK / 2;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    enc_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int n_t,
                    int t_valid, float scale) {
  __shared__ __align__(16) float s_kv[2 * kTK * D];
  float* s_k = s_kv;            // kTK x D
  float* s_v = s_kv + kTK * D;  // kTK x D
  const int bh = blockIdx.y;
  const int qi = threadIdx.x % kTQ;
  const int half = threadIdx.x / kTQ;
  const int row = blockIdx.x * kTQ + qi;
  const size_t base = (size_t)bh * n_t * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row < n_t ? to_f32(q[base + (size_t)row * D + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = GWT_NEG, l = 0.f;

  for (int k0 = 0; k0 < n_t; k0 += kTK) {
    for (int i = threadIdx.x; i < kTK * D; i += kThreads) {
      const int j = i / D, d = i % D, key = k0 + j;
      const bool in = key < n_t;
      s_k[j * D + d] = in ? to_f32(k[base + (size_t)key * D + d]) : 0.f;
      s_v[j * D + d] = in ? to_f32(v[base + (size_t)key * D + d]) : 0.f;
    }
    __syncthreads();

    float s[kHalf];
    float mt = GWT_NEG;
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
      const int j = half * kHalf + jj;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&s_k[j * D + d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      s[jj] = (k0 + j < t_valid) ? dot * scale : GWT_NEG;
      mt = fmaxf(mt, s[jj]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
      const int j = half * kHalf + jj;
      // masked keys contribute exactly 0, as exp(-1e30 - m) does
      const float p = s[jj] > 0.5f * GWT_NEG ? expf(s[jj] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&s_v[j * D + d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  // merge the two key halves of each query (reuses the tiles' memory:
  // kTQ * (D + 1) + 2 * kTQ floats fit in 2 * kTK * D)
  float* s_acc = s_kv;                  // kTQ x (D + 1)
  float* s_ml = s_kv + kTQ * (D + 1);   // kTQ x 2
  if (half == 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) s_acc[qi * (D + 1) + d] = acc[d];
    s_ml[2 * qi] = m;
    s_ml[2 * qi + 1] = l;
  }
  __syncthreads();
  if (half == 0 && row < n_t) {
    const float m1 = s_ml[2 * qi], l1 = s_ml[2 * qi + 1];
    const float mm = fmaxf(m, m1);
    const float a0 = expf(m - mm), a1 = expf(m1 - mm);
    const float inv = 1.f / fmaxf(l * a0 + l1 * a1, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d)
      out[base + (size_t)row * D + d] = from_f32<T>(
          (acc[d] * a0 + s_acc[qi * (D + 1) + d] * a1) * inv);
  }
}

template <typename T, int D>
int launch_fma(const void* q, const void* k, const void* v, void* out,
               int bh, int n_t, int t_valid, float scale,
               cudaStream_t stream) {
  const dim3 grid((n_t + kTQ - 1) / kTQ, bh);
  enc_attn_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, n_t, t_valid, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32 or 64.
extern "C" int gwt_enc_attn(const void* q, const void* k, const void* v,
                            void* out, int bh, int n_t, int head_dim,
                            int t_valid, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && head_dim == 64)
    return launch_fma<float, 64>(q, k, v, out, bh, n_t, t_valid, scale, s);
  if (dtype == 0 && head_dim == 32)
    return launch_fma<float, 32>(q, k, v, out, bh, n_t, t_valid, scale, s);
  if (dtype == 1 && head_dim == 64)
    return gwt_tc::launch<64, true>(q, k, v, out, bh, n_t, t_valid, scale, s);
  if (dtype == 1 && head_dim == 32)
    return gwt_tc::launch<32, true>(q, k, v, out, bh, n_t, t_valid, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 tensor-core kernels (K2 and K13 share
// the layout) for head_dim 32 or 64; chip_smoke.py prints it.
extern "C" int gwt_enc_attn_tc_smem(int head_dim) {
  return head_dim == 64 ? gwt_tc::Layout<64>::kBytes
                        : gwt_tc::Layout<32>::kBytes;
}
