// K3/K4: single-query decode attention over a stacked merged-head cache,
// split across the cache axis.
//
// Replaces BOTH TPU kernels of godot_whisper_tpu/ops/decode_attention.py:
// `_decode_attn_kernel` (one K/V row per query row, and its `shared_kv`
// variant) and `_decode_attn_group_packed_kernel` (kv_group query rows --
// the best_of decoders of one stream -- sharing one K/V row).  They compute
// one function, so on Hopper they are one kernel with `kv_group` a template
// argument:
//
//   q (B, S); k, v the full stacked caches (L, B / kv_group, C, S) read at
//   `layer` by pointer offset (never a per-layer copy); slot c of row b is
//   valid iff c < lo[b] or split <= c < hi (hi read from `hi_ptr` on the
//   device when that is not null, so a CUDA graph can replay every step of
//   the token loop); per-head softmax of
//   q . k / sqrt(D) in f32 with f32 p; out (B, S) f32.
//
// Self-attention passes lo = prompt length, split = prompt capacity,
// hi = split + step + 1; cross-attention passes lo = t_valid, split = C,
// hi = 0.  The TPU kernels' segment matrix and 128-lane head padding are
// lane-layout artefacts: here each CTA indexes its head's D columns.
//
// Bound on an H100: bytes.  Each live K/V byte of the group is read once:
// 2 * (live slots) * S * sizeof(T) per group, 2.3 MB for tiny.en's bf16
// cross-attention (1500 valid slots x 384), ~0.7 us at 3.35 TB/s; the math
// is about 10 FLOP per byte at kv_group 5.
//
// Design (decode_split.cuh): grid (B / kv_group, n_head, n_split), 128
// threads.  The wrapper picks n_split and the slice length from the cache
// capacity C and the SM count (never from hi, so the grid is the same at
// every step).  CTA (g, h, i) takes slots [i * slice, (i + 1) * slice) of
// its head, scores all kv_group rows against each K/V row it loads (16-byte
// vector loads), and writes a partial; the pair's last CTA merges the
// partials in split order.  A slice or chunk with no slot any row may
// attend -- past max(hi, max lo), or inside self-attention's gap
// [max lo, split) between the prompt and the prompt capacity -- is never
// loaded.
#include "decode_split.cuh"

namespace {

using dsplit::kChunk;
using dsplit::kThreads;

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lo,
                        float* __restrict__ out, float* __restrict__ ws,
                        int* __restrict__ tickets, int layer, int n_groups,
                        int C, int S, int split, int hi,
                        const int* __restrict__ hi_ptr, float scale,
                        int slice, int n_split) {
  using L = dsplit::Lay<T, D>;
  __shared__ dsplit::Smem<D> sm;
  const int g = blockIdx.x, h = blockIdx.y, i = blockIdx.z, H = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // q does not depend on lo or hi: its loads go out beside theirs
  const int d0 = (lane % L::kLpr) * L::kVec;
  float qv[R][L::kVec];
  dsplit::load_q<T, D, R>(q, g * R, S, h * D + d0, qv);
  if (hi_ptr != nullptr) hi = *hi_ptr;
  int lo_r[R];
  int lo_max = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lo_r[r] = lo[g * R + r];
    lo_max = max(lo_max, lo_r[r]);
  }
  const int a = i * slice, b = min(a + slice, C);
  const size_t pair0 = ((size_t)g * H + h) * n_split;  // first split row
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)n_groups * H * n_split * R * D;

  if (dsplit::live(a, b, lo_max, split, hi)) {
    dsplit::RowState<R, L::kVec> st;
    st.init();
    const size_t base = ((size_t)layer * n_groups + g) * C * S + h * D + d0;
    auto chunk_live = [&](int c0, int ce) {
      return dsplit::live(c0, ce, lo_max, split, hi);
    };
    auto fill = [&](int c0, int ce, long long (&off)[L::kPass],
                    unsigned (&ok)[R]) {
#pragma unroll
      for (int r = 0; r < R; ++r) ok[r] = 0u;
#pragma unroll
      for (int p = 0; p < L::kPass; ++p) {
        const int c = c0 + warp * (kChunk / dsplit::kWarps) + p * L::kSpp
                      + lane / L::kLpr;
        bool any = false;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool o = c < ce && (c < lo_r[r] || (c >= split && c < hi));
          ok[r] |= (unsigned)o << p;
          any = any || o;
        }
        off[p] = any ? (long long)(base + (size_t)c * S) : -1;
      }
    };
    dsplit::run_slice<T, D, R>(a, b, chunk_live, fill, k, v, qv, scale, st,
                               sm);
    dsplit::write_partial<T, D, R>(st, (pair0 + i) * R, ws_acc, ws_ml, sm);
  } else {
    dsplit::write_empty<D>((pair0 + i) * R, R, ws_acc, ws_ml);
  }
  if (!dsplit::last_to_arrive(&tickets[g * H + h], n_split, sm)) return;
  dsplit::merge<D, R>(ws_acc + pair0 * R * D, ws_ml + pair0 * R * 2,
                      dsplit::AllRows{n_split}, out, (size_t)g * R * S, S,
                      h * D, sm, &tickets[g * H + h]);
}

template <typename T, int D, int R>
int launch(const void* q, const void* k, const void* v, const void* lo,
           void* out, void* ws, void* tickets, int layer, int n_groups, int C,
           int S, int n_head, int split, int hi, const void* hi_ptr,
           float scale, int slice, int n_split, cudaStream_t stream) {
  const dim3 grid(n_groups, n_head, n_split);
  decode_split_kernel<T, D, R><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lo, (float*)out,
      (float*)ws, (int*)tickets, layer, n_groups, C, S, split, hi,
      (const int*)hi_ptr, scale, slice, n_split);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_rows(int kv_group, const void* q, const void* k, const void* v,
                const void* lo, void* out, void* ws, void* tickets, int layer,
                int n_groups, int C, int S, int n_head, int split, int hi,
                const void* hi_ptr, float scale, int slice, int n_split,
                cudaStream_t stream) {
#define GWT_ROWS(R)                                                         \
  case R:                                                                   \
    return launch<T, D, R>(q, k, v, lo, out, ws, tickets, layer, n_groups,  \
                           C, S, n_head, split, hi, hi_ptr, scale, slice,   \
                           n_split, stream)
  switch (kv_group) {
    GWT_ROWS(1); GWT_ROWS(2); GWT_ROWS(3); GWT_ROWS(4);
    GWT_ROWS(5); GWT_ROWS(6); GWT_ROWS(7); GWT_ROWS(8);
  }
#undef GWT_ROWS
  return (int)cudaErrorInvalidValue;
}

// K14: grouped-query decode attention for a decoder-only LM
// (models/unimoe.py): one query token a row; H query heads over Hkv K/V
// heads of D = 128; a row's cache (L, B, C, Hkv D) holds slots [0, hi),
// all valid (every row's prompt has one length).  It replaces no TPU
// kernel: the JAX package has no decoder-only model.  The split-cache
// design of K3 / K4 (decode_split.cuh) with the R = H / Hkv query heads
// that read one K/V head as the R rows of a group: CTA (b, j, i) scores
// query heads j R .. j R + R - 1 of row b against slice i of K/V head j,
// so each K/V byte is read once a step, as in the model.  Bound on an
// H100: bytes (2 x live slots x Hkv D x 2 B a row and layer; ~14 FLOP a
// byte at R 7).  The merge loops over R x D outputs (R D > 128 threads).
template <int D, int R>
__device__ __forceinline__ void merge_rows(const float* ws_acc,
                                           const float* ws_ml, int n,
                                           float* __restrict__ out,
                                           dsplit::Smem<D>& sm, int* ticket) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int idx = tid; idx < R * n; idx += kThreads) {
    const int r = idx / n, k = idx % n;
    sm.m[r][k] = __ldcg(ws_ml + 2 * (k * R + r));
    sm.l[r][k] = __ldcg(ws_ml + 2 * (k * R + r) + 1);
  }
  __syncthreads();
  for (int r = warp; r < R; r += dsplit::kWarps) {
    float mt = GWT_NEG;
    for (int k = lane; k < n; k += 32)
      if (sm.l[r][k] > 0.f) mt = fmaxf(mt, sm.m[r][k]);
    mt = warp_max(mt);
    for (int k = lane; k < n; k += 32)
      sm.w[r][k] = sm.l[r][k] > 0.f ? expf(sm.m[r][k] - mt) : 0.f;
  }
  __syncthreads();
  if (tid < R) {
    float lt = 0.f;
    for (int k = 0; k < n; ++k) lt += sm.l[tid][k] * sm.w[tid][k];
    sm.l_tot[tid] = lt;
  }
  __syncthreads();
  for (int t = tid; t < R * D; t += kThreads) {
    const int r = t / D, d = t % D;
    float a = 0.f;
    for (int k = 0; k < n; ++k)
      a = fmaf(sm.w[r][k], __ldcg(ws_acc + (size_t)(k * R + r) * D + d), a);
    out[(size_t)r * D + d] = a / fmaxf(sm.l_tot[r], 1e-30f);
  }
  if (tid == 0) *ticket = 0;
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
    gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ ws, int* __restrict__ tickets,
                      int layer, int B, int C, int Hkv, int hi,
                      const int* __restrict__ hi_ptr, float scale, int slice,
                      int n_split) {
  using L = dsplit::Lay<T, D>;
  __shared__ dsplit::Smem<D> sm;
  const int g = blockIdx.x, h = blockIdx.y, i = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Skv = Hkv * D;
  const size_t q0 = (size_t)g * Hkv * R * D + (size_t)h * R * D;
  const int d0 = (lane % L::kLpr) * L::kVec;
  float qv[R][L::kVec];
  dsplit::load_q<T, D, R>(q + q0, 0, D, d0, qv);
  if (hi_ptr != nullptr) hi = *hi_ptr;
  const int a = i * slice, b = min(a + slice, C);
  const size_t pair0 = ((size_t)g * Hkv + h) * n_split;
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)B * Hkv * n_split * R * D;

  if (dsplit::live(a, b, 0, 0, hi)) {
    dsplit::RowState<R, L::kVec> st;
    st.init();
    const size_t base = ((size_t)layer * B + g) * C * Skv + h * D + d0;
    auto chunk_live = [&](int c0, int ce) {
      return dsplit::live(c0, ce, 0, 0, hi);
    };
    auto fill = [&](int c0, int ce, long long (&off)[L::kPass],
                    unsigned (&ok)[R]) {
      unsigned m = 0u;
#pragma unroll
      for (int p = 0; p < L::kPass; ++p) {
        const int c = c0 + warp * (kChunk / dsplit::kWarps) + p * L::kSpp
                      + lane / L::kLpr;
        const bool o = c < ce && c < hi;
        m |= (unsigned)o << p;
        off[p] = o ? (long long)(base + (size_t)c * Skv) : -1;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) ok[r] = m;
    };
    dsplit::run_slice<T, D, R>(a, b, chunk_live, fill, k, v, qv, scale, st,
                               sm);
    dsplit::write_partial<T, D, R>(st, (pair0 + i) * R, ws_acc, ws_ml, sm);
  } else {
    dsplit::write_empty<D>((pair0 + i) * R, R, ws_acc, ws_ml);
  }
  if (!dsplit::last_to_arrive(&tickets[g * Hkv + h], n_split, sm)) return;
  merge_rows<D, R>(ws_acc + pair0 * R * D, ws_ml + pair0 * R * 2, n_split,
                   out + q0, sm, &tickets[g * Hkv + h]);
}

template <int R>
int launch_gqa(const void* q, const void* k, const void* v, void* out,
               void* ws, void* tickets, int layer, int B, int C, int Hkv,
               int hi, const void* hi_ptr, float scale, int slice,
               int n_split, cudaStream_t stream) {
  const dim3 grid(B, Hkv, n_split);
  gqa_decode_kernel<__nv_bfloat16, 128, R><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (float*)out, (float*)ws, (int*)tickets, layer,
      B, C, Hkv, hi, (const int*)hi_ptr, scale, slice, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// K14.  q (B, Hkv * group * 128) bf16, k / v (L, B, C, Hkv * 128) bf16,
// out (B, Hkv * group * 128) f32; ws: (B * Hkv * n_split * group) * 130
// floats; tickets: B * Hkv ints, 0 on entry and left at 0; slots [0, hi)
// are valid (hi_ptr: null, or one int on the device read in place of hi);
// slice a multiple of 64 with n_split * slice >= C, n_split <= 128;
// group <= 8.
extern "C" int gwt_gqa_decode_attn(const void* q, const void* k,
                                   const void* v, void* out, void* ws,
                                   void* tickets, int layer, int B, int C,
                                   int Hkv, int group, int hi,
                                   const void* hi_ptr, float scale,
                                   int slice, int n_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (group < 1 || group > dsplit::kMaxRows || slice % kChunk
      || n_split < 1 || n_split > dsplit::kMaxSplit
      || (long long)n_split * slice < C)
    return (int)cudaErrorInvalidValue;
#define GWT_GQA(R)                                                          \
  case R:                                                                   \
    return launch_gqa<R>(q, k, v, out, ws, tickets, layer, B, C, Hkv, hi,   \
                         hi_ptr, scale, slice, n_split, s)
  switch (group) {
    GWT_GQA(1); GWT_GQA(2); GWT_GQA(3); GWT_GQA(4);
    GWT_GQA(5); GWT_GQA(6); GWT_GQA(7); GWT_GQA(8);
  }
#undef GWT_GQA
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32 or 64.  kv_group <= 8.
// ws: (n_groups * n_head * n_split * kv_group) * (head_dim + 2) floats;
// tickets: n_groups * n_head ints, 0 on entry and left at 0.  slice: a
// multiple of 64 with n_split * slice >= C and n_split <= 128.  hi_ptr:
// null, or one int on the device that every CTA reads in place of hi.
extern "C" int gwt_decode_attn(const void* q, const void* k, const void* v,
                               const void* lo, void* out, void* ws,
                               void* tickets, int layer, int n_groups, int C,
                               int S, int n_head, int kv_group, int split,
                               int hi, const void* hi_ptr, float scale,
                               int slice, int n_split, int dtype,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int hd = S / n_head;
  if (kv_group < 1 || kv_group > dsplit::kMaxRows || slice % kChunk
      || n_split < 1 || n_split > dsplit::kMaxSplit
      || (long long)n_split * slice < C)
    return (int)cudaErrorInvalidValue;
#define GWT_DEC(T, D)                                                       \
  return launch_rows<T, D>(kv_group, q, k, v, lo, out, ws, tickets, layer,  \
                           n_groups, C, S, n_head, split, hi, hi_ptr,       \
                           scale, slice, n_split, s)
  if (dtype == 0 && hd == 64) GWT_DEC(float, 64);
  if (dtype == 0 && hd == 32) GWT_DEC(float, 32);
  if (dtype == 1 && hd == 64) GWT_DEC(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 32) GWT_DEC(__nv_bfloat16, 32);
#undef GWT_DEC
  return (int)cudaErrorInvalidValue;
}
