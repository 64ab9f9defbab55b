// K7: beam self-attention over a split prompt / live cache, one softmax
// across both, split across the cache axes.
//
// Replaces the TPU kernel `_split_beam_kernel` of
// godot_whisper_tpu/ops/split_attention.py (reached through
// `split_beam_attention`):
//
//   q (B, S) with B = G * R (G beam groups of R beams);
//   the PROMPT cache kp, vp (L, G, CP, S) is stored once per group (the R
//   beams of a group share their prompt), slot c of beam b valid iff
//   c < lo[b];
//   the LIVE cache kl, vl (L, B, NL, S) holds the autoregressive slots,
//   valid below hi_live, and beam b's slot t lives in row
//   g * R + rowmap[b, t] of its group (the zero-copy beam merge permutes
//   this (B, NL) map instead of moving cache bytes);
//   per-head softmax of q . k / sqrt(D) over both regions in f32 with f32
//   p; out (B, S) f32.
//
// Both caches enter as the full stacked tensors, the layer selected by
// pointer offset.  The TPU kernel's 128-lane packing of R x H heads into one
// score tile and its one-hot row-map matmul are Mosaic workarounds: here a
// CTA indexes its head's D columns and reads the row map directly.
//
// Bound on an H100: bytes.  The group's prompt K/V up to max(lo) once and
// every beam's live K/V up to hi_live: 2 * max(lo) * S + 2 * B * hi_live * S
// elements; at tiny.en beam 5 (S = 384, prompt <= 232 slots, <= 220 live
// slots) under 2 MB per layer, under 1 us at 3.35 TB/s.  The math is a few
// FLOP per byte.
//
// Design (decode_split.cuh): grid (G, n_head, n_p + R * n_l), 128 threads.
// The concatenated range -- prompt slots [0, max lo), then live slots
// [0, hi_live) -- is cut into slices whose length and counts the wrapper
// picks from the capacities CP and NL (never from hi_live).  Splits
// [0, n_p) are prompt slices: a CTA scores all R beams against each prompt
// K/V row it loads, as K3/K4 do.  Split n_p + r * n_l + j is live slice j
// of beam r: its CTA gathers that beam's rows through the row map.  The
// pair's last CTA merges, for each beam, the prompt partials and then that
// beam's live partials, in split order.  Slices past max lo or hi_live are
// never loaded.
#include "decode_split.cuh"

namespace {

using dsplit::kChunk;
using dsplit::kThreads;

// Prompt splits hold every beam; live split n_p + r * n_l + j only beam r:
// beam r's partials are the prompt splits, then its own live splits.
struct SplitRows {
  int n_p, n_l;
  __device__ __forceinline__ int count() const { return n_p + n_l; }
  __device__ __forceinline__ int index(int k, int r) const {
    return k < n_p ? k : n_p + r * n_l + (k - n_p);
  }
};

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
    split_beam_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp, const T* __restrict__ kl,
                      const T* __restrict__ vl, const int* __restrict__ lo,
                      const int* __restrict__ rowmap, float* __restrict__ out,
                      float* __restrict__ ws, int* __restrict__ tickets,
                      int layer, int G, int CP, int NL, int S, int hi_live,
                      float scale, int slice, int n_p, int n_l) {
  using L = dsplit::Lay<T, D>;
  __shared__ dsplit::Smem<D> sm;
  const int g = blockIdx.x, h = blockIdx.y, i = blockIdx.z, H = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = G * R, n_split = n_p + R * n_l;
  const int d0 = (lane % L::kLpr) * L::kVec;
  const size_t pair0 = ((size_t)g * H + h) * n_split;
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)G * H * n_split * R * D;

  if (i < n_p) {
    // ---- a prompt slice: all R beams against each prompt K/V row (q's
    // loads go out beside lo's)
    float qv[R][L::kVec];
    dsplit::load_q<T, D, R>(q, g * R, S, h * D + d0, qv);
    int lo_r[R];
    int lo_max = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      lo_r[r] = lo[g * R + r];
      lo_max = max(lo_max, lo_r[r]);
    }
    lo_max = min(lo_max, CP);
    const int a = i * slice, b = min(a + slice, CP);
    if (a < lo_max) {
      dsplit::RowState<R, L::kVec> st;
      st.init();
      const size_t base = ((size_t)layer * G + g) * CP * S + h * D + d0;
      auto chunk_live = [&](int c0, int) { return c0 < lo_max; };
      auto fill = [&](int c0, int ce, long long (&off)[L::kPass],
                      unsigned (&ok)[R]) {
#pragma unroll
        for (int r = 0; r < R; ++r) ok[r] = 0u;
#pragma unroll
        for (int p = 0; p < L::kPass; ++p) {
          const int c = c0 + warp * (kChunk / dsplit::kWarps)
                        + p * L::kSpp + lane / L::kLpr;
          bool any = false;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const bool o = c < ce && c < lo_r[r];
            ok[r] |= (unsigned)o << p;
            any = any || o;
          }
          off[p] = any ? (long long)(base + (size_t)c * S) : -1;
        }
      };
      dsplit::run_slice<T, D, R>(a, b, chunk_live, fill, kp, vp, qv, scale,
                                 st, sm);
      dsplit::write_partial<T, D, R>(st, (pair0 + i) * R, ws_acc, ws_ml,
                                     sm);
    } else {
      dsplit::write_empty<D>((pair0 + i) * R, R, ws_acc, ws_ml);
    }
  } else {
    // ---- live slice j of beam r0: its rows gathered through the row map
    const int j = i - n_p, r0 = j / n_l;
    const int bq = g * R + r0;
    const int a = (j % n_l) * slice, b = min(a + slice, NL);
    const size_t row = (pair0 + i) * R + r0;
    if (a < hi_live) {
      float qv[1][L::kVec];
      dsplit::load_q<T, D, 1>(q, bq, S, h * D + d0, qv);
      dsplit::RowState<1, L::kVec> st;
      st.init();
      const int* rm = rowmap + (size_t)bq * NL;
      auto chunk_live = [&](int t0, int) { return t0 < hi_live; };
      auto fill = [&](int t0, int te, long long (&off)[L::kPass],
                      unsigned (&ok)[1]) {
        ok[0] = 0u;
#pragma unroll
        for (int p = 0; p < L::kPass; ++p) {
          const int t = t0 + warp * (kChunk / dsplit::kWarps)
                        + p * L::kSpp + lane / L::kLpr;
          const bool o = t < te && t < hi_live;
          ok[0] |= (unsigned)o << p;
          off[p] = o ? (long long)((((size_t)layer * B + g * R + rm[t]) * NL
                                    + t) * S + h * D + d0)
                     : -1;
        }
      };
      dsplit::run_slice<T, D, 1>(a, b, chunk_live, fill, kl, vl, qv, scale,
                                 st, sm);
      dsplit::write_partial<T, D, 1>(st, row, ws_acc, ws_ml, sm);
    } else {
      dsplit::write_empty<D>(row, 1, ws_acc, ws_ml);
    }
  }
  if (!dsplit::last_to_arrive(&tickets[g * H + h], n_split, sm)) return;
  dsplit::merge<D, R>(ws_acc + pair0 * R * D, ws_ml + pair0 * R * 2,
                      SplitRows{n_p, n_l}, out, (size_t)g * R * S, S, h * D,
                      sm, &tickets[g * H + h]);
}

template <typename T, int D, int R>
int launch(const void* q, const void* kp, const void* vp, const void* kl,
           const void* vl, const void* lo, const void* rowmap, void* out,
           void* ws, void* tickets, int layer, int G, int CP, int NL, int S,
           int n_head, int hi_live, float scale, int slice, int n_p, int n_l,
           cudaStream_t stream) {
  const dim3 grid(G, n_head, n_p + R * n_l);
  split_beam_kernel<T, D, R><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const T*)kl, (const T*)vl,
      (const int*)lo, (const int*)rowmap, (float*)out, (float*)ws,
      (int*)tickets, layer, G, CP, NL, S, hi_live, scale, slice, n_p, n_l);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_rows(int R, const void* q, const void* kp, const void* vp,
                const void* kl, const void* vl, const void* lo,
                const void* rowmap, void* out, void* ws, void* tickets,
                int layer, int G, int CP, int NL, int S, int n_head,
                int hi_live, float scale, int slice, int n_p, int n_l,
                cudaStream_t stream) {
#define GWT_ROWS(N)                                                          \
  case N:                                                                    \
    return launch<T, D, N>(q, kp, vp, kl, vl, lo, rowmap, out, ws, tickets,  \
                           layer, G, CP, NL, S, n_head, hi_live, scale,      \
                           slice, n_p, n_l, stream)
  switch (R) {
    GWT_ROWS(1); GWT_ROWS(2); GWT_ROWS(3); GWT_ROWS(4);
    GWT_ROWS(5); GWT_ROWS(6); GWT_ROWS(7); GWT_ROWS(8);
  }
#undef GWT_ROWS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32 or 64.  R (beams per
// group) <= 8.  rowmap values must lie in [0, R).  ws: (G * n_head *
// (n_p + R * n_l) * R) * (head_dim + 2) floats; tickets: G * n_head ints,
// 0 on entry and left at 0.  slice: a multiple of 64 with n_p * slice >= CP,
// n_l * slice >= NL and n_p + R * n_l <= 128.
extern "C" int gwt_split_beam_attn(const void* q, const void* kp,
                                   const void* vp, const void* kl,
                                   const void* vl, const void* lo,
                                   const void* rowmap, void* out, void* ws,
                                   void* tickets, int layer, int G, int CP,
                                   int NL, int S, int n_head, int R,
                                   int hi_live, float scale, int slice,
                                   int n_p, int n_l, int dtype,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int hd = S / n_head;
  if (R < 1 || R > dsplit::kMaxRows || slice % kChunk || n_p < 1 || n_l < 1
      || n_p + R * n_l > dsplit::kMaxSplit || (long long)n_p * slice < CP
      || (long long)n_l * slice < NL)
    return (int)cudaErrorInvalidValue;
#define GWT_SPLIT(T, D)                                                     \
  return launch_rows<T, D>(R, q, kp, vp, kl, vl, lo, rowmap, out, ws,       \
                           tickets, layer, G, CP, NL, S, n_head, hi_live,   \
                           scale, slice, n_p, n_l, s)
  if (dtype == 0 && hd == 64) GWT_SPLIT(float, 64);
  if (dtype == 0 && hd == 32) GWT_SPLIT(float, 32);
  if (dtype == 1 && hd == 64) GWT_SPLIT(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 32) GWT_SPLIT(__nv_bfloat16, 32);
#undef GWT_SPLIT
  return (int)cudaErrorInvalidValue;
}
