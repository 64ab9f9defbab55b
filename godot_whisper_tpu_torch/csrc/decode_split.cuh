// Split-cache decode attention: the parts that K3/K4 (decode_attn.cu) and
// K7 (split_attn.cu) share.
//
// One query token per row attends over a cache of C slots.  On the TPU one
// grid step walks the whole cache of a (group, head) pair; on Hopper that
// fills 6 of 132 SMs at tiny.en.  Here the cache axis is cut into slices
// and each slice is one CTA of 128 threads:
//
//   - the CTA scores every query row it serves (kv_group <= 8 rows that
//     share one K/V row) against each K/V row it loads, so every byte is
//     still read once per group, and runs an online softmax over its slice
//     in chunks of 64 slots (f32 scores, f32 p, masked slots exactly 0);
//   - it writes a partial (m, l, acc[D]) per row to a workspace;
//   - the last CTA of the pair to finish (a __threadfence and an atomic
//     ticket) merges the pair's partials in split order 0..n-1, so results
//     are bitwise the same from run to run, divides by max(l, 1e-30), writes
//     the output and resets the ticket to 0, so the next launch (or a CUDA
//     graph replay) finds it at 0.  One launch per call.
//
// A slice (or a chunk of one) that holds no slot any row may attend is
// never loaded: its CTA writes an empty partial (m = -1e30, l = 0, acc = 0)
// and takes its ticket.  The merge gives partials with l = 0 the weight 0.
//
// Loads: a head's K/V row (D elements of T) is read as 16-byte vectors by
// kLpr = D / kVec lanes.  A chunk is 4 warps x 16 slots; in pass p lane l of
// warp w holds slot w*16 + p*kSpp + l/kLpr and dims (l % kLpr)*kVec.. +kVec.
// All of a chunk's K and V vectors are requested before the first use, so
// a CTA keeps 16 KB (bf16) in flight.  A row's score is the shuffle sum over
// its kLpr lanes; p . V accumulates per lane and is reduced once per slice.
//
// Bound on an H100: bytes.  At most kv_group <= 8 rows per K/V element is
// about 10 FLOP per byte at kv_group 5, under the ~20 FLOP/B ridge of f32 FMA
// on the CUDA cores, so no tensor cores are needed.
#pragma once

#include "common.cuh"

namespace dsplit {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;      // slots per chunk (16 per warp)
constexpr int kMaxRows = 8;     // MAX_DECODERS
constexpr int kMaxSplit = 128;  // most partials one (group, head) merges

template <typename T, int D>
struct Lay {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per vector
  static constexpr int kLpr = D / kVec;             // lanes per K/V row
  static constexpr int kSpp = 32 / kLpr;            // slots per warp pass
  static constexpr int kPass = kChunk / kWarps / kSpp;
  static_assert(kLpr >= 2 && kLpr <= 16 && kPass >= 1, "head dim");
};

template <int D>
struct Smem {
  float red[2][kWarps][kMaxRows];  // chunk maxima, double-buffered
  float red_acc[kWarps * kMaxRows][D];
  float red_l[kWarps * kMaxRows];
  float m[kMaxRows][kMaxSplit];    // merge: a row's partials in split order:
  float l[kMaxRows][kMaxSplit];    // m, l, the weight exp(m - max m) and
  float w[kMaxRows][kMaxSplit];    // l * weight
  float lw[kMaxRows][kMaxSplit];
  float l_tot[kMaxRows];
  int last;
};

// Slots [a, b) hold a slot some row may attend: c < max lo, or
// split <= c < hi.
__device__ __forceinline__ bool live(int a, int b, int lo_max, int split,
                                     int hi) {
  return a < b && (a < lo_max || max(a, split) < min(b, hi));
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

// This lane's share of NR rows' online-softmax state.  m is the same in
// every thread of the CTA; l and acc cover this lane's slots (and, for
// acc, its dims) and are reduced across lanes once per slice.
template <int NR, int V>
struct RowState {
  float m[NR];
  float l[NR];
  float acc[NR][V];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      m[r] = GWT_NEG;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
    }
  }
};

// This lane's query values: row r of q (row stride S), dims d0.. +kVec.
template <typename T, int D, int NR>
__device__ __forceinline__ void load_q(const T* __restrict__ q, int row0,
                                       int S, int col,
                                       float (&qv)[NR][Lay<T, D>::kVec]) {
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int e = 0; e < Lay<T, D>::kVec; ++e)
      qv[r][e] = to_f32(q[(size_t)(row0 + r) * S + col + e]);
}

// This lane's K/V vectors of one chunk and NR rows' masks: ok[r] bit p,
// row r may attend this lane's slot of pass p.
template <typename T, int D, int NR>
struct Chunk {
  uint4 kr[Lay<T, D>::kPass], vr[Lay<T, D>::kPass];
  unsigned ok[NR];
  // off[p]: element offset (into k and v) of this lane's vector in pass p,
  // or -1 when its slot is not loaded (zeros stand in)
  __device__ __forceinline__ void load(
      const T* __restrict__ k, const T* __restrict__ v,
      const long long (&off)[Lay<T, D>::kPass]) {
#pragma unroll
    for (int p = 0; p < Lay<T, D>::kPass; ++p) {
      if (off[p] >= 0) {
        kr[p] = __ldg(reinterpret_cast<const uint4*>(k + off[p]));
        vr[p] = __ldg(reinterpret_cast<const uint4*>(v + off[p]));
      } else {
        kr[p] = make_uint4(0u, 0u, 0u, 0u);
        vr[p] = kr[p];
      }
    }
  }
};

// One chunk of the online softmax.  red: the chunk-maximum buffer of this
// chunk's parity (a chunk writes one buffer and reads it after the
// barrier; the next chunk writes the other, so one barrier per chunk
// suffices).
template <typename T, int D, int NR>
__device__ __forceinline__ void chunk_update(
    const Chunk<T, D, NR>& ch, const float (&qv)[NR][Lay<T, D>::kVec],
    float scale, RowState<NR, Lay<T, D>::kVec>& st, float (*red)[kMaxRows]) {
  using L = Lay<T, D>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const auto& kr = ch.kr;
  const auto& vr = ch.vr;
  const auto& ok = ch.ok;
  float s[NR][L::kPass];
#pragma unroll
  for (int p = 0; p < L::kPass; ++p) {
    float kf[L::kVec];
    unpack(kr[p], kf);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) dot = fmaf(qv[r][e], kf[e], dot);
#pragma unroll
      for (int o = 1; o < L::kLpr; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[r][p] = (ok[r] >> p & 1u) ? dot * scale : GWT_NEG;
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float mx = s[r][0];
#pragma unroll
    for (int p = 1; p < L::kPass; ++p) mx = fmaxf(mx, s[r][p]);
#pragma unroll
    for (int o = L::kLpr; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) red[warp][r] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float mx = red[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w][r]);
    const float m_new = fmaxf(st.m[r], mx);
    const float corr = expf(st.m[r] - m_new);
    st.m[r] = m_new;
    float ps = 0.f;
#pragma unroll
    for (int p = 0; p < L::kPass; ++p) {
      // masked slots contribute exactly 0, as exp(-1e30 - m) does
      s[r][p] = (ok[r] >> p & 1u) ? expf(s[r][p] - m_new) : 0.f;
      ps += s[r][p];
    }
    st.l[r] = st.l[r] * corr + ps;
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) st.acc[r][e] *= corr;
  }
#pragma unroll
  for (int p = 0; p < L::kPass; ++p) {
    float vf[L::kVec];
    unpack(vr[p], vf);
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int e = 0; e < L::kVec; ++e)
        st.acc[r][e] = fmaf(s[r][p], vf[e], st.acc[r][e]);
  }
}

// The online softmax over a slice's chunks [a, b): a chunk [c0, ce) is
// skipped unless live(c0, ce) (the same in every thread), and fill(c0, ce,
// off, ok) gives this lane's offsets and masks (see Chunk).
template <typename T, int D, int NR, typename Live, typename Fill>
__device__ __forceinline__ void run_slice(
    int a, int b, Live live, Fill fill, const T* __restrict__ k,
    const T* __restrict__ v, const float (&qv)[NR][Lay<T, D>::kVec],
    float scale, RowState<NR, Lay<T, D>::kVec>& st, Smem<D>& sm) {
  int par = 0;
  for (int c0 = a; c0 < b; c0 += kChunk) {
    const int ce = min(c0 + kChunk, b);
    if (!live(c0, ce)) continue;
    long long off[Lay<T, D>::kPass];
    Chunk<T, D, NR> ch;
    fill(c0, ce, off, ch.ok);
    ch.load(k, v, off);
    chunk_update<T, D, NR>(ch, qv, scale, st, sm.red[par]);
    par ^= 1;
  }
}

// The slice's partial of NR rows, reduced over lanes and warps in a fixed
// order, to workspace rows row0.. +NR: acc (D floats a row) and (m, l).
template <typename T, int D, int NR>
__device__ __forceinline__ void write_partial(
    const RowState<NR, Lay<T, D>::kVec>& st, size_t row0,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml, Smem<D>& sm) {
  using L = Lay<T, D>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float l = st.l[r];
#pragma unroll
    for (int o = L::kLpr; o < 32; o <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) sm.red_l[warp * kMaxRows + r] = l;
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) {
      float a = st.acc[r][e];
#pragma unroll
      for (int o = L::kLpr; o < 32; o <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane < L::kLpr)
        sm.red_acc[warp * kMaxRows + r][lane * L::kVec + e] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < NR * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float a = sm.red_acc[r][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += sm.red_acc[w * kMaxRows + r][d];
    ws_acc[(row0 + r) * D + d] = a;
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (tid == r) {
      float l = sm.red_l[r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) l += sm.red_l[w * kMaxRows + r];
      ws_ml[2 * (row0 + r)] = st.m[r];
      ws_ml[2 * (row0 + r) + 1] = l;
    }
  }
}

// Empty partials (no slot attended) for workspace rows row0.. +n, written
// by every thread of the CTA.
template <int D>
__device__ __forceinline__ void write_empty(size_t row0, int n,
                                            float* __restrict__ ws_acc,
                                            float* __restrict__ ws_ml) {
  for (int i = threadIdx.x; i < n * D; i += kThreads)
    ws_acc[row0 * D + i] = 0.f;
  if (threadIdx.x < n) {
    ws_ml[2 * (row0 + threadIdx.x)] = GWT_NEG;
    ws_ml[2 * (row0 + threadIdx.x) + 1] = 0.f;
  }
}

// True in every thread of the CTA that took the pair's last ticket.  The
// barrier, then thread 0's fence before its atomic (the pattern of
// cooperative groups' grid barrier), make every thread's partial visible
// to the CTA that takes the last ticket; its thread 0 fences again before
// that CTA reads them.
template <int D>
__device__ __forceinline__ bool last_to_arrive(int* ticket, int n_split,
                                               Smem<D>& sm) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    sm.last = atomicAdd(ticket, 1) == n_split - 1;
    __threadfence();
  }
  __syncthreads();
  return sm.last != 0;
}

// Every split holds every row (K3/K4): row r's k-th partial is split k.
struct AllRows {
  int n_split;
  __device__ __forceinline__ int count() const { return n_split; }
  __device__ __forceinline__ int index(int k, int) const { return k; }
};

// Merge of one (group, head) pair's partials by the last CTA.  Row r has
// held.count() partials, its k-th in workspace row (held.index(k, r) * R +
// r), in split order.  Writes rows r of out (stride S) at columns col..
// +D and resets the ticket.  Each thread owns a float4 of one row's acc;
// the first 16 partials' float4s are requested together with every (m, l),
// so the merge waits for memory once for up to 16 partials a row.  Then,
// one warp per row, the largest m and each partial's weight exp(m_k - m)
// (0 where l = 0); l and acc are summed in split order.
template <int D, int R, typename Held>
__device__ __forceinline__ void merge(const float* ws_acc, const float* ws_ml,
                                      Held held, float* __restrict__ out,
                                      size_t out0, int S, int col,
                                      Smem<D>& sm, int* ticket) {
  constexpr int kQ = D / 4;  // float4 columns of a row
  constexpr int kB = 16;     // partials whose acc one batch requests
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = tid / kQ, d4 = tid % kQ;
  const bool mine = tid < R * kQ;
  const int n = held.count();
  auto acc_at = [&](int k) {
    return __ldcg(reinterpret_cast<const float4*>(
                      ws_acc + ((size_t)held.index(k, r) * R + r) * D) + d4);
  };
  float4 x[kB];
#pragma unroll
  for (int u = 0; u < kB; ++u)
    x[u] = (mine && u < n) ? acc_at(u) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = tid; idx < R * n; idx += kThreads) {
    const int rr = idx / n, k = idx % n;
    const size_t e = (size_t)held.index(k, rr) * R + rr;
    sm.m[rr][k] = __ldcg(ws_ml + 2 * e);
    sm.l[rr][k] = __ldcg(ws_ml + 2 * e + 1);
  }
  __syncthreads();
  for (int rr = warp; rr < R; rr += kWarps) {
    float mt = GWT_NEG;
    for (int k = lane; k < n; k += 32)
      if (sm.l[rr][k] > 0.f) mt = fmaxf(mt, sm.m[rr][k]);
    mt = warp_max(mt);
    for (int k = lane; k < n; k += 32) {
      const float w = sm.l[rr][k] > 0.f ? expf(sm.m[rr][k] - mt) : 0.f;
      sm.w[rr][k] = w;
      sm.lw[rr][k] = sm.l[rr][k] * w;
    }
  }
  __syncthreads();
  if (tid < R) {
    float lt = 0.f;
    for (int k = 0; k < n; ++k) lt += sm.lw[tid][k];
    sm.l_tot[tid] = lt;
  }
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add = [&](float w, const float4& v) {
    a.x = fmaf(w, v.x, a.x);
    a.y = fmaf(w, v.y, a.y);
    a.z = fmaf(w, v.z, a.z);
    a.w = fmaf(w, v.w, a.w);
  };
  if (mine) {
#pragma unroll
    for (int u = 0; u < kB; ++u)
      if (u < n) add(sm.w[r][u], x[u]);
    for (int k0 = kB; k0 < n; k0 += kB) {
#pragma unroll
      for (int u = 0; u < kB; ++u)
        x[u] = k0 + u < n ? acc_at(k0 + u) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kB; ++u)
        if (k0 + u < n) add(sm.w[r][k0 + u], x[u]);
    }
  }
  __syncthreads();
  if (mine) {
    const float l = fmaxf(sm.l_tot[r], 1e-30f);
    *reinterpret_cast<float4*>(out + out0 + (size_t)r * S + col + 4 * d4) =
        make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
  }
  if (tid == 0) *ticket = 0;
}

}  // namespace dsplit
