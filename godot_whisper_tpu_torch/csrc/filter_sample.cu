// K5: fused logit filter + sampler, and K6: fused logit filter + top-K beam
// expansion.  Both kernels run the same filter stage (`filter_slice`), so
// the two cannot drift apart.
//
// Replaces two TPU kernels of godot_whisper_tpu/ops/filter_sample.py:
//
// - `_kernel` with its filter stage `_filter_lp` (reached through
//   `fused_filter_sample`): temperature scaling; the suppression rules
//   (static mask, blank at start, no_timestamps, timestamp pairing, initial
//   timestamp cap, monotonic timestamps); the masked log-softmax; the
//   "timestamp mass beats the best text token" rule; then argmax over the
//   probabilities (lowest index on ties, as jnp.argmax) or Gumbel-max
//   sampling chosen per row by state column 6; and the timestamp statistics
//   (pt, ptsum, tid) of whisper_sample_token.
// - `_topk_kernel` (reached through `fused_filter_topk`): the same filter
//   stage, the pre-merge timestamp statistics, then the K largest filtered
//   log-probs per row in the order of K argmax passes that mask each winner
//   (lowest index on ties: the lax.top_k order) with the probability at
//   each id.  Once the live ids run out, every remaining pass finds all ids
//   at -1e30 and takes id 0; the kernel repeats id 0 with its value there.
//
// The -1e30 sentinel and the `lp > -0.5e30` tests follow the TPU kernels
// exactly; no -inf appears.  No atomics decide anything: every reduction
// runs in a fixed order, and every CTA of a cluster combines the same
// partials in the same order, so bit-identical rows give bit-identical
// outputs (the beam merge's equal-score dedupe relies on it at step 0,
// where all beams of a group share one distribution).
//
// Gumbel noise (K5): the TPU's hardware random bits cannot be reproduced,
// so the noise comes from a counter-based integer hash of (seed, row,
// global id) -> 24-bit uniform u -> -log(-log(max(u, 1e-12))).  The plain
// PyTorch version computes the same hash, so kernel and plain version agree
// at t > 0 too, apart from last-ulp differences in log.
//
// Bound on an H100: bytes.  One f32 row of V logits read once (5 x 51864 x
// 4 B = 1 MB for tiny.en's 5 decoder rows, ~0.3 us at 3.35 TB/s) plus the
// shared (V,) suppress mask; outputs are a few scalars per row.  What a
// call really waits on is latency: a first global load returns ~1700
// cycles after the kernel starts, and every cross-CTA exchange is a
// cluster barrier of 1200-1600 cycles.
//
// Design: one thread-block cluster of C CTAs per row, grid (C, B), C and
// the slice width W = npt * 256 chosen from V alone by the wrapper
// (`ops/filter_sample.py::filter_plan`; C 16 and npt 13 at V 51864).  CTA
// r takes ids [r W, r W + W); thread t holds ids r W + i 256 + t, i < npt,
// in registers (a warp's 32 ids of one i are consecutive, so its loads
// coalesce and no row goes through shared memory).  Every load of a
// thread (logits, suppress bytes, row state) is issued before any value is
// used, so the row arrives in about one round trip.  The row's reductions
// cross CTAs in three exchanges: each warp stores its partials into every
// CTA's shared memory (or rank 0's alone for the last) with
// `map_shared_rank`, then one `cluster.sync()`:
//   1. the timestamp and text maxima of the scaled, suppressed logits.
//      Their max is the row max m; since fl(a - c) never decreases as a
//      grows, the log-prob maxima are fl(max - lse) exactly, with no pass;
//   2. the masked sum of exp(l - m) -> lse, and lp = fl(l - lse);
//   3. to rank 0: the timestamp log-mass sum and the timestamp statistics,
//      which the rule does not change, and the candidates for both outcomes
//      of the rule.  K5 sends each warp's best over all ids (the rule does
//      not fire) and over timestamp ids (it fires: every text id drops to
//      -1e30, so the best text id becomes id 0 at p 0); K6 sends each CTA's
//      top-K over text ids and over timestamp ids (local top-K per warp by
//      redux argmax rounds, merged per CTA).  Rank 0 decides the rule from
//      the combined sums and picks the winner, or merges the C sorted lists
//      of timestamp ids (and of text ids when the rule does not fire).
// Warp argmaxes are two `redux.sync` instructions: the max of an
// order-preserving integer key of the value, then the min id among the
// lanes that hold it.  A thread's loops over its slots are branch-free
// with tree reductions, its loads at constant offsets from one pointer;
// timestamp work runs only in warps that hold timestamp ids.  Registers
// are capped at 80 (3 CTAs an SM), so 40 rows (8 streams of 5) take fewer
// waves.  The cluster attribute is set once per process.
//
// K5 at an LM's vocabulary (152064 ids, models/unimoe.py): the same kernel
// instantiated at 38 ids a thread with 64-bit slot masks and no register
// cap below 255, chosen by the entry point when the plan gives more than
// 14 ids a thread; Whisper's vocabularies keep the 14-id instantiation.
//
// Where the time goes (clock64 stamps of CTA 0 on an H100, K5 at (5,
// 51864), ~16,000 cycles): ~4,000 to load and filter the slice, ~1,900 for
// each of the three cluster exchanges (the third also waits for the CTA
// with the timestamp ids), ~1,600 and ~2,300 for the passes between them,
// ~1,200 for rank 0's combine.  K6 adds ~3,300 cycles of redux rounds for
// its per-warp lists (K 5) and ~2,800 for the merges.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;                    // non-portable cluster
constexpr int kMaxNpt = 14;                        // 16 x 256 x 14 >= 56000
constexpr int kWideNpt = 38;  // K5 only: 16 x 256 x 38 >= 152064 (an LM's ids)
constexpr int kMaxParts = kMaxCluster * kWarps;    // warp partials of a row
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int V, npt, eot, beg, space_id, max_initial_tid, suppress_blank,
      no_timestamps;
  float temperature;
  uint32_t seed;
};

struct Cand {
  float v;
  int i;
};

__device__ __forceinline__ uint32_t hash32(uint32_t seed, uint32_t row,
                                           uint32_t col) {
  uint32_t x = col + 0x9E3779B9u * (row + 1u) + 0x632BE5ABu * seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// An unsigned key that orders as the float does (-0 taken as +0).
__device__ __forceinline__ uint32_t ord_key(float v) {
  const uint32_t u = __float_as_uint(v + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_val(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float warp_max_fast(float v) {
  return key_val(__reduce_max_sync(kFull, ord_key(v)));
}

// Every lane gets the warp's largest v and, among the lanes holding it, the
// lowest id: argmax_merge's order, in two redux instructions.
__device__ __forceinline__ void warp_argmax_fast(float& v, int& i) {
  const uint32_t k = ord_key(v);
  const uint32_t km = __reduce_max_sync(kFull, k);
  i = (int)__reduce_min_sync(kFull, k == km ? (uint32_t)i : 0xffffffffu);
  v = key_val(km);
}

// The same, carrying a third value from the winning lane (ids are
// distinct across lanes).
__device__ __forceinline__ void warp_argmax_carry(float& v, int& i,
                                                  float& c) {
  const int own = i;
  warp_argmax_fast(v, i);
  const unsigned who = __ballot_sync(kFull, own == i);
  c = __shfl_sync(kFull, c, __ffs(who) - 1);
}

__device__ __forceinline__ void merge_carry(float& v, int& i, float& c,
                                            float v2, int i2, float c2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
    c = c2;
  }
}

// The n <= kMaxParts warp partials of one exchange, combined by a whole
// warp in a fixed order: every warp of every CTA gets the same bits.
__device__ __forceinline__ float parts_sum(const float* p, int n) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxParts / 32; ++q)
    if (lane + 32 * q < n) s += p[lane + 32 * q];
  return warp_sum(s);
}

// Max and sum of a thread's slots by a fixed tree (short dependency chains;
// the max is exact in any order).
template <int N>
__device__ __forceinline__ float tree_max(const float (&v)[N]) {
  float t[N];
#pragma unroll
  for (int s = 0; s < N; ++s) t[s] = v[s];
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int s = 0; s + w < N; s += 2 * w) t[s] = fmaxf(t[s], t[s + w]);
  return t[0];
}
template <int N>
__device__ __forceinline__ float tree_sum(const float (&v)[N]) {
  float t[N];
#pragma unroll
  for (int s = 0; s < N; ++s) t[s] = v[s];
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int s = 0; s + w < N; s += 2 * w) t[s] += t[s + w];
  return t[0];
}

// The lowest slot whose v equals m (the max of v), as its id and its c;
// id INT_MAX when m is -inf (no candidate: every other value is >= -1e30).
template <int N>
__device__ __forceinline__ void first_at(const float (&v)[N], float m,
                                         const float (&c)[N], int j0,
                                         int& id, float& cv) {
  id = 0x7fffffff;
  cv = 0.f;
#pragma unroll
  for (int s = N - 1; s >= 0; --s)
    if (v[s] == m && m != -INFINITY) {
      id = j0 + s * kThreads;
      cv = c[s];
    }
}

struct RowStats {
  float lse, ts_m, text_m;  // the log-prob maxima over timestamp / text ids
};

// The filter stage of both kernels (the TPU's `_filter_lp`) on this
// thread's slots: slot s is id j0 + s * kThreads, present when bit s of
// `have` is set.  Reads row b's raw logits `lg` and its state `st` (7
// ints: [is_initial, last, penult, n_tokens, has_ts, seek_delta,
// argmax_flag]); on return x[s] holds the filtered log-prob before the
// timestamp rule (-1e30 where suppressed; bit s of `sup` set) and `rs` the
// row's lse and log-prob maxima.  Every thread of the cluster calls it;
// it takes exchanges 1 and 2 and the cluster barrier of the entry.
template <int N, typename M>
__device__ __forceinline__ void filter_slice(
    const float* __restrict__ lg, const uint8_t* __restrict__ suppress,
    const int* __restrict__ st, const Params& a, int j0,
    cg::cluster_group& cluster, float2* s_x1, float* s_x2,
    float (&x)[N], M& have, M& sup, RowStats& rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = (int)cluster.block_rank(), nc = (int)cluster.num_blocks();
  const int V = a.V, beg = a.beg, eot = a.eot;

  // every load first: the row state, the logits and the suppress bytes,
  // at constant offsets from the thread's first id
  int sv[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) sv[c] = __ldg(st + c);
  const int n_have = min(a.npt, (V - j0 + kThreads - 1) / kThreads);
  const float* lg0 = lg + j0;
  const uint8_t* sup0 = suppress + j0;
  uint32_t sb[N];
#pragma unroll
  for (int s = 0; s < N; ++s) {
    x[s] = s < n_have ? __ldg(lg0 + s * kThreads) : 0.f;
    sb[s] = s < n_have ? (uint32_t)__ldg(sup0 + s * kThreads) : 1u;
  }
  have = n_have > 0 ? (M(2) << (n_have - 1)) - M(1) : M(0);
  const int is_initial = sv[0], last = sv[1], penult = sv[2];
  const int n_tokens = sv[3], has_ts = sv[4], seek_delta = sv[5];
  const bool last_was_ts = n_tokens > 0 && last >= beg;
  const bool penult_was_ts = n_tokens < 2 || penult >= beg;

  // pass 1: temperature, suppression, the timestamp and text maxima; a
  // missing slot counts as suppressed
  float tsl[N], txl[N];
  sup = 0;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const int j = j0 + s * kThreads;
    float l = x[s];
    if (a.temperature > 0.f) l = l / fmaxf(a.temperature, 1e-8f);
    const bool ts = j >= beg;
    const bool su =
        !((have >> s) & 1u) | (sb[s] != 0) |
        (a.suppress_blank && is_initial && (j == eot || j == a.space_id)) |
        (a.no_timestamps && ts) | (last_was_ts && penult_was_ts && ts) |
        (last_was_ts && !penult_was_ts && j < eot) |
        (is_initial && j > beg + a.max_initial_tid) |
        (has_ts && ts && j < beg + seek_delta / 2);
    l = su ? GWT_NEG : l;
    sup |= (M)su << s;
    x[s] = l;
    tsl[s] = ts ? l : GWT_NEG;
    txl[s] = ts ? GWT_NEG : l;
  }
  const float ts_mx = tree_max(tsl), text_mx = tree_max(txl);

  // exchange 1: the maxima
  const float2 mine = make_float2(warp_max_fast(ts_mx),
                                  warp_max_fast(text_mx));
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int part = rank * kWarps + warp, n_parts = nc * kWarps;
  if (lane < nc) cluster.map_shared_rank(s_x1, lane)[part] = mine;
  cluster.sync();
  float tm = GWT_NEG, xm = GWT_NEG;
#pragma unroll
  for (int q = 0; q < kMaxParts / 32; ++q)
    if (lane + 32 * q < n_parts) {
      const float2 p = s_x1[lane + 32 * q];
      tm = fmaxf(tm, p.x);
      xm = fmaxf(xm, p.y);
    }
  tm = warp_max_fast(tm);
  xm = warp_max_fast(xm);
  const float m = fmaxf(tm, xm);

  // pass 2 and exchange 2: the masked sum -> lse
  float e[N];
#pragma unroll
  for (int s = 0; s < N; ++s)
    e[s] = ((sup >> s) & 1u) ? 0.f : expf(x[s] - m);
  const float se = warp_sum(tree_sum(e));
  if (lane < nc) cluster.map_shared_rank(s_x2, lane)[part] = se;
  cluster.sync();
  const float lse = logf(parts_sum(s_x2, n_parts)) + m;

  // pass 3: log-probs in place; their maxima follow from the logits'
  rs.lse = lse;
  rs.ts_m = tm > GWT_NEG ? tm - lse : GWT_NEG;
  rs.text_m = xm > GWT_NEG ? xm - lse : GWT_NEG;
#pragma unroll
  for (int s = 0; s < N; ++s)
    x[s] = ((sup >> s) & 1u) ? GWT_NEG : x[s] - lse;
}

// Exchange 3's warp partial of K5.
struct Part5 {
  float ts_se, ptsum, ts_pr;
  int ts_i;
  float a_v;  // best score over all ids (the rule does not fire)
  int a_i;
  float a_lp;
  float b_v;  // best score over timestamp ids (it fires)
  int b_i;
  float b_lp;
};

template <int N, typename M>
__global__ void __launch_bounds__(kThreads, N <= kMaxNpt ? 3 : 1)
    filter_sample_kernel(const float* __restrict__ logits,
                         const uint8_t* __restrict__ suppress,
                         const int* __restrict__ state,  // (B, 7)
                         Params a, int* __restrict__ tok_out,
                         float* __restrict__ p_out,
                         float* __restrict__ plog_out,
                         float* __restrict__ pt_out,
                         float* __restrict__ ptsum_out,
                         int* __restrict__ tid_out) {
  __shared__ float2 s_x1[kMaxParts];
  __shared__ float s_x2[kMaxParts];
  __shared__ Part5 s_x3[kMaxParts];  // rank 0's
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nc = (int)cluster.num_blocks();
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int V = a.V, beg = a.beg;
  const int* st = state + (size_t)b * 7;
  const int j0 = rank * a.npt * kThreads + tid;
  const bool use_argmax = __ldg(st + 6) != 0;

  float x[N];
  M have, sup;
  RowStats rs;
  filter_slice(logits + (size_t)b * V, suppress, st, a, j0, cluster, s_x1,
               s_x2, x, have, sup, rs);

  // the sample's candidates for both outcomes of the timestamp rule, and
  // the timestamp statistics (only warps that hold timestamp ids)
  Part5 p{0.f, 0.f, -INFINITY, 0x7fffffff, -INFINITY, 0x7fffffff, 0.f,
          -INFINITY, 0x7fffffff, 0.f};
  float pr[N], sc[N];
#pragma unroll
  for (int s = 0; s < N; ++s)
    pr[s] = x[s] > 0.5f * GWT_NEG ? expf(x[s]) : 0.f;
  if (use_argmax) {
#pragma unroll
    for (int s = 0; s < N; ++s)
      sc[s] = ((have >> s) & 1u) ? pr[s] : -INFINITY;
  } else {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const uint32_t h =
          hash32(a.seed, (uint32_t)b, (uint32_t)(j0 + s * kThreads));
      const float u = (float)(h & 0xFFFFFFu) * (1.f / 16777216.f);
      const float g = x[s] - logf(-logf(fmaxf(u, 1e-12f)));
      sc[s] = !((have >> s) & 1u)          ? -INFINITY
              : x[s] > 0.5f * GWT_NEG ? g
                                      : GWT_NEG;
    }
  }
  p.a_v = tree_max(sc);
  first_at(sc, p.a_v, x, j0, p.a_i, p.a_lp);
  warp_argmax_carry(p.a_v, p.a_i, p.a_lp);
  if (j0 - lane + (a.npt - 1) * kThreads + 31 >= beg) {  // warp-uniform
    float te[N], tp[N], tv[N], bv[N];
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const bool ts = ((have >> s) & 1u) && j0 + s * kThreads >= beg;
      te[s] = ts && !((sup >> s) & 1u) ? expf(x[s] - rs.ts_m) : 0.f;
      tp[s] = ts ? pr[s] : 0.f;
      tv[s] = ts ? pr[s] : -INFINITY;
      bv[s] = ts ? sc[s] : -INFINITY;
    }
    p.ts_se = warp_sum(tree_sum(te));
    p.ptsum = warp_sum(tree_sum(tp));
    float unused;
    p.ts_pr = tree_max(tv);
    first_at(tv, p.ts_pr, tv, j0, p.ts_i, unused);
    warp_argmax_fast(p.ts_pr, p.ts_i);
    p.b_v = tree_max(bv);
    first_at(bv, p.b_v, x, j0, p.b_i, p.b_lp);
    warp_argmax_carry(p.b_v, p.b_i, p.b_lp);
  }
  if (lane == 0)
    cluster.map_shared_rank(s_x3, 0)[rank * kWarps + warp] = p;
  cluster.sync();  // exchange 3
  if (rank != 0 || warp != 0) return;

  // rank 0, warp 0: combine, decide the rule, write the row's outputs
  const int n_parts = nc * kWarps;
  Part5 t{0.f, 0.f, -INFINITY, 0x7fffffff, -INFINITY, 0x7fffffff, 0.f,
          -INFINITY, 0x7fffffff, 0.f};
#pragma unroll
  for (int q = 0; q < kMaxParts / 32; ++q) {
    if (lane + 32 * q >= n_parts) break;
    const Part5 e = s_x3[lane + 32 * q];
    t.ts_se += e.ts_se;
    t.ptsum += e.ptsum;
    argmax_merge(t.ts_pr, t.ts_i, e.ts_pr, e.ts_i);
    merge_carry(t.a_v, t.a_i, t.a_lp, e.a_v, e.a_i, e.a_lp);
    merge_carry(t.b_v, t.b_i, t.b_lp, e.b_v, e.b_i, e.b_lp);
  }
  const float ts_se = warp_sum(t.ts_se), ptsum = warp_sum(t.ptsum);
  warp_argmax_fast(t.ts_pr, t.ts_i);
  warp_argmax_carry(t.a_v, t.a_i, t.a_lp);
  warp_argmax_carry(t.b_v, t.b_i, t.b_lp);
  if (lane != 0) return;
  const float ts_lp = ts_se > 0.f ? logf(ts_se) + rs.ts_m : GWT_NEG;
  int tok = t.a_i;
  float lp_sel = t.a_lp;
  if (ts_lp > rs.text_m) {
    // the rule fires: every text id scores as a filtered id, the lowest
    // of them (id 0) first
    if (beg > 0)
      merge_carry(t.b_v, t.b_i, t.b_lp, use_argmax ? 0.f : GWT_NEG, 0,
                  GWT_NEG);
    tok = t.b_i;
    lp_sel = t.b_lp;
  }
  const float p_sel = lp_sel > 0.5f * GWT_NEG ? expf(lp_sel) : 0.f;
  float pt = t.ts_pr / (ptsum + 1e-10f);
  int t_id = t.ts_i;
  if (tok >= beg) {
    t_id = tok;
    pt = p_sel;
  }
  tok_out[b] = tok;
  p_out[b] = p_sel;
  plog_out[b] = lp_sel;
  pt_out[b] = pt;
  ptsum_out[b] = ptsum;
  tid_out[b] = t_id;
}

// The K best (value desc, id asc) of the warp's slots whose bit is set in
// `mask`, into out[0, K); entries past the last candidate get -inf.  One
// redux argmax a round; only the winning lane looks at its slots again.
__device__ __forceinline__ void warp_topk(const float (&x)[kMaxNpt],
                                          uint32_t mask, int j0, int K,
                                          Cand* out) {
  const int lane = threadIdx.x & 31;
  if (!__any_sync(kFull, mask != 0)) {
    for (int e = lane; e < K; e += 32) out[e] = Cand{-INFINITY, 0};
    return;
  }
  float bv, unused;
  int bi;
  auto best = [&]() {
    float mv[kMaxNpt];
#pragma unroll
    for (int s = 0; s < kMaxNpt; ++s)
      mv[s] = ((mask >> s) & 1u) ? x[s] : -INFINITY;
    bv = tree_max(mv);
    first_at(mv, bv, mv, j0, bi, unused);
  };
  best();
  for (int k = 0; k < K; ++k) {
    float v = bv;
    int i = bi;
    warp_argmax_fast(v, i);
    if (v == -INFINITY) {  // warp-uniform
      for (int e = k + lane; e < K; e += 32) out[e] = Cand{-INFINITY, 0};
      return;
    }
    if (lane == 0) out[k] = Cand{v, i};
    if (i == bi) {
      mask &= ~(1u << ((i - j0) / kThreads));
      best();
    }
  }
}

// K-way merge of n <= 32 sorted lists of K entries (lane l owns list l,
// lists + l * kMaxK): emit(k, v, i) for the K best, (-inf, ...) once all
// lists are spent.  The next entry of each list is loaded ahead.
template <typename Emit>
__device__ __forceinline__ void warp_merge(const Cand* lists, int n, int K,
                                           Emit emit) {
  const int lane = threadIdx.x & 31;
  const Cand none{-INFINITY, 0x7fffffff};
  const Cand* my = lists + lane * kMaxK;
  int pos = 0;
  Cand head = lane < n ? my[0] : none;
  Cand next = lane < n && K > 1 ? my[1] : none;
  if (head.v == -INFINITY) head = none;
  for (int k = 0; k < K; ++k) {
    float v = head.v;
    int i = head.i;
    warp_argmax_fast(v, i);
    emit(k, v, i);
    if (v != -INFINITY && i == head.i) {
      ++pos;
      head = next.v == -INFINITY ? none : next;
      next = pos + 1 < K ? my[pos + 1] : none;
    }
  }
}

// Exchange 3's warp partial of K6 (its lists travel separately).
struct Part6 {
  float ts_se, ptsum, ts_pr;
  int ts_i;
};

__global__ void __launch_bounds__(kThreads, 3)
    filter_topk_kernel(const float* __restrict__ logits,
                       const uint8_t* __restrict__ suppress,
                       const int* __restrict__ state,  // (B, 7)
                       Params a, int K, float* __restrict__ plog_out,  // (B, K)
                       int* __restrict__ ids_out,                     // (B, K)
                       float* __restrict__ p_out,                     // (B, K)
                       float* __restrict__ pt_out,
                       float* __restrict__ ptsum_out,
                       int* __restrict__ tid_out) {
  __shared__ float2 s_x1[kMaxParts];
  __shared__ float s_x2[kMaxParts];
  __shared__ Part6 s_x3[kMaxParts];                    // rank 0's
  __shared__ Cand s_wl[2][kWarps][kMaxK];              // warp lists
  __shared__ Cand s_cl[2 * kMaxCluster][kMaxK];        // rank 0's: C text
                                                       // lists, C ts lists
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nc = (int)cluster.num_blocks();
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int V = a.V, beg = a.beg;
  const int j0 = rank * a.npt * kThreads + tid;

  float x[kMaxNpt];
  uint32_t have, sup;
  RowStats rs;
  filter_slice(logits + (size_t)b * V, suppress, state + (size_t)b * 7, a,
               j0, cluster, s_x1, s_x2, x, have, sup, rs);

  // which slots are text / timestamp candidates (any value above -1e30),
  // and the timestamp statistics (only warps that hold timestamp ids)
  Part6 p{0.f, 0.f, -INFINITY, 0x7fffffff};
  uint32_t text_c = 0, ts_c = 0;
#pragma unroll
  for (int s = 0; s < kMaxNpt; ++s) {
    const bool cand = ((have >> s) & 1u) && x[s] > GWT_NEG;
    const bool ts = j0 + s * kThreads >= beg;
    text_c |= (uint32_t)(cand && !ts) << s;
    ts_c |= (uint32_t)(cand && ts) << s;
  }
  if (j0 - lane + (a.npt - 1) * kThreads + 31 >= beg) {  // warp-uniform
    float te[kMaxNpt], tp[kMaxNpt], tv[kMaxNpt];
#pragma unroll
    for (int s = 0; s < kMaxNpt; ++s) {
      const bool ts = ((have >> s) & 1u) && j0 + s * kThreads >= beg;
      const float pr = x[s] > 0.5f * GWT_NEG ? expf(x[s]) : 0.f;
      te[s] = ts && !((sup >> s) & 1u) ? expf(x[s] - rs.ts_m) : 0.f;
      tp[s] = ts ? pr : 0.f;
      tv[s] = ts ? pr : -INFINITY;
    }
    p.ts_se = warp_sum(tree_sum(te));
    p.ptsum = warp_sum(tree_sum(tp));
    float unused;
    p.ts_pr = tree_max(tv);
    first_at(tv, p.ts_pr, tv, j0, p.ts_i, unused);
    warp_argmax_fast(p.ts_pr, p.ts_i);
  }
  if (lane == 0) cluster.map_shared_rank(s_x3, 0)[rank * kWarps + warp] = p;

  // each warp's top-K over its text ids and over its timestamp ids, then
  // the CTA's (warp 0 text, warp 1 timestamps) into rank 0's lists
  warp_topk(x, text_c, j0, K, s_wl[0][warp]);
  warp_topk(x, ts_c, j0, K, s_wl[1][warp]);
  __syncthreads();
  if (warp < 2) {
    Cand* dst = cluster.map_shared_rank(&s_cl[warp * nc + rank][0], 0);
    warp_merge(&s_wl[warp][0][0], kWarps, K, [&](int k, float v, int i) {
      if (lane == 0) dst[k] = Cand{v, i};
    });
  }
  cluster.sync();  // exchange 3
  if (rank != 0 || warp != 0) return;

  // rank 0, warp 0: the statistics, the rule, the merge of the lists
  const int n_parts = nc * kWarps;
  Part6 t{0.f, 0.f, -INFINITY, 0x7fffffff};
#pragma unroll
  for (int q = 0; q < kMaxParts / 32; ++q) {
    if (lane + 32 * q >= n_parts) break;
    const Part6 e = s_x3[lane + 32 * q];
    t.ts_se += e.ts_se;
    t.ptsum += e.ptsum;
    argmax_merge(t.ts_pr, t.ts_i, e.ts_pr, e.ts_i);
  }
  const float ts_se = warp_sum(t.ts_se), ptsum = warp_sum(t.ptsum);
  warp_argmax_fast(t.ts_pr, t.ts_i);
  const float ts_lp = ts_se > 0.f ? logf(ts_se) + rs.ts_m : GWT_NEG;
  const bool fire = ts_lp > rs.text_m;
  if (lane == 0) {
    pt_out[b] = t.ts_pr / (ptsum + 1e-10f);
    ptsum_out[b] = ptsum;
    tid_out[b] = t.ts_i;
  }
  // past the last candidate every pass takes id 0 (lane 0 holds it)
  const float lp0 = __shfl_sync(kFull, fire && 0 < beg ? GWT_NEG : x[0], 0);
  float* plog = plog_out + (size_t)b * K;
  float* pp = p_out + (size_t)b * K;
  int* ids = ids_out + (size_t)b * K;
  warp_merge(fire ? &s_cl[nc][0] : &s_cl[0][0], fire ? nc : 2 * nc, K,
             [&](int k, float v, int i) {
               if (lane != 0) return;
               if (v == -INFINITY) {
                 v = lp0;
                 i = 0;
               }
               plog[k] = v;
               ids[k] = i;
               pp[k] = v > 0.5f * GWT_NEG ? expf(v) : 0.f;
             });
}

// The cluster attribute, once per device (clusters of 16 are not
// portable; function attributes belong to the device's context).
constexpr int kMaxDevices = 64;

int cluster_attrs() {
  static bool attr_set[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && attr_set[dev]) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)filter_sample_kernel<kMaxNpt, uint32_t>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        (const void*)filter_sample_kernel<kWideNpt, uint64_t>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)filter_topk_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess && dev < kMaxDevices) attr_set[dev] = true;
  return (int)e;
}

cudaLaunchConfig_t cluster_config(int C, int B, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The plan's checks: C slices of npt * kThreads ids cover [0, V), the last
// one not empty, npt at most max_npt.
bool plan_ok(int B, int V, int C, int npt, int max_npt = kMaxNpt) {
  const long w = (long)npt * kThreads;
  return B >= 1 && V >= 1 && C >= 1 && C <= kMaxCluster && npt >= 1 &&
         npt <= max_npt && (long)C * w >= V && (long)(C - 1) * w < V;
}

}  // namespace

extern "C" int gwt_filter_sample(const void* logits, const void* suppress,
                                 const void* state, void* tok, void* p,
                                 void* plog, void* pt, void* ptsum, void* tid,
                                 int B, int V, int C, int npt, int eot,
                                 int beg, int space_id, int max_initial_tid,
                                 int suppress_blank, int no_timestamps,
                                 float temperature, unsigned int seed,
                                 void* stream) {
  if (!plan_ok(B, V, C, npt, kWideNpt)) return (int)cudaErrorInvalidValue;
  const int err = cluster_attrs();
  if (err != 0) return err;
  const Params a{V, npt, eot, beg, space_id, max_initial_tid, suppress_blank,
                 no_timestamps, temperature, seed};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(C, B, stream, attr);
  // up to 14 ids a thread (Whisper's vocabularies) in the kernel as it
  // was; past that the wide instantiation (64-bit slot masks)
  const cudaError_t e =
      npt <= kMaxNpt
          ? cudaLaunchKernelEx(&cfg, filter_sample_kernel<kMaxNpt, uint32_t>,
                               (const float*)logits, (const uint8_t*)suppress,
                               (const int*)state, a, (int*)tok, (float*)p,
                               (float*)plog, (float*)pt, (float*)ptsum,
                               (int*)tid)
          : cudaLaunchKernelEx(&cfg, filter_sample_kernel<kWideNpt, uint64_t>,
                               (const float*)logits, (const uint8_t*)suppress,
                               (const int*)state, a, (int*)tok, (float*)p,
                               (float*)plog, (float*)pt, (float*)ptsum,
                               (int*)tid);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int gwt_filter_topk(const void* logits, const void* suppress,
                               const void* state, void* plog, void* ids,
                               void* p, void* pt, void* ptsum, void* tid,
                               int B, int V, int C, int npt, int K, int eot,
                               int beg, int space_id, int max_initial_tid,
                               int suppress_blank, int no_timestamps,
                               float temperature, void* stream) {
  if (!plan_ok(B, V, C, npt) || K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const int err = cluster_attrs();
  if (err != 0) return err;
  const Params a{V, npt, eot, beg, space_id, max_initial_tid, suppress_blank,
                 no_timestamps, temperature, 0u};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(C, B, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, filter_topk_kernel, (const float*)logits,
      (const uint8_t*)suppress, (const int*)state, a, K, (float*)plog,
      (int*)ids, (float*)p, (float*)pt, (float*)ptsum, (int*)tid);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
