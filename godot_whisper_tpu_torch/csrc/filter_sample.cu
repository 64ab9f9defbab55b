// K5: fused logit filter + sampler, and K6: fused logit filter + top-K beam
// expansion.  One row of raw logits per block; both kernels run the same
// filter stage (`filter_row`), so the two cannot drift apart.
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
//   log-probs per row by K argmax passes that mask each winner (lowest index
//   on ties: the lax.top_k order) with the probability at each id.
//
// The -1e30 sentinel and the `lp > -0.5e30` tests follow the TPU kernels
// exactly; no -inf appears.  No atomics decide anything: every reduction is
// a fixed tree, so bit-identical rows give bit-identical outputs (the beam
// merge's equal-score dedupe relies on it at step 0, where all beams of a
// group share one distribution).
//
// Gumbel noise (K5): the TPU's hardware random bits cannot be reproduced,
// so the noise comes from a counter-based integer hash of (seed, row,
// column) -> 24-bit uniform u -> -log(-log(max(u, 1e-12))).  The plain
// PyTorch version computes the same hash, so kernel and plain version agree
// at t > 0 too, apart from last-ulp differences in log.
//
// Bound on an H100: bytes.  One f32 row of V logits read once (5 x 51864 x
// 4 B = 1 MB for tiny.en's 5 decoder rows, ~0.3 us at 3.35 TB/s) plus the
// shared (V,) suppress mask; outputs are a few scalars per row.
//
// Design: the whole row lives in shared memory (V = 51866 floats = 207 KB
// of the 227 KB a block may use) next to a V-bit suppression bitmap, so
// device memory is read once and every pass over the row (max, sum,
// log-probs, timestamp maxima and sums, the sample or the K top-K passes)
// runs from shared memory with 1024 threads and block-wide reductions.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

struct Params {
  int V, eot, beg, space_id, max_initial_tid, suppress_blank, no_timestamps;
  float temperature;
  uint32_t seed;
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

// The filter stage of both kernels (the TPU's `_filter_lp`).  Reads row b's
// raw logits `lg` and its state `st` (B, 7) = [is_initial, last, penult,
// n_tokens, has_ts, seek_delta, argmax_flag]; on return `row` holds the
// filtered log-probs (suppressed ids and, when the timestamp rule fires,
// every text id at -1e30) and `bits` the suppression bitmap.  Every thread
// of the block calls it; it ends on a barrier.
__device__ void filter_row(const float* __restrict__ lg,
                           const uint8_t* __restrict__ suppress,
                           const int* __restrict__ st, const Params& a,
                           float* row, uint32_t* bits, float* redv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int is_initial = st[0], last = st[1], penult = st[2];
  const int n_tokens = st[3], has_ts = st[4], seek_delta = st[5];
  const int V = a.V, beg = a.beg, eot = a.eot;
  const bool last_was_ts = n_tokens > 0 && last >= beg;
  const bool penult_was_ts = n_tokens < 2 || penult >= beg;

  // pass 1: temperature, suppression, row max.  Each warp covers 32
  // consecutive ids so one ballot builds one bitmap word.
  float mx = GWT_NEG;
  for (int base = warp * 32; base < V; base += kThreads) {
    const int j = base + lane;
    bool sup = true;
    float l = GWT_NEG;
    if (j < V) {
      l = lg[j];
      if (a.temperature > 0.f) l = l / fmaxf(a.temperature, 1e-8f);
      sup = suppress[j] != 0;
      if (a.suppress_blank && is_initial && (j == eot || j == a.space_id))
        sup = true;
      if (a.no_timestamps && j >= beg) sup = true;
      if (last_was_ts && penult_was_ts && j >= beg) sup = true;
      if (last_was_ts && !penult_was_ts && j < eot) sup = true;
      if (is_initial && j > beg + a.max_initial_tid) sup = true;
      if (has_ts && j >= beg && j < beg + seek_delta / 2) sup = true;
      if (sup) l = GWT_NEG;
      row[j] = l;
    }
    const uint32_t word = __ballot_sync(0xffffffffu, sup);
    if (lane == 0) bits[base >> 5] = word;
    mx = fmaxf(mx, l);
  }
  const float m = block_max(mx, redv);  // its barriers publish row and bits

  auto is_sup = [&](int j) { return (bits[j >> 5] >> (j & 31)) & 1u; };

  // pass 2: masked log-sum-exp
  float se = 0.f;
  for (int j = tid; j < V; j += kThreads)
    if (!is_sup(j)) se += expf(row[j] - m);
  const float lse = logf(block_sum(se, redv)) + m;

  // pass 3: log-probs in place, maxima over timestamp and text ids
  float ts_mx = GWT_NEG, text_mx = GWT_NEG;
  for (int j = tid; j < V; j += kThreads) {
    const float lp = is_sup(j) ? GWT_NEG : row[j] - lse;
    row[j] = lp;
    if (j >= beg)
      ts_mx = fmaxf(ts_mx, lp);
    else
      text_mx = fmaxf(text_mx, lp);
  }
  const float ts_m = block_max(ts_mx, redv);
  const float text_m = block_max(text_mx, redv);

  // pass 4: timestamp log-mass vs the best text token
  float ts_se = 0.f;
  for (int j = beg + tid; j < V; j += kThreads)
    if (!is_sup(j)) ts_se += expf(row[j] - ts_m);
  ts_se = block_sum(ts_se, redv);
  const float ts_lp = ts_se > 0.f ? logf(ts_se) + ts_m : GWT_NEG;
  if (ts_lp > text_m)  // block-uniform: every thread read the same sums
    for (int j = tid; j < beg; j += kThreads) row[j] = GWT_NEG;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    filter_sample_kernel(const float* __restrict__ logits,
                         const uint8_t* __restrict__ suppress,
                         const int* __restrict__ state,  // (B, 7)
                         Params a, int* __restrict__ tok_out,
                         float* __restrict__ p_out,
                         float* __restrict__ plog_out,
                         float* __restrict__ pt_out,
                         float* __restrict__ ptsum_out,
                         int* __restrict__ tid_out) {
  extern __shared__ float row[];                 // V floats
  uint32_t* bits = (uint32_t*)(row + a.V);       // ceil(V / 32) words
  __shared__ float redv[32];
  __shared__ int redi[32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int* st = state + (size_t)b * 7;
  const int V = a.V, beg = a.beg;
  filter_row(logits + (size_t)b * V, suppress, st, a, row, bits, redv);

  // sample + timestamp statistics
  const bool use_argmax = st[6] != 0;
  float best = -INFINITY, ts_best = -INFINITY, sum_ts = 0.f;
  int best_i = 0x7fffffff, ts_i = 0x7fffffff;
  for (int j = tid; j < V; j += kThreads) {
    const float lp = row[j];
    const bool live = lp > 0.5f * GWT_NEG;
    const float pr = live ? expf(lp) : 0.f;
    float score;
    if (use_argmax) {
      score = pr;
    } else if (live) {
      const uint32_t h = hash32(a.seed, (uint32_t)b, (uint32_t)j);
      const float u = (float)(h & 0xFFFFFFu) * (1.f / 16777216.f);
      score = lp - logf(-logf(fmaxf(u, 1e-12f)));
    } else {
      score = GWT_NEG;
    }
    argmax_merge(best, best_i, score, j);
    if (j >= beg) {
      sum_ts += pr;
      argmax_merge(ts_best, ts_i, pr, j);
    }
  }
  block_argmax(best, best_i, redv, redi);
  const float ptsum = block_sum(sum_ts, redv);
  block_argmax(ts_best, ts_i, redv, redi);

  if (tid == 0) {
    const int tok = best_i;
    const float lp_sel = row[tok];
    const float p_sel = lp_sel > 0.5f * GWT_NEG ? expf(lp_sel) : 0.f;
    float pt = ts_best / (ptsum + 1e-10f);
    int t_id = ts_i;
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
}

__global__ void __launch_bounds__(kThreads)
    filter_topk_kernel(const float* __restrict__ logits,
                       const uint8_t* __restrict__ suppress,
                       const int* __restrict__ state,  // (B, 7)
                       Params a, int K, float* __restrict__ plog_out,  // (B, K)
                       int* __restrict__ ids_out,                     // (B, K)
                       float* __restrict__ p_out,                     // (B, K)
                       float* __restrict__ pt_out,
                       float* __restrict__ ptsum_out,
                       int* __restrict__ tid_out) {
  extern __shared__ float row[];
  uint32_t* bits = (uint32_t*)(row + a.V);
  __shared__ float redv[32];
  __shared__ int redi[32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int V = a.V, beg = a.beg;
  filter_row(logits + (size_t)b * V, suppress, state + (size_t)b * 7, a, row,
             bits, redv);

  // pre-merge timestamp statistics of the filtered distribution
  float ts_best = -INFINITY, sum_ts = 0.f;
  int ts_i = 0x7fffffff;
  for (int j = beg + tid; j < V; j += kThreads) {
    const float lp = row[j];
    const float pr = lp > 0.5f * GWT_NEG ? expf(lp) : 0.f;
    sum_ts += pr;
    argmax_merge(ts_best, ts_i, pr, j);
  }
  const float ptsum = block_sum(sum_ts, redv);
  block_argmax(ts_best, ts_i, redv, redi);
  if (tid == 0) {
    pt_out[b] = ts_best / (ptsum + 1e-10f);
    ptsum_out[b] = ptsum;
    tid_out[b] = ts_i;
  }

  // K argmax passes over the log-probs, each winner masked to -1e30
  for (int k = 0; k < K; ++k) {
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    for (int j = tid; j < V; j += kThreads) argmax_merge(best, best_i, row[j], j);
    block_argmax(best, best_i, redv, redi);
    if (tid == 0) {
      plog_out[(size_t)b * K + k] = best;
      ids_out[(size_t)b * K + k] = best_i;
      p_out[(size_t)b * K + k] = best > 0.5f * GWT_NEG ? expf(best) : 0.f;
      row[best_i] = GWT_NEG;
    }
    __syncthreads();  // the mask is visible, and redv/redi are free again
  }
}

int set_smem(const void* kernel, int V, size_t* smem) {
  *smem = sizeof(float) * (size_t)V +
          sizeof(uint32_t) * (size_t)((V + 31) / 32 + 1);
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace

extern "C" int gwt_filter_sample(const void* logits, const void* suppress,
                                 const void* state, void* tok, void* p,
                                 void* plog, void* pt, void* ptsum, void* tid,
                                 int B, int V, int eot, int beg, int space_id,
                                 int max_initial_tid, int suppress_blank,
                                 int no_timestamps, float temperature,
                                 unsigned int seed, void* stream) {
  const Params a{V, eot, beg, space_id, max_initial_tid, suppress_blank,
                 no_timestamps, temperature, seed};
  size_t smem;
  const int err = set_smem((const void*)filter_sample_kernel, V, &smem);
  if (err != 0) return err;
  filter_sample_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)logits, (const uint8_t*)suppress, (const int*)state, a,
      (int*)tok, (float*)p, (float*)plog, (float*)pt, (float*)ptsum,
      (int*)tid);
  return (int)cudaGetLastError();
}

extern "C" int gwt_filter_topk(const void* logits, const void* suppress,
                               const void* state, void* plog, void* ids,
                               void* p, void* pt, void* ptsum, void* tid,
                               int B, int V, int K, int eot, int beg,
                               int space_id, int max_initial_tid,
                               int suppress_blank, int no_timestamps,
                               float temperature, void* stream) {
  const Params a{V, eot, beg, space_id, max_initial_tid, suppress_blank,
                 no_timestamps, temperature, 0u};
  size_t smem;
  const int err = set_smem((const void*)filter_topk_kernel, V, &smem);
  if (err != 0) return err;
  filter_topk_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)logits, (const uint8_t*)suppress, (const int*)state, a, K,
      (float*)plog, (int*)ids, (float*)p, (float*)pt, (float*)ptsum,
      (int*)tid);
  return (int)cudaGetLastError();
}
