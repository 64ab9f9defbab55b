// K5: fused logit filter + sampler, one row of raw logits per block.
//
// Replaces the TPU kernel `_kernel` with its filter stage `_filter_lp`
// (godot_whisper_tpu/ops/filter_sample.py, reached through
// `fused_filter_sample`): temperature scaling; the suppression rules
// (static mask, blank at start, no_timestamps, timestamp pairing, initial
// timestamp cap, monotonic timestamps); the masked log-softmax; the
// "timestamp mass beats the best text token" rule; then argmax over the
// probabilities (lowest index on ties, as jnp.argmax) or Gumbel-max
// sampling chosen per row by state column 6; and the timestamp statistics
// (pt, ptsum, tid) of whisper_sample_token.  The -1e30 sentinel and the
// `lp > -0.5e30` tests follow the TPU kernel exactly; no -inf appears.
//
// Gumbel noise: the TPU's hardware random bits cannot be reproduced, so
// the noise comes from a counter-based integer hash of (seed, row, column)
// -> 24-bit uniform u -> -log(-log(max(u, 1e-12))).  The plain PyTorch
// version computes the same hash, so kernel and plain version agree at
// t > 0 too, apart from last-ulp differences in log.
//
// Bound on an H100: bytes.  One f32 row of V logits read once (5 x 51864 x
// 4 B = 1 MB for tiny.en's 5 decoder rows, ~0.3 us at 3.35 TB/s) plus the
// shared (V,) suppress mask; outputs are 6 scalars per row.
//
// Design: the whole row lives in shared memory (V = 51866 floats = 207 KB
// of the 227 KB a block may use) next to a V-bit suppression bitmap, so
// device memory is read once and the ~6 passes over the row (max, sum,
// log-probs, timestamp maxima, timestamp sum, final argmaxes) run from
// shared memory with 1024 threads and block-wide reductions.
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
  const int lane = tid & 31, warp = tid >> 5;
  const int* st = state + (size_t)b * 7;
  const int is_initial = st[0], last = st[1], penult = st[2];
  const int n_tokens = st[3], has_ts = st[4], seek_delta = st[5];
  const int argmax_flag = st[6];
  const int V = a.V, beg = a.beg, eot = a.eot;
  const float* lg = logits + (size_t)b * V;

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
  const bool force_ts = ts_lp > text_m;

  // pass 5: sample + timestamp statistics
  const bool use_argmax = argmax_flag != 0;
  float best = -INFINITY, ts_best = -INFINITY, sum_ts = 0.f;
  int best_i = 0x7fffffff, ts_i = 0x7fffffff;
  for (int j = tid; j < V; j += kThreads) {
    float lp = row[j];
    if (force_ts && j < beg) {
      lp = GWT_NEG;
      row[j] = lp;
    }
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
  const size_t smem = sizeof(float) * (size_t)V +
                      sizeof(uint32_t) * (size_t)((V + 31) / 32 + 1);
  cudaError_t err = cudaFuncSetAttribute(
      filter_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  filter_sample_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)logits, (const uint8_t*)suppress, (const int*)state, a,
      (int*)tok, (float*)p, (float*)plog, (float*)pt, (float*)ptsum,
      (int*)tid);
  return (int)cudaGetLastError();
}
