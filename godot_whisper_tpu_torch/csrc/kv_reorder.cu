// K8: bounded beam reorder of the merged self-KV cache.
//
// Replaces the TPU kernel `_copy_kernel` of
// godot_whisper_tpu/ops/kv_reorder.py (reached through `reorder_kv_live`):
//
//   k_out[l, j, c] = k[l, src[j], c] and v_out likewise, for every layer l,
//   row j and slot c < hi; slots c >= hi of the output are left as they
//   are (unspecified).
//
// The beam merge takes this path when the split-cache kernel (K7) does not
// fit, beam_size * n_text_head > 128.  The copy cannot run in place: row j
// may read a row that another block has already overwritten, so the output
// is a second preallocated cache pair and the decode loop swaps the two.
//
// Dead slots: the TPU kernel zero-fills the slots past hi up to the next
// 256-slot block, because its decode-attention kernels fetch whole blocks
// and multiply masked slots by exact-zero probabilities, which turns a NaN
// in uninitialised memory into a NaN output.  The port's K3 kernel
// (decode_attn.cu) reads only slots c < max(hi, max lo), and the next step
// writes slot hi before attending [0, hi + 1), so no slot >= hi is ever read
// and none is written here.  Revisit this if K3 ever reads past hi.
//
// Bound on an H100: bytes.  2 (K and V) * L * B * hi * S elements read once
// and written once; tiny.en-sized caches move a few MB, a few us at
// 3.35 TB/s.
//
// Design: slots [0, hi) of one (layer, row) are one contiguous run of
// hi * S elements, so each (layer, row) pair is a flat copy of 16-byte
// vectors with neighbouring threads on neighbouring addresses.  Grid
// (vector tiles, B, L); each block copies its tile of K and of V.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    reorder_kernel(const uint4* __restrict__ k, const uint4* __restrict__ v,
                   uint4* __restrict__ k_out, uint4* __restrict__ v_out,
                   const int* __restrict__ src, int B, long long row_vecs,
                   long long live_vecs) {
  const int j = blockIdx.y, l = blockIdx.z;
  const size_t in_base = ((size_t)l * B + src[j]) * row_vecs;
  const size_t out_base = ((size_t)l * B + j) * row_vecs;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < live_vecs; i += (long long)gridDim.x * kThreads) {
    k_out[out_base + i] = k[in_base + i];
    v_out[out_base + i] = v[in_base + i];
  }
}

}  // namespace

// Caches (L, B, C, S) of `itemsize`-byte elements; S * itemsize must be a
// multiple of 16 and the pointers 16-byte aligned.  src (B,) int32 in
// [0, B); 0 <= hi <= C.
extern "C" int gwt_reorder_kv(const void* k, const void* v, void* k_out,
                              void* v_out, const void* src, int L, int B,
                              int C, int S, int itemsize, int hi,
                              void* stream) {
  const long long row_bytes = (long long)S * itemsize;
  if (row_bytes % 16 != 0 || hi < 0 || hi > C)
    return (int)cudaErrorInvalidValue;
  const long long row_vecs = row_bytes / 16 * C;
  const long long live_vecs = row_bytes / 16 * hi;
  const long long tiles = (live_vecs + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(tiles < 1 ? 1 : (tiles > 1024 ? 1024 : tiles)),
                  B, L);
  reorder_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)k, (const uint4*)v, (uint4*)k_out, (uint4*)v_out,
      (const int*)src, B, row_vecs, live_vecs);
  return (int)cudaGetLastError();
}
