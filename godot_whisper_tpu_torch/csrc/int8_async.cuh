// Helpers the int8 kernels share (qmatmul.cu: K9/K10; cross_attn.cu:
// K11/K12): exact int8 -> float / bf16 conversion by byte permutes,
// cp.async copies into shared memory, the two halves of a thread-block-
// cluster barrier, and mma.sync m16n8k16 on bf16 with f32 sums.
#pragma once

#include "common.cuh"

namespace gwt_q8 {

// The four int8 of a word as exact floats, without an I2F: the float with
// bits 0x4B0000(b ^ 0x80) is 2^23 + b + 128 (one byte permute), minus
// 2^23 + 128.
__device__ __forceinline__ void i8x4_f32(uint32_t u, float (&f)[4]) {
  const uint32_t t = u ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(t, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(t, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(t, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(t, 0x4B000000u, 0x7543)) - 8388736.f;
}

// Two floats that are exact in bf16 (an int8 value has 8 significant bits)
// as a bf16x2, a in the low half: their upper 16 bits.
__device__ __forceinline__ uint32_t bf16x2_exact(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// 16 bytes into shared memory; src_bytes 0 writes zeros (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The two halves of a cluster barrier: every CTA arrives on entry and
// waits before its first store into another CTA's shared memory, which
// then exists (all CTAs of the cluster have started).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// c += a b: A 16 x 16 (row), B 16 x 8 (col) bf16 fragments, f32 c.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace gwt_q8
