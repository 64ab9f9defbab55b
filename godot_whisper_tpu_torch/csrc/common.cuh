// Shared helpers of the port's CUDA kernels: dtype conversion and
// warp reductions.  Every kernel source includes this file and
// exports plain C entry points that return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The JAX package's masking sentinel: finite, so exp(s - m) on a masked
// slot underflows to exactly 0 and no inf - inf NaN can appear.
#define GWT_NEG (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch does
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Keep the larger value; on a tie keep the LOWER index (jnp.argmax and
// torch.argmax both return the first maximal index).
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2,
                                             int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}
