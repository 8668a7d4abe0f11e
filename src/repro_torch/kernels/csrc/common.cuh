// Helpers shared by the port's CUDA kernels: loads and stores in the two
// element types the kernels take (f32 and bf16), with all arithmetic in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Sum or max over the `width` lanes of a warp segment (width a power of two).
template <int width>
__device__ __forceinline__ float segment_sum(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int width>
__device__ __forceinline__ float segment_max(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

}  // namespace repro
