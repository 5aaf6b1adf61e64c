// Device helpers shared by the row-per-warp attention kernels of this
// package: the ragged paged-attention kernel (ragged_attention.cu) and the
// flash kernel over contiguous K/V (flash_attention.cu).
//
// Both kernels fold queries to rows of (kv head, GQA group g major, chunk
// position t minor), give each row one warp with its lanes split over the
// head dimension, and keep the online softmax in f32 registers. Each file
// holds its own kernel: the ragged kernel keeps the page loop it was tuned
// with, and a body shared between the two addressings made its decode
// launches about a third slower.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // query rows per block, one warp each

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A key or value element as the dot products see it. Storage in the
// query's type T is read as it is; an int8 element is dequantized with its
// page's scale in f32 and rounded to T before the dot, as the JAX kernel
// does ((int8 * scale).astype(q.dtype)).
template <typename T>
__device__ __forceinline__ float kv_value(T x, float) {
  return to_float(x);
}
template <typename T>
__device__ __forceinline__ float kv_value(int8_t x, float scale) {
  return to_float(from_float<T>(static_cast<float>(x) * scale));
}

// floor(a / b) for b > 0: an empty row's position is -1
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

}  // namespace
