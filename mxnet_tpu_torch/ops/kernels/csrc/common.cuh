// Shared helpers of the kernel library: the plain C interface's dtype
// codes, float <-> storage conversions, and warp/block reductions.
//
// Every C entry point takes raw device pointers, sizes, a dtype code and
// the cudaStream_t to launch on, launches, and returns the value of
// cudaGetLastError() (0 on success), so the Python wrapper can raise on
// a refused launch. Kernels allocate nothing and never synchronise.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MXT_API extern "C" __attribute__((visibility("default")))

// dtype codes shared with ops/kernels/__init__.py (DTYPE_CODES)
enum MxtDtype { MXT_F32 = 0, MXT_BF16 = 1 };

// the finite mask value of every attention path (ops/attention.py)
#define MXT_NEG_INF (-1e30f)

__device__ __forceinline__ float mxt_to_float(float v) { return v; }
__device__ __forceinline__ float mxt_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T mxt_from_float(float v);
template <>
__device__ __forceinline__ float mxt_from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 mxt_from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float mxt_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the whole block; every thread gets the result. `scratch`
// holds at least 32 floats of shared memory. Starts and ends with a
// barrier so the scratch can be reused by the next call.
__device__ __forceinline__ float mxt_block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = mxt_warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? scratch[lane] : 0.f;
  t = mxt_warp_sum(t);
  return t;
}

static inline bool mxt_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}
