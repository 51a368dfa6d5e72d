// LayerNorm forward over the trailing axis.
//
// Replaces the TPU kernel mxnet_tpu/ops/kernels/norm.py `_ln_fwd_kernel`
// (launched by `_ln_call`). Semantics kept: float32 statistics in two
// passes (the mean, then the mean of squared deviations, as jnp.var),
// (x - mean) * rsqrt(var + eps) * gamma + beta computed in float32 and
// written in x's dtype. The TPU version pads C to the 128-lane tile and
// masks the padded lanes; here the loop simply stops at C.
//
// Bound on the card: bytes. Each row is read from device memory once
// (the second and third passes hit L1/L2: a row is a few KB) and written
// once, so the least time is (2 * rows * C * sizeof(T)) / 3.35 TB/s.
// Design: one block per row; 16-byte vector loads when C and the
// pointers allow them; block reductions by warp shuffles.
#include "common.cuh"

template <typename T, int VEC>
struct alignas(16) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              T* __restrict__ out, int C, float eps) {
  __shared__ float scratch[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * C;
  T* orow = out + row * C;
  const int step = blockDim.x * VEC;

  float s = 0.f;
  for (int i = threadIdx.x * VEC; i < C; i += step) {
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
#pragma unroll
    for (int j = 0; j < VEC; ++j) s += mxt_to_float(p.v[j]);
  }
  const float mean = mxt_block_sum(s, scratch) / C;

  float s2 = 0.f;
  for (int i = threadIdx.x * VEC; i < C; i += step) {
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = mxt_to_float(p.v[j]) - mean;
      s2 += d * d;
    }
  }
  const float var = mxt_block_sum(s2, scratch) / C;
  const float rstd = rsqrtf(var + eps);

  for (int i = threadIdx.x * VEC; i < C; i += step) {
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float y = (mxt_to_float(p.v[j]) - mean) * rstd;
      o.v[j] = mxt_from_float<T>(y * gamma[i + j] + beta[i + j]);
    }
    *reinterpret_cast<Pack<T, VEC>*>(orow + i) = o;
  }
}

template <typename T, int VEC>
static void ln_launch(const void* x, const void* g, const void* b, void* out,
                      long long rows, int C, float eps, cudaStream_t stream) {
  int per_row = (C + VEC - 1) / VEC;
  int threads = ((per_row + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  ln_fwd_kernel<T, VEC><<<(unsigned)rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<T*>(out), C, eps);
}

// x, out: (rows, C) contiguous in `dtype`; gamma, beta: (C,) float32.
MXT_API int mxt_layernorm_fwd(const void* x, const void* gamma,
                              const void* beta, void* out, long long rows,
                              int C, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || C <= 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec_ok = mxt_aligned16(x) && mxt_aligned16(out);
  if (dtype == MXT_F32) {
    if (vec_ok && C % 4 == 0)
      ln_launch<float, 4>(x, gamma, beta, out, rows, C, eps, s);
    else
      ln_launch<float, 1>(x, gamma, beta, out, rows, C, eps, s);
  } else if (dtype == MXT_BF16) {
    if (vec_ok && C % 8 == 0)
      ln_launch<__nv_bfloat16, 8>(x, gamma, beta, out, rows, C, eps, s);
    else
      ln_launch<__nv_bfloat16, 1>(x, gamma, beta, out, rows, C, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
