// Fused bias add + exact (erf) GELU over the trailing axis.
//
// Replaces the TPU kernel mxnet_tpu/ops/kernels/norm.py `_bg_fwd_kernel`
// (launched by `_bg_call`): z = x + b in x's dtype, then
// gelu(z) = 0.5 * z * erfc(-z / sqrt(2)) (the jax.nn.gelu exact form) in
// float32, written in x's dtype. The TPU version streams row blocks
// padded to the 128-lane tile; here one flat grid-stride loop covers the
// (rows, C) array and needs no padding.
//
// Bound on the card: bytes (x read once, out written once; the bias is
// C values that stay in L1/L2). Design: one elementwise pass, 16-byte
// vector loads and stores when C and the pointers allow them.
#include "common.cuh"

template <typename T, int VEC>
struct alignas(16) BgPack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void bias_gelu_fwd_kernel(const T* __restrict__ x,
                                     const T* __restrict__ b,
                                     T* __restrict__ out, long long n_packs,
                                     int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < n_packs; p += stride) {
    const long long i = p * VEC;
    const int c = (int)(i % C);   // VEC divides C: one pack, one row
    BgPack<T, VEC> xv = *reinterpret_cast<const BgPack<T, VEC>*>(x + i);
    BgPack<T, VEC> bv = *reinterpret_cast<const BgPack<T, VEC>*>(b + c);
    BgPack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      // the add rounds to T, as z = x + b in x's dtype
      const float z =
          mxt_to_float(mxt_from_float<T>(mxt_to_float(xv.v[j]) +
                                         mxt_to_float(bv.v[j])));
      o.v[j] = mxt_from_float<T>(0.5f * z * erfcf(-z * 0.70710678118654752f));
    }
    *reinterpret_cast<BgPack<T, VEC>*>(out + i) = o;
  }
}

template <typename T, int VEC>
static void bg_launch(const void* x, const void* b, void* out, long long n,
                      int C, cudaStream_t stream) {
  const long long n_packs = n / VEC;
  const int threads = 256;
  long long blocks = (n_packs + threads - 1) / threads;
  const long long cap = 132LL * 16;   // 16 blocks of 256 per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  bias_gelu_fwd_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<T*>(out), n_packs, C);
}

// x, out: (n / C, C) contiguous in `dtype`; b: (C,) in `dtype`.
MXT_API int mxt_bias_gelu_fwd(const void* x, const void* b, void* out,
                              long long n, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || C <= 0) return 0;
  const bool vec_ok =
      mxt_aligned16(x) && mxt_aligned16(b) && mxt_aligned16(out);
  if (dtype == MXT_F32) {
    if (vec_ok && C % 4 == 0)
      bg_launch<float, 4>(x, b, out, n, C, s);
    else
      bg_launch<float, 1>(x, b, out, n, C, s);
  } else if (dtype == MXT_BF16) {
    if (vec_ok && C % 8 == 0)
      bg_launch<__nv_bfloat16, 8>(x, b, out, n, C, s);
    else
      bg_launch<__nv_bfloat16, 1>(x, b, out, n, C, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
