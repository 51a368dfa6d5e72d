// Backward of the fused bias add + exact (erf) GELU: dx and db.
//
// Replaces the TPU kernel mxnet_tpu/ops/kernels/norm.py `_bg_bwd_kernel`
// (launched by `_bg_call` with `bwd_dy`). Semantics kept: z = x + b in
// x's dtype, then in float32 dx = dy * (Phi(z) + z * phi(z)) with
// Phi(z) = 0.5 * (1 + erf(z / sqrt(2))) and phi(z) = exp(-z*z/2) /
// sqrt(2*pi), written in x's dtype; db = the float32 column sums of the
// unrounded dx.
//
// What has no CUDA counterpart: the TPU kernel carries db in VMEM across
// a sequential ("arbitrary") grid axis. As in layernorm_bwd.cu, the
// column sums take two passes here: each of `nparts` blocks walks its
// rows (row = block, block + nparts, ...) and keeps its float32 column
// partials in shared memory, written once at the end; a second small
// kernel sums the partials of each column in block order. No atomics, so
// runs on one card repeat bit for bit.
//
// Bound on the card: bytes. x and dy are read and dx written once
// (3 * rows * C * sizeof(T)), plus the nparts * C float32 partials.
// Design: one block per row at a time, 16-byte vector loads when C and
// the pointers allow them (else a scalar path for any C).
#include "common.cuh"

template <typename T, int VEC>
struct alignas(16) BgbPack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void bias_gelu_bwd_kernel(const T* __restrict__ x,
                                     const T* __restrict__ b,
                                     const T* __restrict__ dy,
                                     T* __restrict__ dx,
                                     float* __restrict__ db_part,
                                     long long rows, int C) {
  extern __shared__ float sdb[];   // [C]: this block's column partials
  const int step = blockDim.x * VEC;
  for (int i = threadIdx.x * VEC; i < C; i += step) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) sdb[i + j] = 0.f;
  }
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * C;
    const T* dyr = dy + row * C;
    T* dxr = dx + row * C;
    for (int i = threadIdx.x * VEC; i < C; i += step) {
      BgbPack<T, VEC> px = *reinterpret_cast<const BgbPack<T, VEC>*>(xr + i);
      BgbPack<T, VEC> pb = *reinterpret_cast<const BgbPack<T, VEC>*>(b + i);
      BgbPack<T, VEC> pg = *reinterpret_cast<const BgbPack<T, VEC>*>(dyr + i);
      BgbPack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        // the add rounds to T, as z = x + b in x's dtype
        const float z = mxt_to_float(mxt_from_float<T>(
            mxt_to_float(px.v[j]) + mxt_to_float(pb.v[j])));
        const float phi = expf(-0.5f * z * z) * 0.3989422804014327f;
        const float cdf = 0.5f * (1.0f + erff(z / 1.4142135623730951f));
        const float d = mxt_to_float(pg.v[j]) * (cdf + z * phi);
        o.v[j] = mxt_from_float<T>(d);
        sdb[i + j] += d;
      }
      *reinterpret_cast<BgbPack<T, VEC>*>(dxr + i) = o;
    }
  }
  float* pb = db_part + (size_t)blockIdx.x * C;
  for (int i = threadIdx.x * VEC; i < C; i += step) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) pb[i + j] = sdb[i + j];
  }
}

// db[c]: the nparts partials of column c, summed in block order
__global__ void bias_gelu_bwd_colsum_kernel(const float* __restrict__ db_part,
                                            float* __restrict__ db,
                                            int nparts, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += db_part[(size_t)p * C + c];
  db[c] = s;
}

template <typename T, int VEC>
static int bgb_launch(const void* x, const void* b, const void* dy, void* dx,
                      void* db_part, long long rows, int C, int nparts,
                      cudaStream_t stream) {
  int per_row = (C + VEC - 1) / VEC;
  int threads = ((per_row + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  const size_t smem = sizeof(float) * (size_t)C;
  if (smem > 48 * 1024) {
    // above 48 KB a block's shared memory must be asked for explicitly
    static size_t configured = 0;
    if (smem > configured) {
      cudaError_t e = cudaFuncSetAttribute(
          bias_gelu_bwd_kernel<T, VEC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      configured = smem;
    }
  }
  bias_gelu_bwd_kernel<T, VEC><<<nparts, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(db_part), rows, C);
  return (int)cudaGetLastError();
}

// x, dy, dx: (rows, C) contiguous in `dtype`; b: (C,) in `dtype`;
// db_part: (nparts, C) float32 scratch, 1 <= nparts <= rows; db: (C,)
// float32. C * 4 bytes must fit in shared memory.
MXT_API int mxt_bias_gelu_bwd(const void* x, const void* b, const void* dy,
                              void* dx, void* db_part, void* db,
                              long long rows, int C, int nparts, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || C <= 0) return 0;
  if (nparts < 1 || nparts > rows) return (int)cudaErrorInvalidValue;
  const bool vec_ok = mxt_aligned16(x) && mxt_aligned16(b) &&
                      mxt_aligned16(dy) && mxt_aligned16(dx);
  int err;
  if (dtype == MXT_F32) {
    err = (vec_ok && C % 4 == 0)
              ? bgb_launch<float, 4>(x, b, dy, dx, db_part, rows, C, nparts,
                                     s)
              : bgb_launch<float, 1>(x, b, dy, dx, db_part, rows, C, nparts,
                                     s);
  } else if (dtype == MXT_BF16) {
    err = (vec_ok && C % 8 == 0)
              ? bgb_launch<__nv_bfloat16, 8>(x, b, dy, dx, db_part, rows, C,
                                             nparts, s)
              : bgb_launch<__nv_bfloat16, 1>(x, b, dy, dx, db_part, rows, C,
                                             nparts, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  bias_gelu_bwd_colsum_kernel<<<(C + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(db_part), static_cast<float*>(db), nparts, C);
  return (int)cudaGetLastError();
}
