// LayerNorm backward over the trailing axis: dx, dgamma, dbeta.
//
// Replaces the TPU kernel mxnet_tpu/ops/kernels/norm.py `_ln_bwd_kernel`
// (launched by `_ln_call` with `bwd_dy`). Semantics kept: mean and var
// recomputed from x with the forward's two-pass float32 recipe (the mean,
// then the mean of squared deviations), xhat = (x - mean) * rstd,
// dxhat = dy * gamma, dx = rstd * (dxhat - mean(dxhat) - xhat *
// mean(dxhat * xhat)) in float32 written in x's dtype; dgamma = sum over
// rows of dy * xhat and dbeta = sum over rows of dy, in float32.
//
// What has no CUDA counterpart: the TPU kernel carries dgamma and dbeta
// in VMEM across a sequential ("arbitrary") grid axis. Blocks here run
// in no order, so the column sums take two passes: each of `nparts`
// blocks walks its rows (row = block, block + nparts, ...) and keeps its
// own float32 column partials in shared memory, written once at the end;
// a second small kernel sums the partials of each column in block order.
// No atomics, so runs on one card repeat bit for bit.
//
// Bound on the card: bytes. x and dy are read and dx written once
// (3 * rows * C * sizeof(T)), plus the 2 * nparts * C float32 partials.
// Design: one block per row at a time, 16-byte vector loads when C and
// the pointers allow them (else a scalar path for any C), block
// reductions by warp shuffles; the row is re-read from L1 rather than
// held.
#include "common.cuh"

template <typename T, int VEC>
struct alignas(16) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void ln_bwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const T* __restrict__ dy, T* __restrict__ dx,
                              float* __restrict__ dg_part,
                              float* __restrict__ db_part, long long rows,
                              int C, float eps) {
  extern __shared__ float sacc[];   // [2][C]: this block's column partials
  __shared__ float scratch[32];
  float* sg = sacc;
  float* sb = sacc + C;
  const int step = blockDim.x * VEC;
  // each thread reads and writes only its own columns of sg and sb
  for (int i = threadIdx.x * VEC; i < C; i += step) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) sg[i + j] = sb[i + j] = 0.f;
  }

  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * C;
    const T* dyr = dy + row * C;
    T* dxr = dx + row * C;

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

    float a1 = 0.f, a2 = 0.f;
    for (int i = threadIdx.x * VEC; i < C; i += step) {
      Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
      Pack<T, VEC> pg = *reinterpret_cast<const Pack<T, VEC>*>(dyr + i);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = (mxt_to_float(px.v[j]) - mean) * rstd;
        const float g = mxt_to_float(pg.v[j]);
        const float dxhat = g * gamma[i + j];
        a1 += dxhat;
        a2 += dxhat * xhat;
        sg[i + j] += g * xhat;
        sb[i + j] += g;
      }
    }
    const float m1 = mxt_block_sum(a1, scratch) / C;
    const float m2 = mxt_block_sum(a2, scratch) / C;

    for (int i = threadIdx.x * VEC; i < C; i += step) {
      Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
      Pack<T, VEC> pg = *reinterpret_cast<const Pack<T, VEC>*>(dyr + i);
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = (mxt_to_float(px.v[j]) - mean) * rstd;
        const float dxhat = mxt_to_float(pg.v[j]) * gamma[i + j];
        o.v[j] = mxt_from_float<T>(rstd * (dxhat - m1 - xhat * m2));
      }
      *reinterpret_cast<Pack<T, VEC>*>(dxr + i) = o;
    }
  }

  float* pg = dg_part + (size_t)blockIdx.x * C;
  float* pb = db_part + (size_t)blockIdx.x * C;
  for (int i = threadIdx.x * VEC; i < C; i += step) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      pg[i + j] = sg[i + j];
      pb[i + j] = sb[i + j];
    }
  }
}

// dgamma[c] and dbeta[c]: the nparts partials of column c, summed in
// block order
__global__ void ln_bwd_colsum_kernel(const float* __restrict__ dg_part,
                                     const float* __restrict__ db_part,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int nparts,
                                     int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sg = 0.f, sb = 0.f;
  for (int p = 0; p < nparts; ++p) {
    sg += dg_part[(size_t)p * C + c];
    sb += db_part[(size_t)p * C + c];
  }
  dgamma[c] = sg;
  dbeta[c] = sb;
}

template <typename T, int VEC>
static int ln_bwd_launch(const void* x, const void* g, const void* dy,
                         void* dx, void* dg_part, void* db_part,
                         long long rows, int C, int nparts, float eps,
                         cudaStream_t stream) {
  int per_row = (C + VEC - 1) / VEC;
  int threads = ((per_row + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  const size_t smem = sizeof(float) * 2 * (size_t)C;
  if (smem > 48 * 1024) {
    // above 48 KB a block's shared memory must be asked for explicitly
    static bool configured = false;
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          ln_bwd_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
  }
  ln_bwd_kernel<T, VEC><<<nparts, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dg_part), static_cast<float*>(db_part), rows, C,
      eps);
  return (int)cudaGetLastError();
}

// x, dy, dx: (rows, C) contiguous in `dtype`; gamma: (C,) float32;
// dg_part, db_part: (nparts, C) float32 scratch, 1 <= nparts <= rows;
// dgamma, dbeta: (C,) float32. C * 8 bytes must fit in shared memory.
MXT_API int mxt_layernorm_bwd(const void* x, const void* gamma,
                              const void* dy, void* dx, void* dg_part,
                              void* db_part, void* dgamma, void* dbeta,
                              long long rows, int C, int nparts, float eps,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || C <= 0) return 0;
  if (nparts < 1 || nparts > rows) return (int)cudaErrorInvalidValue;
  const bool vec_ok = mxt_aligned16(x) && mxt_aligned16(dy) &&
                      mxt_aligned16(dx);
  int err;
  if (dtype == MXT_F32) {
    err = (vec_ok && C % 4 == 0)
              ? ln_bwd_launch<float, 4>(x, gamma, dy, dx, dg_part, db_part,
                                        rows, C, nparts, eps, s)
              : ln_bwd_launch<float, 1>(x, gamma, dy, dx, dg_part, db_part,
                                        rows, C, nparts, eps, s);
  } else if (dtype == MXT_BF16) {
    err = (vec_ok && C % 8 == 0)
              ? ln_bwd_launch<__nv_bfloat16, 8>(x, gamma, dy, dx, dg_part,
                                                db_part, rows, C, nparts,
                                                eps, s)
              : ln_bwd_launch<__nv_bfloat16, 1>(x, gamma, dy, dx, dg_part,
                                                db_part, rows, C, nparts,
                                                eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  ln_bwd_colsum_kernel<<<(C + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(dg_part), static_cast<const float*>(db_part),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), nparts, C);
  return (int)cudaGetLastError();
}
