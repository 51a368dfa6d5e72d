// LayerNorm forward over the trailing axis.
//
// Replaces the TPU kernel mxnet_tpu/ops/kernels/norm.py `_ln_fwd_kernel`
// (launched by `_ln_call`). Semantics kept: float32 statistics in two
// passes (the mean, then the mean of squared deviations, as jnp.var),
// (x - mean) * rsqrt(var + eps) * gamma + beta computed in float32 and
// written in x's dtype; gamma and beta are float32. The TPU version pads
// C to the 128-lane tile and masks the padded lanes; here the loops stop
// at C, and any C is taken.
//
// Bound on the card: bytes. Each row is read from device memory once and
// written once: (2 * rows * C * sizeof(T)) / 3.35 TB/s, 3.8 us at 4096 x
// 768 in bf16. At that size the kernel is bound by latency unless every
// row's loads are in flight at once, so (ln_fwd_warp_kernel, C up to
// ln_fwd_plan's cap):
// - one warp owns a row, held in registers as loaded (16-byte loads
//   where C and the pointers allow, else one element a lane a column
//   group); the two statistics are passes over those registers, each
//   reduced by a warp shuffle tree, with no block barrier;
// - latency is hidden by warps, not by a second row in flight:
//   __launch_bounds__ asks for the blocks an SM that the register
//   estimate allows (LnFwdCfg::MINB), and the grid is persistent (the
//   plan's blocks walk the rows warp by warp);
// - gamma and beta are read with 16-byte loads for each row's output
//   (L1 hits after the first row). Holding them in registers for all of
//   a warp's rows costs the registers of half its warps an SM, and
//   measured slower at every shape tried on the H100 (PERF.md, section
//   6).
// Wider rows (ln_fwd_block_kernel) take a block a row: the row is read
// from device memory once, kept in shared memory for the second and
// third passes when it fits the plan's cap, else re-read through L2.
//
// The launch (branch, vector width, packs a lane, threads, blocks) is
// planned in Python (ops/kernels/norm.py ln_fwd_plan), which repeats the
// register estimate of LnFwdCfg; this file checks what it is given.
#include "common.cuh"

#define LNF_WARP_THREADS 128
#define LNF_WARPS (LNF_WARP_THREADS / 32)
// the block branch keeps a row in shared memory up to this many bytes
// (norm.py LN_FWD_SMEM_CAP)
#define LNF_SMEM_CAP 65536

template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) LnfPack {
  T v[VEC];
};

// Register use of the warp branch, estimated from what a lane holds: its
// packs of the row as loaded, beside gamma and beta of one pack, the
// addresses and the sums. norm.py `_ln_fwd_blocks_per_sm` repeats this
// estimate.
template <typename T, int VEC, int NP>
struct LnFwdCfg {
  static constexpr int ROW = (NP * VEC * (int)sizeof(T) + 3) / 4;
  static constexpr int REGS = (ROW + 40 + 7) / 8 * 8;
  static constexpr int MINB_RAW = 65536 / (LNF_WARP_THREADS * REGS);
  static constexpr int MINB =
      MINB_RAW < 1 ? 1 : (MINB_RAW > 16 ? 16 : MINB_RAW);
};

// VEC floats of v from column c0 (16-byte loads where VEC allows)
template <int VEC>
__device__ __forceinline__ void lnf_load_f32(const float* __restrict__ v,
                                             int c0, float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(v + c0 + j));
      out[j] = q.x;
      out[j + 1] = q.y;
      out[j + 2] = q.z;
      out[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = __ldg(v + c0 + j);
  }
}

// Warp w of block b normalises rows b * LNF_WARPS + w, then every
// gridDim.x * LNF_WARPS rows further. Lane `lane`'s pack p holds columns
// (p * 32 + lane) * VEC ... + VEC - 1, when they lie below C.
template <typename T, int VEC, int NP>
__global__ void __launch_bounds__(LNF_WARP_THREADS,
                                  (LnFwdCfg<T, VEC, NP>::MINB))
ln_fwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ out,
                   long long rows, int C, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nw = (long long)gridDim.x * LNF_WARPS;
  for (long long row = (long long)blockIdx.x * LNF_WARPS + warp; row < rows;
       row += nw) {
    const T* xr = x + row * C;
    LnfPack<T, VEC> r[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int c0 = (p * 32 + lane) * VEC;
      if (c0 < C) r[p] = *reinterpret_cast<const LnfPack<T, VEC>*>(xr + c0);
    }
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if ((p * 32 + lane) * VEC < C) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) s += mxt_to_float(r[p].v[j]);
      }
    }
    const float mean = mxt_warp_sum(s) / C;
    float s2 = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if ((p * 32 + lane) * VEC < C) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = mxt_to_float(r[p].v[j]) - mean;
          s2 += d * d;
        }
      }
    }
    const float var = mxt_warp_sum(s2) / C;
    const float rstd = rsqrtf(var + eps);

    T* orow = out + row * C;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int c0 = (p * 32 + lane) * VEC;
      if (c0 < C) {
        float gv[VEC], bv[VEC];
        lnf_load_f32<VEC>(gamma, c0, gv);
        lnf_load_f32<VEC>(beta, c0, bv);
        LnfPack<T, VEC> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float y = (mxt_to_float(r[p].v[j]) - mean) * rstd;
          o.v[j] = mxt_from_float<T>(y * gv[j] + bv[j]);
        }
        *reinterpret_cast<LnfPack<T, VEC>*>(orow + c0) = o;
      }
    }
  }
}

// Rows wider than the warp branch takes: a block a row at a time (row =
// block, block + gridDim.x, ...). The first pass reads the row from
// device memory and, when `cached`, keeps it in shared memory, where the
// second and third passes read it; otherwise they re-read it through L2.
// Each thread reads back only what it wrote, so the row needs no barrier.
template <typename T, int VEC>
__global__ void ln_fwd_block_kernel(const T* __restrict__ x,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta,
                                    T* __restrict__ out, long long rows,
                                    int C, float eps, int cached) {
  extern __shared__ __align__(16) unsigned char lnf_row[];
  __shared__ float scratch[32];
  T* srow = reinterpret_cast<T*>(lnf_row);
  const int step = blockDim.x * VEC;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * C;
    float s = 0.f;
    for (int i = threadIdx.x * VEC; i < C; i += step) {
      const LnfPack<T, VEC> p =
          *reinterpret_cast<const LnfPack<T, VEC>*>(xr + i);
      if (cached) *reinterpret_cast<LnfPack<T, VEC>*>(srow + i) = p;
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += mxt_to_float(p.v[j]);
    }
    const float mean = mxt_block_sum(s, scratch) / C;
    const T* src = cached ? srow : xr;
    float s2 = 0.f;
    for (int i = threadIdx.x * VEC; i < C; i += step) {
      const LnfPack<T, VEC> p =
          *reinterpret_cast<const LnfPack<T, VEC>*>(src + i);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = mxt_to_float(p.v[j]) - mean;
        s2 += d * d;
      }
    }
    const float var = mxt_block_sum(s2, scratch) / C;
    const float rstd = rsqrtf(var + eps);
    T* orow = out + row * C;
    for (int i = threadIdx.x * VEC; i < C; i += step) {
      const LnfPack<T, VEC> p =
          *reinterpret_cast<const LnfPack<T, VEC>*>(src + i);
      float gv[VEC], bv[VEC];
      lnf_load_f32<VEC>(gamma, i, gv);
      lnf_load_f32<VEC>(beta, i, bv);
      LnfPack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float y = (mxt_to_float(p.v[j]) - mean) * rstd;
        o.v[j] = mxt_from_float<T>(y * gv[j] + bv[j]);
      }
      *reinterpret_cast<LnfPack<T, VEC>*>(orow + i) = o;
    }
  }
}

template <typename T, int VEC, int NP>
static int lnf_warp_launch(const void* x, const void* g, const void* b,
                           void* out, long long rows, int C, float eps,
                           int blocks, cudaStream_t s) {
  ln_fwd_warp_kernel<T, VEC, NP><<<blocks, LNF_WARP_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<T*>(out), rows, C, eps);
  return (int)cudaGetLastError();
}

// The warp branch's instance for (T, VEC, packs): 1-8 packs of 16 bytes,
// or 8, 16, 24 or 32 single elements a lane.
template <typename T, int VEC>
static int lnf_warp_dispatch(int packs, const void* x, const void* g,
                             const void* b, void* out, long long rows, int C,
                             float eps, int blocks, cudaStream_t s) {
#define LNF_W(NP_) \
  lnf_warp_launch<T, VEC, NP_>(x, g, b, out, rows, C, eps, blocks, s)
  if constexpr (VEC > 1) {
    switch (packs) {
      case 1: return LNF_W(1);
      case 2: return LNF_W(2);
      case 3: return LNF_W(3);
      case 4: return LNF_W(4);
      case 5: return LNF_W(5);
      case 6: return LNF_W(6);
      case 7: return LNF_W(7);
      case 8: return LNF_W(8);
    }
  } else {
    switch (packs) {
      case 8: return LNF_W(8);
      case 16: return LNF_W(16);
      case 24: return LNF_W(24);
      case 32: return LNF_W(32);
    }
  }
#undef LNF_W
  return (int)cudaErrorInvalidValue;
}

template <typename T, int VEC>
static int lnf_run(int packs, const void* x, const void* g,
                   const void* b, void* out, long long rows, int C,
                   float eps, int threads, int blocks, cudaStream_t s) {
  if (packs > 0) {
    if (threads != LNF_WARP_THREADS || (long long)packs * 32 * VEC < C)
      return (int)cudaErrorInvalidValue;
    return lnf_warp_dispatch<T, VEC>(packs, x, g, b, out, rows, C, eps,
                                     blocks, s);
  }
  const size_t bytes = sizeof(T) * (size_t)C;
  const int cached = bytes <= LNF_SMEM_CAP;
  const size_t smem = cached ? (bytes + 15) / 16 * 16 : 0;
  auto fn = ln_fwd_block_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory must be asked for: the
    // most any row needs, the same value from every call and host thread
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, LNF_SMEM_CAP);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<blocks, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<T*>(out), rows, C, eps,
      cached);
  return (int)cudaGetLastError();
}

// x, out: (rows, C) contiguous in `dtype`; gamma, beta: (C,) float32.
// The launch as ln_fwd_plan gives it: `vec` elements a load (1, or 4
// float32 / 8 bfloat16, which needs C % vec == 0 and 16-byte aligned x,
// out, gamma and beta), `packs` loads a lane in the warp branch (0: the
// block branch, which keeps a row of up to LNF_SMEM_CAP bytes in shared
// memory), `threads` a block and `blocks` (1 <= blocks <= rows).
MXT_API int mxt_layernorm_fwd(const void* x, const void* gamma,
                              const void* beta, void* out, long long rows,
                              int C, float eps, int dtype, int vec, int packs,
                              int threads, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || C <= 0) return 0;
  if (blocks < 1 || blocks > rows || threads < 32 || threads > 1024 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  const int wide = dtype == MXT_F32 ? 4 : 8;
  if (vec != 1 &&
      (vec != wide || C % vec || !mxt_aligned16(x) || !mxt_aligned16(out) ||
       !mxt_aligned16(gamma) || !mxt_aligned16(beta)))
    return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32) {
    return vec == 4 ? lnf_run<float, 4>(packs, x, gamma, beta, out, rows,
                                        C, eps, threads, blocks, s)
                    : lnf_run<float, 1>(packs, x, gamma, beta, out, rows,
                                        C, eps, threads, blocks, s);
  }
  if (dtype == MXT_BF16) {
    return vec == 8
               ? lnf_run<__nv_bfloat16, 8>(packs, x, gamma, beta, out,
                                           rows, C, eps, threads, blocks, s)
               : lnf_run<__nv_bfloat16, 1>(packs, x, gamma, beta, out,
                                           rows, C, eps, threads, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
