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
// in no order, so the column sums take two passes: each block leaves one
// float32 partial of its rows' columns, and a second small kernel sums
// the partials of each column in a fixed order. No atomics, so runs on
// one card repeat bit for bit.
//
// Bound on the card: bytes. x and dy are read and dx written once
// (3 * rows * C * sizeof(T)), plus the 2 * blocks * C float32 partials.
// The kernel is bound by latency unless enough loads are in flight, so
// (ln_bwd_warp_kernel, C up to ln_bwd_plan's cap):
// - one warp owns a row: each lane holds its columns of x and dy in
//   registers (16-byte loads where C and the pointers allow, else one
//   element a lane a column group), and the four row sums are warp
//   shuffle trees, with no block barrier;
// - latency is hidden by warps, not by a prefetch: __launch_bounds__ asks
//   for the blocks an SM that the register estimate allows
//   (LnWarpCfg::MINB: 16 warps an SM at C 768), each warp's row in
//   flight while others reduce theirs. Holding the next row too (two rows
//   in flight a warp) costs the registers of 4 of those warps, and
//   measured slower on the H100 (PERF.md, section 6);
// - a lane keeps the dgamma/dbeta partials of its columns, over the rows
//   its warp walks, in registers; the block joins its warps' partials in
//   warp order in shared memory, one partial a block.
// Wider rows (ln_bwd_block_kernel) take a block a row, as the first
// version did, with the two sums of dxhat reduced together.
//
// The launch (branch, vector width, packs a lane, threads, blocks) is
// planned in Python (ops/kernels/norm.py ln_bwd_plan), which repeats the
// register estimate of LnWarpCfg; this file checks what it is given.
#include "common.cuh"

#define LN_WARP_THREADS 128
#define LN_WARPS (LN_WARP_THREADS / 32)
#define LN_COLSUM_WARPS 8

template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) LnbPack {
  T v[VEC];
};

// Register use of the warp branch, estimated from what a lane holds: a
// row of x and dy as floats once read, and the dgamma/dbeta partials of
// its NP * VEC columns, beside the addresses and sums. norm.py
// `_ln_warp_blocks_per_sm` repeats this estimate.
template <typename T, int VEC, int NP>
struct LnWarpCfg {
  static constexpr int ROW = 2 * NP * VEC;
  static constexpr int PART = 2 * NP * VEC;
  static constexpr int REGS = (ROW + PART + (VEC > 1 ? 24 : 40) + 7) / 8 * 8;
  static constexpr int MINB_RAW = 65536 / (LN_WARP_THREADS * REGS);
  static constexpr int MINB =
      MINB_RAW < 1 ? 1 : (MINB_RAW > 16 ? 16 : MINB_RAW);
};

template <typename T, int VEC, int NP>
struct LnRow {
  LnbPack<T, VEC> x[NP], dy[NP];
};

template <int VEC>
__device__ __forceinline__ void ln_gamma(const float* __restrict__ g, int c0,
                                         float (&gv)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(g + c0 + j));
      gv[j] = q.x;
      gv[j + 1] = q.y;
      gv[j + 2] = q.z;
      gv[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) gv[j] = __ldg(g + c0 + j);
  }
}

// Lane `lane`'s columns of one row: pack p holds columns
// (p * 32 + lane) * VEC ... + VEC - 1, when they lie below C.
template <typename T, int VEC, int NP>
__device__ __forceinline__ void ln_load_row(LnRow<T, VEC, NP>& r,
                                            const T* __restrict__ x,
                                            const T* __restrict__ dy,
                                            long long row, int C, int lane) {
  const T* xr = x + row * C;
  const T* dr = dy + row * C;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int c0 = (p * 32 + lane) * VEC;
    if (c0 < C) {
      r.x[p] = *reinterpret_cast<const LnbPack<T, VEC>*>(xr + c0);
      r.dy[p] = *reinterpret_cast<const LnbPack<T, VEC>*>(dr + c0);
    }
  }
}

// dx of one row from its registers, and the row's terms added to the
// lane's column partials.
template <typename T, int VEC, int NP>
__device__ __forceinline__ void ln_warp_row(const LnRow<T, VEC, NP>& r,
                                            const float* __restrict__ gamma,
                                            T* __restrict__ dx,
                                            long long row, int C, float eps,
                                            int lane, float (&dg)[NP * VEC],
                                            float (&db)[NP * VEC]) {
  float s = 0.f;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if ((p * 32 + lane) * VEC < C) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += mxt_to_float(r.x[p].v[j]);
    }
  }
  const float mean = mxt_warp_sum(s) / C;
  float s2 = 0.f;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if ((p * 32 + lane) * VEC < C) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = mxt_to_float(r.x[p].v[j]) - mean;
        s2 += d * d;
      }
    }
  }
  const float var = mxt_warp_sum(s2) / C;
  const float rstd = rsqrtf(var + eps);

  float a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int c0 = (p * 32 + lane) * VEC;
    if (c0 < C) {
      float gv[VEC];
      ln_gamma<VEC>(gamma, c0, gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = (mxt_to_float(r.x[p].v[j]) - mean) * rstd;
        const float g = mxt_to_float(r.dy[p].v[j]);
        const float dxhat = g * gv[j];
        a1 += dxhat;
        a2 += dxhat * xhat;
        dg[p * VEC + j] += g * xhat;
        db[p * VEC + j] += g;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a1 += __shfl_xor_sync(0xffffffffu, a1, o);
    a2 += __shfl_xor_sync(0xffffffffu, a2, o);
  }
  const float m1 = a1 / C, m2 = a2 / C;

  T* dxr = dx + row * C;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int c0 = (p * 32 + lane) * VEC;
    if (c0 < C) {
      float gv[VEC];
      ln_gamma<VEC>(gamma, c0, gv);
      LnbPack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = (mxt_to_float(r.x[p].v[j]) - mean) * rstd;
        const float dxhat = mxt_to_float(r.dy[p].v[j]) * gv[j];
        o.v[j] = mxt_from_float<T>(rstd * (dxhat - m1 - xhat * m2));
      }
      *reinterpret_cast<LnbPack<T, VEC>*>(dxr + c0) = o;
    }
  }
}

// Warp w of block b walks rows b * LN_WARPS + w, then every
// gridDim.x * LN_WARPS rows further; part: (gridDim.x, 2, C) float32, the
// block's dgamma then dbeta partial.
template <typename T, int VEC, int NP>
__global__ void __launch_bounds__(LN_WARP_THREADS, (LnWarpCfg<T, VEC, NP>::MINB))
ln_bwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ part, long long rows, int C,
                   float eps) {
  extern __shared__ float sjoin[];   // [2][C]: the block's partials
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nw = (long long)gridDim.x * LN_WARPS;
  float dg[NP * VEC], db[NP * VEC];
#pragma unroll
  for (int i = 0; i < NP * VEC; ++i) dg[i] = db[i] = 0.f;

  LnRow<T, VEC, NP> a;
  for (long long row = (long long)blockIdx.x * LN_WARPS + warp; row < rows;
       row += nw) {
    ln_load_row(a, x, dy, row, C, lane);
    ln_warp_row(a, gamma, dx, row, C, eps, lane, dg, db);
  }

  // the block's partial: its warps' partials added in warp order
  for (int w = 0; w < LN_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int c0 = (p * 32 + lane) * VEC;
        if (c0 < C) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const int i = p * VEC + j;
            sjoin[c0 + j] = w == 0 ? dg[i] : sjoin[c0 + j] + dg[i];
            sjoin[C + c0 + j] = w == 0 ? db[i] : sjoin[C + c0 + j] + db[i];
          }
        }
      }
    }
    __syncthreads();
  }
  float* pb = part + (size_t)blockIdx.x * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) pb[i] = sjoin[i];
}

// Both sums over the block; every thread gets them. `scratch` holds 64
// floats. Starts with a barrier so the scratch can be reused.
__device__ __forceinline__ void ln_block_sum2(float& a, float& b,
                                              float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();
  if (lane == 0) {
    scratch[warp] = a;
    scratch[32 + warp] = b;
  }
  __syncthreads();
  a = lane < nwarps ? scratch[lane] : 0.f;
  b = lane < nwarps ? scratch[32 + lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Rows wider than the warp branch takes: a block a row at a time (row =
// block, block + gridDim.x, ...), the row re-read from L1 between its
// passes, the block's column partials in shared memory.
template <typename T, int VEC>
__global__ void ln_bwd_block_kernel(const T* __restrict__ x,
                                    const float* __restrict__ gamma,
                                    const T* __restrict__ dy,
                                    T* __restrict__ dx,
                                    float* __restrict__ part, long long rows,
                                    int C, float eps) {
  extern __shared__ float sacc[];   // [2][C]: this block's column partials
  __shared__ float scratch[64];
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
      LnbPack<T, VEC> p = *reinterpret_cast<const LnbPack<T, VEC>*>(xr + i);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += mxt_to_float(p.v[j]);
    }
    const float mean = mxt_block_sum(s, scratch) / C;
    float s2 = 0.f;
    for (int i = threadIdx.x * VEC; i < C; i += step) {
      LnbPack<T, VEC> p = *reinterpret_cast<const LnbPack<T, VEC>*>(xr + i);
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
      LnbPack<T, VEC> px = *reinterpret_cast<const LnbPack<T, VEC>*>(xr + i);
      LnbPack<T, VEC> pg = *reinterpret_cast<const LnbPack<T, VEC>*>(dyr + i);
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
    ln_block_sum2(a1, a2, scratch);
    const float m1 = a1 / C, m2 = a2 / C;

    for (int i = threadIdx.x * VEC; i < C; i += step) {
      LnbPack<T, VEC> px = *reinterpret_cast<const LnbPack<T, VEC>*>(xr + i);
      LnbPack<T, VEC> pg = *reinterpret_cast<const LnbPack<T, VEC>*>(dyr + i);
      LnbPack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = (mxt_to_float(px.v[j]) - mean) * rstd;
        const float dxhat = mxt_to_float(pg.v[j]) * gamma[i + j];
        o.v[j] = mxt_from_float<T>(rstd * (dxhat - m1 - xhat * m2));
      }
      *reinterpret_cast<LnbPack<T, VEC>*>(dxr + i) = o;
    }
  }

  float* pb = part + (size_t)blockIdx.x * 2 * C;
  for (int i = threadIdx.x * VEC; i < C; i += step) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      pb[i + j] = sg[i + j];
      pb[C + i + j] = sb[i + j];
    }
  }
}

// dgamma[c] and dbeta[c] from the nparts partials (nparts, 2, C): warp w
// of a block adds the partials w, w + LN_COLSUM_WARPS, ... of its 32
// columns, then the warps' sums are added in warp order. A fixed order,
// so a card repeats bit for bit.
__global__ void ln_bwd_colsum_kernel(const float* __restrict__ part,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int nparts,
                                     int C) {
  __shared__ float red[LN_COLSUM_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;     // of the 2 * C columns
  float s = 0.f;
  if (col < 2 * C) {
#pragma unroll 4
    for (int p = w; p < nparts; p += LN_COLSUM_WARPS)
      s += part[(size_t)p * 2 * C + col];
  }
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && col < 2 * C) {
    float t = red[0][lane];
#pragma unroll
    for (int k = 1; k < LN_COLSUM_WARPS; ++k) t += red[k][lane];
    if (col < C)
      dgamma[col] = t;
    else
      dbeta[col - C] = t;
  }
}

// widest C (norm.py LN_BWD_MAX_C): a block's partials, 2 * C floats
#define LN_MAX_C 16384

// Above 48 KB a block's dynamic shared memory must be asked for: the most
// any C needs, the same value from every call and host thread.
template <typename K>
static int ln_smem_attr(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * 2 * LN_MAX_C));
}

template <typename T, int VEC, int NP>
static int ln_warp_launch(const void* x, const void* g, const void* dy,
                          void* dx, void* part, long long rows, int C,
                          float eps, int blocks, cudaStream_t s) {
  const size_t smem = sizeof(float) * 2 * (size_t)C;
  auto fn = ln_bwd_warp_kernel<T, VEC, NP>;
  int e = ln_smem_attr(fn, smem);
  if (e) return e;
  fn<<<blocks, LN_WARP_THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(part), rows, C, eps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int ln_block_launch(const void* x, const void* g, const void* dy,
                           void* dx, void* part, long long rows, int C,
                           float eps, int threads, int blocks,
                           cudaStream_t s) {
  const size_t smem = sizeof(float) * 2 * (size_t)C;
  auto fn = ln_bwd_block_kernel<T, VEC>;
  int e = ln_smem_attr(fn, smem);
  if (e) return e;
  fn<<<blocks, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(part), rows, C, eps);
  return (int)cudaGetLastError();
}

// The warp branch's instance for (T, VEC, packs): 1-8 packs of 16 bytes,
// or 8, 16, 24 or 32 single elements a lane.
template <typename T, int VEC>
static int ln_warp_dispatch(int packs, const void* x, const void* g,
                            const void* dy, void* dx, void* part,
                            long long rows, int C, float eps, int blocks,
                            cudaStream_t s) {
#define LN_W(NP_) \
  ln_warp_launch<T, VEC, NP_>(x, g, dy, dx, part, rows, C, eps, blocks, s)
  if constexpr (VEC > 1) {
    switch (packs) {
      case 1: return LN_W(1);
      case 2: return LN_W(2);
      case 3: return LN_W(3);
      case 4: return LN_W(4);
      case 5: return LN_W(5);
      case 6: return LN_W(6);
      case 7: return LN_W(7);
      case 8: return LN_W(8);
    }
  } else {
    switch (packs) {
      case 8: return LN_W(8);
      case 16: return LN_W(16);
      case 24: return LN_W(24);
      case 32: return LN_W(32);
    }
  }
#undef LN_W
  return (int)cudaErrorInvalidValue;
}

template <typename T, int VEC>
static int ln_bwd_run(int packs, const void* x, const void* g,
                      const void* dy, void* dx, void* part, long long rows,
                      int C, float eps, int threads, int blocks,
                      cudaStream_t s) {
  if (packs > 0) {
    if (threads != LN_WARP_THREADS || (long long)packs * 32 * VEC < C)
      return (int)cudaErrorInvalidValue;
    return ln_warp_dispatch<T, VEC>(packs, x, g, dy, dx, part, rows, C, eps,
                                    blocks, s);
  }
  return ln_block_launch<T, VEC>(x, g, dy, dx, part, rows, C, eps, threads,
                                 blocks, s);
}

// x, dy, dx: (rows, C) contiguous in `dtype`; gamma: (C,) float32;
// part: (blocks, 2, C) float32 scratch; dgamma, dbeta: (C,) float32.
// The launch as ln_bwd_plan gives it: `vec` elements a load (1, or 4
// float32 / 8 bfloat16, which needs C % vec == 0 and 16-byte aligned x,
// dy, dx and gamma), `packs` loads a lane in the warp branch (0: the
// block branch), `threads` a block and `blocks` (1 <= blocks <= rows).
MXT_API int mxt_layernorm_bwd(const void* x, const void* gamma,
                              const void* dy, void* dx, void* part,
                              void* dgamma, void* dbeta, long long rows,
                              int C, float eps, int dtype, int vec,
                              int packs, int threads, int blocks,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || C <= 0) return 0;
  if (C > LN_MAX_C || blocks < 1 || blocks > rows || threads < 32 || threads > 1024 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  const int wide = dtype == MXT_F32 ? 4 : 8;
  if (vec != 1 &&
      (vec != wide || C % vec || !mxt_aligned16(x) || !mxt_aligned16(dy) ||
       !mxt_aligned16(dx) || !mxt_aligned16(gamma)))
    return (int)cudaErrorInvalidValue;
  int err;
  if (dtype == MXT_F32) {
    err = vec == 4 ? ln_bwd_run<float, 4>(packs, x, gamma, dy, dx, part,
                                          rows, C, eps, threads, blocks, s)
                   : ln_bwd_run<float, 1>(packs, x, gamma, dy, dx, part,
                                          rows, C, eps, threads, blocks, s);
  } else if (dtype == MXT_BF16) {
    err = vec == 8
              ? ln_bwd_run<__nv_bfloat16, 8>(packs, x, gamma, dy, dx, part,
                                             rows, C, eps, threads, blocks, s)
              : ln_bwd_run<__nv_bfloat16, 1>(packs, x, gamma, dy, dx, part,
                                             rows, C, eps, threads, blocks,
                                             s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  ln_bwd_colsum_kernel<<<(2 * C + 31) / 32, 32 * LN_COLSUM_WARPS, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), blocks, C);
  return (int)cudaGetLastError();
}
