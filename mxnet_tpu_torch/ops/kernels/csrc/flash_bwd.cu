// Flash-attention backward: dq, dk, dv from q, k, v, dO, lse and
// delta = rowsum(dO * O), with P = exp(s - lse) rebuilt from the scores.
//
// Replaces three TPU kernels of mxnet_tpu/ops/attention.py, all launched
// by `_flash_bwd_pallas`:
//   - `_flash_bwd_fused_kernel` (Sq <= 512 and Sk <= 512: the whole
//     sequence is one 512-block there) -> mxt_flash_bwd_fused;
//   - `_flash_bwd_dq_kernel`, q-parallel over key blocks -> mxt_flash_bwd_dq;
//   - `_flash_bwd_dkv_kernel`, k-parallel over query blocks ->
//     mxt_flash_bwd_dkv (these two for longer sequences).
// Semantics kept exactly:
//   - layout (B*H, S, D), D <= 128; lse and delta (B*H, Sq) float32,
//     computed outside the kernels as on the TPU;
//   - the causal diagonal is aligned to the end: key k is visible to
//     query q iff k <= q + (Sk - Sq);
//   - P is rounded to dO's dtype before dV += P^T dO, and
//     dS = P * (dP - delta) * scale is rounded to q/k's dtype before
//     dQ += dS K and dK += dS^T Q (no-ops in float32);
//   - the mask is applied before P enters any product: a query row with
//     no valid key has lse = -1e30, so exp(s - lse) would be inf, and
//     inf * 0 is NaN. A masked entry's P and dS are exactly 0.
//
// What has no one-to-one CUDA form: the fused TPU kernel holds a whole
// 512 x 512 P block in VMEM, which does not fit in 227 KB of shared
// memory. Here one block per (batch*head) owns dq, dk and dv of its head:
// an outer loop walks 64-key tiles and keeps that tile's dK and dV
// accumulators in registers; an inner loop walks 64-query tiles,
// rebuilds P and dS once per (q-tile, k-tile), and adds dS K into a
// float32 dq accumulator in device memory that only this block writes
// (so no atomics; for float32 it is dq itself). The dq and dkv kernels
// run the same tile step from one side each.
//
// Bound on the card: at BERT's training shape (S = 512, D = 64) the
// backward does 10 * S^2 * D flops per head (QK^T, dO V^T, P^T dO,
// dS^T Q, dS K) for 7 * S * D * sizeof(T) bytes: operations bound it by
// far. This first version is simple: float32 FMAs on CUDA cores from
// shared-memory tiles (no tensor cores, no TMA); 256 threads, four per
// tile row, each holding 16 scores and D/4 accumulators.
#include <type_traits>

#include "common.cuh"

#define BQ 64
#define BK 64
#define NTHREADS 256
#define LDP (BK + 1)   // row stride of the P and dS tiles

template <typename T>
__device__ __forceinline__ float mxt_round(float v) {
  return mxt_to_float(mxt_from_float<T>(v));
}

// rows [row0, row0 + 64) of a (n, D) tensor into a [64][ld] float tile;
// rows at or past n read as 0
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int row0, int n, int D) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NTHREADS) {
    const int row = idx / D, d = idx - row * D;
    const int g = row0 + row;
    dst[row * ld + d] = g < n ? mxt_to_float(src[(size_t)g * D + d]) : 0.f;
  }
}

// lse and delta of query rows [q0, q0 + 64); rows past Sq read as 0
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int Sq) {
  const int t = threadIdx.x;
  if (t < BQ) {
    const bool in = q0 + t < Sq;
    lse_s[t] = in ? lse[q0 + t] : 0.f;
    delta_s[t] = in ? delta[q0 + t] : 0.f;
  }
}

// True when tile (q0, k0) holds a valid causal entry (the TPU's
// `_causal_block_skip`); the same for every thread of the block
__device__ __forceinline__ bool tile_runs(int q0, int k0, int Sq, int Sk,
                                          int causal) {
  return !causal || k0 <= q0 + BQ - 1 + (Sk - Sq);
}

// One (q-tile, k-tile) step: P (rounded to T) and dS (rounded to T) into
// Ps and dSs. Thread (r = tid / 4, cg = tid % 4) does query row r and
// keys cg, cg + 4, ... of the tile.
template <typename T, int DP>
__device__ __forceinline__ void tile_p_ds(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* delta_s, float* Ps, float* dSs, int q0,
    int k0, int Sq, int Sk, int D, int causal, float scale) {
  constexpr int LD = DP + 1;
  const int r = threadIdx.x >> 2, cg = threadIdx.x & 3;
  float s[BK / 4], dp[BK / 4];
#pragma unroll
  for (int j = 0; j < BK / 4; ++j) s[j] = dp[j] = 0.f;
  const float* qrow = Qs + r * LD;
  const float* dorow = dOs + r * LD;
  for (int d = 0; d < D; ++d) {
    const float qd = qrow[d], dod = dorow[d];
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int c = cg + 4 * j;
      s[j] = fmaf(qd, Ks[c * LD + d], s[j]);
      dp[j] = fmaf(dod, Vs[c * LD + d], dp[j]);
    }
  }
  const int q_pos = q0 + r;
  const float lse = lse_s[r], delta = delta_s[r];
#pragma unroll
  for (int j = 0; j < BK / 4; ++j) {
    const int c = cg + 4 * j;
    const int k_pos = k0 + c;
    bool valid = q_pos < Sq && k_pos < Sk;
    if (causal) valid = valid && k_pos <= q_pos + (Sk - Sq);
    const float p = valid ? expf(s[j] * scale - lse) : 0.f;
    const float ds = p * (dp[j] - delta) * scale;
    Ps[r * LDP + c] = mxt_round<T>(p);
    dSs[r * LDP + c] = mxt_round<T>(ds);
  }
}

// dV += P^T dO and dK += dS^T Q for key row tid / 4, columns
// tid % 4 + 4 j of the tile
template <int DP>
__device__ __forceinline__ void accum_dkv(const float* Ps, const float* dSs,
                                          const float* Qs, const float* dOs,
                                          float* dk, float* dv, int D) {
  constexpr int LD = DP + 1;
  const int rk = threadIdx.x >> 2, cg = threadIdx.x & 3;
  for (int r = 0; r < BQ; ++r) {
    const float p = Ps[r * LDP + rk], ds = dSs[r * LDP + rk];
    const float* dorow = dOs + r * LD;
    const float* qrow = Qs + r * LD;
#pragma unroll
    for (int j = 0; j < DP / 4; ++j) {
      const int d = cg + 4 * j;
      if (d < D) {
        dv[j] = fmaf(p, dorow[d], dv[j]);
        dk[j] = fmaf(ds, qrow[d], dk[j]);
      }
    }
  }
}

// dQ += dS K for query row tid / 4, columns tid % 4 + 4 j of the tile
template <int DP>
__device__ __forceinline__ void accum_dq(const float* dSs, const float* Ks,
                                         float* dq, int D) {
  constexpr int LD = DP + 1;
  const int r = threadIdx.x >> 2, cg = threadIdx.x & 3;
  for (int c = 0; c < BK; ++c) {
    const float ds = dSs[r * LDP + c];
    const float* krow = Ks + c * LD;
#pragma unroll
    for (int j = 0; j < DP / 4; ++j) {
      const int d = cg + 4 * j;
      if (d < D) dq[j] = fmaf(ds, krow[d], dq[j]);
    }
  }
}

template <int DP>
__host__ __device__ constexpr size_t smem_floats() {
  // K, V, Q, dO tiles; P and dS tiles; lse and delta rows
  return 4 * 64 * (DP + 1) + 2 * BQ * LDP + 2 * BQ;
}

// --------------------------------------------------------------------------
// fused: one block per (batch*head)
// --------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       float* __restrict__ dq_acc, T* __restrict__ dk,
                       T* __restrict__ dv, int Sq, int Sk, int D, int causal,
                       float scale) {
  constexpr int LD = DP + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* lse_s = dSs + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const float* lse_h = lse + (size_t)bh * Sq;
  const float* delta_h = delta + (size_t)bh * Sq;
  float* acc = dq_acc + qbase;
  const int nq = (Sq + BQ - 1) / BQ, nk = (Sk + BK - 1) / BK;
  const int r = threadIdx.x >> 2, cg = threadIdx.x & 3;

  // this head's dq accumulator starts at 0; thread (r, cg) owns exactly
  // the entries it adds to below, so no barrier is needed
  for (int qt = 0; qt < nq; ++qt) {
    const int qp = qt * BQ + r;
    if (qp < Sq) {
#pragma unroll
      for (int j = 0; j < DP / 4; ++j) {
        const int d = cg + 4 * j;
        if (d < D) acc[(size_t)qp * D + d] = 0.f;
      }
    }
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's K and V are consumed
    load_tile<T>(Ks, LD, k + kbase, k0, Sk, D);
    load_tile<T>(Vs, LD, v + kbase, k0, Sk, D);
    float dkr[DP / 4], dvr[DP / 4];
#pragma unroll
    for (int j = 0; j < DP / 4; ++j) dkr[j] = dvr[j] = 0.f;

    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      if (!tile_runs(q0, k0, Sq, Sk, causal)) continue;
      __syncthreads();   // Q, dO, P and dS of the previous step consumed
      load_tile<T>(Qs, LD, q + qbase, q0, Sq, D);
      load_tile<T>(dOs, LD, dout + qbase, q0, Sq, D);
      load_rows(lse_s, delta_s, lse_h, delta_h, q0, Sq);
      __syncthreads();
      tile_p_ds<T, DP>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq,
                       Sk, D, causal, scale);
      __syncthreads();
      accum_dkv<DP>(Ps, dSs, Qs, dOs, dkr, dvr, D);
      float dqr[DP / 4];
#pragma unroll
      for (int j = 0; j < DP / 4; ++j) dqr[j] = 0.f;
      accum_dq<DP>(dSs, Ks, dqr, D);
      const int qp = q0 + r;
      if (qp < Sq) {
#pragma unroll
        for (int j = 0; j < DP / 4; ++j) {
          const int d = cg + 4 * j;
          if (d < D) acc[(size_t)qp * D + d] += dqr[j];
        }
      }
    }

    const int kp = k0 + r;
    if (kp < Sk) {
#pragma unroll
      for (int j = 0; j < DP / 4; ++j) {
        const int d = cg + 4 * j;
        if (d < D) {
          dk[kbase + (size_t)kp * D + d] = mxt_from_float<T>(dkr[j]);
          dv[kbase + (size_t)kp * D + d] = mxt_from_float<T>(dvr[j]);
        }
      }
    }
  }

  if constexpr (!std::is_same<T, float>::value) {
    for (int qt = 0; qt < nq; ++qt) {
      const int qp = qt * BQ + r;
      if (qp < Sq) {
#pragma unroll
        for (int j = 0; j < DP / 4; ++j) {
          const int d = cg + 4 * j;
          if (d < D)
            dq[qbase + (size_t)qp * D + d] =
                mxt_from_float<T>(acc[(size_t)qp * D + d]);
        }
      }
    }
  }
}

// --------------------------------------------------------------------------
// dq: one block per (batch*head, 64-query tile), looping over key tiles
// --------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int D, int causal, float scale) {
  constexpr int LD = DP + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* lse_s = dSs + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int nq = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * BQ;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const int nk = (Sk + BK - 1) / BK;
  const int r = threadIdx.x >> 2, cg = threadIdx.x & 3;

  load_tile<T>(Qs, LD, q + qbase, q0, Sq, D);
  load_tile<T>(dOs, LD, dout + qbase, q0, Sq, D);
  load_rows(lse_s, delta_s, lse + (size_t)bh * Sq, delta + (size_t)bh * Sq,
            q0, Sq);
  float dqr[DP / 4];
#pragma unroll
  for (int j = 0; j < DP / 4; ++j) dqr[j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (!tile_runs(q0, k0, Sq, Sk, causal)) break;   // later tiles too
    __syncthreads();   // the previous tile's K, V and dS are consumed
    load_tile<T>(Ks, LD, k + kbase, k0, Sk, D);
    load_tile<T>(Vs, LD, v + kbase, k0, Sk, D);
    __syncthreads();
    tile_p_ds<T, DP>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq,
                     Sk, D, causal, scale);
    __syncthreads();
    accum_dq<DP>(dSs, Ks, dqr, D);
  }

  const int qp = q0 + r;
  if (qp < Sq) {
#pragma unroll
    for (int j = 0; j < DP / 4; ++j) {
      const int d = cg + 4 * j;
      if (d < D) dq[qbase + (size_t)qp * D + d] = mxt_from_float<T>(dqr[j]);
    }
  }
}

// --------------------------------------------------------------------------
// dkv: one block per (batch*head, 64-key tile), looping over query tiles
// --------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int D, int causal,
                     float scale) {
  constexpr int LD = DP + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* lse_s = dSs + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int nk = (Sk + BK - 1) / BK;
  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * BK;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const float* lse_h = lse + (size_t)bh * Sq;
  const float* delta_h = delta + (size_t)bh * Sq;
  const int nq = (Sq + BQ - 1) / BQ;
  const int r = threadIdx.x >> 2, cg = threadIdx.x & 3;

  load_tile<T>(Ks, LD, k + kbase, k0, Sk, D);
  load_tile<T>(Vs, LD, v + kbase, k0, Sk, D);
  float dkr[DP / 4], dvr[DP / 4];
#pragma unroll
  for (int j = 0; j < DP / 4; ++j) dkr[j] = dvr[j] = 0.f;

  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    if (!tile_runs(q0, k0, Sq, Sk, causal)) continue;
    __syncthreads();   // Q, dO, P and dS of the previous step consumed
    load_tile<T>(Qs, LD, q + qbase, q0, Sq, D);
    load_tile<T>(dOs, LD, dout + qbase, q0, Sq, D);
    load_rows(lse_s, delta_s, lse_h, delta_h, q0, Sq);
    __syncthreads();
    tile_p_ds<T, DP>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq,
                     Sk, D, causal, scale);
    __syncthreads();
    accum_dkv<DP>(Ps, dSs, Qs, dOs, dkr, dvr, D);
  }

  const int kp = k0 + r;
  if (kp < Sk) {
#pragma unroll
    for (int j = 0; j < DP / 4; ++j) {
      const int d = cg + 4 * j;
      if (d < D) {
        dk[kbase + (size_t)kp * D + d] = mxt_from_float<T>(dkr[j]);
        dv[kbase + (size_t)kp * D + d] = mxt_from_float<T>(dvr[j]);
      }
    }
  }
}

// --------------------------------------------------------------------------
// launchers
// --------------------------------------------------------------------------
// above 48 KB a block's shared memory must be asked for explicitly;
// setting it again from another thread is harmless
template <typename K>
static int allow_smem(K kernel, size_t bytes, bool* configured) {
  if (*configured) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  *configured = true;
  return 0;
}

enum BwdKind { BWD_FUSED = 0, BWD_DQ = 1, BWD_DKV = 2 };

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dq_acc, *dk, *dv;
  int BH, Sq, Sk, D, causal;
  float scale;
};

template <typename T, int DP>
static int bwd_launch(int kind, const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DP>();
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  int err;
  if (kind == BWD_FUSED) {
    static bool configured = false;
    if ((err = allow_smem(flash_bwd_fused_kernel<T, DP>, smem, &configured)))
      return err;
    flash_bwd_fused_kernel<T, DP><<<a.BH, NTHREADS, smem, stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dq),
        static_cast<float*>(a.dq_acc), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.Sq, a.Sk, a.D, a.causal, a.scale);
  } else if (kind == BWD_DQ) {
    static bool configured = false;
    if ((err = allow_smem(flash_bwd_dq_kernel<T, DP>, smem, &configured)))
      return err;
    const long long blocks = (long long)a.BH * ((a.Sq + BQ - 1) / BQ);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    flash_bwd_dq_kernel<T, DP><<<(unsigned)blocks, NTHREADS, smem, stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dq), a.Sq, a.Sk, a.D,
        a.causal, a.scale);
  } else {
    static bool configured = false;
    if ((err = allow_smem(flash_bwd_dkv_kernel<T, DP>, smem, &configured)))
      return err;
    const long long blocks = (long long)a.BH * ((a.Sk + BK - 1) / BK);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    flash_bwd_dkv_kernel<T, DP><<<(unsigned)blocks, NTHREADS, smem, stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.Sq, a.Sk, a.D, a.causal, a.scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int bwd_dispatch_d(int kind, const BwdArgs& a, cudaStream_t s) {
  if (a.D <= 32) return bwd_launch<T, 32>(kind, a, s);
  if (a.D <= 64) return bwd_launch<T, 64>(kind, a, s);
  return bwd_launch<T, 128>(kind, a, s);
}

static int bwd_entry(int kind, const BwdArgs& a, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.D < 1 || a.D > 128) return (int)cudaErrorInvalidValue;
  if (a.BH <= 0 || a.Sq <= 0 || a.Sk <= 0) return 0;
  if (dtype == MXT_F32) return bwd_dispatch_d<float>(kind, a, s);
  if (dtype == MXT_BF16) return bwd_dispatch_d<__nv_bfloat16>(kind, a, s);
  return (int)cudaErrorInvalidValue;
}

// q, dout, dq: (BH, Sq, D); k, v, dk, dv: (BH, Sk, D), contiguous in
// `dtype`; lse, delta: (BH, Sq) float32; dq_acc: (BH, Sq, D) float32
// scratch (may be dq itself when dtype is float32). 1 <= D <= 128.
MXT_API int mxt_flash_bwd_fused(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* dq_acc,
                                void* dk, void* dv, int BH, int Sq, int Sk,
                                int D, int causal, float scale, int dtype,
                                void* stream) {
  BwdArgs a{q, k, v, dout, lse, delta, dq, dq_acc, dk, dv,
            BH, Sq, Sk, D, causal, scale};
  return bwd_entry(BWD_FUSED, a, dtype, stream);
}

MXT_API int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int BH, int Sq,
                             int Sk, int D, int causal, float scale,
                             int dtype, void* stream) {
  BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr,
            BH, Sq, Sk, D, causal, scale};
  return bwd_entry(BWD_DQ, a, dtype, stream);
}

MXT_API int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int BH,
                              int Sq, int Sk, int D, int causal, float scale,
                              int dtype, void* stream) {
  BwdArgs a{q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv,
            BH, Sq, Sk, D, causal, scale};
  return bwd_entry(BWD_DKV, a, dtype, stream);
}
