// Fused flash-attention backward: dq, dk and dv in one C entry, for
// sequences up to 512 (the whole sequence is one 512-block on the TPU).
//
// Replaces mxnet_tpu/ops/attention.py `_flash_bwd_fused_kernel` (its
// `pallas_call` in `_flash_bwd_pallas`). Semantics kept exactly, as in
// flash_bwd.cu's dq and dkv kernels:
//   - layout (B*H, S, D), D <= 128; lse and delta = rowsum(dO * O) are
//     (B*H, Sq) float32, computed outside the kernel as on the TPU;
//   - the causal diagonal is aligned to the end: key k is visible to
//     query q iff k <= q + (Sk - Sq);
//   - the mask is applied before P enters a product (a row with no valid
//     key has lse = -1e30, so it gives 0, not inf * 0);
//   - P is rounded to the input dtype before dV += P^T dO, and
//     dS = P (dP - delta) scale before dQ += dS K and dK += dS^T Q (no-ops
//     in float32).
//
// Bound on the card at BERT-base training's shape (B*H 384, S 512, D 64,
// float32): five products of 64^3 per (64-query, 64-key) tile pair, 64.4
// GFLOP, 0.96 ms at 67 TFLOP/s; its bytes (7 S D values a head) take
// 0.06 ms. Operations bound it.
//
// Design for the H100's CUDA cores (TF32 stays off: it would not hold
// float32's 1e-4 tolerance):
//   - A k-parallel grid: one block per (batch*head, 64-key tile), 3,072
//     blocks at that shape (the first version had one block per head,
//     384 blocks in 1.45 waves). The block stages its K and V tile once,
//     then walks the 32-query tiles that can see it (whole tiles above the
//     causal diagonal are skipped), loading the next tile's Q, dO, lse and
//     delta into registers while it computes the current one. 79 KB of
//     shared memory at D 64, so two blocks (16 warps) share an SM.
//   - Register-tiled products. S = Q K^T (warps 0-3) and dP = dO V^T
//     (warps 4-7) run side by side, 4 x 4 outputs a thread, operands read
//     as float4 along the depth from row-major tiles (one 16-byte load
//     feeds 4 FMAs of each of 4 outputs). dV += P^T dO (warps 0-3) and
//     dK += dS^T Q (warps 4-7) are outer products over the 32 queries,
//     4 x 8 a thread at D 64, held in registers across the walk. dS K,
//     dQ's partial, is an outer product over the 64 keys from a transposed
//     copy of dS, 4 x 2 a thread at D 64. Each warp covers a 2-D patch of
//     outputs, so a load instruction reads one wavefront of distinct words
//     and broadcasts the rest. The first version did about one
//     shared-memory load per FMA. (Tried on the card and slower: each
//     thread computing both S and dP at 2 x 4 entries, which saves the
//     exchange of P and two of the four barriers a step; a double-buffered
//     Q and dO tile, which saves one.) The loops over the depth, the
//     queries and the keys are unrolled in full.
//   - dq by atomics: each block adds its partial dQ of each query tile to
//     a float32 accumulator zeroed in this entry (cudaMemsetAsync), with
//     Hopper's vector atomics (`atomicAdd` of a float2, or a float4 at
//     D 128: one `red.global.add.v2/v4.f32`) where D allows, in place of
//     the first version's read-modify-write of each head's dq once per
//     (key tile, query tile). For float32 the accumulator is dq itself;
//     for bfloat16 a cast kernel in this entry writes dq.
// The atomic adds arrive in an order that changes from run to run, so dq
// repeats only within float32 rounding of its partial sums, one per
// 64-key tile (well inside 1e-4 + 1e-4 |ref|); dk and dv repeat bit for
// bit.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBQ = 32;         // query rows a step
constexpr int kBK = 64;         // key rows a block
constexpr int kThreads = 256;
constexpr int kLDP = kBK + 4;   // row stride of the P and dS tiles
constexpr int kLDT = kBQ + 4;   // row stride of the transposed dS tile

template <typename T>
__device__ __forceinline__ float fb_round(float v) {
  return mxt_to_float(mxt_from_float<T>(v));
}

// four consecutive elements of a row, as loaded (converted to float only
// when stored, so a prefetch's loads stay in flight across the compute)
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  float4 v;
};
template <>
struct Raw4<__nv_bfloat16> {
  uint2 v;
};

// elements [0, n) of p (n in 0..4), zeros after; one 16-byte (float) or
// 8-byte (bfloat16) load when `vec` and n == 4
__device__ __forceinline__ void load4(Raw4<float>& r, const float* p, int n,
                                      bool vec) {
  if (vec && n == 4) {
    r.v = *reinterpret_cast<const float4*>(p);
  } else {
    r.v.x = n > 0 ? p[0] : 0.f;
    r.v.y = n > 1 ? p[1] : 0.f;
    r.v.z = n > 2 ? p[2] : 0.f;
    r.v.w = n > 3 ? p[3] : 0.f;
  }
}
__device__ __forceinline__ void load4(Raw4<__nv_bfloat16>& r,
                                      const __nv_bfloat16* p, int n,
                                      bool vec) {
  if (vec && n == 4) {
    r.v = *reinterpret_cast<const uint2*>(p);
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
    const unsigned a = n > 0 ? s[0] : 0u, b = n > 1 ? s[1] : 0u;
    const unsigned c = n > 2 ? s[2] : 0u, d = n > 3 ? s[3] : 0u;
    r.v.x = a | (b << 16);
    r.v.y = c | (d << 16);
  }
}
__device__ __forceinline__ float4 to_float4(const Raw4<float>& r) {
  return r.v;
}
__device__ __forceinline__ float4 to_float4(const Raw4<__nv_bfloat16>& r) {
  return make_float4(__uint_as_float(r.v.x << 16),
                     __uint_as_float(r.v.x & 0xffff0000u),
                     __uint_as_float(r.v.y << 16),
                     __uint_as_float(r.v.y & 0xffff0000u));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int DP>
struct Geo {
  static constexpr int LD = DP + 4;                 // Q, dO, K, V tiles
  static constexpr int QCH = kBQ * DP / 4 / kThreads;   // chunks a thread
  static constexpr int KCH = kBK * DP / 4 / kThreads;
  static constexpr int NJ = DP / 32;                // dK/dV float4s a row
  static constexpr int DC = DP / 32;                // dQ columns a thread
  static constexpr size_t smem_floats =
      2 * (size_t)kBK * LD + 2 * (size_t)kBQ * LD + 2 * (size_t)kBQ * kLDP +
      (size_t)kBK * kLDT + 2 * kBQ;
};

// Rows [row0, row0 + ROWS) of a (n, D) tensor, this thread's CH chunks of
// four elements; rows at or past n and columns at or past D read as 0.
template <typename T, int DP, int ROWS, int CH>
__device__ __forceinline__ void load_tile(Raw4<T> (&r)[CH], const T* src,
                                          int row0, int n, int D, bool vec) {
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const int ci = threadIdx.x + kThreads * m;
    const int row = ci / (DP / 4), d = 4 * (ci % (DP / 4));
    const int g = row0 + row;
    const int nv = g < n ? min(4, max(0, D - d)) : 0;
    load4(r[m], src + (size_t)(nv > 0 ? g : 0) * D + (nv > 0 ? d : 0), nv,
          vec);
  }
}

template <typename T, int DP, int CH>
__device__ __forceinline__ void store_tile(float* dst, const Raw4<T> (&r)[CH]) {
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const int ci = threadIdx.x + kThreads * m;
    const int row = ci / (DP / 4), d = 4 * (ci % (DP / 4));
    *reinterpret_cast<float4*>(dst + row * Geo<DP>::LD + d) = to_float4(r[m]);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1)
flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq_acc, T* __restrict__ dk,
                       T* __restrict__ dv, int Sq, int Sk, int D, int causal,
                       float scale, int vec) {
  using G = Geo<DP>;
  constexpr int LD = G::LD;
  extern __shared__ float4 smem_v[];
  float* Ks = reinterpret_cast<float*>(smem_v);
  float* Vs = Ks + kBK * LD;
  float* Qs = Vs + kBK * LD;
  float* dOs = Qs + kBQ * LD;
  float* Ps = dOs + kBQ * LD;
  float* dSs = Ps + kBQ * kLDP;
  float* dSt = dSs + kBQ * kLDP;   // [key][query]
  float* rows_s = dSt + kBK * kLDT;   // lse [0, 32), delta [32, 64)

  const int nk = (Sk + kBK - 1) / kBK, nq = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * kBK;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const float* lse_h = lse + (size_t)bh * Sq;
  const float* delta_h = delta + (size_t)bh * Sq;
  const int tid = threadIdx.x;
  const bool vecb = vec != 0;

  // the first query tile that sees this key tile (`_causal_block_skip`);
  // every later one does too
  int qt = 0;
  if (causal) {
    const int lo = k0 - (Sk - Sq) - kBQ + 1;
    qt = lo > 0 ? (lo + kBQ - 1) / kBQ : 0;
  }

  Raw4<T> rq[G::QCH], rdo[G::QCH];
  float rowv = 0.f;
  auto prefetch = [&](int t) {
    const int q0 = t * kBQ;
    load_tile<T, DP, kBQ, G::QCH>(rq, q + qbase, q0, Sq, D, vecb);
    load_tile<T, DP, kBQ, G::QCH>(rdo, dout + qbase, q0, Sq, D, vecb);
    if (tid < 2 * kBQ) {
      const int row = q0 + (tid & (kBQ - 1));
      rowv = row < Sq ? (tid < kBQ ? lse_h[row] : delta_h[row]) : 0.f;
    }
  };
  if (qt < nq) prefetch(qt);
  {
    Raw4<T> rk[G::KCH], rv[G::KCH];
    load_tile<T, DP, kBK, G::KCH>(rk, k + kbase, k0, Sk, D, vecb);
    load_tile<T, DP, kBK, G::KCH>(rv, v + kbase, k0, Sk, D, vecb);
    store_tile<T, DP, G::KCH>(Ks, rk);
    store_tile<T, DP, G::KCH>(Vs, rv);
  }

  const int u = tid & 127, lane = tid & 31, wq = u >> 5;
  const bool upper = tid >= 128;   // warps 4-7: dP and dK; 0-3: S and dV
  // Each warp covers a 2-D patch of a product's outputs, so that one
  // shared-memory load instruction reads few distinct 16-byte words (one
  // wavefront) and the rest are broadcasts.
  // phase A: rows rg + 8 i, keys cg + 16 j of the 32 x 64 tile; a warp
  // takes 4 rg x 8 cg
  const int rg = (wq >> 1) * 4 + (lane >> 3), cg = (wq & 1) * 8 + (lane & 7);
  // phase B: keys c0 .. c0 + 3, columns 4 dgB + 32 j (+ 0..3); a warp
  // takes 8 key groups x 4 column groups
  const int c0 = 4 * ((wq & 1) * 8 + (lane & 7));
  const int dgB = (wq >> 1) * 4 + (lane >> 3);
  // phase E: query rows 4 rgE .. 4 rgE + 3, columns DC dgE .. + DC - 1; a
  // warp takes 4 row groups x 8 column groups
  const int rgE = (tid >> 7) * 4 + (lane >> 3);
  const int dgE = ((tid >> 5) & 3) * 8 + (lane & 7);

  float kv[4][G::NJ][4];   // dV (warps 0-3) or dK (warps 4-7)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[i][j][e] = 0.f;

  for (; qt < nq; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();   // the previous step's tiles are consumed
    store_tile<T, DP, G::QCH>(Qs, rq);
    store_tile<T, DP, G::QCH>(dOs, rdo);
    if (tid < 2 * kBQ) rows_s[tid] = rowv;
    __syncthreads();
    if (qt + 1 < nq) prefetch(qt + 1);

    // phase A: S = Q K^T (warps 0-3), dP = dO V^T (warps 4-7)
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    {
      const float* A = upper ? dOs : Qs;
      const float* B = upper ? Vs : Ks;
#pragma unroll
      for (int d = 0; d < DP; d += 4) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(B + (cg + 16 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a =
              *reinterpret_cast<const float4*>(A + (rg + 8 * i) * LD + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot4(a, b[j], acc[i][j]);
        }
      }
    }
    // P: masked before it enters any product; rounded to T for dV, kept
    // unrounded for dS (in dS's tile until dS overwrites it)
    float* p_raw = std::is_same<T, float>::value ? Ps : dSs;
    if (!upper) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 8 * i, qp = q0 + r;
        const float l = rows_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg + 16 * j, kp = k0 + c;
          bool valid = qp < Sq && kp < Sk;
          if (causal) valid = valid && kp <= qp + (Sk - Sq);
          const float p = valid ? expf(acc[i][j] * scale - l) : 0.f;
          Ps[r * kLDP + c] = fb_round<T>(p);
          if (!std::is_same<T, float>::value) dSs[r * kLDP + c] = p;
        }
      }
    }
    __syncthreads();
    if (upper) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 8 * i;
        const float dl = rows_s[kBQ + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg + 16 * j;
          const float ds =
              fb_round<T>(p_raw[r * kLDP + c] * (acc[i][j] - dl) * scale);
          dSs[r * kLDP + c] = ds;
          dSt[c * kLDT + r] = ds;
        }
      }
    }
    __syncthreads();

    // phase B: dV += P^T dO (warps 0-3), dK += dS^T Q (warps 4-7)
    {
      const float* A = upper ? dSs : Ps;
      const float* B = upper ? Qs : dOs;
#pragma unroll
      for (int r = 0; r < kBQ; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(A + r * kLDP + c0);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int j = 0; j < G::NJ; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(
              B + r * LD + 4 * dgB + 32 * j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kv[i][j][0] = fmaf(av[i], b.x, kv[i][j][0]);
            kv[i][j][1] = fmaf(av[i], b.y, kv[i][j][1]);
            kv[i][j][2] = fmaf(av[i], b.z, kv[i][j][2]);
            kv[i][j][3] = fmaf(av[i], b.w, kv[i][j][3]);
          }
        }
      }
    }

    // phase E: dQ's partial dS K, added to the float32 accumulator
    {
      constexpr int DC = G::DC;
      float dqp[4][DC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DC; ++e) dqp[i][e] = 0.f;
      const int r0 = 4 * rgE, d0 = DC * dgE;
#pragma unroll
      for (int c = 0; c < kBK; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(dSt + c * kLDT + r0);
        const float av[4] = {a.x, a.y, a.z, a.w};
        float bv[DC];
        const float* bp = Ks + c * LD + d0;
        if constexpr (DC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(bp);
          bv[0] = t.x;
          bv[1] = t.y;
          bv[2] = t.z;
          bv[3] = t.w;
        } else if constexpr (DC == 2) {
          const float2 t = *reinterpret_cast<const float2*>(bp);
          bv[0] = t.x;
          bv[1] = t.y;
        } else {
          bv[0] = bp[0];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < DC; ++e) dqp[i][e] = fmaf(av[i], bv[e], dqp[i][e]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + r0 + i;
        if (qp >= Sq || d0 >= D) continue;
        float* dst = dq_acc + qbase + (size_t)qp * D + d0;
        if (vecb && d0 + DC <= D) {
          if constexpr (DC == 4) {
            atomicAdd(reinterpret_cast<float4*>(dst),
                      make_float4(dqp[i][0], dqp[i][1], dqp[i][2], dqp[i][3]));
          } else if constexpr (DC == 2) {
            atomicAdd(reinterpret_cast<float2*>(dst),
                      make_float2(dqp[i][0], dqp[i][1]));
          } else {
            atomicAdd(dst, dqp[i][0]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < DC; ++e)
            if (d0 + e < D) atomicAdd(dst + e, dqp[i][e]);
        }
      }
    }
  }

  // this key tile's dK or dV rows
  T* out = upper ? dk : dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + c0 + i;
    if (kp >= Sk) continue;
#pragma unroll
    for (int j = 0; j < G::NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * dgB + 32 * j + e;
        if (d < D)
          out[kbase + (size_t)kp * D + d] = mxt_from_float<T>(kv[i][j][e]);
      }
    }
  }
}

template <typename T>
__global__ void flash_bwd_dq_cast_kernel(const float* __restrict__ acc,
                                         T* __restrict__ dq, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dq[i] = mxt_from_float<T>(acc[i]);
}

struct FusedArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dq_acc, *dk, *dv;
  int BH, Sq, Sk, D, causal;
  float scale;
};

template <typename T, int DP>
int fused_launch(const FusedArgs& a, cudaStream_t s) {
  const size_t smem = sizeof(float) * Geo<DP>::smem_floats;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_fused_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;   // setting it again from another thread is harmless
  }
  const size_t n = (size_t)a.BH * a.Sq * a.D;
  cudaError_t e = cudaMemsetAsync(a.dq_acc, 0, n * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)a.BH * ((a.Sk + kBK - 1) / kBK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // 16-byte loads of four elements (8-byte for bfloat16) and float4 atomics
  // where every row starts aligned
  const uintptr_t mask = sizeof(T) == 4 ? 15u : 7u;
  const bool vec =
      a.D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
        reinterpret_cast<uintptr_t>(a.v) |
        reinterpret_cast<uintptr_t>(a.dout)) & mask) == 0 &&
      mxt_aligned16(a.dq_acc);
  flash_bwd_fused_kernel<T, DP><<<(unsigned)blocks, kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq_acc), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Sq, a.Sk, a.D, a.causal, a.scale,
      vec ? 1 : 0);
  if (!std::is_same<T, float>::value) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const size_t want = (n + 255) / 256;
    const unsigned grid = (unsigned)(want < 4096 ? want : 4096);
    flash_bwd_dq_cast_kernel<T><<<grid, 256, 0, s>>>(
        static_cast<const float*>(a.dq_acc), static_cast<T*>(a.dq), n);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int fused_dispatch_d(const FusedArgs& a, cudaStream_t s) {
  if (a.D <= 32) return fused_launch<T, 32>(a, s);
  if (a.D <= 64) return fused_launch<T, 64>(a, s);
  return fused_launch<T, 128>(a, s);
}

}  // namespace

// q, dout, dq: (BH, Sq, D); k, v, dk, dv: (BH, Sk, D), contiguous in
// `dtype`; lse, delta: (BH, Sq) float32; dq_acc: (BH, Sq, D) float32
// scratch, zeroed here (dq itself when dtype is float32). 1 <= D <= 128.
MXT_API int mxt_flash_bwd_fused(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* dq_acc,
                                void* dk, void* dv, int BH, int Sq, int Sk,
                                int D, int causal, float scale, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (dtype == MXT_F32 && dq_acc != dq) return (int)cudaErrorInvalidValue;
  FusedArgs a{q, k, v, dout, lse, delta, dq, dq_acc, dk, dv,
              BH, Sq, Sk, D, causal, scale};
  if (dtype == MXT_F32) return fused_dispatch_d<float>(a, s);
  if (dtype == MXT_BF16) return fused_dispatch_d<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
