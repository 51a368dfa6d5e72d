// Flash-attention backward for long sequences: dq and dk, dv from q, k,
// v, dO, lse and delta = rowsum(dO * O), with P = exp(s - lse) rebuilt
// from the scores.
//
// Replaces two TPU kernels of mxnet_tpu/ops/attention.py, launched by
// `_flash_bwd_pallas` when Sq or Sk exceeds 512:
//   - `_flash_bwd_dq_kernel`, q-parallel over key blocks -> mxt_flash_bwd_dq;
//   - `_flash_bwd_dkv_kernel`, k-parallel over query blocks ->
//     mxt_flash_bwd_dkv.
// The third, `_flash_bwd_fused_kernel` (Sq and Sk <= 512), is
// flash_bwd_fused.cu.
// Semantics kept exactly:
//   - layout (B*H, S, D), any 1 <= D <= 128, Sq != Sk allowed; lse and
//     delta (B*H, Sq) float32, computed outside the kernels as on the TPU;
//   - the causal diagonal is aligned to the end: key k is visible to
//     query q iff k <= q + (Sk - Sq); whole tiles above it are skipped
//     (`_causal_block_skip`);
//   - P is rounded to dO's dtype before dV += P^T dO, and
//     dS = P * (dP - delta) * scale is rounded to q/k's dtype before
//     dQ += dS K and dK += dS^T Q (no-ops in float32);
//   - the mask is applied before P enters any product: a query row with
//     no valid key has lse = -1e30, so exp(s - lse) would be inf, and
//     inf * 0 is NaN. A masked entry's P and dS are exactly 0.
// Each output has one owner and no atomics are used, so dq, dk and dv
// repeat bit for bit from run to run.
//
// Bound on the card at the long-sequence training shape (B*H 24, S 1024,
// D 64): dq does 3 products of S^2 D per head (QK^T, dO V^T, dS K), 0.144
// ms at 67 TFLOP/s float32; dkv 4 (QK^T, dO V^T, P^T dO, dS^T Q), 0.192
// ms. Their bytes (q, k, v, dO, lse and delta read once, the gradients
// written once) take ~0.01 ms: operations bound both.
//
// float32, on CUDA cores (TF32 would not hold float32's 1e-4), 256
// threads, the products register-tiled as in flash_bwd_fused.cu: S = Q K^T
// (warps 0-3) and dP = dO V^T (warps 4-7) side by side over a 32-query x
// 64-key tile pair, 4 x 4 outputs a thread from float4 operands along the
// depth, each warp a 2-D patch so that a load instruction reads one
// wavefront and broadcasts the rest; P goes to the dP warps through
// shared memory.
//   - dq: one block per (batch*head, 32-query tile) walks the 64-key
//     tiles, K and V double-buffered through 16-byte cp.async (zero-filled
//     past Sk and D; plain loads where D or a pointer is not 16-byte
//     aligned), so the next tile's copies fly during the products. dQ +=
//     dS K is an outer product from a transposed dS tile, each half of the
//     block over half of the tile's keys, 4 rows x D/16 columns a thread,
//     held in registers for the walk; the halves' sums meet once at the
//     end, in a fixed order (twice the FMAs a loaded value of 4 rows x
//     D/32 columns over all 64 keys, and 7 % faster than it).
//     105 KB of shared memory at D 64, 2 blocks an SM: 768 blocks at that
//     shape, 2.91 waves of 264, the last 91 % full.
//   - dkv: one block per (batch*head, 64-key tile) keeps K and V in shared
//     memory and walks the 32-query tiles; the next tile's Q, dO, lse and
//     delta are loaded into registers once this tile's P and dS are
//     written, so they fly during dV += P^T dO (warps 0-3) and dK += dS^T Q
//     (warps 4-7), outer products over the 32 queries, 4 keys x D/8
//     columns a thread held for the walk. 70 KB at D 64, 3 blocks an SM:
//     the 384 blocks at that shape fit one wave of 396 (at the 80
//     registers this leaves, ptxas spills 236 bytes; 2 blocks an SM with
//     no spill ran 1 % slower).
// bfloat16, on tensor cores: mma.sync.m16n8k16 (bf16 operands, float32
// sums), 128 threads, 64-row blocks walking 64-row tiles double-buffered
// through cp.async, each warp 16 rows of the block; D not a multiple of
// 16 is zero-padded in shared memory. The walked tile is taken 16 rows at
// a time, so the two score products' accumulators feed the next product
// as its A fragment straight from registers.
//   - dq: S and dP are accumulator fragments (Q and dO as A fragments held
//     for the walk, K and V as B fragments by ldmatrix); dS, rounded to
//     bf16, is the A fragment of dS K, with K the B operand through
//     ldmatrix.trans. 55 KB at D 64; registers for 3 blocks an SM (a cap
//     of 128 for 4 spilled and ran 2 % slower): one wave.
//   - dkv: the transposed scores S^T = K Q^T and dP^T = V dO^T, so P^T and
//     dS^T are already the A fragments of P^T dO and dS^T Q (dO and Q
//     through ldmatrix.trans); lse and delta are read per column from
//     shared memory, prefetched by cp.async with the tile. K and V's
//     fragments are held for the walk at D <= 64 (10 % faster than
//     reloading them, though ptxas spills 20 bytes). 56 KB at D 64, 3
//     blocks an SM: one wave.
// mxt_flash_bwd_plan reports each kernel's tile, threads, shared memory,
// blocks an SM and blocks for a shape.
#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFT = 256;        // threads of a block
constexpr int kFQ = 32;         // query rows of a tile
constexpr int kFK = 64;         // keys of a tile
constexpr int kLDP = kFK + 8;   // row stride of the P and dS tiles
constexpr int kLDT = kFQ + 4;   // row stride of the transposed dS tile

template <int DP>
struct F32Geo {
  static constexpr int LD = DP + 4;                 // Q, dO, K, V tiles
  static constexpr int DC = DP / 16;                // dq columns a thread
  static constexpr int NJ = DP / 32;                // dk/dv float4s a thread
  static constexpr int QCH = kFQ * DP / 4 / kFT;    // prefetched float4s
  static constexpr size_t dq_floats =
      2 * (size_t)kFQ * LD + 4 * (size_t)kFK * LD + (size_t)kFQ * kLDP +
      (size_t)kFK * kLDT + 2 * kFQ;
  static constexpr size_t dkv_floats = 2 * (size_t)kFK * LD +
                                       2 * (size_t)kFQ * LD +
                                       2 * (size_t)kFQ * kLDP + 2 * kFQ;
};

// S = Q K^T (A = Q, B = K) or dP = dO V^T (A = dO, B = V) of a 32 x 64
// tile pair: query rows rg + 8 i, keys cg + 16 j
template <int DP>
__device__ __forceinline__ void f32_scores(float (&acc)[4][4], const float* A,
                                           const float* B, int rg, int cg) {
  constexpr int LD = F32Geo<DP>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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

// P = exp(s scale - lse) where visible, else exactly 0, into Ps
__device__ __forceinline__ void f32_store_p(const float (&acc)[4][4],
                                            float* Ps, const float* lse_s,
                                            int rg, int cg, int q0, int k0,
                                            int Sq, int Sk, int causal,
                                            float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 8 * i;
    const float l = lse_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cg + 16 * j;
      Ps[r * kLDP + c] = visible(q0 + r, k0 + c, Sq, Sk, causal)
                             ? expf(acc[i][j] * scale - l)
                             : 0.f;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kFT, DP <= 64 ? 2 : 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int Sq, int Sk, int D,
                        int causal, float scale, int vec) {
  using G = F32Geo<DP>;
  constexpr int LD = G::LD, DC = G::DC;
  static_assert(kFQ * kLDP + kFK * kLDT >= kFQ * DP,
                "the dq halves meet in the P and dS^T tiles");
  extern __shared__ float4 smem_v[];
  float* Qs = reinterpret_cast<float*>(smem_v);
  float* dOs = Qs + kFQ * LD;
  float* Ks = dOs + kFQ * LD;       // [2][kFK][LD]
  float* Vs = Ks + 2 * kFK * LD;    // [2][kFK][LD]
  float* Ps = Vs + 2 * kFK * LD;    // [kFQ][kLDP]
  float* dSt = Ps + kFQ * kLDP;     // [kFK][kLDT]: dS transposed
  float* lse_s = dSt + kFK * kLDT;
  float* delta_s = lse_s + kFQ;

  const int nq = (Sq + kFQ - 1) / kFQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * kFQ;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const int tid = threadIdx.x, lane = tid & 31, wq = (tid & 127) >> 5;
  const bool upper = tid >= 128;   // warps 4-7: dP and dS; 0-3: S and P
  const bool vb = vec != 0;
  // scores: rows rg + 8 i, keys cg + 16 j; a warp takes 4 rg x 8 cg
  const int rg = (wq >> 1) * 4 + (lane >> 3), cg = (wq & 1) * 8 + (lane & 7);
  // dQ: each half of the block sums half of every tile's keys (the
  // lower 0-31, the upper 32-63) into rows r0 .. r0 + 3 and columns d0 ..
  // d0 + DC - 1; a warp takes 4 row groups x 8 column groups
  const int r0 = 4 * ((wq & 1) * 4 + (lane >> 3));
  const int d0 = DC * ((wq >> 1) * 8 + (lane & 7));
  const int c_half = upper ? kFK / 2 : 0;
  const int nk = key_tiles(q0, kFQ, kFK, Sq, Sk, causal);

  if (nk > 0) {
    load_tile<float, kFQ, DP, LD, kFT>(Qs, q + qbase, q0, Sq, D, vb);
    load_tile<float, kFQ, DP, LD, kFT>(dOs, dout + qbase, q0, Sq, D, vb);
    load_tile<float, kFK, DP, LD, kFT>(Ks, k + kbase, 0, Sk, D, vb);
    load_tile<float, kFK, DP, LD, kFT>(Vs, v + kbase, 0, Sk, D, vb);
    cp_async_commit();
    if (tid < kFQ) {
      const bool in = q0 + tid < Sq;
      lse_s[tid] = in ? lse[(size_t)bh * Sq + q0 + tid] : 0.f;
      delta_s[tid] = in ? delta[(size_t)bh * Sq + q0 + tid] : 0.f;
    }
  }

  float dqa[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DC; ++e) dqa[i][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1, k0 = kt * kFK;
    cp_async_wait_all();
    __syncthreads();   // tile kt is in; everyone is done with tile kt - 1
    if (kt + 1 < nk) {
      load_tile<float, kFK, DP, LD, kFT>(Ks + (buf ^ 1) * kFK * LD,
                                         k + kbase, k0 + kFK, Sk, D, vb);
      load_tile<float, kFK, DP, LD, kFT>(Vs + (buf ^ 1) * kFK * LD,
                                         v + kbase, k0 + kFK, Sk, D, vb);
      cp_async_commit();
    }
    const float* Kb = Ks + buf * kFK * LD;
    const float* Vb = Vs + buf * kFK * LD;

    float acc[4][4];
    f32_scores<DP>(acc, upper ? dOs : Qs, upper ? Vb : Kb, rg, cg);
    if (!upper)
      f32_store_p(acc, Ps, lse_s, rg, cg, q0, k0, Sq, Sk, causal, scale);
    __syncthreads();
    if (upper) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 8 * i;
        const float dl = delta_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg + 16 * j;
          dSt[c * kLDT + r] = Ps[r * kLDP + c] * (acc[i][j] - dl) * scale;
        }
      }
    }
    __syncthreads();

    // dQ += dS K over this half's 32 keys of the tile
#pragma unroll
    for (int c = c_half; c < c_half + kFK / 2; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(dSt + c * kLDT + r0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[DC];
      const float* bp = Kb + c * LD + d0;
      if constexpr (DC == 2) {
        const float2 t = *reinterpret_cast<const float2*>(bp);
        bv[0] = t.x;
        bv[1] = t.y;
      } else {
#pragma unroll
        for (int e = 0; e < DC; e += 4) {
          const float4 t = *reinterpret_cast<const float4*>(bp + e);
          bv[e] = t.x;
          bv[e + 1] = t.y;
          bv[e + 2] = t.z;
          bv[e + 3] = t.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DC; ++e) dqa[i][e] = fmaf(av[i], bv[e], dqa[i][e]);
    }
  }

  // the upper half's sums join the lower half's through the P and dS^T
  // tiles (kFQ x DP floats), always in that order
  float* part = Ps;
  __syncthreads();   // the last tile's dS^T is consumed
  if (upper) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < DC; ++e) part[(r0 + i) * DP + d0 + e] = dqa[i][e];
  }
  __syncthreads();
  if (upper) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + r0 + i;
    if (qp >= Sq) continue;
#pragma unroll
    for (int e = 0; e < DC; ++e)
      if (d0 + e < D)
        dq[qbase + (size_t)qp * D + d0 + e] =
            dqa[i][e] + part[(r0 + i) * DP + d0 + e];
  }
}

// elements [0, n) of p (n in 0..4), zeros after; one 16-byte load when
// `vec` and n == 4
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec && n == 4) return *reinterpret_cast<const float4*>(p);
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f,
                     n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
}

template <int DP>
__global__ void __launch_bounds__(kFT, DP <= 64 ? 3 : 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int Sq, int Sk, int D, int causal, float scale,
                         int vec) {
  using G = F32Geo<DP>;
  constexpr int LD = G::LD, QCH = G::QCH;
  extern __shared__ float4 smem_v[];
  float* Ks = reinterpret_cast<float*>(smem_v);
  float* Vs = Ks + kFK * LD;
  float* Qs = Vs + kFK * LD;
  float* dOs = Qs + kFQ * LD;
  float* Ps = dOs + kFQ * LD;      // [kFQ][kLDP]
  float* dSs = Ps + kFQ * kLDP;    // [kFQ][kLDP]
  float* rows_s = dSs + kFQ * kLDP;   // lse [0, 32), delta [32, 64)

  const int nk = (Sk + kFK - 1) / kFK, nq = (Sq + kFQ - 1) / kFQ;
  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * kFK;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const float* lse_h = lse + (size_t)bh * Sq;
  const float* delta_h = delta + (size_t)bh * Sq;
  const int tid = threadIdx.x, lane = tid & 31, wq = (tid & 127) >> 5;
  const bool upper = tid >= 128;   // warps 4-7: dP, dS, dK; 0-3: S, P, dV
  const bool vb = vec != 0;
  const int rg = (wq >> 1) * 4 + (lane >> 3), cg = (wq & 1) * 8 + (lane & 7);
  // dK/dV: keys c0 .. c0 + 3, columns 4 dg + 32 j (+ 0..3); a warp takes
  // 8 key groups x 4 column groups
  const int c0 = 4 * ((wq & 1) * 8 + (lane & 7));
  const int dg = (wq >> 1) * 4 + (lane >> 3);

  int qt = first_query_tile(k0, kFQ, Sq, Sk, causal);
  float4 rq[QCH], rdo[QCH];
  float rowv = 0.f;
  auto prefetch = [&](int t) {
    const int q0 = t * kFQ;
#pragma unroll
    for (int m = 0; m < QCH; ++m) {
      const int ci = tid + kFT * m;
      const int row = ci / (DP / 4), d = 4 * (ci % (DP / 4));
      const int g = q0 + row;
      const int n = g < Sq ? min(4, max(0, D - d)) : 0;
      const size_t off = n > 0 ? (size_t)g * D + d : 0;
      rq[m] = load4(q + qbase + off, n, vb);
      rdo[m] = load4(dout + qbase + off, n, vb);
    }
    if (tid < 2 * kFQ) {
      const int row = q0 + (tid & (kFQ - 1));
      rowv = row < Sq ? (tid < kFQ ? lse_h[row] : delta_h[row]) : 0.f;
    }
  };
  if (qt < nq) prefetch(qt);
  load_tile<float, kFK, DP, LD, kFT>(Ks, k + kbase, k0, Sk, D, vb);
  load_tile<float, kFK, DP, LD, kFT>(Vs, v + kbase, k0, Sk, D, vb);
  cp_async_commit();

  float kv[4][G::NJ][4];   // dV (warps 0-3) or dK (warps 4-7)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[i][j][e] = 0.f;

  for (; qt < nq; ++qt) {
    const int q0 = qt * kFQ;
    __syncthreads();   // the previous step's tiles are consumed
#pragma unroll
    for (int m = 0; m < QCH; ++m) {
      const int ci = tid + kFT * m;
      const int row = ci / (DP / 4), d = 4 * (ci % (DP / 4));
      *reinterpret_cast<float4*>(Qs + row * LD + d) = rq[m];
      *reinterpret_cast<float4*>(dOs + row * LD + d) = rdo[m];
    }
    if (tid < 2 * kFQ) rows_s[tid] = rowv;
    cp_async_wait_all();   // K and V, on the first step
    __syncthreads();

    float acc[4][4];
    f32_scores<DP>(acc, upper ? dOs : Qs, upper ? Vs : Ks, rg, cg);
    if (!upper)
      f32_store_p(acc, Ps, rows_s, rg, cg, q0, k0, Sq, Sk, causal, scale);
    __syncthreads();
    if (upper) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 8 * i;
        const float dl = rows_s[kFQ + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg + 16 * j;
          dSs[r * kLDP + c] = Ps[r * kLDP + c] * (acc[i][j] - dl) * scale;
        }
      }
    }
    __syncthreads();
    if (qt + 1 < nq) prefetch(qt + 1);

    // dV += P^T dO (warps 0-3), dK += dS^T Q (warps 4-7)
    const float* A = upper ? dSs : Ps;
    const float* B = upper ? Qs : dOs;
#pragma unroll
    for (int r = 0; r < kFQ; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * kLDP + c0);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < G::NJ; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(B + r * LD + 4 * dg + 32 * j);
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
  cp_async_wait_all();   // no copy outlives the block

  float* out = upper ? dk : dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + c0 + i;
    if (kp >= Sk) continue;
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * dg + 32 * j + e;
        if (d < D) out[kbase + (size_t)kp * D + d] = kv[i][j][e];
      }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using bf = __nv_bfloat16;
constexpr int kBT = 128;   // four warps, 16 rows of the block each
constexpr int kBR = 64;    // rows of a block and of a walked tile

template <int DP>
struct Bf16Geo {
  static constexpr int LD = DP + 8;         // row stride (bf16): 16-byte rows
  // dq: Q, dO, 2 K, 2 V; dkv: K, V, 2 Q, 2 dO, then 2 x 64 lse and delta
  static constexpr size_t dq_bytes = 6 * (size_t)kBR * LD * sizeof(bf);
  static constexpr size_t dkv_bytes = dq_bytes + 4 * kBR * sizeof(float);
};

template <int DP>
__global__ void __launch_bounds__(kBT, DP <= 64 ? 3 : 2)
flash_bwd_dq_bf16_kernel(const bf* __restrict__ q, const bf* __restrict__ k,
                         const bf* __restrict__ v,
                         const bf* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf* __restrict__ dq, int Sq, int Sk, int D,
                         int causal, float scale, int vec) {
  constexpr int LD = Bf16Geo<DP>::LD, KS = DP / 16, NT = DP / 8;
  extern __shared__ float4 smem_v[];
  bf* Qs = reinterpret_cast<bf*>(smem_v);
  bf* dOs = Qs + kBR * LD;
  bf* Ks = dOs + kBR * LD;   // [2][kBR][LD]
  bf* Vs = Ks + 2 * kBR * LD;   // [2][kBR][LD]

  const int nq = (Sq + kBR - 1) / kBR;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * kBR;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const bool vb = vec != 0;
  const float scale2 = scale * kLog2e;
  const int r0 = 16 * warp + gid;           // rows r0 and r0 + 8 of the tile
  const int nk = key_tiles(q0, kBR, kBR, Sq, Sk, causal);

  if (nk > 0) {
    load_tile<bf, kBR, DP, LD, kBT>(Qs, q + qbase, q0, Sq, D, vb);
    load_tile<bf, kBR, DP, LD, kBT>(dOs, dout + qbase, q0, Sq, D, vb);
    load_tile<bf, kBR, DP, LD, kBT>(Ks, k + kbase, 0, Sk, D, vb);
    load_tile<bf, kBR, DP, LD, kBT>(Vs, v + kbase, 0, Sk, D, vb);
    cp_async_commit();
  }
  float l2[2], dl[2];   // lse (base 2) and delta of rows r0, r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + r0 + 8 * h;
    l2[h] = qp < Sq ? lse[(size_t)bh * Sq + qp] * kLog2e : 0.f;
    dl[h] = qp < Sq ? delta[(size_t)bh * Sq + qp] : 0.f;
  }

  unsigned qf[KS][4], df[KS][4];   // this warp's Q and dO rows
  float acc[NT][4];                // dQ: rows r0 (0, 1), r0 + 8 (2, 3)
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1, k0 = kt * kBR;
    cp_async_wait_all();
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        afrag<LD>(qf[ks], Qs, warp, ks, mi, mr);
        afrag<LD>(df[ks], dOs, warp, ks, mi, mr);
      }
    }
    if (kt + 1 < nk) {
      load_tile<bf, kBR, DP, LD, kBT>(Ks + (buf ^ 1) * kBR * LD, k + kbase,
                                      k0 + kBR, Sk, D, vb);
      load_tile<bf, kBR, DP, LD, kBT>(Vs + (buf ^ 1) * kBR * LD, v + kbase,
                                      k0 + kBR, Sk, D, vb);
      cp_async_commit();
    }
    const bf* Kb = Ks + buf * kBR * LD;
    const bf* Vb = Vs + buf * kBR * LD;
    // the mask only where the tile pair holds an invisible entry
    const bool edge = k0 + kBR > Sk || q0 + kBR > Sq ||
                      (causal && k0 + kBR - 1 > q0 + (Sk - Sq));

#pragma unroll
    for (int kc = 0; kc < kBR / 16; ++kc) {
      // S and dP of keys 16 kc .. + 15: s[n][0..1] row r0, [2..3] row
      // r0 + 8, keys 16 kc + 8 n + 2 tig (+1)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = (16 * kc + 8 * (mi >> 1) + mr) * LD + 16 * ks +
                        8 * (mi & 1);
        unsigned b[4];
        ldsm_x4(b, Kb + off);
        mma_bf16(s[0], qf[ks], b[0], b[1]);
        mma_bf16(s[1], qf[ks], b[2], b[3]);
        ldsm_x4(b, Vb + off);
        mma_bf16(dp[0], df[ks], b[0], b[1]);
        mma_bf16(dp[1], df[ks], b[2], b[3]);
      }
      // dS = P (dP - delta) scale, P masked first
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 2 * h + e;
            float p = exp2f(fmaf(s[n][x], scale2, -l2[h]));
            if (edge && !visible(q0 + r0 + 8 * h, k0 + 16 * kc + 8 * n +
                                 2 * tig + e, Sq, Sk, causal))
              p = 0.f;
            s[n][x] = p * (dp[n][x] - dl[h]) * scale;
          }
      // dQ += dS K: dS (rounded to bf16) is the A fragment, K^T the B
      const unsigned a[4] = {pack_bf16(s[0][0], s[0][1]),
                             pack_bf16(s[0][2], s[0][3]),
                             pack_bf16(s[1][0], s[1][1]),
                             pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        unsigned b[4];
        ldsm_x4_t(b, Kb + (16 * kc + 8 * (mi & 1) + mr) * LD +
                         8 * (n + (mi >> 1)));
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + r0 + 8 * h;
    if (qp >= Sq) continue;
    bf* row = dq + qbase + (size_t)qp * D;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store_pair(row, 8 * n + 2 * tig, D, acc[n][2 * h], acc[n][2 * h + 1],
                 vb);
  }
}

template <int DP>
__global__ void __launch_bounds__(kBT, DP <= 64 ? 3 : 2)
flash_bwd_dkv_bf16_kernel(const bf* __restrict__ q, const bf* __restrict__ k,
                          const bf* __restrict__ v,
                          const bf* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf* __restrict__ dk, bf* __restrict__ dv, int Sq,
                          int Sk, int D, int causal, float scale, int vec) {
  constexpr int LD = Bf16Geo<DP>::LD, KS = DP / 16, NT = DP / 8;
  constexpr bool kHold = DP <= 64;   // K and V fragments in registers
  extern __shared__ float4 smem_v[];
  bf* Ks = reinterpret_cast<bf*>(smem_v);
  bf* Vs = Ks + kBR * LD;
  bf* Qs = Vs + kBR * LD;        // [2][kBR][LD]
  bf* dOs = Qs + 2 * kBR * LD;   // [2][kBR][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kBR * LD);   // [2][kBR]
  float* delta_s = lse_s + 2 * kBR;                               // [2][kBR]

  const int nk = (Sk + kBR - 1) / kBR, nq = (Sq + kBR - 1) / kBR;
  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * kBR;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const float* lse_h = lse + (size_t)bh * Sq;
  const float* delta_h = delta + (size_t)bh * Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const bool vb = vec != 0;
  const float scale2 = scale * kLog2e;
  const int r0 = 16 * warp + gid;   // key rows r0 and r0 + 8 of the block

  // query tile t's Q, dO, lse and delta into buffer b, one commit group
  auto stage = [&](int t, int b) {
    const int q0 = t * kBR;
    load_tile<bf, kBR, DP, LD, kBT>(Qs + b * kBR * LD, q + qbase, q0, Sq, D,
                                    vb);
    load_tile<bf, kBR, DP, LD, kBT>(dOs + b * kBR * LD, dout + qbase, q0,
                                    Sq, D, vb);
    const int row = q0 + (tid & (kBR - 1));
    const bool in = row < Sq;
    const float* src = tid < kBR ? lse_h : delta_h;
    float* dst = (tid < kBR ? lse_s : delta_s) + b * kBR + (tid & (kBR - 1));
    cp_async4(dst, in ? src + row : src, in ? 4 : 0);
  };

  int qt = first_query_tile(k0, kBR, Sq, Sk, causal);
  load_tile<bf, kBR, DP, LD, kBT>(Ks, k + kbase, k0, Sk, D, vb);
  load_tile<bf, kBR, DP, LD, kBT>(Vs, v + kbase, k0, Sk, D, vb);
  if (qt < nq) stage(qt, 0);
  cp_async_commit();

  unsigned kf[kHold ? KS : 1][4], vf[kHold ? KS : 1][4];
  float dka[NT][4], dva[NT][4];   // rows r0 (0, 1), r0 + 8 (2, 3)
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; qt < nq; ++qt, ++it) {
    const int buf = it & 1, q0 = qt * kBR;
    cp_async_wait_all();
    __syncthreads();   // tile qt is in; everyone is done with tile qt - 1
    if constexpr (kHold) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          afrag<LD>(kf[ks], Ks, warp, ks, mi, mr);
          afrag<LD>(vf[ks], Vs, warp, ks, mi, mr);
        }
      }
    }
    if (qt + 1 < nq) {
      stage(qt + 1, buf ^ 1);
      cp_async_commit();
    }
    const bf* Qb = Qs + buf * kBR * LD;
    const bf* dOb = dOs + buf * kBR * LD;
    const float* lb = lse_s + buf * kBR;
    const float* db = delta_s + buf * kBR;
    const bool edge = k0 + kBR > Sk || q0 + kBR > Sq ||
                      (causal && k0 + kBR - 1 > q0 + (Sk - Sq));

#pragma unroll
    for (int kc = 0; kc < kBR / 16; ++kc) {
      // S^T = K Q^T and dP^T = V dO^T of queries 16 kc .. + 15:
      // st[n][0..1] key r0, [2..3] key r0 + 8, queries 16 kc + 8 n + 2 tig
      // (+1)
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned ka[4], va[4];
        if constexpr (kHold) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[ks][e];
            va[e] = vf[ks][e];
          }
        } else {
          afrag<LD>(ka, Ks, warp, ks, mi, mr);
          afrag<LD>(va, Vs, warp, ks, mi, mr);
        }
        const int off = (16 * kc + 8 * (mi >> 1) + mr) * LD + 16 * ks +
                        8 * (mi & 1);
        unsigned b[4];
        ldsm_x4(b, Qb + off);
        mma_bf16(st[0], ka, b[0], b[1]);
        mma_bf16(st[1], ka, b[2], b[3]);
        ldsm_x4(b, dOb + off);
        mma_bf16(dpt[0], va, b[0], b[1]);
        mma_bf16(dpt[1], va, b[2], b[3]);
      }
      // P^T masked, then dS^T = P^T (dP^T - delta) scale; lse and delta
      // per column (query)
      float pt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 16 * kc + 8 * n + 2 * tig + e;
          const float l = lb[qi] * kLog2e, dd = db[qi];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 2 * h + e;
            float p = exp2f(fmaf(st[n][x], scale2, -l));
            if (edge && !visible(q0 + qi, k0 + r0 + 8 * h, Sq, Sk, causal))
              p = 0.f;
            pt[n][x] = p;
            st[n][x] = p * (dpt[n][x] - dd) * scale;
          }
        }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T (rounded to bf16) are
      // the A fragments, dO and Q (transposed by ldmatrix) the B
      const unsigned pa[4] = {pack_bf16(pt[0][0], pt[0][1]),
                              pack_bf16(pt[0][2], pt[0][3]),
                              pack_bf16(pt[1][0], pt[1][1]),
                              pack_bf16(pt[1][2], pt[1][3])};
      const unsigned da[4] = {pack_bf16(st[0][0], st[0][1]),
                              pack_bf16(st[0][2], st[0][3]),
                              pack_bf16(st[1][0], st[1][1]),
                              pack_bf16(st[1][2], st[1][3])};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        const int off = (16 * kc + 8 * (mi & 1) + mr) * LD +
                        8 * (n + (mi >> 1));
        unsigned b[4];
        ldsm_x4_t(b, dOb + off);
        mma_bf16(dva[n], pa, b[0], b[1]);
        mma_bf16(dva[n + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, Qb + off);
        mma_bf16(dka[n], da, b[0], b[1]);
        mma_bf16(dka[n + 1], da, b[2], b[3]);
      }
    }
  }
  cp_async_wait_all();   // no copy outlives the block

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = k0 + r0 + 8 * h;
    if (kp >= Sk) continue;
    bf* krow = dk + kbase + (size_t)kp * D;
    bf* vrow = dv + kbase + (size_t)kp * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * tig;
      store_pair(krow, col, D, dka[n][2 * h], dka[n][2 * h + 1], vb);
      store_pair(vrow, col, D, dva[n][2 * h], dva[n][2 * h + 1], vb);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum BwdKind { BWD_DQ = 1, BWD_DKV = 2 };

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int BH, Sq, Sk, D, causal;
  float scale;
};

// a kernel, its block and grid for one call
struct BwdPlan {
  void* fn;
  int rows;      // rows of a block: queries (dq) or keys (dkv)
  int walk;      // rows of a walked tile: keys (dq) or queries (dkv)
  int threads;
  size_t smem;
  long long blocks;
};

template <int DP>
BwdPlan bwd_plan(int kind, int dtype, const BwdArgs& a) {
  BwdPlan p;
  const bool dq = kind == BWD_DQ;
  if (dtype == MXT_F32) {
    p.fn = dq ? (void*)flash_bwd_dq_f32_kernel<DP>
              : (void*)flash_bwd_dkv_f32_kernel<DP>;
    p.rows = dq ? kFQ : kFK;
    p.walk = dq ? kFK : kFQ;
    p.threads = kFT;
    p.smem = sizeof(float) *
             (dq ? F32Geo<DP>::dq_floats : F32Geo<DP>::dkv_floats);
  } else {
    p.fn = dq ? (void*)flash_bwd_dq_bf16_kernel<DP>
              : (void*)flash_bwd_dkv_bf16_kernel<DP>;
    p.rows = p.walk = kBR;
    p.threads = kBT;
    p.smem = dq ? Bf16Geo<DP>::dq_bytes : Bf16Geo<DP>::dkv_bytes;
  }
  const int s = dq ? a.Sq : a.Sk;
  p.blocks = (long long)a.BH * ((s + p.rows - 1) / p.rows);
  return p;
}

// whole 16-byte chunks of every row (D a multiple of 16 bytes' elements)
// and every pointer 16-byte aligned
bool vec_ok(int dtype, const BwdArgs& a) {
  const int e = dtype == MXT_F32 ? 4 : 8;
  const uintptr_t p = reinterpret_cast<uintptr_t>(a.q) |
                      reinterpret_cast<uintptr_t>(a.k) |
                      reinterpret_cast<uintptr_t>(a.v) |
                      reinterpret_cast<uintptr_t>(a.dout) |
                      reinterpret_cast<uintptr_t>(a.dq) |
                      reinterpret_cast<uintptr_t>(a.dk) |
                      reinterpret_cast<uintptr_t>(a.dv);
  return a.D % e == 0 && (p & 15u) == 0;
}

// The kernel's shared-memory limit is set on every call, to the same
// value (the kernel's own size), so it holds on every device and no call
// changes it under another's launch.
template <int DP>
int bwd_launch(int kind, int dtype, const BwdArgs& a, cudaStream_t s) {
  const BwdPlan p = bwd_plan<DP>(kind, dtype, a);
  cudaError_t e = cudaFuncSetAttribute(
      p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  if (p.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const unsigned g = (unsigned)p.blocks;
  const int vec = vec_ok(dtype, a) ? 1 : 0;
  if (dtype == MXT_F32) {
    using T = float;
    const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
            *v = static_cast<const T*>(a.v),
            *d = static_cast<const T*>(a.dout);
    const float *l = static_cast<const float*>(a.lse),
                *dl = static_cast<const float*>(a.delta);
    if (kind == BWD_DQ)
      flash_bwd_dq_f32_kernel<DP><<<g, p.threads, p.smem, s>>>(
          q, k, v, d, l, dl, static_cast<T*>(a.dq), a.Sq, a.Sk, a.D,
          a.causal, a.scale, vec);
    else
      flash_bwd_dkv_f32_kernel<DP><<<g, p.threads, p.smem, s>>>(
          q, k, v, d, l, dl, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
          a.Sq, a.Sk, a.D, a.causal, a.scale, vec);
  } else {
    using T = bf;
    const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
            *v = static_cast<const T*>(a.v),
            *d = static_cast<const T*>(a.dout);
    const float *l = static_cast<const float*>(a.lse),
                *dl = static_cast<const float*>(a.delta);
    if (kind == BWD_DQ)
      flash_bwd_dq_bf16_kernel<DP><<<g, p.threads, p.smem, s>>>(
          q, k, v, d, l, dl, static_cast<T*>(a.dq), a.Sq, a.Sk, a.D,
          a.causal, a.scale, vec);
    else
      flash_bwd_dkv_bf16_kernel<DP><<<g, p.threads, p.smem, s>>>(
          q, k, v, d, l, dl, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
          a.Sq, a.Sk, a.D, a.causal, a.scale, vec);
  }
  return (int)cudaGetLastError();
}

// out: rows of a block, rows of a walked tile, threads, shared-memory
// bytes, blocks resident on an SM, blocks, SMs
template <int DP>
int bwd_plan_query(int kind, int dtype, const BwdArgs& a, int* out) {
  const BwdPlan p = bwd_plan<DP>(kind, dtype, a);
  cudaError_t e = cudaFuncSetAttribute(
      p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, p.fn, p.threads, p.smem)) != cudaSuccess ||
      (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  out[0] = p.rows;
  out[1] = p.walk;
  out[2] = p.threads;
  out[3] = (int)p.smem;
  out[4] = per_sm;
  out[5] = p.blocks > 0x7fffffffLL ? -1 : (int)p.blocks;
  out[6] = sms;
  return 0;
}

bool bwd_args_ok(int kind, int dtype, const BwdArgs& a) {
  return (kind == BWD_DQ || kind == BWD_DKV) &&
         (dtype == MXT_F32 || dtype == MXT_BF16) && a.D >= 1 && a.D <= 128;
}

int bwd_entry(int kind, const BwdArgs& a, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bwd_args_ok(kind, dtype, a)) return (int)cudaErrorInvalidValue;
  if (a.BH <= 0 || a.Sq <= 0 || a.Sk <= 0) return 0;
  if (a.D <= 32) return bwd_launch<32>(kind, dtype, a, s);
  if (a.D <= 64) return bwd_launch<64>(kind, dtype, a, s);
  return bwd_launch<128>(kind, dtype, a, s);
}

}  // namespace

// q, dout, dq: (BH, Sq, D); k, v, dk, dv: (BH, Sk, D), contiguous in
// `dtype`; lse, delta: (BH, Sq) float32. 1 <= D <= 128.
MXT_API int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int BH, int Sq,
                             int Sk, int D, int causal, float scale,
                             int dtype, void* stream) {
  BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
            BH, Sq, Sk, D, causal, scale};
  return bwd_entry(BWD_DQ, a, dtype, stream);
}

MXT_API int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int BH,
                              int Sq, int Sk, int D, int causal, float scale,
                              int dtype, void* stream) {
  BwdArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv,
            BH, Sq, Sk, D, causal, scale};
  return bwd_entry(BWD_DKV, a, dtype, stream);
}

// The plan of the dq (kind 1) or dkv (kind 2) kernel for a shape on the
// current device, into out[7] (see bwd_plan_query). A query: it launches
// nothing.
MXT_API int mxt_flash_bwd_plan(int kind, int BH, int Sq, int Sk, int D,
                               int dtype, int* out) {
  BwdArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
            nullptr, nullptr, BH, Sq, Sk, D, 0, 1.f};
  if (!bwd_args_ok(kind, dtype, a) || BH < 0 || Sq < 0 || Sk < 0)
    return (int)cudaErrorInvalidValue;
  if (D <= 32) return bwd_plan_query<32>(kind, dtype, a, out);
  if (D <= 64) return bwd_plan_query<64>(kind, dtype, a, out);
  return bwd_plan_query<128>(kind, dtype, a, out);
}
