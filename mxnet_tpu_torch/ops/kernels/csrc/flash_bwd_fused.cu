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
// Bound on the card at BERT-base training's shape (B*H 384, S 512, D 64):
// five products of 64^3 per (64-query, 64-key) tile pair, 64.4 GFLOP,
// 0.96 ms at 67 TFLOP/s in float32 and 0.065 ms at 989 TFLOP/s on bf16
// tensor cores; its bytes (7 S D values a head) take 0.06 / 0.03 ms.
// Operations bound it in both dtypes.
//
// float32, on the H100's CUDA cores (TF32 stays off: it would not hold
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
// bfloat16, on tensor cores (mma.sync.m16n8k16: bf16 operands, float32
// sums), the design of flash_bwd.cu's bf16 dkv kernel with dQ added:
//   - the same k-parallel grid, one block of 128 threads per (batch*head,
//     64-key tile), 3,072 blocks at BERT training's shape; each warp owns
//     16 keys of the block. The block walks the 64-query tiles that see
//     its keys, Q, dO, lse and delta double-buffered through cp.async.
//   - The transposed scores S^T = K Q^T and dP^T = V dO^T, so P^T and
//     dS^T, rounded to bf16, are already the A fragments of dV += P^T dO
//     and dK += dS^T Q straight from the accumulators; Q and dO are B
//     operands through ldmatrix.trans; the warp's K and V fragments are
//     held in registers for the walk (D <= 64).
//   - dQ: each warp writes its dS^T fragments (rounded to bf16) to a
//     shared [key][query] tile, in conflict-free 4-byte stores; after one
//     barrier each warp multiplies dS K for 16 query rows (dS through
//     ldmatrix.trans of that tile, K through ldmatrix.trans) and adds the
//     partial to the float32 accumulator with vector atomics
//     (`atomicAdd` of a float2: red.global.add.v2.f32). The cast kernel of
//     this entry writes dq.
//   - 64 KB of shared memory at D 64, three blocks an SM.
// The atomic adds arrive in an order that changes from run to run, so dq
// repeats only within float32 rounding of its partial sums, one per
// 64-key tile (well inside 1e-4 + 1e-4 |ref|, 2e-2 in bf16); dk and dv
// repeat bit for bit.
#include "flash_common.cuh"

namespace {

constexpr int kBQ = 32;         // query rows a step
constexpr int kBK = 64;         // key rows a block
constexpr int kThreads = 256;
constexpr int kLDP = kBK + 4;   // row stride of the P and dS tiles
constexpr int kLDT = kBQ + 4;   // row stride of the transposed dS tile

// elements [0, n) of p (n in 0..4), zeros after; one 16-byte load when
// `vec` and n == 4
__device__ __forceinline__ void load4(float4& r, const float* p, int n,
                                      bool vec) {
  if (vec && n == 4) {
    r = *reinterpret_cast<const float4*>(p);
  } else {
    r.x = n > 0 ? p[0] : 0.f;
    r.y = n > 1 ? p[1] : 0.f;
    r.z = n > 2 ? p[2] : 0.f;
    r.w = n > 3 ? p[3] : 0.f;
  }
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
// four elements, held in registers until stored to shared memory (so a
// prefetch's loads stay in flight across the compute); rows at or past n
// and columns at or past D read as 0.
template <int DP, int ROWS, int CH>
__device__ __forceinline__ void load_regs(float4 (&r)[CH], const float* src,
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

template <int DP, int CH>
__device__ __forceinline__ void store_regs(float* dst, const float4 (&r)[CH]) {
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const int ci = threadIdx.x + kThreads * m;
    const int row = ci / (DP / 4), d = 4 * (ci % (DP / 4));
    *reinterpret_cast<float4*>(dst + row * Geo<DP>::LD + d) = r[m];
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1)
flash_bwd_fused_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq_acc, float* __restrict__ dk,
                       float* __restrict__ dv, int Sq, int Sk, int D,
                       int causal, float scale, int vec) {
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

  float4 rq[G::QCH], rdo[G::QCH];
  float rowv = 0.f;
  auto prefetch = [&](int t) {
    const int q0 = t * kBQ;
    load_regs<DP, kBQ, G::QCH>(rq, q + qbase, q0, Sq, D, vecb);
    load_regs<DP, kBQ, G::QCH>(rdo, dout + qbase, q0, Sq, D, vecb);
    if (tid < 2 * kBQ) {
      const int row = q0 + (tid & (kBQ - 1));
      rowv = row < Sq ? (tid < kBQ ? lse_h[row] : delta_h[row]) : 0.f;
    }
  };
  if (qt < nq) prefetch(qt);
  {
    float4 rk[G::KCH], rv[G::KCH];
    load_regs<DP, kBK, G::KCH>(rk, k + kbase, k0, Sk, D, vecb);
    load_regs<DP, kBK, G::KCH>(rv, v + kbase, k0, Sk, D, vecb);
    store_regs<DP, G::KCH>(Ks, rk);
    store_regs<DP, G::KCH>(Vs, rv);
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
    store_regs<DP, G::QCH>(Qs, rq);
    store_regs<DP, G::QCH>(dOs, rdo);
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
    // P: masked before it enters any product (rounding to the input dtype
    // is a no-op in float32)
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
          Ps[r * kLDP + c] = p;
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
              Ps[r * kLDP + c] * (acc[i][j] - dl) * scale;
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
  float* out = upper ? dk : dv;
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
          out[kbase + (size_t)kp * D + d] = kv[i][j][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using bf = __nv_bfloat16;
constexpr int kBT = 128;   // four warps, 16 keys of the block each
constexpr int kBR = 64;    // keys of a block, queries of a walked tile

constexpr int kLDS = kBR + 8;   // row stride of the dS^T tile (queries)

template <int DP>
struct Bf16Geo {
  static constexpr int LD = DP + 8;   // row stride (bf16): 16-byte rows
  // K, V, 2 Q, 2 dO, dS^T, then 2 x 64 lse and delta
  static constexpr size_t bytes = 6 * (size_t)kBR * LD * sizeof(bf) +
                                  (size_t)kBR * kLDS * sizeof(bf) +
                                  4 * kBR * sizeof(float);
};

// a and c into p[0] and p[1] (c only where `two`) of the float32
// accumulator: one red.global.add.v2.f32 where `vec`
__device__ __forceinline__ void add_pair(float* p, float a, float c,
                                         bool two, bool vec) {
  if (two && vec) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, c));
  } else {
    atomicAdd(p, a);
    if (two) atomicAdd(p + 1, c);
  }
}

template <int DP>
__global__ void __launch_bounds__(kBT, DP <= 64 ? 3 : 1)
flash_bwd_fused_bf16_kernel(const bf* __restrict__ q,
                            const bf* __restrict__ k,
                            const bf* __restrict__ v,
                            const bf* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq_acc, bf* __restrict__ dk,
                            bf* __restrict__ dv, int Sq, int Sk, int D,
                            int causal, float scale, int vec, int vec_acc) {
  constexpr int LD = Bf16Geo<DP>::LD, KS = DP / 16, NT = DP / 8;
  constexpr bool kHold = DP <= 64;   // K and V fragments in registers
  extern __shared__ float4 smem_v[];
  bf* Ks = reinterpret_cast<bf*>(smem_v);
  bf* Vs = Ks + kBR * LD;
  bf* Qs = Vs + kBR * LD;         // [2][kBR][LD]
  bf* dOs = Qs + 2 * kBR * LD;    // [2][kBR][LD]
  bf* dSt = dOs + 2 * kBR * LD;   // [key][query]: dS^T rounded to bf16
  float* lse_s = reinterpret_cast<float*>(dSt + kBR * kLDS);   // [2][kBR]
  float* delta_s = lse_s + 2 * kBR;                           // [2][kBR]

  const int nk = (Sk + kBR - 1) / kBR, nq = (Sq + kBR - 1) / kBR;
  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * kBR;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const float* lse_h = lse + (size_t)bh * Sq;
  const float* delta_h = delta + (size_t)bh * Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, row
  const bool vb = vec != 0, va = vec_acc != 0;
  const float scale2 = scale * kLog2e;
  const int r0 = 16 * warp + gid;   // key rows r0 and r0 + 8 of the block

  // query tile t's Q, dO, lse and delta into buffer b (not committed)
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
        unsigned ka[4], vfr[4];
        if constexpr (kHold) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[ks][e];
            vfr[e] = vf[ks][e];
          }
        } else {
          afrag<LD>(ka, Ks, warp, ks, mi, mr);
          afrag<LD>(vfr, Vs, warp, ks, mi, mr);
        }
        const int off = (16 * kc + 8 * (mi >> 1) + mr) * LD + 16 * ks +
                        8 * (mi & 1);
        unsigned b[4];
        ldsm_x4(b, Qb + off);
        mma_bf16(st[0], ka, b[0], b[1]);
        mma_bf16(st[1], ka, b[2], b[3]);
        ldsm_x4(b, dOb + off);
        mma_bf16(dpt[0], vfr, b[0], b[1]);
        mma_bf16(dpt[1], vfr, b[2], b[3]);
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
      // P^T and dS^T rounded to bf16: the A fragments of dV += P^T dO and
      // dK += dS^T Q (dO and Q transposed by ldmatrix the B)
      const unsigned pa[4] = {pack_bf16(pt[0][0], pt[0][1]),
                              pack_bf16(pt[0][2], pt[0][3]),
                              pack_bf16(pt[1][0], pt[1][1]),
                              pack_bf16(pt[1][2], pt[1][3])};
      const unsigned da[4] = {pack_bf16(st[0][0], st[0][1]),
                              pack_bf16(st[0][2], st[0][3]),
                              pack_bf16(st[1][0], st[1][1]),
                              pack_bf16(st[1][2], st[1][3])};
      // dS^T to shared memory for dQ: da[2 n + h] holds key r0 + 8 h,
      // queries 16 kc + 8 n + 2 tig (+1)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<unsigned*>(dSt + (r0 + 8 * h) * kLDS +
                                       16 * kc + 8 * n + 2 * tig) =
              da[2 * n + h];
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
    __syncthreads();   // the tile pair's dS^T is in shared memory

    // dQ's partial dS K for query rows 16 warp .. + 15 over the block's
    // 64 keys: dS through ldmatrix.trans of dS^T, K^T likewise; added to
    // the float32 accumulator
    unsigned af[kBR / 16][4];
#pragma unroll
    for (int ks = 0; ks < kBR / 16; ++ks)
      ldsm_x4_t(af[ks], dSt + (16 * ks + 8 * (mi >> 1) + mr) * kLDS +
                            16 * warp + 8 * (mi & 1));
    const int qa = q0 + 16 * warp + gid;   // rows qa (0, 1), qa + 8 (2, 3)
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      float c[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kBR / 16; ++ks) {
        unsigned b[4];
        ldsm_x4_t(b, Ks + (16 * ks + 8 * (mi & 1) + mr) * LD +
                         8 * (n + (mi >> 1)));
        mma_bf16(c[0], af[ks], b[0], b[1]);
        mma_bf16(c[1], af[ks], b[2], b[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qp = qa + 8 * h, col = 8 * (n + j) + 2 * tig;
          if (qp < Sq && col < D)
            add_pair(dq_acc + qbase + (size_t)qp * D + col, c[j][2 * h],
                     c[j][2 * h + 1], col + 1 < D, va);
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

// float32: the register-tiled kernel, accumulating dq in dq itself. The
// shared-memory limit belongs to the device current when it is set, so it
// is set on every call, to the same value, as the bf16 launch does.
template <int DP>
int fused_launch_f32(const FusedArgs& a, cudaStream_t s) {
  const size_t smem = sizeof(float) * Geo<DP>::smem_floats;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_fused_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)a.BH * a.Sq * a.D;
  e = cudaMemsetAsync(a.dq_acc, 0, n * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)a.BH * ((a.Sk + kBK - 1) / kBK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // 16-byte loads of four elements and float4 atomics where every row
  // starts aligned
  const bool vec =
      a.D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
        reinterpret_cast<uintptr_t>(a.v) |
        reinterpret_cast<uintptr_t>(a.dout)) & 15u) == 0 &&
      mxt_aligned16(a.dq_acc);
  using F = float;
  flash_bwd_fused_kernel<DP><<<(unsigned)blocks, kThreads, smem, s>>>(
      static_cast<const F*>(a.q), static_cast<const F*>(a.k),
      static_cast<const F*>(a.v), static_cast<const F*>(a.dout),
      static_cast<const F*>(a.lse), static_cast<const F*>(a.delta),
      static_cast<F*>(a.dq_acc), static_cast<F*>(a.dk),
      static_cast<F*>(a.dv), a.Sq, a.Sk, a.D, a.causal, a.scale,
      vec ? 1 : 0);
  return (int)cudaGetLastError();
}

// bfloat16: the tensor-core kernel into the float32 accumulator, then the
// cast to dq. The shared-memory limit is set on every call, to the same
// value, so it holds on every device.
template <int DP>
int fused_launch_bf16(const FusedArgs& a, cudaStream_t s) {
  const size_t smem = Bf16Geo<DP>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_fused_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)a.BH * a.Sq * a.D;
  e = cudaMemsetAsync(a.dq_acc, 0, n * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)a.BH * ((a.Sk + kBR - 1) / kBR);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // 16-byte cp.async rows and paired stores where D is a multiple of 8
  // and every pointer 16-byte aligned; float2 atomics where D is even
  const uintptr_t p =
      reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
      reinterpret_cast<uintptr_t>(a.v) |
      reinterpret_cast<uintptr_t>(a.dout) |
      reinterpret_cast<uintptr_t>(a.dk) | reinterpret_cast<uintptr_t>(a.dv);
  const bool vec = a.D % 8 == 0 && (p & 15u) == 0;
  const bool vec_acc =
      a.D % 2 == 0 && (reinterpret_cast<uintptr_t>(a.dq_acc) & 7u) == 0;
  flash_bwd_fused_bf16_kernel<DP><<<(unsigned)blocks, kBT, smem, s>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq_acc), static_cast<bf*>(a.dk),
      static_cast<bf*>(a.dv), a.Sq, a.Sk, a.D, a.causal, a.scale,
      vec ? 1 : 0, vec_acc ? 1 : 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t want = (n + 255) / 256;
  const unsigned grid = (unsigned)(want < 4096 ? want : 4096);
  flash_bwd_dq_cast_kernel<bf><<<grid, 256, 0, s>>>(
      static_cast<const float*>(a.dq_acc), static_cast<bf*>(a.dq), n);
  return (int)cudaGetLastError();
}

int fused_dispatch_f32(const FusedArgs& a, cudaStream_t s) {
  if (a.D <= 32) return fused_launch_f32<32>(a, s);
  if (a.D <= 64) return fused_launch_f32<64>(a, s);
  return fused_launch_f32<128>(a, s);
}

int fused_dispatch_bf16(const FusedArgs& a, cudaStream_t s) {
  if (a.D <= 32) return fused_launch_bf16<32>(a, s);
  if (a.D <= 64) return fused_launch_bf16<64>(a, s);
  return fused_launch_bf16<128>(a, s);
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
  if (dtype == MXT_F32) return fused_dispatch_f32(a, s);
  if (dtype == MXT_BF16) return fused_dispatch_bf16(a, s);
  return (int)cudaErrorInvalidValue;
}
