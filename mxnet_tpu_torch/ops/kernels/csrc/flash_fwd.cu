// Flash-attention forward: online softmax over key tiles -> (out, lse).
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py `_flash_kernel`
// (launched by `_flash_fwd_pallas`). Semantics kept exactly:
//   - layout (B*H, S, D), any 1 <= D <= 128, q of Sq rows, k/v of Sk rows;
//   - the causal diagonal is aligned to the end: key k is visible to
//     query q iff k <= q + (Sk - Sq); keys past Sk are masked;
//   - masked scores are the finite -1e30, so exp() never sees inf (the
//     softmax runs in base 2, scores scaled by scale * log2 e: one ex2 an
//     element; lse comes back in natural units);
//   - a row that sees no valid key outputs 0 and its lse is -1e30;
//   - scores and the PV product accumulate in float32; for bfloat16
//     inputs P is rounded to bfloat16 before the PV product; lse is
//     float32.
// What is NOT carried over: the TPU's 128-lane head-dim padding, the
// 8-lane replication of lse, and `_head_group` (several heads per grid
// program to amortise TPU per-program overhead). Here a grid of blocks
// runs in parallel over (batch*head, 64-row query tile) and a loop in
// the block walks the key tiles, which on the TPU was the sequential
// grid axis.
//
// Bound on the card: at the served shape (B*H 384, S 128, D 64) 1.61
// GFLOP: 0.024 ms at 67 TFLOP/s in float32 (operations bound it), and
// 0.0076 ms for the bytes in bfloat16 (bytes bound it on tensor cores).
// Two kernels, one per dtype:
//   - float32 on CUDA cores (TF32 would not hold float32's 1e-4), register-
//     tiled as flash_bwd_fused.cu: 256 threads, each a 4 x 4 patch of the
//     64 x 64 scores (rows 16 i + rg, keys 16 j + cg) from float4 loads
//     along the depth, so one loaded float feeds 4 FMAs, and a warp's
//     loads read few distinct words (the Q rows are broadcast). The row
//     max and sum are reduced with shuffles among the 16 lanes of a row;
//     P goes through shared memory to the same warp, which multiplies it
//     into a 4-row x D/16-column patch of the output (float4 loads of P
//     and V).
//   - bfloat16 on tensor cores: 128 threads, each warp 16 query rows.
//     S = Q K^T and O += P V are mma.sync.m16n8k16 (bf16 operands, float32
//     sums) with K and V fragments from ldmatrix (V transposed by
//     ldmatrix.trans); the scores' accumulator fragment is, repacked to
//     bf16, the A fragment of the P V product, so P never leaves registers.
// Both walk the key tiles with K and V double-buffered through cp.async
// (16-byte copies, zero-filled past Sk and D), so the next tile's loads
// fly while this one is multiplied; where D or a pointer is not 16-byte
// aligned they are loaded by plain loads instead.
#include "flash_common.cuh"

namespace {

constexpr int kBQ = 64;   // query rows a block
constexpr int kBK = 64;   // keys a tile

constexpr float kLn2 = 0.6931471805599453f;

// Whether key tile [k0, k0 + kBK) needs the mask for some row of the
// query tile [q0, q0 + kBQ): keys past Sk, or (causal) keys past the
// first row's diagonal q0 + Sk - Sq. Interior tiles skip the mask.
__device__ __forceinline__ bool tile_masks(int k0, int q0, int Sk, int diag,
                                           int causal) {
  return k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0 + diag);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFT = 256;

template <int DP>
struct F32Geo {
  static constexpr int LD = DP + 4;         // Q, K, V row stride (floats)
  static constexpr int LDP = kBK + 16;      // P row stride
  static constexpr int DC = DP >= 64 ? DP / 16 : 2;   // output columns
  static constexpr size_t floats =
      (size_t)kBQ * LD + 4 * (size_t)kBK * LD + (size_t)kBQ * LDP;
};

template <int DP>
__global__ void __launch_bounds__(kFT, DP <= 64 ? 2 : 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int D,
                     int causal, float scale, int vec) {
  using Geo = F32Geo<DP>;
  constexpr int LD = Geo::LD, LDP = Geo::LDP, DC = Geo::DC;
  extern __shared__ float4 smem_v[];
  float* Qs = reinterpret_cast<float*>(smem_v);
  float* Ks = Qs + kBQ * LD;                // [2][kBK][LD]
  float* Vs = Ks + 2 * kBK * LD;            // [2][kBK][LD]
  float* Ps = Vs + 2 * kBK * LD;            // [kBQ][LDP]

  const int nq = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * kBQ;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const int diag = Sk - Sq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = 2 * warp + (lane >> 4);    // rows rg + 16 i
  const int cg = lane & 15;                 // keys cg + 16 j
  const bool vb = vec != 0;
  const float scale2 = scale * kLog2e;

  // key tiles this query tile can see (causal: none past the diagonal)
  const int nk = key_tiles(q0, kBQ, kBK, Sq, Sk, causal);

  if (nk > 0) {
    load_tile<float, kBQ, DP, LD, kFT>(Qs, q + qbase, q0, Sq, D, vb);
    load_tile<float, kBK, DP, LD, kFT>(Ks, k + kbase, 0, Sk, D, vb);
    load_tile<float, kBK, DP, LD, kFT>(Vs, v + kbase, 0, Sk, D, vb);
    cp_async_commit();
  }

  float o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = MXT_NEG_INF;
    l_run[i] = 0.f;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1, k0 = kt * kBK;
    cp_async_wait_all();
    __syncthreads();   // tile kt is in; everyone is done with tile kt - 1
    if (kt + 1 < nk) {
      load_tile<float, kBK, DP, LD, kFT>(Ks + (buf ^ 1) * kBK * LD,
                                         k + kbase, k0 + kBK, Sk, D, vb);
      load_tile<float, kBK, DP, LD, kFT>(Vs + (buf ^ 1) * kBK * LD,
                                         v + kbase, k0 + kBK, Sk, D, vb);
      cp_async_commit();
    }
    const float* Kb = Ks + buf * kBK * LD;
    const float* Vb = Vs + buf * kBK * LD;

    // S = Q K^T: rows rg + 16 i, keys cg + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Kb + (cg + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (rg + 16 * i) * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv, kv[j], s[i][j]);
      }
    }

    // online softmax of each row over the 16 lanes that share it, in
    // base 2 (scores scaled by scale * log2 e)
    const bool edge = tile_masks(k0, q0, Sk, diag, causal);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + rg + 16 * i;
      float mloc = MXT_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale2;
        if (edge) {
          const int kp = k0 + cg + 16 * j;
          bool valid = kp < Sk;
          if (causal) valid = valid && kp <= qp + diag;
          s[i][j] = valid ? s[i][j] : MXT_NEG_INF;
        }
        mloc = fmaxf(mloc, s[i][j]);
      }
#pragma unroll
      for (int o2 = 1; o2 < 16; o2 <<= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o2));
      const float m_new = fmaxf(m_run[i], mloc);
      const float alpha = exp2f(m_run[i] - m_new);
      float lsum = 0.f;
      float* prow = Ps + (rg + 16 * i) * LDP;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        lsum += p;
        prow[cg + 16 * j] = p;
      }
#pragma unroll
      for (int o2 = 1; o2 < 16; o2 <<= 1)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, o2);
      l_run[i] = l_run[i] * alpha + lsum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
    }
    __syncwarp();   // a warp reads only the P rows it wrote

    // O += P V: rows rg + 16 i, columns 4 cg + 64 e (+ 0..3), or 2 cg
    // (+ 0..1) at DP 32
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (rg + 16 * i) * LDP + c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vrow = Vb + (c + kk) * LD;
        if constexpr (DP >= 64) {
#pragma unroll
          for (int e = 0; e < DP / 64; ++e) {
            const float4 vv =
                *reinterpret_cast<const float4*>(vrow + 4 * cg + 64 * e);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = f4(pv[i], kk);
              o[i][4 * e] = fmaf(p, vv.x, o[i][4 * e]);
              o[i][4 * e + 1] = fmaf(p, vv.y, o[i][4 * e + 1]);
              o[i][4 * e + 2] = fmaf(p, vv.z, o[i][4 * e + 2]);
              o[i][4 * e + 3] = fmaf(p, vv.w, o[i][4 * e + 3]);
            }
          }
        } else {
          const float2 vv = *reinterpret_cast<const float2*>(vrow + 2 * cg);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = f4(pv[i], kk);
            o[i][0] = fmaf(p, vv.x, o[i][0]);
            o[i][1] = fmaf(p, vv.y, o[i][1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + rg + 16 * i;
    if (qp >= Sq) continue;
    const bool seen = m_run[i] > MXT_NEG_INF / 2;
    const float l = fmaxf(l_run[i], 1e-30f);
    float* orow = out + qbase + (size_t)qp * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = DP >= 64 ? 4 * cg + 64 * (c / 4) + (c & 3) : 2 * cg + c;
      if (col < D) orow[col] = seen ? o[i][c] / l : 0.f;
    }
    if (cg == 0)
      lse[(size_t)bh * Sq + qp] =
          seen ? m_run[i] * kLn2 + logf(l) : MXT_NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBT = 128;   // four warps, 16 query rows each

template <int DP>
struct Bf16Geo {
  static constexpr int LD = DP + 8;         // row stride (bf16): 16-byte rows
  static constexpr size_t elems = 5 * (size_t)64 * LD;   // Q, 2 K, 2 V
};

template <int DP>
__global__ void __launch_bounds__(kBT)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int D,
                      int causal, float scale, int vec) {
  using bf = __nv_bfloat16;
  constexpr int LD = Bf16Geo<DP>::LD, KS = DP / 16, NT = DP / 8;
  extern __shared__ float4 smem_v[];
  bf* Qs = reinterpret_cast<bf*>(smem_v);
  bf* Ks = Qs + 64 * LD;                    // [2][64][LD]
  bf* Vs = Ks + 2 * 64 * LD;                // [2][64][LD]

  const int nq = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * kBQ;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const int diag = Sk - Sq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const bool vb = vec != 0;
  const float scale2 = scale * kLog2e;
  const int r0 = 16 * warp + gid;           // rows r0 and r0 + 8 of the tile

  const int nk = key_tiles(q0, kBQ, kBK, Sq, Sk, causal);

  if (nk > 0) {
    load_tile<bf, kBQ, DP, LD, kBT>(Qs, q + qbase, q0, Sq, D, vb);
    load_tile<bf, kBK, DP, LD, kBT>(Ks, k + kbase, 0, Sk, D, vb);
    load_tile<bf, kBK, DP, LD, kBT>(Vs, v + kbase, 0, Sk, D, vb);
    cp_async_commit();
  }

  unsigned qf[KS][4];                       // this warp's Q rows, A fragments
  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_run[2] = {MXT_NEG_INF, MXT_NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1, k0 = kt * kBK;
    cp_async_wait_all();
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], Qs + (16 * warp + mr + 8 * (mi & 1)) * LD + 16 * ks +
                            8 * (mi >> 1));
    }
    if (kt + 1 < nk) {
      load_tile<bf, kBK, DP, LD, kBT>(Ks + (buf ^ 1) * 64 * LD, k + kbase,
                                      k0 + kBK, Sk, D, vb);
      load_tile<bf, kBK, DP, LD, kBT>(Vs + (buf ^ 1) * 64 * LD, v + kbase,
                                      k0 + kBK, Sk, D, vb);
      cp_async_commit();
    }
    const bf* Kb = Ks + buf * 64 * LD;
    const bf* Vb = Vs + buf * 64 * LD;

    // S = Q K^T: 8 tiles of 8 keys; s[n][0..1] row r0, [2..3] row r0 + 8,
    // keys 8 n + 2 tig (+1)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        unsigned b[4];   // key tiles n, n + 1; depth halves 0, 1
        ldsm_x4(b, Kb + (8 * (n + (mi >> 1)) + mr) * LD + 16 * ks +
                       8 * (mi & 1));
        mma_bf16(s[n], qf[ks], b[0], b[1]);
        mma_bf16(s[n + 1], qf[ks], b[2], b[3]);
      }
    }

    float alpha[2];
    const bool edge = tile_masks(k0, q0, Sk, diag, causal);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = q0 + r0 + 8 * h;
      float mloc = MXT_NEG_INF;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * h + e];
          x *= scale2;
          if (edge) {
            const int kp = k0 + 8 * n + 2 * tig + e;
            bool valid = kp < Sk;
            if (causal) valid = valid && kp <= qp + diag;
            x = valid ? x : MXT_NEG_INF;
          }
          mloc = fmaxf(mloc, x);
        }
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
      const float m_new = fmaxf(m_run[h], mloc);
      alpha[h] = exp2f(m_run[h] - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * h + e];
          x = exp2f(x - m_new);
          lsum += x;
        }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      l_run[h] = l_run[h] * alpha[h] + lsum;
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O += P V: P (rounded to bf16) is the A fragment straight from s
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const unsigned pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        unsigned b[4];   // V^T: column tiles n, n + 1; key halves 0, 1
        ldsm_x4_t(b, Vb + (16 * kc + 8 * (mi & 1) + mr) * LD +
                         8 * (n + (mi >> 1)));
        mma_bf16(oacc[n], pa, b[0], b[1]);
        mma_bf16(oacc[n + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + r0 + 8 * h;
    if (qp >= Sq) continue;
    const bool seen = m_run[h] > MXT_NEG_INF / 2;
    const float l = fmaxf(l_run[h], 1e-30f);
    bf* orow = out + qbase + (size_t)qp * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * tig;
      store_pair(orow, col, D, seen ? oacc[n][2 * h] / l : 0.f,
                 seen ? oacc[n][2 * h + 1] / l : 0.f, vb);
    }
    if (tig == 0)
      lse[(size_t)bh * Sq + qp] =
          seen ? m_run[h] * kLn2 + logf(l) : MXT_NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct FwdArgs {
  const void *q, *k, *v;
  void *out, *lse;
  int BH, Sq, Sk, D, causal;
  float scale;
};

template <typename T>
bool vec_ok(const FwdArgs& a) {
  constexpr int E = 16 / sizeof(T);
  return a.D % E == 0 &&
         ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
           reinterpret_cast<uintptr_t>(a.v)) & 15u) == 0;
}

// The kernel's shared-memory limit is set on every call, to the same
// value (the kernel's own size), so it holds on every device and no call
// changes it under another's launch.
template <typename T, int DP>
int fwd_launch(const FwdArgs& a, cudaStream_t s) {
  constexpr bool F32 = sizeof(T) == 4;
  const size_t smem = F32 ? sizeof(float) * F32Geo<DP>::floats
                          : sizeof(__nv_bfloat16) * Bf16Geo<DP>::elems;
  void* fn = F32 ? (void*)flash_fwd_f32_kernel<DP>
                 : (void*)flash_fwd_bf16_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)a.BH * ((a.Sq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int vec = vec_ok<T>(a) ? 1 : 0;
  if constexpr (F32) {
    flash_fwd_f32_kernel<DP><<<(unsigned)blocks, kFT, smem, s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.out),
        static_cast<float*>(a.lse), a.Sq, a.Sk, a.D, a.causal, a.scale, vec);
  } else {
    flash_fwd_bf16_kernel<DP><<<(unsigned)blocks, kBT, smem, s>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.lse),
        a.Sq, a.Sk, a.D, a.causal, a.scale, vec);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_dispatch_d(const FwdArgs& a, cudaStream_t s) {
  if (a.D <= 32) return fwd_launch<T, 32>(a, s);
  if (a.D <= 64) return fwd_launch<T, 64>(a, s);
  return fwd_launch<T, 128>(a, s);
}

}  // namespace

// q: (BH, Sq, D); k, v: (BH, Sk, D); out: (BH, Sq, D), all contiguous in
// `dtype`; lse: (BH, Sq) float32. 1 <= D <= 128.
MXT_API int mxt_flash_fwd(const void* q, const void* k, const void* v,
                          void* out, void* lse, int BH, int Sq, int Sk, int D,
                          int causal, float sm_scale, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0) return 0;
  const FwdArgs a{q, k, v, out, lse, BH, Sq, Sk, D, causal, sm_scale};
  if (dtype == MXT_F32) return fwd_dispatch_d<float>(a, s);
  if (dtype == MXT_BF16) return fwd_dispatch_d<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// cudaGetErrorString for the codes the entries of every kernel return
MXT_API const char* mxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
