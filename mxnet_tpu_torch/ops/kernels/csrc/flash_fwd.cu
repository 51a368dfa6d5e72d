// Flash-attention forward: online softmax over key tiles -> (out, lse).
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py `_flash_kernel`
// (launched by `_flash_fwd_pallas`). Semantics kept exactly:
//   - layout (B*H, S, D), any D <= 128, q of Sq rows, k/v of Sk rows;
//   - the causal diagonal is aligned to the end: key k is visible to
//     query q iff k <= q + (Sk - Sq); keys past Sk are masked;
//   - masked scores are the finite -1e30, so exp() never sees inf;
//   - a row that sees no valid key outputs 0 and its lse is -1e30;
//   - scores and the PV product accumulate in float32; for bfloat16
//     inputs P is rounded to bfloat16 before the PV product.
// What is NOT carried over: the TPU's 128-lane head-dim padding, the
// 8-lane replication of lse, and `_head_group` (several heads per grid
// program to amortise TPU per-program overhead). Here a grid of blocks
// runs in parallel over (batch*head, 64-row query tile) and a loop in
// the block walks the key tiles, which on the TPU was the sequential
// grid axis.
//
// Bound on the card: at BERT's shapes (S = 128, D = 64) the kernel does
// 4*S*S*D flops per head for 4*S*D*sizeof(T) bytes, about 32 flops a
// byte in float32: above the float32 CUDA-core ridge, so operations
// bound it. This first version is simple: float32 FMAs on CUDA cores
// from shared-memory tiles (no tensor cores, no TMA); 256 threads, four
// per query row, each holding 16 scores and D/4 accumulators.
#include "common.cuh"

#define BQ 64
#define BK 64
#define NTHREADS 256

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int D, int causal,
                 float sm_scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [BQ][DP + 1]
  float* Ks = Qs + BQ * (DP + 1);        // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);        // [BK][DP]
  float* Ps = Vs + BK * DP;              // [BQ][BK + 1]

  const int nq = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2;                // query row in the tile
  const int cg = tid & 3;                // which quarter of the columns
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const int diag = Sk - Sq;

  for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
    const int row = idx / D, d = idx - row * D;
    const int gq = q0 + row;
    Qs[row * (DP + 1) + d] =
        gq < Sq ? mxt_to_float(q[qbase + (size_t)gq * D + d]) : 0.f;
  }

  // key tiles this query tile can see (causal: none past the diagonal)
  const int nk_all = (Sk + BK - 1) / BK;
  int nk = nk_all;
  if (causal) {
    const int last_q = min(q0 + BQ, Sq) - 1;
    const int kmax = last_q + diag;
    nk = kmax < 0 ? 0 : min(nk_all, kmax / BK + 1);
  }

  float acc[DP / 4];
#pragma unroll
  for (int j = 0; j < DP / 4; ++j) acc[j] = 0.f;
  float m_run = MXT_NEG_INF, l_run = 0.f;
  const int q_pos = q0 + r;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int row = idx / D, d = idx - row * D;
      const int gk = k0 + row;
      float kv = 0.f, vv = 0.f;
      if (gk < Sk) {
        kv = mxt_to_float(k[kbase + (size_t)gk * D + d]);
        vv = mxt_to_float(v[kbase + (size_t)gk * D + d]);
      }
      Ks[row * (DP + 1) + d] = kv;
      Vs[row * DP + d] = vv;
    }
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * (DP + 1);
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < BK / 4; ++j)
        s[j] = fmaf(qd, Ks[(cg + 4 * j) * (DP + 1) + d], s[j]);
    }
    float mloc = MXT_NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int k_pos = k0 + cg + 4 * j;
      bool valid = k_pos < Sk;
      if (causal) valid = valid && (k_pos <= q_pos + diag);
      s[j] = valid ? s[j] * sm_scale : MXT_NEG_INF;
      mloc = fmaxf(mloc, s[j]);
    }
    // the four threads of a row are neighbouring lanes
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m_run, mloc);
    const float alpha = expf(m_run - m_new);
    float lsum = 0.f;
    float* prow = Ps + r * (BK + 1);
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const float p = expf(s[j] - m_new);
      lsum += p;
      // P takes V's dtype before the PV product (a no-op for float32)
      prow[cg + 4 * j] = mxt_to_float(mxt_from_float<T>(p));
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l_run = l_run * alpha + lsum;
    m_run = m_new;
    __syncwarp();      // the row's P is written by lanes of this warp

#pragma unroll
    for (int j = 0; j < DP / 4; ++j) acc[j] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = prow[c];
      const float* vrow = Vs + c * DP;
#pragma unroll
      for (int j = 0; j < DP / 4; ++j) {
        const int d = cg + 4 * j;
        if (d < D) acc[j] = fmaf(p, vrow[d], acc[j]);
      }
    }
  }

  if (q_pos < Sq) {
    const bool seen = m_run > MXT_NEG_INF / 2;
    const float l = fmaxf(l_run, 1e-30f);
    T* orow = out + qbase + (size_t)q_pos * D;
#pragma unroll
    for (int j = 0; j < DP / 4; ++j) {
      const int d = cg + 4 * j;
      if (d < D) orow[d] = mxt_from_float<T>(seen ? acc[j] / l : 0.f);
    }
    if (cg == 0)
      lse[(size_t)bh * Sq + q_pos] = seen ? m_run + logf(l) : MXT_NEG_INF;
  }
}

template <typename T, int DP>
static int flash_launch(const void* q, const void* k, const void* v,
                        void* out, void* lse, int BH, int Sq, int Sk, int D,
                        int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * BQ * (DP + 1) + BK * DP + BQ * (BK + 1));
  // above 48 KB a block's shared memory must be asked for explicitly;
  // setting it again from another thread is harmless
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long blocks = (long long)BH * ((Sq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, DP><<<(unsigned)blocks, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Sk, D, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int flash_dispatch_d(const void* q, const void* k, const void* v,
                            void* out, void* lse, int BH, int Sq, int Sk,
                            int D, int causal, float sm_scale,
                            cudaStream_t s) {
  if (D <= 32)
    return flash_launch<T, 32>(q, k, v, out, lse, BH, Sq, Sk, D, causal,
                               sm_scale, s);
  if (D <= 64)
    return flash_launch<T, 64>(q, k, v, out, lse, BH, Sq, Sk, D, causal,
                               sm_scale, s);
  return flash_launch<T, 128>(q, k, v, out, lse, BH, Sq, Sk, D, causal,
                              sm_scale, s);
}

// q: (BH, Sq, D); k, v: (BH, Sk, D); out: (BH, Sq, D), all contiguous in
// `dtype`; lse: (BH, Sq) float32. 1 <= D <= 128.
MXT_API int mxt_flash_fwd(const void* q, const void* k, const void* v,
                          void* out, void* lse, int BH, int Sq, int Sk, int D,
                          int causal, float sm_scale, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  if (BH <= 0 || Sq <= 0) return 0;
  if (dtype == MXT_F32)
    return flash_dispatch_d<float>(q, k, v, out, lse, BH, Sq, Sk, D, causal,
                                   sm_scale, s);
  if (dtype == MXT_BF16)
    return flash_dispatch_d<__nv_bfloat16>(q, k, v, out, lse, BH, Sq, Sk, D,
                                           causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// cudaGetErrorString for the codes the entries above return
MXT_API const char* mxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
