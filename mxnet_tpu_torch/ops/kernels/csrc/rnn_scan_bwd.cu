// Time-fused recurrence backward (LSTM / GRU / vanilla RNN): dxw, dh0,
// dc0, dW_hh and db_hh of one (layer, direction), one C entry.
//
// Replaces the TPU kernel mxnet_tpu/ops/kernels/rnn_scan.py `_bwd_kernel`
// (launched by `_scan_bwd_pallas`). Semantics kept: a reverse-time walk
// from t = T-1 to 0 that recomputes the gates from xw_t and h_{t-1}
// (one extra h @ W_hh^T a step, instead of storing them in the forward),
// takes dh = dy_t + dh_carry and the dc carry (seeded with c_T's
// cotangent at t = T-1, exactly where the scan transpose takes it), and
// mirrors _bwd_step's expression groupings; the carries dh and dc and the
// sums dW and db are float32, as the TPU scratch is; dxw, dh0 and dc0 are
// written in the activation dtype, dW and db in W_hh's.
//
// What has no CUDA counterpart: the TPU kernel keeps dh, dc, dW and db in
// VMEM and walks its time blocks in order on one core. Here:
// 1. a persistent cooperative kernel (rnn_scan.cuh, the forward's split:
//    a block owns U hidden units with all their gates) walks the steps;
//    per step it recomputes its units' gates and writes their dgates
//    into dxw (activation dtype) and dhw (float32, all T steps kept for
//    pass 2: T*N*G*H*4 bytes, 23.3 MB at T 35, N 64, G 4, H 650); a grid
//    barrier; then dh_{t-1} of its units = dh_dir + dhw_t @ W_hh[:, units],
//    the block's U columns of W_hh held in shared memory beside its G*U
//    rows (2 x 52 KB at H = 650, U = 5; read from device memory when they
//    do not fit);
// 2. a tiled float32 product dW_hh = sum over the T*N rows m of
//    dhw[m]^T h_{t-1}[m] (h_{-1} = h0), each output summed in row order by
//    one thread, whose column blocks also take db_hh = sum over m of
//    dhw[m] in the same order. The TPU adds them step by step from T-1
//    down; this order differs, so float32 dW and db differ by rounding.
// No atomics: a card repeats its result bit for bit.
//
// Bound on the card: operations (three products of 2*T*N*G*H^2 flops:
// the recompute, dh and dW; 22.7 GFLOP at the LM's shape, 0.34 ms at
// 67 TFLOP/s float32). Pass 1 is latency-bound like the forward (two
// dot phases and one grid barrier a step); pass 2 is a plain CUDA-core
// product.
#include "rnn_scan.cuh"

template <typename T, int G, int U>
__global__ void __launch_bounds__(MXT_RNN_THREADS)
rnn_scan_bwd_kernel(const T* __restrict__ xw, const T* __restrict__ h0,
                    const T* __restrict__ c0, const float* __restrict__ w,
                    const float* __restrict__ b, const T* __restrict__ ys,
                    const T* __restrict__ cs, const T* __restrict__ dy,
                    float* dh_s, float* dc_s, T* __restrict__ dxw,
                    float* dhw, T* __restrict__ dh0, T* __restrict__ dc0,
                    int Tn, int N, int H, int mode, int w_in_smem) {
  // [G*U][H]: the block's rows of W_hh; then [U][G*H]: its columns
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int GH = G * H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* swr = smem;
  float* swc = smem + G * U * H;
  if (w_in_smem) {
    mxt_rnn_load_rows<G, U>(swr, w, H, u0, nu);
    for (int idx = threadIdx.x; idx < U * GH; idx += blockDim.x) {
      const int j = idx / GH, r = idx - j * GH;
      swc[idx] = j < nu ? w[(size_t)r * H + u0 + j] : 0.f;
    }
    __syncthreads();
  }
  const float* wb = w_in_smem ? swr : w;
  int off[G * U];
  mxt_rnn_row_offsets<G, U>(w_in_smem, H, u0, nu, off);
  // column j of the slice: swc + j*GH + r, or W_hh + r*H + u0 + j
  const float* wcb = w_in_smem ? swc : w;
  int coff[U];
#pragma unroll
  for (int j = 0; j < U; ++j)
    coff[j] = w_in_smem ? j * GH : u0 + (j < nu ? j : 0);
  const int rstride = w_in_smem ? 1 : H;
  float bias[G];
  if (lane < nu) {
#pragma unroll
    for (int g = 0; g < G; ++g) bias[g] = b[g * H + u0 + lane];
  }
  const size_t step = (size_t)N * H;

  for (int t = Tn - 1; t >= 0; --t) {
    const T* hprev = t == 0 ? h0 : ys + (t - 1) * step;
    const T* cprev = t == 0 ? c0 : cs + (t - 1) * step;
    // phase 1: recompute the gates, dgates of this block's units
    for (int n = warp; n < N; n += nwarps) {
      float acc[G * U];
      // acc[g*U + j] = h_{t-1}[n] . W_hh[g*H + u0 + j]
      mxt_rnn_warp_dot<T, G * U>(hprev + (size_t)n * H, H, wb, off, 1, acc);
      float hw[G];
      mxt_rnn_pick<G, U>(acc, lane, hw);
      if (lane < nu) {
        const int u = u0 + lane;
        const size_t row = (size_t)t * N + n;
        const size_t su = (size_t)n * H + u;
        float x[G];
#pragma unroll
        for (int g = 0; g < G; ++g) x[g] = mxt_to_float(xw[row * GH + g * H + u]);
        const float h_prev = mxt_to_float(hprev[su]);
        const float c_prev = G == 4 ? mxt_to_float(cprev[su]) : 0.f;
        const float c_new = G == 4 ? mxt_to_float(cs[row * H + u]) : 0.f;
        const float y = G == 1 ? mxt_to_float(ys[row * H + u]) : 0.f;
        float gx[G], gh[G], dh_dir, dc_out = 0.f;
        mxt_rnn_bwd_unit<G>(mode, x, hw, bias, h_prev, c_prev, c_new, y,
                            mxt_to_float(dy[row * H + u]), dh_s[su],
                            G == 4 ? dc_s[su] : 0.f, gx, gh, dh_dir, dc_out);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          dxw[row * GH + g * H + u] = mxt_from_float<T>(gx[g]);
          dhw[row * GH + g * H + u] = gh[g];
        }
        dh_s[su] = dh_dir;
        if (G == 4) dc_s[su] = dc_out;
      }
    }
    grid.sync();
    // phase 2: dh_{t-1} = dh_dir + dhw_t @ W_hh[:, units]
    for (int n = warp; n < N; n += nwarps) {
      float acc[U];
      mxt_rnn_warp_dot<float, U>(dhw + ((size_t)t * N + n) * GH, GH, wcb,
                                 coff, rstride, acc);
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (lane == j && j < nu) {
          const size_t su = (size_t)n * H + u0 + j;
          dh_s[su] = dh_s[su] + acc[j];
        }
      }
    }
    // no barrier here: the next step writes another slice of dhw, and
    // dh_s / dc_s of a unit are touched only by the lane that owns it
  }
  for (int n = warp; n < N; n += nwarps) {
    if (lane < nu) {
      const size_t su = (size_t)n * H + u0 + lane;
      dh0[su] = mxt_from_float<T>(dh_s[su]);
      if (G == 4) dc0[su] = mxt_from_float<T>(dc_s[su]);
    }
  }
}

// dW[r][k] = sum over m of dhw[m][r] * hp(m, k), hp(m) = m < N ? h0[m] :
// ys[m - N] (h_{t-1} of row m = t*N + n); blockIdx.x == 0 also writes
// db[r] = sum over m of dhw[m][r]. 64 x 64 outputs a block, 4 x 4 a
// thread, rows m taken 16 at a time through shared memory, in order.
template <typename T>
__global__ void __launch_bounds__(256)
rnn_dw_kernel(const float* __restrict__ dhw, const T* __restrict__ h0,
              const T* __restrict__ ys, T* __restrict__ dw,
              T* __restrict__ db, int M, int N, int GH, int H) {
  __shared__ float As[16][64];
  __shared__ float Bs[16][64];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.y * 64, k0 = blockIdx.x * 64;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float dbacc = 0.f;
  // tile m0's values of this thread, loaded one tile ahead of the FMAs
  float ra[4], rb[4];
  auto load_tile = [&](int m0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + 256 * i, mm = idx >> 6, cc = idx & 63;
      const int m = m0 + mm;
      const int r = r0 + cc, k = k0 + cc;
      ra[i] = (m < M && r < GH) ? dhw[(size_t)m * GH + r] : 0.f;
      rb[i] = 0.f;
      if (m < M && k < H)
        rb[i] = mxt_to_float(m < N ? h0[(size_t)m * H + k]
                                   : ys[(size_t)(m - N) * H + k]);
    }
  };
  load_tile(0);
  for (int m0 = 0; m0 < M; m0 += 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + 256 * i, mm = idx >> 6, cc = idx & 63;
      As[mm][cc] = ra[i];
      Bs[mm][cc] = rb[i];
    }
    __syncthreads();
    if (m0 + 16 < M) load_tile(m0 + 16);
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (blockIdx.x == 0 && tid < 64) {
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) dbacc += As[kk][tid];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= GH) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < H) dw[(size_t)r * H + k] = mxt_from_float<T>(acc[i][j]);
    }
  }
  if (blockIdx.x == 0 && tid < 64 && r0 + tid < GH)
    db[r0 + tid] = mxt_from_float<T>(dbacc);
}

template <typename T, int G>
static int rnn_bwd_launch(const void* xw, const void* h0, const void* c0,
                          const void* w, const void* b, const void* ys,
                          const void* cs, const void* dy, void* dh_s,
                          void* dc_s, void* dxw, void* dhw, void* dh0,
                          void* dc0, void* dw, void* db, int Tn, int N, int H,
                          int mode, cudaStream_t s) {
  void* const fns[MXT_RNN_MAX_UNITS] = {
      (void*)rnn_scan_bwd_kernel<T, G, 1>, (void*)rnn_scan_bwd_kernel<T, G, 2>,
      (void*)rnn_scan_bwd_kernel<T, G, 3>, (void*)rnn_scan_bwd_kernel<T, G, 4>,
      (void*)rnn_scan_bwd_kernel<T, G, 5>, (void*)rnn_scan_bwd_kernel<T, G, 6>,
      (void*)rnn_scan_bwd_kernel<T, G, 7>, (void*)rnn_scan_bwd_kernel<T, G, 8>};
  const T* a_xw = static_cast<const T*>(xw);
  const T* a_h0 = static_cast<const T*>(h0);
  const T* a_c0 = static_cast<const T*>(c0);
  const float* a_w = static_cast<const float*>(w);
  const float* a_b = static_cast<const float*>(b);
  const T* a_ys = static_cast<const T*>(ys);
  const T* a_cs = static_cast<const T*>(cs);
  const T* a_dy = static_cast<const T*>(dy);
  float* a_dh_s = static_cast<float*>(dh_s);
  float* a_dc_s = static_cast<float*>(dc_s);
  T* a_dxw = static_cast<T*>(dxw);
  float* a_dhw = static_cast<float*>(dhw);
  T* a_dh0 = static_cast<T*>(dh0);
  T* a_dc0 = static_cast<T*>(dc0);
  int w_in_smem = 0;
  void* args[] = {&a_xw, &a_h0, &a_c0, &a_w, &a_b, &a_ys, &a_cs, &a_dy,
                  &a_dh_s, &a_dc_s, &a_dxw, &a_dhw, &a_dh0, &a_dc0,
                  &Tn, &N, &H, &mode, &w_in_smem};
  // a unit's G rows and its column of W_hh
  int err = mxt_rnn_coop_launch(fns, H, 2 * sizeof(float) * G * (size_t)H,
                                args, &w_in_smem, s);
  if (err) return err;
  const int GH = G * H;
  dim3 grid((H + 63) / 64, (GH + 63) / 64);
  rnn_dw_kernel<T><<<grid, 256, 0, s>>>(a_dhw, a_h0, a_ys, static_cast<T*>(dw),
                                        static_cast<T*>(db), Tn * N, N, GH, H);
  return (int)cudaGetLastError();
}

// xw, dxw: (T, N, G*H); h0, c0, dh0, dc0: (N, H); ys, cs, dy: (T, N, H),
// all contiguous in `dtype` (c0, cs, dc0 only for LSTM, else may be
// null); w_hh: (G*H, H) and b_hh: (G*H,) contiguous float32; dh_s: (N,
// H) float32 zeros; dc_s: (N, H) float32 holding c_T's cotangent (LSTM);
// dhw: (T, N, G*H) float32 scratch; dw: (G*H, H) and db: (G*H,) in
// `dtype`.
MXT_API int mxt_rnn_scan_bwd(const void* xw, const void* h0, const void* c0,
                             const void* w_hh, const void* b_hh,
                             const void* ys, const void* cs, const void* dy,
                             void* dh_s, void* dc_s, void* dxw, void* dhw,
                             void* dh0, void* dc0, void* dw, void* db, int Tn,
                             int N, int H, int mode, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tn <= 0 || N <= 0 || H <= 0) return 0;
  if (mode < MXT_RNN_RELU || mode > MXT_GRU) return (int)cudaErrorInvalidValue;
  const int G = mxt_rnn_gates(mode);
  if ((size_t)G * H * H >= (1u << 31)) return (int)cudaErrorInvalidValue;
  if (G == 4 && (c0 == nullptr || cs == nullptr || dc_s == nullptr ||
                 dc0 == nullptr))
    return (int)cudaErrorInvalidValue;
#define MXT_RNN_BWD(T_, G_)                                                 \
  rnn_bwd_launch<T_, G_>(xw, h0, c0, w_hh, b_hh, ys, cs, dy, dh_s, dc_s,    \
                         dxw, dhw, dh0, dc0, dw, db, Tn, N, H, mode, s)
  if (dtype == MXT_F32) {
    return G == 4 ? MXT_RNN_BWD(float, 4)
                  : (G == 3 ? MXT_RNN_BWD(float, 3) : MXT_RNN_BWD(float, 1));
  }
  if (dtype == MXT_BF16) {
    return G == 4 ? MXT_RNN_BWD(__nv_bfloat16, 4)
                  : (G == 3 ? MXT_RNN_BWD(__nv_bfloat16, 3)
                            : MXT_RNN_BWD(__nv_bfloat16, 1));
  }
#undef MXT_RNN_BWD
  return (int)cudaErrorInvalidValue;
}
