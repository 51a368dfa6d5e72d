// Time-fused recurrence forward (LSTM / GRU / vanilla RNN), one launch
// per (layer, direction) that owns the whole sequence.
//
// Replaces the TPU kernel mxnet_tpu/ops/kernels/rnn_scan.py `_fwd_kernel`
// (launched by `_scan_fwd_pallas`). Semantics kept: from the precomputed
// input projections xw (T, N, G*H) = x @ W_ih^T + b_ih, each step computes
// h_{t-1} @ W_hh^T, adds xw_t and b_hh, applies the gate math (gate order
// LSTM [i, f, g, o], GRU [r, z, n]) and writes h_t into ys (and c_t into
// cs for LSTM, the residual the backward reads). The state keeps the
// activation dtype from step to step (the TPU's h_s / c_s scratch); the
// arithmetic of a step is float32.
//
// What has no CUDA counterpart: the TPU program walks every time block
// with h and c pinned in VMEM and W_hh (G*H x H, 6.8 MB at H = 650)
// resident. No block can hold that here, so this is a persistent
// cooperative kernel: each block owns U hidden units with all G gates of
// each (mxt_rnn_coop_launch sizes U and the grid from occupancy, so every
// block is resident), keeps those G*U rows of W_hh in shared memory
// (52 KB at H = 650, U = 5; read from device memory, which L2 holds, when
// they do not fit), and after each step the grid meets at a barrier
// (grid.sync()) before anyone reads h_t.
//
// Bound on the card: operations (2*T*N*G*H^2 flops; 7.57 GFLOP at T 35,
// N 64, G 4, H 650, 0.11 ms at 67 TFLOP/s float32). It is in fact
// latency-bound: T dependent steps, each a grid barrier plus, per batch
// row, a dot product of length H per output split over a warp's 32 lanes
// (each lane loads its h values MXT_RNN_CHUNK at a time, so a row costs
// one L2 round trip, not one per value) and reduced with warp shuffles.
#include "rnn_scan.cuh"

template <typename T, int G, int U>
__global__ void __launch_bounds__(MXT_RNN_THREADS)
rnn_scan_fwd_kernel(const T* __restrict__ xw, const T* __restrict__ h0,
                    const T* __restrict__ c0, const float* __restrict__ w,
                    const float* __restrict__ b, T* ys, T* cs, int Tn, int N,
                    int H, int mode, int w_in_smem) {
  extern __shared__ float sw[];   // [G*U][H]: the block's rows of W_hh
  cg::grid_group grid = cg::this_grid();
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int GH = G * H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (w_in_smem) {
    mxt_rnn_load_rows<G, U>(sw, w, H, u0, nu);
    __syncthreads();
  }
  const float* wb = w_in_smem ? sw : w;
  int off[G * U];
  mxt_rnn_row_offsets<G, U>(w_in_smem, H, u0, nu, off);
  float bias[G];
  if (lane < nu) {
#pragma unroll
    for (int g = 0; g < G; ++g) bias[g] = b[g * H + u0 + lane];
  }

  for (int t = 0; t < Tn; ++t) {
    const size_t step = (size_t)N * H;
    const T* hprev = t == 0 ? h0 : ys + (t - 1) * step;
    const T* cprev = t == 0 ? c0 : cs + (t - 1) * step;
    for (int n = warp; n < N; n += nwarps) {
      float acc[G * U];
      // acc[g*U + j] = h_{t-1}[n] . W_hh[g*H + u0 + j]
      mxt_rnn_warp_dot<T, G * U>(hprev + (size_t)n * H, H, wb, off, 1, acc);
      float hw[G];
      mxt_rnn_pick<G, U>(acc, lane, hw);
      if (lane < nu) {
        const int u = u0 + lane;
        const size_t row = (size_t)t * N + n;
        float x[G];
#pragma unroll
        for (int g = 0; g < G; ++g) x[g] = mxt_to_float(xw[row * GH + g * H + u]);
        const float h_prev = mxt_ldcg(hprev + (size_t)n * H + u);
        const float c_prev = G == 4 ? mxt_ldcg(cprev + (size_t)n * H + u) : 0.f;
        float h_new, c_new = 0.f;
        mxt_rnn_fwd_unit<T, G>(mode, x, hw, bias, h_prev, c_prev, h_new, c_new);
        ys[row * H + u] = mxt_from_float<T>(h_new);
        if (G == 4) cs[row * H + u] = mxt_from_float<T>(c_new);
      }
    }
    grid.sync();
  }
}

template <typename T, int G>
static int rnn_fwd_launch(const void* xw, const void* h0, const void* c0,
                          const void* w, const void* b, void* ys, void* cs,
                          int Tn, int N, int H, int mode, cudaStream_t s) {
  void* const fns[MXT_RNN_MAX_UNITS] = {
      (void*)rnn_scan_fwd_kernel<T, G, 1>, (void*)rnn_scan_fwd_kernel<T, G, 2>,
      (void*)rnn_scan_fwd_kernel<T, G, 3>, (void*)rnn_scan_fwd_kernel<T, G, 4>,
      (void*)rnn_scan_fwd_kernel<T, G, 5>, (void*)rnn_scan_fwd_kernel<T, G, 6>,
      (void*)rnn_scan_fwd_kernel<T, G, 7>, (void*)rnn_scan_fwd_kernel<T, G, 8>};
  const T* a_xw = static_cast<const T*>(xw);
  const T* a_h0 = static_cast<const T*>(h0);
  const T* a_c0 = static_cast<const T*>(c0);
  const float* a_w = static_cast<const float*>(w);
  const float* a_b = static_cast<const float*>(b);
  T* a_ys = static_cast<T*>(ys);
  T* a_cs = static_cast<T*>(cs);
  int w_in_smem = 0;
  void* args[] = {&a_xw, &a_h0, &a_c0, &a_w, &a_b, &a_ys, &a_cs,
                  &Tn, &N, &H, &mode, &w_in_smem};
  return mxt_rnn_coop_launch(fns, H, sizeof(float) * G * (size_t)H, args,
                             &w_in_smem, s);
}

// xw: (T, N, G*H); h0, c0: (N, H); ys, cs: (T, N, H), all contiguous in
// `dtype` (c0 and cs only for LSTM, else may be null); w_hh: (G*H, H)
// and b_hh: (G*H,) contiguous float32.
MXT_API int mxt_rnn_scan_fwd(const void* xw, const void* h0, const void* c0,
                             const void* w_hh, const void* b_hh, void* ys,
                             void* cs, int Tn, int N, int H, int mode,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tn <= 0 || N <= 0 || H <= 0) return 0;
  if (mode < MXT_RNN_RELU || mode > MXT_GRU) return (int)cudaErrorInvalidValue;
  const int G = mxt_rnn_gates(mode);
  if ((size_t)G * H * H >= (1u << 31)) return (int)cudaErrorInvalidValue;
  if (G == 4 && (c0 == nullptr || cs == nullptr))
    return (int)cudaErrorInvalidValue;
#define MXT_RNN_FWD(T_, G_)                                                  \
  rnn_fwd_launch<T_, G_>(xw, h0, c0, w_hh, b_hh, ys, cs, Tn, N, H, mode, s)
  if (dtype == MXT_F32) {
    return G == 4 ? MXT_RNN_FWD(float, 4)
                  : (G == 3 ? MXT_RNN_FWD(float, 3) : MXT_RNN_FWD(float, 1));
  }
  if (dtype == MXT_BF16) {
    return G == 4 ? MXT_RNN_FWD(__nv_bfloat16, 4)
                  : (G == 3 ? MXT_RNN_FWD(__nv_bfloat16, 3)
                            : MXT_RNN_FWD(__nv_bfloat16, 1));
  }
#undef MXT_RNN_FWD
  return (int)cudaErrorInvalidValue;
}
