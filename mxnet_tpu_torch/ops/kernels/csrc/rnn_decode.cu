// One inference step of the recurrence (LSTM / GRU / vanilla RNN): the
// autoregressive-decode kernel.
//
// Replaces the TPU kernel mxnet_tpu/ops/kernels/rnn_scan.py `_decode_kernel`
// (launched by `_decode_pallas`). Semantics kept: from the precomputed
// input projection xw (N, G*H) = x @ W_ih^T + b_ih, one step computes
// h @ W_hh^T, adds xw and b_hh, and applies the gate math (gate order LSTM
// [i, f, g, o], GRU [r, z, n]) through mxt_rnn_fwd_unit, the scan kernels'
// own function. The arithmetic is float32; h_new (and c_new) are
// written in the activation dtype. Outputs are separate buffers: the
// kernel never writes what it reads.
//
// What has no CUDA counterpart: the TPU program keeps h, c, W_hh and b_hh
// in VMEM for the whole call. Here no block holds W_hh (G*H x H float32,
// 6.76 MB at H = 650), so the work is split as the scan kernels split it
// (rnn_scan.cuh), without their grid barrier: one ordinary launch a step,
// a block owning U hidden units with all G gates of each (G*U rows of
// W_hh), so the cell update of a unit stays inside one thread. The block
// stages h (N x H, as float) in shared memory; each warp takes rows of
// W_hh and reads each row from device memory once, dotting it with all N
// rows of h (in tiles of MXT_DEC_NB rows). Every row of W_hh is used once
// a step, so copying it into shared memory would buy nothing.
//
// Loads: a warp reads a row as consecutive 4-byte words, one 128-byte
// transaction a warp instruction, the same DRAM efficiency as 16-byte
// loads; 16 bytes a lane would make each lane read h from shared memory
// at a 4-word stride, a 4-way bank conflict on every operand. The staging
// of h keeps MXT_RNN_CHUNK loads in flight a thread, so it costs one L2
// round trip, not one a value.
//
// Fixed summation order: the sum of row r against batch row n is the
// scan kernels' (mxt_rnn_warp_dot): lane j adds k = j, j + 32, ... with
// fmaf, then the warp's shuffle tree. It depends neither on N nor on the
// other rows, so a slot's state is bit for bit the same in every batch
// size (the decode engine's continuous = static and speculative = greedy
// contracts rest on this), and a decode step equals the same position of
// rnn_scan_fwd bit for bit.
//
// Bound on the card: bytes. W_hh is read once (6.76 MB at H = 650 float32,
// 2.0 us at 3.35 TB/s) against 2*N*G*H^2 operations (27 MFLOP at N = 8,
// 0.4 us at 67 TFLOP/s); at H = 128 the 0.27 MB take 0.08 us and the
// launch itself costs more.
#include "rnn_scan.cuh"

#define MXT_DEC_THREADS 256
#define MXT_DEC_WARPS (MXT_DEC_THREADS / 32)
// batch rows one pass over a row of W_hh serves (register accumulators)
#define MXT_DEC_NB 8

// units a block owns, by gate count: 8, 9 and 8 rows of W_hh a block
template <int G>
struct MxtDecUnits {
  static constexpr int U = G == 4 ? 2 : (G == 3 ? 3 : 8);
};

// acc[i] = dot(w[0:H], sh[(n0 + i) * H : ...]) for i < nb: lane j takes
// k = j, j + 32, ... in that order (the scan kernels' mxt_rnn_warp_dot
// order), loading MXT_RNN_CHUNK values of the row before it multiplies,
// then the warp's partial sums are reduced by the same shuffle tree.
__device__ __forceinline__ void mxt_dec_row_dot(const float* __restrict__ w,
                                                const float* sh, int H,
                                                int n0, int nb, float* acc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MXT_DEC_NB; ++i) acc[i] = 0.f;
  for (int k0 = lane; k0 < H; k0 += 32 * MXT_RNN_CHUNK) {
    float wv[MXT_RNN_CHUNK];
#pragma unroll
    for (int c = 0; c < MXT_RNN_CHUNK; ++c) {
      const int k = k0 + 32 * c;
      wv[c] = k < H ? __ldg(w + k) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < MXT_RNN_CHUNK; ++c) {
      const int k = k0 + 32 * c;
      if (k < H) {
#pragma unroll
        for (int i = 0; i < MXT_DEC_NB; ++i)
          if (i < nb) acc[i] = fmaf(sh[(n0 + i) * H + k], wv[c], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MXT_DEC_NB; ++i) acc[i] = mxt_warp_sum(acc[i]);
}

template <typename T, int G>
__global__ void __launch_bounds__(MXT_DEC_THREADS)
rnn_decode_kernel(const T* __restrict__ xw, const T* __restrict__ h,
                  const T* __restrict__ c, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ h_out,
                  T* __restrict__ c_out, int N, int H, int mode) {
  constexpr int U = MxtDecUnits<G>::U;
  constexpr int R = G * U;                  // rows of W_hh this block owns
  extern __shared__ float smem[];
  float* sh = smem;                         // [N][H]: h as float
  float* shw = smem + (size_t)N * H;        // [R][N]: h @ W_hh^T
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int NH = N * H;
  for (int i0 = threadIdx.x; i0 < NH; i0 += blockDim.x * MXT_RNN_CHUNK) {
    float v[MXT_RNN_CHUNK];
#pragma unroll
    for (int q = 0; q < MXT_RNN_CHUNK; ++q) {
      const int i = i0 + q * blockDim.x;
      v[q] = i < NH ? mxt_to_float(h[i]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < MXT_RNN_CHUNK; ++q) {
      const int i = i0 + q * blockDim.x;
      if (i < NH) sh[i] = v[q];
    }
  }
  __syncthreads();

  for (int r = warp; r < R; r += MXT_DEC_WARPS) {
    const int g = r / U, j = r - g * U;
    if (j >= nu) continue;
    const float* wr = w + (size_t)(g * H + u0 + j) * H;
    for (int n0 = 0; n0 < N; n0 += MXT_DEC_NB) {
      const int nb = min(MXT_DEC_NB, N - n0);
      float acc[MXT_DEC_NB];
      mxt_dec_row_dot(wr, sh, H, n0, nb, acc);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < MXT_DEC_NB; ++i)
          if (i < nb) shw[r * N + n0 + i] = acc[i];
      }
    }
  }
  __syncthreads();

  const int GH = G * H;
  for (int t = threadIdx.x; t < nu * N; t += blockDim.x) {
    const int n = t / nu, j = t - n * nu;
    const int u = u0 + j;
    float x[G], hw[G], bias[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      x[g] = mxt_to_float(xw[(size_t)n * GH + g * H + u]);
      hw[g] = shw[(g * U + j) * N + n];
      bias[g] = b[g * H + u];
    }
    const float h_prev = sh[n * H + u];
    const float c_prev = G == 4 ? mxt_to_float(c[(size_t)n * H + u]) : 0.f;
    float h_new, c_new = 0.f;
    mxt_rnn_fwd_unit<T, G>(mode, x, hw, bias, h_prev, c_prev, h_new, c_new);
    h_out[(size_t)n * H + u] = mxt_from_float<T>(h_new);
    if (G == 4) c_out[(size_t)n * H + u] = mxt_from_float<T>(c_new);
  }
}

template <typename T, int G>
static int rnn_decode_launch(const void* xw, const void* h, const void* c,
                             const void* w, const void* b, void* h_out,
                             void* c_out, int N, int H, int mode,
                             cudaStream_t s) {
  constexpr int U = MxtDecUnits<G>::U;
  const size_t smem = sizeof(float) * ((size_t)N * H + (size_t)G * U * N);
  auto fn = rnn_decode_kernel<T, G>;
  int dev, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (H + U - 1) / U;
  fn<<<blocks, MXT_DEC_THREADS, smem, s>>>(
      static_cast<const T*>(xw), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(h_out),
      static_cast<T*>(c_out), N, H, mode);
  return (int)cudaGetLastError();
}

// xw: (N, G*H); h, c, h_out, c_out: (N, H), all contiguous in `dtype` (c
// and c_out only for LSTM, else may be null); w_hh: (G*H, H) and b_hh:
// (G*H,) contiguous float32. h_out and c_out must not overlap the inputs.
MXT_API int mxt_rnn_decode(const void* xw, const void* h, const void* c,
                           const void* w_hh, const void* b_hh, void* h_out,
                           void* c_out, int N, int H, int mode, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0) return 0;
  if (mode < MXT_RNN_RELU || mode > MXT_GRU) return (int)cudaErrorInvalidValue;
  const int G = mxt_rnn_gates(mode);
  if ((size_t)G * H * H >= (1u << 31)) return (int)cudaErrorInvalidValue;
  if (G == 4 && (c == nullptr || c_out == nullptr))
    return (int)cudaErrorInvalidValue;
#define MXT_RNN_DEC(T_, G_)                                                  \
  rnn_decode_launch<T_, G_>(xw, h, c, w_hh, b_hh, h_out, c_out, N, H, mode, s)
  if (dtype == MXT_F32) {
    return G == 4 ? MXT_RNN_DEC(float, 4)
                  : (G == 3 ? MXT_RNN_DEC(float, 3) : MXT_RNN_DEC(float, 1));
  }
  if (dtype == MXT_BF16) {
    return G == 4 ? MXT_RNN_DEC(__nv_bfloat16, 4)
                  : (G == 3 ? MXT_RNN_DEC(__nv_bfloat16, 3)
                            : MXT_RNN_DEC(__nv_bfloat16, 1));
  }
#undef MXT_RNN_DEC
  return (int)cudaErrorInvalidValue;
}
