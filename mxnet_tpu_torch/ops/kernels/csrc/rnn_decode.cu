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
// W_hh), so the cell update of a unit stays inside one thread, and one
// group of at most NR batch rows. The block stages its group's rows of h
// (NR x H, as float) in shared memory; NR is the most rows that fit a
// block (88 at H = 650), balanced over the groups, so any batch runs
// (N 128 at H 650 takes two groups of 64). Each warp takes rows
// of W_hh and reads each row from device memory once a group, dotting it
// with the group's rows of h (in tiles of MXT_DEC_NB rows). Every row of
// W_hh is used once a group, so copying it into shared memory would buy
// nothing. Where not even one row of h fits (H > ~58,000), the dot reads
// h through L2 instead of staging it.
//
// Loads: a warp reads a row as consecutive 4-byte words, one 128-byte
// transaction a warp instruction, the same DRAM efficiency as 16-byte
// loads; 16 bytes a lane would make each lane read h from shared memory
// at a 4-word stride, a 4-way bank conflict on every operand. The staging
// of h keeps MXT_RNN_CHUNK loads in flight a thread, so it costs one L2
// round trip, not one a value.
//
// Fixed summation order: the sum of row r against batch row n is the
// order of rnn_scan.cuh, the forward's: lane j adds k = j, j + 32, ...
// with fmaf, then the warp's shuffle tree. It depends neither on N, nor on
// the row group, nor on the other rows, so a slot's state is bit for bit
// the same in every batch size (the decode engine's continuous = static
// and speculative = greedy contracts rest on this), and a decode step
// equals the same position of rnn_scan_fwd bit for bit.
//
// Bound on the card: bytes. W_hh is read once a group (6.76 MB at H = 650
// float32, 2.0 us at 3.35 TB/s) against 2*N*G*H^2 operations (27 MFLOP at
// N = 8, 0.4 us at 67 TFLOP/s); at H = 128 the 0.27 MB take 0.08 us and
// the launch itself costs more.
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

// acc[i] = dot(w[0:H], h row n0 + i) for i < nb: lane j takes k = j,
// j + 32, ... in that order (rnn_scan.cuh's order), loading MXT_RNN_CHUNK
// values of the row before it multiplies, then the warp's partial sums are
// reduced by the same shuffle tree. h row n is sh[n * H + k] (staged) or
// hg[n * H + k] (device memory, read through L2).
template <typename T, bool STAGED>
__device__ __forceinline__ void mxt_dec_row_dot(const float* __restrict__ w,
                                                const float* sh, const T* hg,
                                                int H, int n0, int nb,
                                                float* acc) {
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
        for (int i = 0; i < MXT_DEC_NB; ++i) {
          if (i >= nb) continue;
          // 32-bit indices into the staged rows (they fit a block)
          const float hv = STAGED ? sh[(n0 + i) * H + k]
                                  : mxt_ldcg(hg + (size_t)(n0 + i) * H + k);
          acc[i] = fmaf(hv, wv[c], acc[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MXT_DEC_NB; ++i) acc[i] = mxt_warp_sum(acc[i]);
}

template <typename T, int G, bool STAGED>
__global__ void __launch_bounds__(MXT_DEC_THREADS)
rnn_decode_kernel(const T* __restrict__ xw, const T* __restrict__ h,
                  const T* __restrict__ c, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ h_out,
                  T* __restrict__ c_out, int N, int H, int mode, int NR) {
  constexpr int U = MxtDecUnits<G>::U;
  constexpr int R = G * U;                  // rows of W_hh this block owns
  extern __shared__ float smem[];
  const int n_ub = (H + U - 1) / U;
  const int u0 = (blockIdx.x % n_ub) * U;
  const int nbase = (blockIdx.x / n_ub) * NR;
  const int nu = min(U, H - u0), nr = min(NR, N - nbase);
  float* sh = smem;                         // [nr][H]: the group's h as float
  float* shw = smem + (STAGED ? (size_t)NR * H : 0);   // [R][NR]: h @ W_hh^T
  const T* hg = h + (size_t)nbase * H;      // the group's rows of h
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (STAGED) {
    const int NH = nr * H;
    for (int i0 = threadIdx.x; i0 < NH; i0 += blockDim.x * MXT_RNN_CHUNK) {
      float v[MXT_RNN_CHUNK];
#pragma unroll
      for (int q = 0; q < MXT_RNN_CHUNK; ++q) {
        const int i = i0 + q * blockDim.x;
        v[q] = i < NH ? mxt_to_float(hg[i]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < MXT_RNN_CHUNK; ++q) {
        const int i = i0 + q * blockDim.x;
        if (i < NH) sh[i] = v[q];
      }
    }
    __syncthreads();
  }

  for (int r = warp; r < R; r += MXT_DEC_WARPS) {
    const int g = r / U, j = r - g * U;
    if (j >= nu) continue;
    const float* wr = w + ((size_t)g * H + u0 + j) * H;
    for (int n0 = 0; n0 < nr; n0 += MXT_DEC_NB) {
      const int nb = min(MXT_DEC_NB, nr - n0);
      float acc[MXT_DEC_NB];
      mxt_dec_row_dot<T, STAGED>(wr, sh, hg, H, n0, nb, acc);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < MXT_DEC_NB; ++i)
          if (i < nb) shw[r * NR + n0 + i] = acc[i];
      }
    }
  }
  __syncthreads();

  const size_t GH = (size_t)G * H;
  for (int t = threadIdx.x; t < nu * nr; t += blockDim.x) {
    const int nl = t / nu, j = t - nl * nu;
    const int u = u0 + j;
    const size_t n = (size_t)nbase + nl;
    float x[G], hw[G], bias[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      x[g] = mxt_to_float(xw[n * GH + (size_t)g * H + u]);
      hw[g] = shw[(g * U + j) * NR + nl];
      bias[g] = b[(size_t)g * H + u];
    }
    const float h_prev = STAGED ? sh[nl * H + u]
                                : mxt_to_float(h[n * H + u]);
    const float c_prev = G == 4 ? mxt_to_float(c[n * H + u]) : 0.f;
    float h_new, c_new = 0.f;
    mxt_rnn_fwd_unit<T, G>(mode, x, hw, bias, h_prev, c_prev, h_new, c_new);
    h_out[n * H + u] = mxt_from_float<T>(h_new);
    if (G == 4) c_out[n * H + u] = mxt_from_float<T>(c_new);
  }
}

// Rows a block stages (its group of the batch): the most that fit the
// card's shared memory beside the sums, balanced over the groups; 0 when
// not one row of h fits (the kernel then reads h through L2).
static int dec_group_rows(int N, int H, int R, int optin, int* groups) {
  const size_t budget = (size_t)optin / sizeof(float);
  const size_t per_row = (size_t)H + R;
  int most = (int)(budget / per_row);
  if (most < 1) {
    most = (int)(budget / R);      // the sums alone
    if (most > N) most = N;
    *groups = (N + most - 1) / most;
    return -((N + *groups - 1) / *groups);
  }
  if (most > N) most = N;
  *groups = (N + most - 1) / most;
  return (N + *groups - 1) / *groups;
}

template <typename T, int G>
static int rnn_decode_launch(const void* xw, const void* h, const void* c,
                             const void* w, const void* b, void* h_out,
                             void* c_out, int N, int H, int mode,
                             cudaStream_t s) {
  constexpr int U = MxtDecUnits<G>::U;
  int sms, optin, groups;
  int e = mxt_device_limits(&sms, &optin);
  if (e) return e;
  int nr = dec_group_rows(N, H, G * U, optin, &groups);
  const bool staged = nr > 0;
  if (!staged) nr = -nr;
  const size_t smem =
      sizeof(float) * ((size_t)G * U * nr + (staged ? (size_t)nr * H : 0));
  auto fn = staged ? rnn_decode_kernel<T, G, true>
                   : rnn_decode_kernel<T, G, false>;
  // above 48 KB a launch must be allowed more: the card's most, the same
  // value from every call and host thread (a launch that fits 48 KB, as
  // decode's buckets do, leaves the kernel's attributes as they are)
  if (smem > 48 * 1024) {
    e = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e) return e;
  }
  const long long blocks = (long long)((H + U - 1) / U) * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fn<<<(unsigned)blocks, MXT_DEC_THREADS, smem, s>>>(
      static_cast<const T*>(xw), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(h_out),
      static_cast<T*>(c_out), N, H, mode, nr);
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
