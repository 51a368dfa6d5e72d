// Shared pieces of the time-fused recurrence kernels (rnn_scan_fwd.cu,
// rnn_scan_bwd.cu): mode codes, the gate math of one hidden unit forward
// and backward, the block's slice of W_hh, the h @ W_hh^T dot product of
// one batch row, and the cooperative launch that sizes its grid from
// occupancy.
//
// Work split: a block owns U consecutive hidden units with all G gates of
// each unit, so the cell update of a unit stays inside one thread. Within
// a block each warp takes batch rows n = warp, warp + 8, ...; the lanes
// split the contraction axis, and lane j finishes unit u0 + j of the row.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// mode codes shared with ops/kernels/rnn_scan.py (MODE_CODES)
enum MxtRnnMode { MXT_RNN_RELU = 0, MXT_RNN_TANH = 1, MXT_LSTM = 2,
                  MXT_GRU = 3 };

#define MXT_RNN_THREADS 256
// the most hidden units one block owns (the register arrays are sized by it)
#define MXT_RNN_MAX_UNITS 8
// values of a row each lane loads before it multiplies: the loads are all
// in flight together, so a row of H <= 768 costs one L2 round trip
#define MXT_RNN_CHUNK 24

static inline int mxt_rnn_gates(int mode) {
  return mode == MXT_LSTM ? 4 : (mode == MXT_GRU ? 3 : 1);
}

// Loads of data that other blocks wrote before the last grid barrier go
// to L2 (ld.global.cg), never to a possibly stale L1 line.
__device__ __forceinline__ float mxt_ldcg(const float* p) {
  return __ldcg(p);
}
__device__ __forceinline__ float mxt_ldcg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T>
__device__ __forceinline__ float mxt_round(float v) {
  return mxt_to_float(mxt_from_float<T>(v));
}

__device__ __forceinline__ float mxt_sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// One forward step of one unit (ops/kernels/rnn_scan.py _fwd_step):
// x, hw, b hold the unit's G gate values of xw_t, h_{t-1} @ W_hh^T and
// b_hh. The new cell state is rounded to T before tanh(c) reads it, as
// the stored state is what the backward recomputes from.
template <typename T, int G>
__device__ __forceinline__ void mxt_rnn_fwd_unit(int mode, const float* x,
                                                 const float* hw,
                                                 const float* b,
                                                 float h_prev, float c_prev,
                                                 float& h_new, float& c_new) {
  if constexpr (G == 4) {
    const float i = mxt_sigmoid((x[0] + hw[0]) + b[0]);
    const float f = mxt_sigmoid((x[1] + hw[1]) + b[1]);
    const float g = tanhf((x[2] + hw[2]) + b[2]);
    const float o = mxt_sigmoid((x[3] + hw[3]) + b[3]);
    c_new = mxt_round<T>(f * c_prev + i * g);
    h_new = o * tanhf(c_new);
  } else if constexpr (G == 3) {
    const float hr = hw[0] + b[0], hz = hw[1] + b[1], hn = hw[2] + b[2];
    const float r = mxt_sigmoid(x[0] + hr);
    const float z = mxt_sigmoid(x[1] + hz);
    const float n = tanhf(x[2] + r * hn);
    h_new = (1.f - z) * n + z * h_prev;
  } else {
    const float pre = (x[0] + hw[0]) + b[0];
    h_new = mode == MXT_RNN_TANH ? tanhf(pre) : fmaxf(pre, 0.f);
  }
}

// One reverse step of one unit (ops/kernels/rnn_scan.py _bwd_step), with
// its expression groupings: dh = dy + dh_carry; dxw and dhw (they differ
// for GRU only); dh_dir, the part of dh_{t-1} that skips W_hh (GRU: dh *
// z); dc_out, the cell carry dc * f (LSTM).
template <int G>
__device__ __forceinline__ void mxt_rnn_bwd_unit(
    int mode, const float* x, const float* hw, const float* b, float h_prev,
    float c_prev, float c_new, float y, float dy, float dh_carry,
    float dc_carry, float* dxw, float* dhw, float& dh_dir, float& dc_out) {
  const float dh = dy + dh_carry;
  dh_dir = 0.f;
  if constexpr (G == 4) {
    const float i = mxt_sigmoid((x[0] + hw[0]) + b[0]);
    const float f = mxt_sigmoid((x[1] + hw[1]) + b[1]);
    const float g = tanhf((x[2] + hw[2]) + b[2]);
    const float o = mxt_sigmoid((x[3] + hw[3]) + b[3]);
    const float tc = tanhf(c_new);
    const float u = (dh * o) * (1.f - tc);
    const float dc = (dc_carry + u) + u * tc;
    const float ug = (dc * i) * (1.f - g);
    dxw[0] = (dc * g) * (i * (1.f - i));
    dxw[1] = (dc * c_prev) * (f * (1.f - f));
    dxw[2] = ug + ug * g;
    dxw[3] = (dh * tc) * (o * (1.f - o));
    dc_out = dc * f;
#pragma unroll
    for (int k = 0; k < 4; ++k) dhw[k] = dxw[k];
  } else if constexpr (G == 3) {
    const float hr = hw[0] + b[0], hz = hw[1] + b[1], hn = hw[2] + b[2];
    const float r = mxt_sigmoid(x[0] + hr);
    const float z = mxt_sigmoid(x[1] + hz);
    const float n = tanhf(x[2] + r * hn);
    const float dz = dh * h_prev - dh * n;
    const float un = (dh * (1.f - z)) * (1.f - n);
    const float dn_pre = un + un * n;
    const float dr_pre = (dn_pre * hn) * (r * (1.f - r));
    const float dz_pre = dz * (z * (1.f - z));
    dxw[0] = dhw[0] = dr_pre;
    dxw[1] = dhw[1] = dz_pre;
    dxw[2] = dn_pre;
    dhw[2] = dn_pre * r;
    dh_dir = dh * z;
  } else {
    float dpre;
    if (mode == MXT_RNN_TANH) {
      const float ut = dh * (1.f - y);
      dpre = ut + ut * y;
    } else {
      dpre = y > 0.f ? dh : 0.f;
    }
    dxw[0] = dhw[0] = dpre;
  }
}

// The block's rows of W_hh (G*U rows of H, row g*U + j is W_hh[g*H + u0 +
// j], zero past the last unit) into shared memory at `dst`.
template <int G, int U>
__device__ void mxt_rnn_load_rows(float* dst, const float* __restrict__ w,
                                  int H, int u0, int nu) {
  for (int idx = threadIdx.x; idx < G * U * H; idx += blockDim.x) {
    const int q = idx / H, k = idx - q * H;
    const int g = q / U, j = q - g * U;
    dst[idx] = j < nu ? w[(size_t)(g * H + u0 + j) * H + k] : 0.f;
  }
}

// acc[q] = sum over k < K of v[k] * w[off[q] + k * stride] for Q sums, this
// lane taking k = lane, lane + 32, ... in that order, the warp's partial
// sums then reduced so that every lane holds every sum. v is read from L2
// (other blocks wrote it), MXT_RNN_CHUNK values at a time.
template <typename T, int Q>
__device__ __forceinline__ void mxt_rnn_warp_dot(const T* v, int K,
                                                 const float* w,
                                                 const int* off, int stride,
                                                 float* acc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0.f;
  for (int k0 = lane; k0 < K; k0 += 32 * MXT_RNN_CHUNK) {
    float vv[MXT_RNN_CHUNK];
#pragma unroll
    for (int i = 0; i < MXT_RNN_CHUNK; ++i) {
      const int k = k0 + 32 * i;
      vv[i] = k < K ? mxt_ldcg(v + k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MXT_RNN_CHUNK; ++i) {
      const int k = k0 + 32 * i;
      if (k < K) {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          acc[q] = fmaf(vv[i], w[off[q] + (size_t)k * stride], acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = mxt_warp_sum(acc[q]);
}


// Row offsets of the block's G*U rows: in the shared slice, or in W_hh
// (a row past the last unit points at row 0; its sums are never used).
template <int G, int U>
__device__ __forceinline__ void mxt_rnn_row_offsets(bool smem, int H, int u0,
                                                    int nu, int* off) {
#pragma unroll
  for (int q = 0; q < G * U; ++q) {
    const int g = q / U, j = q - g * U;
    off[q] = smem ? q * H : (j < nu ? (g * H + u0 + j) * H : 0);
  }
}

// Lane j's G values of acc (unit u0 + j) into hw, with compile-time
// indices so that acc stays in registers.
template <int G, int U>
__device__ __forceinline__ void mxt_rnn_pick(const float* acc, int lane,
                                             float* hw) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    if (lane == j) {
#pragma unroll
      for (int g = 0; g < G; ++g) hw[g] = acc[g * U + j];
    }
  }
}

// Launch kernel `fns[U-1]` (U = 1..MXT_RNN_MAX_UNITS units per block) as a
// cooperative grid of ceil(H / U) blocks, all co-resident. U starts at
// ceil(H / SMs), one block per SM, and grows until the grid fits what the
// card can hold at the kernel's occupancy. `smem_per_unit` is the shared
// memory one unit's slice of W_hh takes; where U units' slices do not fit
// a block, the kernel reads W_hh from device memory (args[w_flag_index]
// is set to 0). Returns cudaErrorCooperativeLaunchTooLarge when no U
// gives a co-resident grid.
static int mxt_rnn_coop_launch(void* const* fns, int H, size_t smem_per_unit,
                               void** args, int* w_in_smem,
                               cudaStream_t stream) {
  int dev, sms, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  int u = (H + sms - 1) / sms;
  if (u < 1) u = 1;
  if (u > MXT_RNN_MAX_UNITS) u = MXT_RNN_MAX_UNITS;
  for (; u <= MXT_RNN_MAX_UNITS; ++u) {
    const void* fn = fns[u - 1];
    size_t smem = smem_per_unit * u;
    *w_in_smem = smem <= (size_t)optin ? 1 : 0;
    if (!*w_in_smem) smem = 0;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn,
                                                      MXT_RNN_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (H + u - 1) / u;
    if (blocks <= occ * sms) {
      e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(MXT_RNN_THREADS),
                                      args, smem, stream);
      if (e != cudaSuccess) return (int)e;
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorCooperativeLaunchTooLarge;
}
