// Shared pieces of the recurrence kernels (rnn_scan_fwd.cu, rnn_scan_bwd.cu,
// rnn_decode.cu): mode codes, the gate math of one hidden unit forward and
// backward, the summation order of h @ W_hh^T that the forward and the
// decode step share, and the card's limits that the launch plans read.
//
// The summation order (fixed, so that a decode step equals a position of
// the forward bit for bit, and a batch row's sum never depends on the
// other rows): the dot of a row of h with a row of W_hh over k < H is
// taken by the 32 lanes of a warp, lane j adding k = j, j + 32, j + 64,
// ... in that order with fmaf(h[k], w[k], acc), and the 32 partial sums
// are then added by the xor tree of mxt_warp_sum (offsets 16, 8, 4, 2, 1).
// mxt_rnn_reduce64 takes that tree for 64 sums at once (each pairwise sum
// is the same addition, so the bits are the same).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// mode codes shared with ops/kernels/rnn_scan.py (MODE_CODES)
enum MxtRnnMode { MXT_RNN_RELU = 0, MXT_RNN_TANH = 1, MXT_LSTM = 2,
                  MXT_GRU = 3 };

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

// Halve the C sums a lane holds by one level of the xor tree at offset o:
// of each pair (v[i], v[i + C/2]) the lane keeps one half (the upper when
// `hi`) and adds the partner lane's value of it; the partner keeps the
// other half. Every sum is the one mxt_warp_sum forms at that level.
template <int C>
__device__ __forceinline__ void mxt_rnn_halve(float* v, int o, bool hi) {
#pragma unroll
  for (int i = 0; i < C / 2; ++i) {
    const float send = hi ? v[i] : v[i + C / 2];
    const float keep = hi ? v[i + C / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// The warp sums of 64 values a lane holds (each the lane's partial sum of
// one dot product), by the xor tree of mxt_warp_sum: afterwards lane l
// holds the sums of values 2 l and 2 l + 1 in v[0] and v[1].
__device__ __forceinline__ void mxt_rnn_reduce64(float (&v)[64]) {
  const int lane = threadIdx.x & 31;
  mxt_rnn_halve<64>(v, 16, lane & 16);
  mxt_rnn_halve<32>(v, 8, lane & 8);
  mxt_rnn_halve<16>(v, 4, lane & 4);
  mxt_rnn_halve<8>(v, 2, lane & 2);
  mxt_rnn_halve<4>(v, 1, lane & 1);
}

// The current device's SM count and the shared memory a block may opt in to.
static inline int mxt_device_limits(int* sms, int* optin) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}
