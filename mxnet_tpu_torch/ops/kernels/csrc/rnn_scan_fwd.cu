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
// resident. No block holds that here, so this is a persistent cooperative
// grid that meets at one grid barrier a step.
//
// Bound on the card: operations, 2*T*N*G*H^2 flops (7.57 GFLOP at the LM's
// T 35, N 64, G 4, H 650: 0.11 ms at 67 TFLOP/s float32). In fact every
// step waits for the one before it, so the design keeps a step's latency
// short:
//   - Tiles. A tile is NB batch rows x UP hidden units with all G gates of
//     each unit, so the cell update of a (row, unit) pair stays inside one
//     thread (32 x 10 at the LM's shape: 130 tiles). The plan
//     (fwd_plan, also the query mxt_rnn_fwd_plan) picks the tile from the
//     card's SM count and shared memory; every block is resident, and where
//     there are more tiles than SMs a block takes several tiles a step.
//   - W_hh. Where a block has one tile and the tile's G*UP rows of W_hh fit
//     beside the staged h, they stay in shared memory for the whole
//     sequence (104 KB at the LM's shape); else the product reads them
//     through L2 each step.
//   - A step: the xw_t values, the bias and the previous state of the
//     thread's own pairs are loaded first, so they fly while the tile's
//     rows of h_{t-1} are staged into shared memory (16-byte L2 loads,
//     several in flight a thread) and multiplied; where a row is too long
//     for shared memory, h is staged in column chunks. The product is
//     register-tiled: a warp takes a patch of 8 rows x 8 gate rows, each
//     lane a slice of the contraction (k = lane, lane + 32, ...) for all
//     64 outputs, so one value loaded from shared memory feeds 8 FMAs; the
//     patch is then reduced by mxt_rnn_reduce64 (the summation order of
//     rnn_scan.cuh, which rnn_decode.cu takes too, so a decode step equals
//     a position here bit for bit). Then the gate math (mxt_rnn_fwd_unit)
//     of the thread's pairs, and ONE grid barrier.
#include "rnn_scan.cuh"

namespace {

constexpr int kFT = 256;          // threads of a block
constexpr int kFW = kFT / 32;     // warps of a block
constexpr int kPatch = 8;         // rows and gate rows of a warp's patch
constexpr int kMaxPairs = 2;      // (row, unit) pairs a thread owns in a tile
constexpr int kStageVec = 8;      // 16-byte loads in flight a thread

// count elements of src into the floats at dst (contiguous in both):
// 16-byte L2 loads from the first 16-byte boundary,
// kStageVec of them in flight a thread, single elements around them
template <typename T>
__device__ __forceinline__ void stage_flat(float* dst, const T* src,
                                           int count) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) & 15u) / sizeof(T));
  const int peel = min(count, mis ? V - mis : 0);
  for (int i = tid; i < peel; i += kFT) dst[i] = mxt_to_float(mxt_ldcg(src + i));
  const int nvec = (count - peel) / V;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + peel);
  float* d = dst + peel;
  for (int v0 = tid; v0 < nvec; v0 += kFT * kStageVec) {
    uint4 r[kStageVec];
#pragma unroll
    for (int b = 0; b < kStageVec; ++b) {
      const int idx = v0 + b * kFT;
      if (idx < nvec) r[b] = __ldcg(s4 + idx);
    }
#pragma unroll
    for (int b = 0; b < kStageVec; ++b) {
      const int idx = v0 + b * kFT;
      if (idx >= nvec) continue;
      const unsigned u[4] = {r[b].x, r[b].y, r[b].z, r[b].w};
      float* o = d + (size_t)idx * V;
      if constexpr (V == 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = __uint_as_float(u[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[2 * e] = __uint_as_float(u[e] << 16);
          o[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
        }
      }
    }
  }
  for (int i = peel + nvec * V + tid; i < count; i += kFT)
    dst[i] = mxt_to_float(mxt_ldcg(src + i));
}

// acc[r * 8 + q] += h[r][k] * w[q][k] for this lane's k = k_lo + lane,
// k_lo + lane + 32, ... below k_hi (k_lo a multiple of 32), in that order;
// h[r][k] is hs[r * ldh + k - k0] (the staged columns start at k0), w[q]
// a row of W_hh in shared memory or device memory
template <bool WS>
__device__ __forceinline__ void patch_fma(float (&acc)[64], const float* hs,
                                          int ldh, int k0,
                                          const float* const (&w)[kPatch],
                                          int k_lo, int k_hi) {
  const int lane = threadIdx.x & 31;
  auto step = [&](int k) {
    float hv[kPatch], wv[kPatch];
#pragma unroll
    for (int r = 0; r < kPatch; ++r) hv[r] = hs[r * ldh + k - k0];
#pragma unroll
    for (int q = 0; q < kPatch; ++q) wv[q] = WS ? w[q][k] : __ldg(w[q] + k);
#pragma unroll
    for (int r = 0; r < kPatch; ++r)
#pragma unroll
      for (int q = 0; q < kPatch; ++q)
        acc[r * kPatch + q] = fmaf(hv[r], wv[q], acc[r * kPatch + q]);
  };
  int k = k_lo + lane;
  for (; k + 96 < k_hi; k += 128) {   // four k a lane at once: fewer address
    step(k);                          // updates, loads ahead of the FMAs
    step(k + 32);
    step(k + 64);
    step(k + 96);
  }
  for (; k < k_hi; k += 32) step(k);
}

template <typename T, int G, bool WS>
__global__ void __launch_bounds__(kFT, 1)
rnn_scan_fwd_kernel(const T* __restrict__ xw, const T* __restrict__ h0,
                    const T* __restrict__ c0, const float* __restrict__ w,
                    const float* __restrict__ b, T* ys, T* cs, int Tn, int N,
                    int H, int mode, int NB, int UP, int kc) {
  extern __shared__ float4 smem_v[];
  cg::grid_group grid = cg::this_grid();
  const int GU = G * UP;
  const int GUP = (GU + kPatch - 1) / kPatch * kPatch;
  const bool whole = kc >= H;           // whole rows of h staged at once
  const int ldh = whole ? H : kc;
  // [GU][H] W_hh's rows of the tile (WS); [NB][GUP] the tile's sums of
  // h @ W_hh^T; [NB][ldh] the staged rows of h_{t-1}
  float* ws = reinterpret_cast<float*>(smem_v);
  float* hwx = ws + (WS ? (size_t)GU * H : 0);
  float* hs = hwx + (size_t)NB * GUP;
  const int n_ug = (H + UP - 1) / UP;
  const int tiles = ((N + NB - 1) / NB) * n_ug;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pr = NB / kPatch, npatch = pr * (GUP / kPatch);
  const size_t GH = (size_t)G * H, step = (size_t)N * H;

  if (WS) {   // one tile a block: its rows of W_hh, once (a gate's rows
              // of the tile are contiguous in W_hh; rows past H are zero)
    const int u0 = (blockIdx.x % n_ug) * UP, nu = min(UP, H - u0);
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      float* dst = ws + (size_t)g * UP * H;
      stage_flat<float>(dst, w + ((size_t)g * H + u0) * H, nu * H);
      for (int i = nu * H + tid; i < UP * H; i += kFT) dst[i] = 0.f;
    }
  }

  for (int t = 0; t < Tn; ++t) {
    const T* hprev = t == 0 ? h0 : ys + (t - 1) * step;
    const T* cprev = t == 0 ? c0 : cs + (t - 1) * step;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile / n_ug) * NB, u0 = (tile % n_ug) * UP;
      const int nb = min(NB, N - n0), nu = min(UP, H - u0);
      // this thread's pairs: their xw_t, bias and state, in flight
      // through the product
      float x[kMaxPairs][G], bias[kMaxPairs][G], hp[kMaxPairs], cp[kMaxPairs];
      bool own[kMaxPairs];
#pragma unroll
      for (int m = 0; m < kMaxPairs; ++m) {
        const int p = tid + kFT * m, nl = p / UP, ul = p - nl * UP;
        own[m] = nl < nb && ul < nu;
        if (!own[m]) continue;
        const size_t su = (size_t)(n0 + nl) * H + u0 + ul;
        const size_t row = (size_t)t * N + n0 + nl;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          x[m][g] = mxt_to_float(xw[row * GH + (size_t)g * H + u0 + ul]);
          bias[m][g] = b[(size_t)g * H + u0 + ul];
        }
        // the thread wrote these itself a step ago (or they are inputs)
        hp[m] = G == 3 ? mxt_to_float(hprev[su]) : 0.f;
        cp[m] = G == 4 ? mxt_to_float(cprev[su]) : 0.f;
      }

      if (whole) {
        stage_flat<T>(hs, hprev + (size_t)n0 * H, nb * H);
        __syncthreads();
      }
      for (int base = 0; base < npatch; base += kFW) {
        const int patch = base + warp;
        const bool active = patch < npatch;
        const int r0 = (patch % pr) * kPatch, q0 = (patch / pr) * kPatch;
        const float* wr[kPatch];
#pragma unroll
        for (int q = 0; q < kPatch; ++q) {
          const int qq = q0 + q < GU ? q0 + q : 0;
          const int g = qq / UP, j = qq - g * UP;
          wr[q] = WS ? ws + (size_t)qq * H
                     : w + ((size_t)g * H + u0 + (j < nu ? j : 0)) * H;
        }
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        for (int k0 = 0; k0 < H; k0 += ldh) {
          const int k1 = min(H, k0 + ldh);
          if (!whole) {   // the columns [k0, k1) of the tile's rows
            __syncthreads();
            const int wdt = k1 - k0;
            for (int idx = tid; idx < nb * wdt; idx += kFT) {
              const int r = idx / wdt, c = idx - r * wdt;
              hs[r * ldh + c] =
                  mxt_to_float(mxt_ldcg(hprev + (size_t)(n0 + r) * H + k0 + c));
            }
            __syncthreads();
          }
          if (active)
            patch_fma<WS>(acc, hs + r0 * ldh, ldh, k0, wr, k0, k1);
        }
        if (active) {
          mxt_rnn_reduce64(acc);
          // lane l holds outputs 2 l, 2 l + 1: row l / 4, gate rows 2 (l % 4)
          // and 2 (l % 4) + 1 of the patch
          float* o = hwx + (size_t)(r0 + (lane >> 2)) * GUP + q0 + 2 * (lane & 3);
          o[0] = acc[0];
          o[1] = acc[1];
        }
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kMaxPairs; ++m) {
        if (!own[m]) continue;
        const int p = tid + kFT * m, nl = p / UP, ul = p - nl * UP;
        float hw[G];
#pragma unroll
        for (int g = 0; g < G; ++g) hw[g] = hwx[(size_t)nl * GUP + g * UP + ul];
        float h_new, c_new = 0.f;
        mxt_rnn_fwd_unit<T, G>(mode, x[m], hw, bias[m], hp[m], cp[m], h_new,
                               c_new);
        const size_t out = (size_t)t * step + (size_t)(n0 + nl) * H + u0 + ul;
        ys[out] = mxt_from_float<T>(h_new);
        if (G == 4) cs[out] = mxt_from_float<T>(c_new);
      }
      __syncthreads();   // hs and hwx are the next tile's
    }
    if (t + 1 < Tn) grid.sync();
  }
}

struct FwdPlan {
  int nb, up, tiles, blocks, ws, kc;
  size_t smem;
};

// The tile of the forward for (N, H, G) on this card (see the note at the
// top): among NB in {8, ..., 256} and UP with NB*UP <= kFT*kMaxPairs, the
// least estimated time a step, counted in shared-memory load clocks a
// block: its tiles (one or more a block over at most one block an SM) x
// (rounds of patches x ceil(H/32) x 16 loads, x 2.5 where W_hh comes
// through L2) plus staging. Fails only when no one row of h fits a block.
static bool fwd_plan(int N, int H, int G, int sms, int optin,
                     FwdPlan* best) {
  const size_t budget = (size_t)optin / sizeof(float);
  double best_cost = -1;
  const int kiters = (H + 31) / 32;
  for (int nb = kPatch; nb <= 256; nb *= 2) {
    if (nb >= 2 * ((N + kPatch - 1) / kPatch * kPatch) && nb > kPatch) break;
    for (int up = 1; nb * up <= kFT * kMaxPairs && up <= H; ++up) {
      const int gu = G * up, gup = (gu + kPatch - 1) / kPatch * kPatch;
      const long long tiles =
          (long long)((N + nb - 1) / nb) * ((H + up - 1) / up);
      const long long blocks = tiles < sms ? tiles : sms;
      const long long tpb = (tiles + blocks - 1) / blocks;
      const size_t hwx = (size_t)nb * gup;
      for (int ws = 1; ws >= 0; --ws) {
        if (ws && tpb > 1) continue;
        const size_t wfl = ws ? (size_t)gu * H : 0;
        if (wfl + hwx + (size_t)nb * 32 > budget) continue;
        const size_t room = budget - wfl - hwx;
        int kc;
        if ((size_t)nb * H <= room) {
          kc = H;
        } else {
          kc = (int)(room / nb) / 32 * 32;
          if (kc < 32) continue;
        }
        const int rounds = (nb / kPatch * (gup / kPatch) + kFW - 1) / kFW;
        const double product = (double)rounds * kiters * 16 * (ws ? 1.0 : 2.5);
        const double staging =
            (double)nb * H / kFT * 2 * (kc >= H ? 1 : rounds);
        const double cost = (double)tpb * (product + staging + 400);
        if (best_cost < 0 || cost < best_cost) {
          best_cost = cost;
          const size_t fl = wfl + hwx + (size_t)nb * (kc >= H ? H : kc);
          *best = FwdPlan{nb, up, (int)tiles, (int)blocks, ws, kc,
                          fl * sizeof(float)};
        }
      }
    }
  }
  return best_cost >= 0;
}

template <typename T, int G>
static void fwd_fns(void* (&fns)[2]) {
  fns[0] = (void*)rnn_scan_fwd_kernel<T, G, false>;
  fns[1] = (void*)rnn_scan_fwd_kernel<T, G, true>;
}

static void fwd_fns_of(int G, int dtype, void* (&fns)[2]) {
  if (dtype == MXT_F32) {
    if (G == 4) fwd_fns<float, 4>(fns);
    else if (G == 3) fwd_fns<float, 3>(fns);
    else fwd_fns<float, 1>(fns);
  } else {
    if (G == 4) fwd_fns<__nv_bfloat16, 4>(fns);
    else if (G == 3) fwd_fns<__nv_bfloat16, 3>(fns);
    else fwd_fns<__nv_bfloat16, 1>(fns);
  }
}

// the plan for (N, H, G) and the kernel it launches; every call sets both
// kernels' shared-memory limit to the card's most (the same value from
// every call and host thread, so no call changes it under another's
// launch), and the grid is capped by the occupancy at the plan's size
static int fwd_prepare(int N, int H, int G, int dtype, FwdPlan* plan,
                       void** fn) {
  int sms, optin;
  int e = mxt_device_limits(&sms, &optin);
  if (e) return e;
  void* fns[2];
  fwd_fns_of(G, dtype, fns);
  for (int i = 0; i < 2; ++i) {
    e = (int)cudaFuncSetAttribute(
        fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e) return e;
  }
  if (!fwd_plan(N, H, G, sms, optin, plan))
    return (int)cudaErrorInvalidValue;
  *fn = fns[plan->ws];
  int occ = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, *fn, kFT,
                                                         plan->smem);
  if (e) return e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

}  // namespace

// The forward's plan for (N, H, mode, dtype) on the current device, as a
// launch would choose it: out = {batch rows a tile, hidden units a tile,
// tiles, blocks, tiles a block takes a step (at most), 1 if W_hh's rows
// stay in shared memory else 0 (read through L2), columns of h staged at
// once (H: whole rows)}. Launches nothing.
MXT_API int mxt_rnn_fwd_plan(int N, int H, int mode, int dtype, int* out) {
  if (N <= 0 || H <= 0 || mode < MXT_RNN_RELU || mode > MXT_GRU ||
      (dtype != MXT_F32 && dtype != MXT_BF16))
    return (int)cudaErrorInvalidValue;
  FwdPlan plan;
  void* fn;
  const int e = fwd_prepare(N, H, mxt_rnn_gates(mode), dtype, &plan, &fn);
  if (e) return e;
  out[0] = plan.nb;
  out[1] = plan.up;
  out[2] = plan.tiles;
  out[3] = plan.blocks;
  out[4] = (plan.tiles + plan.blocks - 1) / plan.blocks;
  out[5] = plan.ws;
  out[6] = plan.kc < H ? plan.kc : H;
  return 0;
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
  if (mode < MXT_RNN_RELU || mode > MXT_GRU ||
      (dtype != MXT_F32 && dtype != MXT_BF16))
    return (int)cudaErrorInvalidValue;
  const int G = mxt_rnn_gates(mode);
  if (G == 4 && (c0 == nullptr || cs == nullptr))
    return (int)cudaErrorInvalidValue;
  FwdPlan plan;
  void* fn;
  int e = fwd_prepare(N, H, G, dtype, &plan, &fn);
  if (e) return e;
  int nb = plan.nb, up = plan.up, kc = plan.kc;
  void* args[] = {const_cast<void**>(&xw), const_cast<void**>(&h0),
                  const_cast<void**>(&c0), const_cast<void**>(&w_hh),
                  const_cast<void**>(&b_hh), &ys, &cs, &Tn, &N, &H, &mode,
                  &nb, &up, &kc};
  e = (int)cudaLaunchCooperativeKernel(fn, dim3(plan.blocks), dim3(kFT), args,
                                       plan.smem, s);
  if (e) return e;
  return (int)cudaGetLastError();
}
