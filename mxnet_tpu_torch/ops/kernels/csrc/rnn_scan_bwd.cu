// Time-fused recurrence backward (LSTM / GRU / vanilla RNN): dxw, dh0,
// dc0, dW_hh and db_hh of one (layer, direction), one C entry.
//
// Replaces the TPU kernel mxnet_tpu/ops/kernels/rnn_scan.py `_bwd_kernel`
// (launched by `_scan_bwd_pallas`). Semantics kept: a reverse-time walk
// from t = T-1 to 0 over the gates recomputed from xw_t and h_{t-1}, with
// dh = dy_t + dh_carry and the dc carry (seeded with c_T's cotangent at
// t = T-1, exactly where the scan transpose takes it), mirroring
// _bwd_step's expression groupings (mxt_rnn_bwd_unit); the carries dh and
// dc and the sums dW and db are float32, as the TPU scratch is; dxw, dh0
// and dc0 are written in the activation dtype, dW and db in W_hh's. No
// atomics: a card repeats its result bit for bit.
//
// Bound on the card at the LM's layer (T 35, N 64, H 650, LSTM, float32):
// three products of 2*T*N*G*H^2 = 7.57 GFLOP (the recompute, dh and dW),
// 22.7 GFLOP, 0.34 ms at 67 TFLOP/s; operations bound it.
//
// Three kernels, launched in order on the caller's stream:
// 1. rnn_gemm_kernel, the recompute hoisted out of the walk: hw[m] =
//    h_{t-1}[m] @ W_hh^T for all T*N rows m = t*N + n at once (h_{-1} =
//    h0), into the float32 `dhw` scratch (T*N*G*H*4 bytes, 23.3 MB at the
//    LM's shape). It reads only the forward's stored ys and h0, so none of
//    it needs to wait for the walk. Its sums run in another order than the
//    forward kernel's, so the recomputed gates differ from the forward's
//    by float32 rounding (where the first version matched them bit for
//    bit): within 1e-4 + 1e-4 |ref| of the plain backward.
// 2. rnn_bwd_walk_kernel, a persistent cooperative grid that walks the
//    steps. A block owns NB batch rows x UP hidden units (16 x 20 at the
//    LM's shape: 132 blocks, one an SM) and keeps their dh and dc carries
//    in shared memory, beside W_hh's columns of its units (G*H x UP floats,
//    208 KB there). Where no tile with the slice in shared memory keeps
//    the whole grid resident (the slice grows with G*H*UP, the grid with
//    H/UP), the walk reads W_hh through L2 instead: at N 300, LSTM and
//    GRU at H 1,024 and the one-gate modes at H 1,500; the card tests and
//    phase 3 of chip_smoke.py run that branch there. Where not even that
//    keeps one tile a block resident (LSTM at N 512 x H 4,096), the grid
//    is as many blocks as the card holds and each block takes several
//    tiles a step, their dh and dc carries kept in the wrapper's float32
//    dh_s / dc_s.
//    Per step: the gate backward of its (row, unit) pairs turns
//    hw_t into the dgates in place in `dhw` (and writes dxw); ONE grid
//    barrier; then dh_{t-1} of its pairs = dh_dir + dhw_t @ W_hh[:, units],
//    each thread summing two rows over an interleaved slice of the G*H
//    depth (16-byte L2 loads of dhw_t, four chunks in flight; each value of
//    the shared slice read once for both rows), the slices then added in a
//    fixed order. A block reads only its rows of dhw_t: 22 MB crosses L2 a
//    step (the first version read all of dhw_t in every block, 87 MB, and
//    ran the recompute and two serial dot phases inside the walk). The
//    tile is planned on every call from the card's occupancy queries
//    (mxt_rnn_bwd_walk_plan gives the plan without launching): 15 us of
//    host time a plan in float32 and 23 us in bfloat16 at the LM's shape,
//    Python's call included (chip_smoke.py, H100 80GB HBM3 at 700 W),
//    against 1.36 ms of kernel; no plan is cached.
// 3. rnn_gemm_kernel again: dW_hh = sum over the T*N rows m of dhw[m]^T
//    h_{t-1}[m], each output summed in row order by one thread; the
//    blocks of the first column tile also take db_hh = sum over m of
//    dhw[m] in the same order. The TPU adds them step by step from T-1
//    down, so float32 dW and db differ by rounding.
// The product routine is one register-tiled kernel for both products:
// 128 x 64 outputs a block, 8 x 4 a thread, 16-deep chunks double-
// buffered in shared memory (the next chunk's loads in flight in
// registers while the current one is multiplied).
#include "rnn_scan.cuh"

namespace {

// ---------------------------------------------------------------------------
// the tiled product C = A B (float32 sums)
// ---------------------------------------------------------------------------

constexpr int kGM = 128, kGN = 64, kGK = 16, kGT = 256;

// a row-major float matrix (X rows of Y, row stride ld), 0 outside
struct MatF {
  const float* p;
  int X, Y, ld;
  __device__ __forceinline__ float at(int x, int y) const {
    return (x < X && y < Y) ? p[(size_t)x * ld + y] : 0.f;
  }
};

// h_{t-1} of the T*N rows m = t*N + n: h0's rows, then ys' (X rows of Y=H)
template <typename T>
struct MatHp {
  const T* h0;
  const T* ys;
  int N, X, Y;
  __device__ __forceinline__ float at(int x, int y) const {
    if (x >= X || y >= Y) return 0.f;
    return mxt_to_float(x < N ? h0[(size_t)x * Y + y]
                              : ys[(size_t)(x - N) * Y + y]);
  }
};

// C[i][j] = sum over p < P of A(i, p) B(p, j) for i < Mi, j < Nj, into
// c[i * ldc + j]. A(i, p) is sa.at(i, p), or sa.at(p, i) when AT; B(p, j)
// is sb.at(p, j), or sb.at(j, p) when BT. With DB, the blocks of column
// tile 0 also write db[i] = sum over p of A(i, p), in p order.
template <class SA, bool AT, class SB, bool BT, typename TC, bool DB>
__global__ void __launch_bounds__(kGT, 2)
rnn_gemm_kernel(SA sa, SB sb, TC* __restrict__ c, int Mi, int Nj, int P,
                int ldc, TC* __restrict__ db) {
  __shared__ __align__(16) float As[2][kGK][kGM + 4];
  __shared__ __align__(16) float Bs[2][kGK][kGN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.y * kGM, j0 = blockIdx.x * kGN;
  constexpr int SA_N = kGK * kGM / kGT, SB_N = kGK * kGN / kGT;
  float ra[SA_N], rb[SB_N];
  // the element of a tile a thread moves: consecutive threads take
  // consecutive addresses of the source's rows
  auto a_ip = [&](int s, int& i, int& p) {
    const int e = tid + kGT * s;
    if (AT) {
      i = e % kGM;
      p = e / kGM;
    } else {
      p = e % kGK;
      i = e / kGK;
    }
  };
  auto b_pj = [&](int s, int& p, int& j) {
    const int e = tid + kGT * s;
    if (BT) {
      p = e % kGK;
      j = e / kGK;
    } else {
      j = e % kGN;
      p = e / kGN;
    }
  };
  auto load = [&](int p0) {
#pragma unroll
    for (int s = 0; s < SA_N; ++s) {
      int i, p;
      a_ip(s, i, p);
      ra[s] = AT ? sa.at(p0 + p, i0 + i) : sa.at(i0 + i, p0 + p);
    }
#pragma unroll
    for (int s = 0; s < SB_N; ++s) {
      int p, j;
      b_pj(s, p, j);
      rb[s] = BT ? sb.at(j0 + j, p0 + p) : sb.at(p0 + p, j0 + j);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int s = 0; s < SA_N; ++s) {
      int i, p;
      a_ip(s, i, p);
      As[buf][p][i] = ra[s];
    }
#pragma unroll
    for (int s = 0; s < SB_N; ++s) {
      int p, j;
      b_pj(s, p, j);
      Bs[buf][p][j] = rb[s];
    }
  };

  // rows 8 ty .. 8 ty + 7, columns 4 tx .. 4 tx + 3
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float dbacc = 0.f;
  const bool do_db = DB && blockIdx.x == 0 && tid < kGM;

  const int nch = (P + kGK - 1) / kGK;
  load(0);
  store(0);
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < nch) load((ch + 1) * kGK);
#pragma unroll
    for (int p = 0; p < kGK; ++p) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][p][8 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][p][8 * ty + 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][p][4 * tx]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (do_db) {
#pragma unroll
      for (int p = 0; p < kGK; ++p) dbacc += As[buf][p][tid];
    }
    if (ch + 1 < nch) store(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = i0 + 8 * ty + i;
    if (r >= Mi) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + 4 * tx + j;
      if (col < Nj) c[(size_t)r * ldc + col] = mxt_from_float<TC>(acc[i][j]);
    }
  }
  if (do_db && i0 + tid < Mi) db[i0 + tid] = mxt_from_float<TC>(dbacc);
}

// ---------------------------------------------------------------------------
// the reverse-time walk
// ---------------------------------------------------------------------------

constexpr int kWT = 256;   // threads of a walk block
constexpr int kWalkBatch = 4;   // dhw_t loads of 16 bytes in flight a thread
constexpr int kWalkRows = 2;    // rows of the dh product a thread takes

// groups of kWalkRows rows in a block of nb rows (a power of two)
__host__ __device__ constexpr int walk_groups(int nb) {
  return (nb + kWalkRows - 1) / kWalkRows;
}

// partial-sum slices of a block's dh product: a warp's lanes are added by
// shuffles when a warp holds several slices of each row group
__host__ __device__ constexpr int walk_slices(int nb) {
  return walk_groups(nb) < 32 ? kWT / 32 : kWT / walk_groups(nb);
}

// dhw_t[k .. k + 3] of one row (written by other blocks before the last
// grid barrier: read from L2), zeros past GH
__device__ __forceinline__ float4 walk_load4(const float* row, int k, int GH,
                                             bool vec) {
  if (vec) return __ldcg(reinterpret_cast<const float4*>(row + k));
  return make_float4(k < GH ? __ldcg(row + k) : 0.f,
                     k + 1 < GH ? __ldcg(row + k + 1) : 0.f,
                     k + 2 < GH ? __ldcg(row + k + 2) : 0.f,
                     k + 3 < GH ? __ldcg(row + k + 3) : 0.f);
}

// acc[r][u] += d[r].e * W_hh[k + e][u0 + u] for e < 4 and each of the
// thread's rows r, from the shared slice [GH][UP] or W_hh itself: each
// value of W read once for kWalkRows rows. A depth index past GH reads row
// GH - 1, which its zero value cancels.
template <int UP>
__device__ __forceinline__ void walk_fma(float (&acc)[kWalkRows][UP],
                                         const float4 (&d)[kWalkRows], int k,
                                         int GH, const float* wc,
                                         const float* w, int H, int u0,
                                         int nu, int w_in_smem) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float dv[kWalkRows];
#pragma unroll
    for (int r = 0; r < kWalkRows; ++r)
      dv[r] = e == 0 ? d[r].x : e == 1 ? d[r].y : e == 2 ? d[r].z : d[r].w;
    const int kr = min(k + e, GH - 1);
    if (w_in_smem) {
      const float* wr = wc + (size_t)kr * UP;
#pragma unroll
      for (int u = 0; u < UP; u += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wr + u);
#pragma unroll
        for (int r = 0; r < kWalkRows; ++r) {
          acc[r][u] = fmaf(dv[r], w4.x, acc[r][u]);
          acc[r][u + 1] = fmaf(dv[r], w4.y, acc[r][u + 1]);
          acc[r][u + 2] = fmaf(dv[r], w4.z, acc[r][u + 2]);
          acc[r][u + 3] = fmaf(dv[r], w4.w, acc[r][u + 3]);
        }
      }
    } else {
      const float* wr = w + (size_t)kr * H + u0;
#pragma unroll
      for (int u = 0; u < UP; ++u) {
        const float wv = u < nu ? __ldg(wr + u) : 0.f;
#pragma unroll
        for (int r = 0; r < kWalkRows; ++r)
          acc[r][u] = fmaf(dv[r], wv, acc[r][u]);
      }
    }
  }
}

template <typename T, int G, int UP>
__global__ void __launch_bounds__(kWT, 1)
rnn_bwd_walk_kernel(const T* __restrict__ xw, const T* __restrict__ h0,
                    const T* __restrict__ c0, const float* __restrict__ w,
                    const float* __restrict__ b, const T* __restrict__ ys,
                    const T* __restrict__ cs, const T* __restrict__ dy,
                    float* dh_s, float* dc_s, T* __restrict__ dxw,
                    float* dhw, T* __restrict__ dh0, T* __restrict__ dc0,
                    int Tn, int N, int H, int mode, int NB, int w_in_smem) {
  extern __shared__ float4 smem_v[];
  cg::grid_group grid = cg::this_grid();
  const int GH = G * H;
  const int n_ug = (H + UP - 1) / UP;
  const int tiles = ((N + NB - 1) / NB) * n_ug;
  // one tile a block: its carries stay in shared memory; several: each
  // pair's carries stay in dh_s / dc_s, touched only by the thread that
  // owns the pair
  const bool one = tiles == (int)gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pairs = NB * UP;
  const int nslices = walk_slices(NB);

  // [GH][UP]: W_hh's columns of this block's units (if they fit; one tile
  // a block); then the partial sums [nslices][NB][UP]; then the dh and dc
  // carries (one tile a block)
  float* wc = reinterpret_cast<float*>(smem_v);
  float* part = wc + (w_in_smem ? (size_t)GH * UP : 0);
  float* dh_c = part + (size_t)nslices * NB * UP;
  float* dc_c = dh_c + pairs;
  // pair p of the tile at (n0, u0): its carries' place
  auto carry = [&](int n0, int u0, int p, size_t& at) -> bool {
    const int nl = p / UP, ul = p - nl * UP;
    at = one ? (size_t)p : (size_t)(n0 + nl) * H + u0 + ul;
    return nl < min(NB, N - n0) && ul < min(UP, H - u0);
  };
  float* dhc = one ? dh_c : dh_s;
  float* dcc = one ? dc_c : dc_s;
  if (one) {
    const int n0 = (blockIdx.x / n_ug) * NB, u0 = (blockIdx.x % n_ug) * UP;
    const int nu = min(UP, H - u0);
    if (w_in_smem) {
      for (int idx = tid; idx < GH * UP; idx += kWT) {
        const int k = idx / UP, ul = idx - k * UP;
        wc[idx] = ul < nu ? w[(size_t)k * H + u0 + ul] : 0.f;
      }
    }
    for (int p = tid; p < pairs; p += kWT) {
      const int nl = p / UP, ul = p - nl * UP;
      size_t at;
      const bool in = carry(n0, u0, p, at);
      const size_t su = (size_t)(n0 + nl) * H + u0 + ul;
      dh_c[p] = in ? dh_s[su] : 0.f;
      dc_c[p] = (in && G == 4) ? dc_s[su] : 0.f;
    }
    __syncthreads();
  }

  const size_t step = (size_t)N * H;
  const int ngr = walk_groups(NB);
  const int grp = tid % ngr, ks = tid / ngr, s_k = kWT / ngr;
  const bool vec = GH % 4 == 0;
  for (int t = Tn - 1; t >= 0; --t) {
    const T* hprev = t == 0 ? h0 : ys + (t - 1) * step;
    const T* cprev = t == 0 ? c0 : cs + (t - 1) * step;
    // the gate backward of this block's (row, unit) pairs; hw_t in dhw
    // becomes dhw_t in place
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile / n_ug) * NB, u0 = (tile % n_ug) * UP;
      for (int p = tid; p < pairs; p += kWT) {
        size_t at;
        if (!carry(n0, u0, p, at)) continue;
        const int nl = p / UP, ul = p - nl * UP;
        const int n = n0 + nl, u = u0 + ul;
        const size_t row = (size_t)t * N + n;
        const size_t su = (size_t)n * H + u;
        float x[G], hw[G], bias[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          x[g] = mxt_to_float(xw[row * GH + g * H + u]);
          hw[g] = __ldcg(dhw + row * GH + g * H + u);
          bias[g] = b[g * H + u];
        }
        const float h_prev = mxt_to_float(hprev[su]);
        const float c_prev = G == 4 ? mxt_to_float(cprev[su]) : 0.f;
        const float c_new = G == 4 ? mxt_to_float(cs[row * H + u]) : 0.f;
        const float y = G == 1 ? mxt_to_float(ys[row * H + u]) : 0.f;
        float gx[G], gh[G], dh_dir, dc_out = 0.f;
        mxt_rnn_bwd_unit<G>(mode, x, hw, bias, h_prev, c_prev, c_new, y,
                            mxt_to_float(dy[row * H + u]), dhc[at],
                            G == 4 ? dcc[at] : 0.f, gx, gh, dh_dir, dc_out);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          dxw[row * GH + g * H + u] = mxt_from_float<T>(gx[g]);
          dhw[row * GH + g * H + u] = gh[g];
        }
        dhc[at] = dh_dir;
        if (G == 4) dcc[at] = dc_out;
      }
    }
    grid.sync();
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile / n_ug) * NB, u0 = (tile % n_ug) * UP;
      const int nb = min(NB, N - n0), nu = min(UP, H - u0);
      // dh_{t-1} = dh_dir + dhw_t @ W_hh[:, units]: this thread's rows
      // kWalkRows grp + r, depth values k = 4 ch .. 4 ch + 3 for ch = ks,
      // ks + s_k, ...
      float acc[kWalkRows][UP];
#pragma unroll
      for (int r = 0; r < kWalkRows; ++r)
#pragma unroll
        for (int u = 0; u < UP; ++u) acc[r][u] = 0.f;
      {
        const float* drow[kWalkRows];
        bool live[kWalkRows];
#pragma unroll
        for (int r = 0; r < kWalkRows; ++r) {
          const int nl = kWalkRows * grp + r;
          live[r] = nl < nb;
          drow[r] = dhw + ((size_t)t * N + n0 + (live[r] ? nl : 0)) * GH;
        }
        auto load = [&](float4 (&d)[kWalkRows], int k) {
#pragma unroll
          for (int r = 0; r < kWalkRows; ++r)
            d[r] = live[r] ? walk_load4(drow[r], k, GH, vec)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        };
        // kWalkBatch chunks of 4 depth values loaded together, then
        // multiplied: one L2 round trip a batch, and no branch between a
        // batch's loads and its FMAs; the chunks left over go one by one
        const int nch = (GH + 3) / 4;
        int ch = ks;
        for (; ch + (kWalkBatch - 1) * s_k < nch; ch += kWalkBatch * s_k) {
          float4 dv[kWalkBatch][kWalkRows];
#pragma unroll
          for (int i = 0; i < kWalkBatch; ++i) load(dv[i], 4 * (ch + i * s_k));
#pragma unroll
          for (int i = 0; i < kWalkBatch; ++i)
            walk_fma<UP>(acc, dv[i], 4 * (ch + i * s_k), GH, wc, w, H, u0, nu,
                         w_in_smem);
        }
        for (; ch < nch; ch += s_k) {
          float4 dv[kWalkRows];
          load(dv, 4 * ch);
          walk_fma<UP>(acc, dv, 4 * ch, GH, wc, w, H, u0, nu, w_in_smem);
        }
      }
      // part[slice][row][u]: lanes lane ^ ngr, lane ^ 2 ngr, ... of a warp
      // hold slices of the same rows, added first by shuffles
      int slice = ks;
      bool writes = true;
      if (ngr < 32) {
#pragma unroll
        for (int r = 0; r < kWalkRows; ++r)
#pragma unroll
          for (int u = 0; u < UP; ++u)
            for (int o = ngr; o < 32; o <<= 1)
              acc[r][u] += __shfl_xor_sync(0xffffffffu, acc[r][u], o);
        slice = warp;
        writes = lane < ngr;
      }
      if (writes) {
#pragma unroll
        for (int r = 0; r < kWalkRows; ++r) {
          const int nl = kWalkRows * grp + r;
          if (nl >= NB) continue;
#pragma unroll
          for (int u = 0; u < UP; ++u)
            part[(slice * NB + nl) * UP + u] = acc[r][u];
        }
      }
      __syncthreads();
      for (int p = tid; p < pairs; p += kWT) {
        size_t at;
        if (!carry(n0, u0, p, at)) continue;
        float s = 0.f;
        for (int sl = 0; sl < nslices; ++sl) s += part[sl * pairs + p];
        dhc[at] = dhc[at] + s;
      }
      // with several tiles, the next tile writes `part` after everyone
      // has read it; with one, the next step's first writes to `part`
      // follow its grid barrier. Each pair's carries are touched by the
      // thread that owns the pair
      if (!one) __syncthreads();
    }
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile / n_ug) * NB, u0 = (tile % n_ug) * UP;
    for (int p = tid; p < pairs; p += kWT) {
      size_t at;
      if (!carry(n0, u0, p, at)) continue;
      const int nl = p / UP, ul = p - nl * UP;
      const size_t su = (size_t)(n0 + nl) * H + u0 + ul;
      dh0[su] = mxt_from_float<T>(dhc[at]);
      if (G == 4) dc0[su] = mxt_from_float<T>(dcc[at]);
    }
  }
}

// the fixed cost of a tile in the walk plan's units (a block that takes
// several tiles a step pays it for each)
constexpr long long kTileCost = 256;

// units a walk block may own (the register array of the dh product)
constexpr int kUnits[] = {4, 8, 12, 16, 20, 24};
constexpr int kNUnits = sizeof(kUnits) / sizeof(kUnits[0]);

struct WalkPlan {
  int up, nb, tiles, blocks, w_in_smem;
  size_t smem;
};

// The (rows, units) tile of a walk block: the smallest work a block whose
// grid is co-resident, W_hh's slice in shared memory where it fits (its
// product then costs max(UP, 21) FMA clocks a row and depth value against
// ~21 for the L2 load of the row's value; through L2 four times that).
// Where no tile keeps a grid of one tile a block resident, the grid is as
// many blocks as the card holds, each taking several tiles a step (W_hh
// through L2, the carries in dh_s / dc_s), at the least estimated work.
static int walk_plan(void* const* fns, int N, int H, int G, WalkPlan* best) {
  int sms, optin;
  cudaError_t e = (cudaError_t)mxt_device_limits(&sms, &optin);
  if (e != cudaSuccess) return (int)e;
  // every call sets the limit to the card's most, the same value from
  // every call and host thread, so that no call changes it under
  // another's launch; each launch asks for its own size
  for (int ui = 0; ui < kNUnits; ++ui) {
    e = cudaFuncSetAttribute(fns[ui],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t GH = (size_t)G * H;
  long long best_cost = -1;
  for (int ui = kNUnits - 1; ui >= 0; --ui) {
    const int up = kUnits[ui];
    for (int nb = 1; nb <= kWT; nb <<= 1) {
      const long long tiles =
          (long long)((N + nb - 1) / nb) * ((H + up - 1) / up);
      const size_t rest =
          sizeof(float) * ((size_t)walk_slices(nb) * nb * up + 2 * nb * up);
      if (rest > (size_t)optin) break;
      const size_t wbytes = sizeof(float) * GH * up;
      const int in_smem = wbytes + rest <= (size_t)optin ? 1 : 0;
      const size_t smem = rest + (in_smem ? wbytes : 0);
      int occ = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fns[ui], kWT,
                                                        smem);
      if (e != cudaSuccess) return (int)e;
      if (tiles > (long long)occ * sms) continue;
      const long long cost =
          (long long)nb * (up > 21 ? up : 21) * (in_smem ? 1 : 4);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        *best = WalkPlan{up, nb, (int)tiles, (int)tiles, in_smem, smem};
      }
      break;   // a larger nb only costs more
    }
  }
  if (best_cost >= 0) return 0;
  // several tiles a block
  for (int ui = kNUnits - 1; ui >= 0; --ui) {
    const int up = kUnits[ui];
    for (int nb = 1; nb <= kWT; nb <<= 1) {
      const long long tiles =
          (long long)((N + nb - 1) / nb) * ((H + up - 1) / up);
      const size_t smem =
          sizeof(float) * ((size_t)walk_slices(nb) * nb * up + 2 * nb * up);
      if (smem > (size_t)optin) break;
      int occ = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fns[ui], kWT,
                                                        smem);
      if (e != cudaSuccess) return (int)e;
      if (occ < 1) continue;
      const long long resident = (long long)occ * sms;
      const long long tpb = (tiles + resident - 1) / resident;
      const long long blocks = (tiles + tpb - 1) / tpb;
      // each tile also pays two block barriers and its partial sums
      const long long cost =
          ((long long)nb * (up > 21 ? up : 21) * 4 + kTileCost) * tpb;
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        *best = WalkPlan{up, nb, (int)tiles, (int)blocks, 0, smem};
      }
    }
  }
  return best_cost < 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

// the walk kernel of each unit width kUnits[i], for one dtype and gate count
template <typename T, int G>
static void walk_fns(void* (&fns)[kNUnits]) {
  fns[0] = (void*)rnn_bwd_walk_kernel<T, G, 4>;
  fns[1] = (void*)rnn_bwd_walk_kernel<T, G, 8>;
  fns[2] = (void*)rnn_bwd_walk_kernel<T, G, 12>;
  fns[3] = (void*)rnn_bwd_walk_kernel<T, G, 16>;
  fns[4] = (void*)rnn_bwd_walk_kernel<T, G, 20>;
  fns[5] = (void*)rnn_bwd_walk_kernel<T, G, 24>;
}

template <typename T, int G>
static int rnn_bwd_launch(const void* xw, const void* h0, const void* c0,
                          const void* w, const void* b, const void* ys,
                          const void* cs, const void* dy, void* dh_s,
                          void* dc_s, void* dxw, void* dhw, void* dh0,
                          void* dc0, void* dw, void* db, int Tn, int N, int H,
                          int mode, cudaStream_t s) {
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
  const int GH = G * H, M = Tn * N;
  const MatHp<T> hp{a_h0, a_ys, N, M, H};

  // 1. hw = h_{t-1} @ W_hh^T for every row, into dhw
  {
    const MatF wt{a_w, GH, H, H};   // B(p = k, j = r) = W_hh[r][k]
    dim3 grid((GH + kGN - 1) / kGN, (M + kGM - 1) / kGM);
    rnn_gemm_kernel<MatHp<T>, false, MatF, true, float, false>
        <<<grid, kGT, 0, s>>>(hp, wt, a_dhw, M, GH, H, GH, nullptr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // 2. the walk, planned on every call (a few occupancy queries)
  {
    void* fns[kNUnits];
    walk_fns<T, G>(fns);
    WalkPlan plan;
    const int err = walk_plan(fns, N, H, G, &plan);
    if (err) return err;
    int ui = 0;
    while (kUnits[ui] != plan.up) ++ui;
    int nb = plan.nb, w_in_smem = plan.w_in_smem;
    void* args[] = {&a_xw, &a_h0, &a_c0, &a_w, &a_b, &a_ys, &a_cs, &a_dy,
                    &a_dh_s, &a_dc_s, &a_dxw, &a_dhw, &a_dh0, &a_dc0,
                    &Tn, &N, &H, &mode, &nb, &w_in_smem};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        fns[ui], dim3(plan.blocks), dim3(kWT), args, plan.smem, s);
    if (e != cudaSuccess) return (int)e;
  }
  // 3. dW = sum over m of dhw[m]^T h_{t-1}[m], db = sum over m of dhw[m]
  {
    const MatF dg{a_dhw, M, GH, GH};   // A(i = r, p = m) = dhw[m][r]
    dim3 grid((H + kGN - 1) / kGN, (GH + kGM - 1) / kGM);
    rnn_gemm_kernel<MatF, true, MatHp<T>, false, T, true>
        <<<grid, kGT, 0, s>>>(dg, hp, static_cast<T*>(dw), GH, H, M, H,
                              static_cast<T*>(db));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The walk's plan for (N, H, mode, dtype) on the current device, as a
// launch would choose it: out = {units a tile, batch rows a tile, blocks,
// 1 if W_hh's column slice is in shared memory else 0 (read through L2),
// tiles, tiles a block takes a step (at most)}. Launches nothing.
MXT_API int mxt_rnn_bwd_walk_plan(int N, int H, int mode, int dtype,
                                  int* out) {
  if (N <= 0 || H <= 0 || mode < MXT_RNN_RELU || mode > MXT_GRU ||
      (dtype != MXT_F32 && dtype != MXT_BF16))
    return (int)cudaErrorInvalidValue;
  const int G = mxt_rnn_gates(mode);
  void* fns[kNUnits];
  if (dtype == MXT_F32) {
    if (G == 4) walk_fns<float, 4>(fns);
    else if (G == 3) walk_fns<float, 3>(fns);
    else walk_fns<float, 1>(fns);
  } else {
    if (G == 4) walk_fns<__nv_bfloat16, 4>(fns);
    else if (G == 3) walk_fns<__nv_bfloat16, 3>(fns);
    else walk_fns<__nv_bfloat16, 1>(fns);
  }
  WalkPlan plan;
  const int err = walk_plan(fns, N, H, G, &plan);
  if (err) return err;
  out[0] = plan.up;
  out[1] = plan.nb;
  out[2] = plan.blocks;
  out[3] = plan.w_in_smem;
  out[4] = plan.tiles;
  out[5] = (plan.tiles + plan.blocks - 1) / plan.blocks;
  return 0;
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
