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
// in VMEM for the whole call. Here no block holds W_hh (G*H x H, 6.76 MB
// at H = 650 in float32), so the work is split as the scan kernels split
// it (rnn_scan.cuh), without their grid barrier: one ordinary launch a
// step, a block owning U hidden units with all G gates of each (G*U rows
// of W_hh), so the cell update of a unit stays inside one thread, and one
// group of at most NR batch rows, whose rows of h the block stages in
// shared memory (see the paths below).
//
// Bound on the card: bytes. W_hh is read once a group (6.76 MB at H = 650
// float32, 2.0 us at 3.35 TB/s; half in bfloat16) against 2*N*G*H^2
// operations (27 MFLOP at N = 8, 0.4 us at 67 TFLOP/s); at H = 128 the
// 0.27 MB take 0.08 us and the launch itself costs more. So the design
// keeps one DRAM round trip in a step and the card evenly loaded. The
// plan (ops/kernels/rnn_scan.py rnn_decode_plan, in Python) gives U so
// that a group's blocks are about the card's SM count (U 5 at H 650: 130
// blocks of 20 rows, one wave) and one of three paths:
// - MXT_DEC_TMA, where the block's rows of W_hh and the batch's h fit
//   shared memory (decode's buckets): both arrive by bulk copies that one
//   thread issues at the start (rnn_decode_tma_kernel, below), while the
//   threads of the gate math load their xw, b_hh and c. A warp then
//   multiplies MXT_DEC_TMA_RB rows at once, so each h value read from
//   shared memory feeds RB FMAs: with a warp a row, every warp read all of
//   h, and those reads, not W_hh's bytes, bounded the step;
// - MXT_DEC_STAGED: h staged in shared memory, and each warp loads its
//   first two chunks of W_hh into registers before h is staged and before
//   any barrier (a whole row for H <= 768), each later chunk while the one
//   two before it is multiplied, MXT_DEC_RB rows at once;
// - MXT_DEC_L2: the same where not one row of h fits a block: h is read
//   through L2.
// W_hh and b_hh are read in their own dtype (float32 or bfloat16) and
// widened in registers: the same values as a float32 copy, half the bytes
// for bfloat16, and no copy launch. Each batch row's loads and FMAs are
// straight-line code: a row past the group's last repeats it (its sums are
// not written), because a branch per row made ptxas issue each shared load
// right before its FMAs.
//
// Loads in the register paths: a warp reads a row as consecutive words,
// one transaction a warp instruction; 16 bytes a lane would make each lane
// read h from shared memory at a 4-word stride, a 4-way bank conflict on
// every operand.
//
// Fixed summation order: the sum of row r against batch row n is the
// order of rnn_scan.cuh, the forward's: lane j adds k = j, j + 32, ...
// with fmaf, then the warp's xor tree (here for MXT_DEC_NB sums at once,
// mxt_dec_reduce8, the same additions). It depends neither on N, nor on
// the row group, nor on the other rows, so a slot's state is bit for bit
// the same in every batch size (the decode engine's continuous = static
// and speculative = greedy contracts rest on this), and a decode step
// equals the same position of rnn_scan_fwd bit for bit.
#include "rnn_scan.cuh"

// batch rows one pass over a row of W_hh serves (register accumulators)
#define MXT_DEC_NB 8
// rows of W_hh a warp multiplies at once: each staged h value feeds RB
// FMAs, so the shared-memory reads of h are 1 / RB of one row a warp
#define MXT_DEC_RB 2
// the same where W_hh's rows of the block sit in shared memory too
// (rnn_decode_tma_kernel), where a row costs a shared read, not registers
#define MXT_DEC_TMA_RB 4
// W_hh values a lane loads a row at once (a chunk: 32 * 12 = 384
// columns; a row of H <= 768 is two chunks, both loaded before the
// barrier)
#define MXT_DEC_CHUNK 12
// most warps a block (the register budget of two chunks of RB rows)
#define MXT_DEC_MAX_WARPS 16
// the launch's paths: h read through L2 or staged in shared memory, W_hh
// through registers; or W_hh's rows and h both copied to shared memory
enum MxtDecPath { MXT_DEC_L2 = 0, MXT_DEC_STAGED = 1, MXT_DEC_TMA = 2 };

__device__ __forceinline__ float mxt_dec_widen(float v) { return v; }
__device__ __forceinline__ float mxt_dec_widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The MXT_DEC_NB warp sums of v (one partial a lane each) by the xor tree
// of mxt_warp_sum, as mxt_rnn_reduce64 takes it: afterwards lane l holds
// sum number ((l >> 4) & 1) * 4 + ((l >> 3) & 1) * 2 + ((l >> 2) & 1) in
// v[0].
__device__ __forceinline__ void mxt_dec_reduce8(float (&v)[MXT_DEC_NB]) {
  const int lane = threadIdx.x & 31;
  mxt_rnn_halve<8>(v, 16, lane & 16);
  mxt_rnn_halve<4>(v, 8, lane & 8);
  mxt_rnn_halve<2>(v, 4, lane & 4);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// What a warp walks: its groups of RB rows (rows rg * RB ... of the
// block's R, for rg = warp, warp + warps, ...), each over the group's
// batch tiles of MXT_DEC_NB rows, each over the k chunks of 32 *
// MXT_DEC_CHUNK columns; item `it` of that walk.
struct MxtDecWalk {
  int warp, warps, R, U, nu, nt, nk, items;
  __device__ void at(int it, int& rg, int& tile, int& kc) const {
    kc = it % nk;
    tile = (it / nk) % nt;
    rg = warp + (it / (nk * nt)) * warps;
  }
};

// The chunk of item `it` for each of its RB rows: lane j's values k = kc
// * 32 * CHUNK + j + 32 c (zeros past H, past R, and for a unit past the
// block's last).
template <typename TW>
__device__ __forceinline__ void mxt_dec_load(
    const MxtDecWalk& wk, int it, const TW* __restrict__ w, int H, int u0,
    float (&wv)[MXT_DEC_RB][MXT_DEC_CHUNK]) {
  int rg, tile, kc;
  wk.at(it, rg, tile, kc);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < MXT_DEC_RB; ++q) {
    const int r = rg * MXT_DEC_RB + q;
    const int g = r / wk.U, j = r - g * wk.U;
    const bool row_ok = r < wk.R && j < wk.nu;
    const TW* wr = w + ((size_t)g * H + u0 + j) * H;
#pragma unroll
    for (int c = 0; c < MXT_DEC_CHUNK; ++c) {
      const int k = kc * 32 * MXT_DEC_CHUNK + 32 * c + lane;
      wv[q][c] = row_ok && k < H ? mxt_dec_widen(__ldg(wr + k)) : 0.f;
    }
  }
}

// Item `it` of the walk with its chunks in `cur`; the RB rows' sums go to
// shw[r][n] when their last chunk is done. h row n is sh[n * H + k]
// (staged) or hg[n * H + k] (device memory, read through L2).
template <typename T, bool STAGED>
__device__ __forceinline__ void mxt_dec_item(
    const MxtDecWalk& wk, int it, const float (&cur)[MXT_DEC_RB][MXT_DEC_CHUNK],
    const float* sh, const T* hg, float* shw, int H, int nr, int NR,
    float (&acc)[MXT_DEC_RB][MXT_DEC_NB]) {
  int rg, tile, kc;
  wk.at(it, rg, tile, kc);
  const int n0 = tile * MXT_DEC_NB;
  const int nb = min(MXT_DEC_NB, nr - n0);
  const int lane = threadIdx.x & 31;
  if (kc == 0) {
#pragma unroll
    for (int q = 0; q < MXT_DEC_RB; ++q)
#pragma unroll
      for (int i = 0; i < MXT_DEC_NB; ++i) acc[q][i] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < MXT_DEC_CHUNK; ++c) {
    const int k = kc * 32 * MXT_DEC_CHUNK + 32 * c + lane;
    if (k < H) {
#pragma unroll
      for (int i = 0; i < MXT_DEC_NB; ++i) {
        // a row past the group's last repeats it (its sums are not
        // written); 32-bit indices into the staged rows (they fit a block)
        const int n = min(n0 + i, nr - 1);
        const float hv = STAGED ? sh[n * H + k]
                                : mxt_ldcg(hg + (size_t)n * H + k);
#pragma unroll
        for (int q = 0; q < MXT_DEC_RB; ++q)
          acc[q][i] = fmaf(hv, cur[q][c], acc[q][i]);
      }
    }
  }
  if (kc == wk.nk - 1) {
    const int i = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                  ((lane >> 2) & 1);
#pragma unroll
    for (int q = 0; q < MXT_DEC_RB; ++q) {
      const int r = rg * MXT_DEC_RB + q;
      const int j = r - (r / wk.U) * wk.U;
      mxt_dec_reduce8(acc[q]);
      if ((lane & 3) == 0 && i < nb && r < wk.R && j < wk.nu)
        shw[r * NR + n0 + i] = acc[q][0];
    }
  }
}

template <typename T, typename TW, int G>
__device__ __forceinline__ void mxt_dec_gate_load(
    int t, int nu, int nbase, int u0, int H, const T* __restrict__ xw,
    const T* __restrict__ c, const TW* __restrict__ b, float (&x)[G],
    float (&bias)[G], float& c_prev) {
  const int nl = t / nu, j = t - nl * nu;
  const int u = u0 + j;
  const size_t n = (size_t)nbase + nl;
  const size_t GH = (size_t)G * H;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    x[g] = mxt_to_float(xw[n * GH + (size_t)g * H + u]);
    bias[g] = mxt_dec_widen(b[(size_t)g * H + u]);
  }
  c_prev = G == 4 ? mxt_to_float(c[n * H + u]) : 0.f;
}

template <typename T, typename TW, int G, bool STAGED>
__global__ void __launch_bounds__(32 * MXT_DEC_MAX_WARPS)
rnn_decode_kernel(const T* __restrict__ xw, const T* __restrict__ h,
                  const T* __restrict__ c, const TW* __restrict__ w,
                  const TW* __restrict__ b, T* __restrict__ h_out,
                  T* __restrict__ c_out, int N, int H, int mode, int U,
                  int NR) {
  extern __shared__ float smem[];
  const int n_ub = (H + U - 1) / U;
  const int u0 = (blockIdx.x % n_ub) * U;
  const int nbase = (blockIdx.x / n_ub) * NR;
  const int nu = min(U, H - u0), nr = min(NR, N - nbase);
  const int R = G * U;                      // rows of W_hh this block owns
  float* sh = smem;                         // [nr][H]: the group's h as float
  float* shw = smem + (STAGED ? (size_t)NR * H : 0);   // [R][NR]: h @ W_hh^T
  const T* hg = h + (size_t)nbase * H;      // the group's rows of h

  MxtDecWalk wk;
  wk.warp = threadIdx.x >> 5;
  wk.warps = blockDim.x >> 5;
  wk.R = R;
  wk.U = U;
  wk.nu = nu;
  wk.nt = (nr + MXT_DEC_NB - 1) / MXT_DEC_NB;
  wk.nk = (H + 32 * MXT_DEC_CHUNK - 1) / (32 * MXT_DEC_CHUNK);
  const int groups = (R + MXT_DEC_RB - 1) / MXT_DEC_RB;
  const int my_groups =
      wk.warp < groups ? (groups - wk.warp + wk.warps - 1) / wk.warps : 0;
  wk.items = my_groups * wk.nt * wk.nk;

  // one round trip: the warp's first two chunks of W_hh (a whole row of
  // H <= 768), the gate operands and h in flight together
  float wa[MXT_DEC_RB][MXT_DEC_CHUNK], wb[MXT_DEC_RB][MXT_DEC_CHUNK];
  if (wk.items > 0) mxt_dec_load(wk, 0, w, H, u0, wa);
  if (wk.items > 1) mxt_dec_load(wk, 1, w, H, u0, wb);
  float px[G], pb[G], pc = 0.f;
  const int n_gate = nu * nr;
  if ((int)threadIdx.x < n_gate)
    mxt_dec_gate_load<T, TW, G>(threadIdx.x, nu, nbase, u0, H, xw, c, b, px,
                                pb, pc);
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

  // two items in flight: after an item is multiplied, its buffer takes
  // the loads of the item two further on
  float acc[MXT_DEC_RB][MXT_DEC_NB];
#pragma unroll 1
  for (int it = 0; it < wk.items; it += 2) {
    mxt_dec_item<T, STAGED>(wk, it, wa, sh, hg, shw, H, nr, NR, acc);
    if (it + 2 < wk.items) mxt_dec_load(wk, it + 2, w, H, u0, wa);
    if (it + 1 < wk.items) {
      mxt_dec_item<T, STAGED>(wk, it + 1, wb, sh, hg, shw, H, nr, NR, acc);
      if (it + 3 < wk.items) mxt_dec_load(wk, it + 3, w, H, u0, wb);
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < n_gate; t += blockDim.x) {
    const int nl = t / nu, j = t - nl * nu;
    const int u = u0 + j;
    const size_t n = (size_t)nbase + nl;
    float x[G], hw[G], bias[G], c_prev;
    if (t == (int)threadIdx.x) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        x[g] = px[g];
        bias[g] = pb[g];
      }
      c_prev = pc;
    } else {
      mxt_dec_gate_load<T, TW, G>(t, nu, nbase, u0, H, xw, c, b, x, bias,
                                  c_prev);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) hw[g] = shw[(g * U + j) * NR + nl];
    const float h_prev = STAGED ? sh[nl * H + u]
                                : mxt_to_float(h[n * H + u]);
    float h_new, c_new = 0.f;
    mxt_rnn_fwd_unit<T, G>(mode, x, hw, bias, h_prev, c_prev, h_new, c_new);
    h_out[n * H + u] = mxt_from_float<T>(h_new);
    if (G == 4) c_out[n * H + u] = mxt_from_float<T>(c_new);
  }
}


// ---------------------------------------------------------------------------
// The shared-memory path (MXT_DEC_TMA): the block's rows of W_hh (G
// segments of nu * H values, each contiguous in W_hh) and the group's h
// (nr * H values, contiguous) are copied to shared memory by the Tensor
// Memory Accelerator's bulk copies, issued by one thread at the start and
// completing on one mbarrier: the whole load phase is one round trip with
// no registers held and few instructions (16-byte aligned interiors; the
// head and tail of a segment, under 16 bytes each, element by element).
// The product then reads W_hh and h from shared memory, MXT_DEC_TMA_RB rows
// a warp at once, in the shared summation order.
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ size_t mxt_align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Bytes of shared memory of the path: the mbarrier, the sums (R x NR
// floats), the staged h (NR x H in T) and G segments of W_hh (U x H in TW),
// each region padded so that a copy keeps its source's offset mod 16.
__host__ __device__ __forceinline__ size_t mxt_dec_tma_smem(int G, int U,
                                                            int NR, int H,
                                                            int st, int sw) {
  return mxt_align16(16 + sizeof(float) * (size_t)G * U * NR) +
         mxt_align16((size_t)st * NR * H + 16) +
         (size_t)G * mxt_align16((size_t)sw * U * H + 16);
}

// Where a copy of `src` lands in the region at `base`: the same offset mod
// 16, so the 16-byte-aligned interiors line up.
template <typename E>
__device__ __forceinline__ E* mxt_dec_land(unsigned char* base,
                                           const E* src) {
  return reinterpret_cast<E*>(base + (reinterpret_cast<uintptr_t>(src) & 15));
}

// The 16-byte-aligned interior [a, z) (bytes from src) of n elements.
template <typename E>
__device__ __forceinline__ void mxt_dec_interior(const E* src, size_t n,
                                                 size_t& a, size_t& z) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const size_t bytes = n * sizeof(E);
  a = ((s + 15) & ~(uintptr_t)15) - s;
  z = ((s + bytes) & ~(uintptr_t)15) - s;
  if (z <= a) a = z = bytes;      // under two granules: element by element
}

// Thread 0: the bulk copies of one segment's interior, completing on bar.
template <typename E>
__device__ __forceinline__ void mxt_dec_bulk(E* dst, const E* src, size_t n,
                                             uint32_t bar) {
  size_t a, z;
  mxt_dec_interior(src, n, a, z);
  const char* gs = reinterpret_cast<const char*>(src);
  const uint32_t sd = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (size_t off = a; off < z; off += 32768) {
    const uint32_t len = (uint32_t)min((size_t)32768, z - off);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(sd + (uint32_t)off), "l"(gs + off),
        "r"(len), "r"(bar)
        : "memory");
  }
}

// All threads: a segment's head and tail, element by element.
template <typename E>
__device__ __forceinline__ void mxt_dec_edges(E* dst, const E* src,
                                              size_t n) {
  size_t a, z;
  mxt_dec_interior(src, n, a, z);
  const size_t ha = a / sizeof(E);
  for (size_t i = threadIdx.x; i < ha; i += blockDim.x) dst[i] = src[i];
  for (size_t i = z / sizeof(E) + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

template <typename E>
__device__ __forceinline__ uint32_t mxt_dec_tx(const E* src, size_t n) {
  size_t a, z;
  mxt_dec_interior(src, n, a, z);
  return (uint32_t)(z - a);
}

template <typename T, typename TW, int G>
__global__ void __launch_bounds__(32 * MXT_DEC_MAX_WARPS)
rnn_decode_tma_kernel(const T* __restrict__ xw, const T* __restrict__ h,
                      const T* __restrict__ c, const TW* __restrict__ w,
                      const TW* __restrict__ b, T* __restrict__ h_out,
                      T* __restrict__ c_out, int N, int H, int mode, int U,
                      int NR) {
  constexpr int RB = MXT_DEC_TMA_RB;
  extern __shared__ __align__(16) unsigned char sraw[];
  const int n_ub = (H + U - 1) / U;
  const int u0 = (blockIdx.x % n_ub) * U;
  const int nbase = (blockIdx.x / n_ub) * NR;
  const int nu = min(U, H - u0), nr = min(NR, N - nbase);
  const int R = G * U;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sraw);
  const uint32_t sbar = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  float* shw = reinterpret_cast<float*>(sraw + 16);     // [R][NR]
  unsigned char* hbase = sraw + mxt_align16(16 + sizeof(float) * (size_t)R * NR);
  const T* hg = h + (size_t)nbase * H;
  T* sh = mxt_dec_land(hbase, hg);                      // [nr][H]
  unsigned char* wbase = hbase + mxt_align16(sizeof(T) * (size_t)NR * H + 16);
  const size_t wstride = mxt_align16(sizeof(TW) * (size_t)U * H + 16);

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sbar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t tx = mxt_dec_tx(hg, (size_t)nr * H);
#pragma unroll
    for (int g = 0; g < G; ++g)
      tx += mxt_dec_tx(w + ((size_t)g * H + u0) * H, (size_t)nu * H);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(sbar),
        "r"(tx)
        : "memory");
    mxt_dec_bulk(sh, hg, (size_t)nr * H, sbar);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const TW* src = w + ((size_t)g * H + u0) * H;
      mxt_dec_bulk(mxt_dec_land(wbase + g * wstride, src), src,
                   (size_t)nu * H, sbar);
    }
  }
  mxt_dec_edges(sh, hg, (size_t)nr * H);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const TW* src = w + ((size_t)g * H + u0) * H;
    mxt_dec_edges(mxt_dec_land(wbase + g * wstride, src), src,
                  (size_t)nu * H);
  }
  // the gate operands, loaded while the copies run
  float px[G], pb[G], pc = 0.f;
  const int n_gate = nu * nr;
  if ((int)threadIdx.x < n_gate)
    mxt_dec_gate_load<T, TW, G>(threadIdx.x, nu, nbase, u0, H, xw, c, b, px,
                                pb, pc);
  {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(sbar), "r"(0u)
          : "memory");
    }
  }
  __syncthreads();      // the edges, written by plain stores

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int ngroups = (R + RB - 1) / RB;
  const int nt = (nr + MXT_DEC_NB - 1) / MXT_DEC_NB;
  for (int rg = warp; rg < ngroups; rg += warps) {
    const TW* wr[RB];
    bool ok[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int r = rg * RB + q;
      const int g = r / U, j = r - g * U;
      ok[q] = r < R && j < nu;
      const TW* src = w + ((size_t)(ok[q] ? g : 0) * H + u0) * H;
      wr[q] = mxt_dec_land(wbase + (ok[q] ? g : 0) * wstride, src) +
              (size_t)(ok[q] ? j : 0) * H;
    }
    for (int tile = 0; tile < nt; ++tile) {
      const int n0 = tile * MXT_DEC_NB;
      const int nb = min(MXT_DEC_NB, nr - n0);
      float acc[RB][MXT_DEC_NB];
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int i = 0; i < MXT_DEC_NB; ++i) acc[q][i] = 0.f;
      // rows past the group's last repeat it and rows past the block's
      // read its first (their sums are not written): no branch
      const T* hrow[MXT_DEC_NB];
#pragma unroll
      for (int i = 0; i < MXT_DEC_NB; ++i)
        hrow[i] = sh + (size_t)min(n0 + i, nr - 1) * H;
#pragma unroll 2
      for (int k = lane; k < H; k += 32) {
        float wv[RB], hv[MXT_DEC_NB];
#pragma unroll
        for (int q = 0; q < RB; ++q) wv[q] = mxt_dec_widen(wr[q][k]);
#pragma unroll
        for (int i = 0; i < MXT_DEC_NB; ++i) hv[i] = mxt_to_float(hrow[i][k]);
#pragma unroll
        for (int i = 0; i < MXT_DEC_NB; ++i)
#pragma unroll
          for (int q = 0; q < RB; ++q)
            acc[q][i] = fmaf(hv[i], wv[q], acc[q][i]);
      }
      const int i = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                    ((lane >> 2) & 1);
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        mxt_dec_reduce8(acc[q]);
        if ((lane & 3) == 0 && i < nb && ok[q])
          shw[(rg * RB + q) * NR + n0 + i] = acc[q][0];
      }
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < n_gate; t += blockDim.x) {
    const int nl = t / nu, j = t - nl * nu;
    const int u = u0 + j;
    const size_t n = (size_t)nbase + nl;
    float x[G], hw[G], bias[G], c_prev;
    if (t == (int)threadIdx.x) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        x[g] = px[g];
        bias[g] = pb[g];
      }
      c_prev = pc;
    } else {
      mxt_dec_gate_load<T, TW, G>(t, nu, nbase, u0, H, xw, c, b, x, bias,
                                  c_prev);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) hw[g] = shw[(g * U + j) * NR + nl];
    const float h_prev = mxt_to_float(sh[nl * H + u]);
    float h_new, c_new = 0.f;
    mxt_rnn_fwd_unit<T, G>(mode, x, hw, bias, h_prev, c_prev, h_new, c_new);
    h_out[n * H + u] = mxt_from_float<T>(h_new);
    if (G == 4) c_out[n * H + u] = mxt_from_float<T>(c_new);
  }
}

template <typename T, typename TW, int G>
static int rnn_decode_launch(const void* xw, const void* h, const void* c,
                             const void* w, const void* b, void* h_out,
                             void* c_out, int N, int H, int mode, int U,
                             int threads, int NR, int path,
                             cudaStream_t s) {
  const long long groups = (N + NR - 1) / NR;
  const bool staged = path == MXT_DEC_STAGED;
  const size_t smem =
      path == MXT_DEC_TMA
          ? mxt_dec_tma_smem(G, U, NR, H, sizeof(T), sizeof(TW))
          : sizeof(float) *
                ((size_t)G * U * NR + (staged ? (size_t)NR * H : 0));
  auto fn = path == MXT_DEC_TMA ? rnn_decode_tma_kernel<T, TW, G>
            : staged            ? rnn_decode_kernel<T, TW, G, true>
                                : rnn_decode_kernel<T, TW, G, false>;
  // above 48 KB a launch must be allowed more: the card's most, the same
  // value from every call and host thread (a launch that fits 48 KB, as
  // decode's buckets do, leaves the kernel's attributes as they are)
  if (smem > 48 * 1024) {
    int sms, optin;
    int e = mxt_device_limits(&sms, &optin);
    if (!e)
      e = (int)cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e) return e;
  }
  const long long blocks = (long long)((H + U - 1) / U) * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fn<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const T*>(xw), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const TW*>(w),
      static_cast<const TW*>(b), static_cast<T*>(h_out),
      static_cast<T*>(c_out), N, H, mode, U, NR);
  return (int)cudaGetLastError();
}

template <typename T, typename TW>
static int rnn_decode_dispatch(int G, const void* xw, const void* h,
                               const void* c, const void* w, const void* b,
                               void* h_out, void* c_out, int N, int H,
                               int mode, int U, int threads, int NR,
                               int path, cudaStream_t s) {
#define MXT_RNN_DEC(G_)                                                     \
  rnn_decode_launch<T, TW, G_>(xw, h, c, w, b, h_out, c_out, N, H, mode, U, \
                               threads, NR, path, s)
  return G == 4 ? MXT_RNN_DEC(4) : (G == 3 ? MXT_RNN_DEC(3) : MXT_RNN_DEC(1));
#undef MXT_RNN_DEC
}

// xw: (N, G*H); h, c, h_out, c_out: (N, H), all contiguous in `dtype` (c
// and c_out only for LSTM, else may be null); w_hh: (G*H, H) and b_hh:
// (G*H,) contiguous in `w_dtype` (float32 or bfloat16). h_out and c_out
// must not overlap the inputs. The launch as rnn_decode_plan gives it: `U`
// units a block, `threads` a block (at most 32 * MXT_DEC_MAX_WARPS),
// `NR` batch rows a group, and the path (MxtDecPath).
MXT_API int mxt_rnn_decode(const void* xw, const void* h, const void* c,
                           const void* w_hh, const void* b_hh, void* h_out,
                           void* c_out, int N, int H, int mode, int dtype,
                           int w_dtype, int U, int threads, int NR,
                           int path, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0) return 0;
  if (mode < MXT_RNN_RELU || mode > MXT_GRU) return (int)cudaErrorInvalidValue;
  if (U < 1 || NR < 1 || threads < 32 || threads % 32 ||
      threads > 32 * MXT_DEC_MAX_WARPS || path < MXT_DEC_L2 ||
      path > MXT_DEC_TMA)
    return (int)cudaErrorInvalidValue;
  const int G = mxt_rnn_gates(mode);
  if (G == 4 && (c == nullptr || c_out == nullptr))
    return (int)cudaErrorInvalidValue;
#define MXT_RNN_DEC(T_, TW_)                                                  \
  rnn_decode_dispatch<T_, TW_>(G, xw, h, c, w_hh, b_hh, h_out, c_out, N, H, \
                               mode, U, threads, NR, path, s)
  if (dtype == MXT_F32 && w_dtype == MXT_F32) return MXT_RNN_DEC(float, float);
  if (dtype == MXT_F32 && w_dtype == MXT_BF16)
    return MXT_RNN_DEC(float, __nv_bfloat16);
  if (dtype == MXT_BF16 && w_dtype == MXT_F32)
    return MXT_RNN_DEC(__nv_bfloat16, float);
  if (dtype == MXT_BF16 && w_dtype == MXT_BF16)
    return MXT_RNN_DEC(__nv_bfloat16, __nv_bfloat16);
#undef MXT_RNN_DEC
  return (int)cudaErrorInvalidValue;
}

__global__ void mxt_empty_kernel() {}

// An empty kernel of `blocks` x `threads`: the launch floor a step of
// decode cannot go below (timed beside rnn_decode by CUDA-graph replay).
MXT_API int mxt_empty_launch(int blocks, int threads, void* stream) {
  mxt_empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
