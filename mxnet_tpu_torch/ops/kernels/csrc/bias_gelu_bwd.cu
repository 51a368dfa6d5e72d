// Backward of the fused bias add + exact (erf) GELU: dx and db.
//
// Replaces the TPU kernel mxnet_tpu/ops/kernels/norm.py `_bg_bwd_kernel`
// (launched by `_bg_call` with `bwd_dy`). Semantics kept: z = x + b in
// x's dtype (b rounded to x's dtype first), then in float32 dx = dy *
// (Phi(z) + z * phi(z)) with Phi(z) = 0.5 * (1 + erf(z / sqrt(2))) and
// phi(z) = exp(-z*z/2) / sqrt(2*pi), written in x's dtype; db = the
// float32 column sums of the unrounded dx, written in b's dtype.
//
// What has no CUDA counterpart: the TPU kernel carries db in VMEM across
// a sequential ("arbitrary") grid axis. Blocks here run in no order, so
// the column sums take two passes: the grid is (column tiles x row
// chunks), each block leaves one float32 partial of its tile's columns
// over its chunk's rows, and a second small kernel sums each column's
// partials in chunk order and writes db in b's dtype. No atomics, and
// every sum in a fixed order, so runs on one card repeat bit for bit.
//
// Bound on the card: bytes. x and dy are read and dx written once
// (3 * rows * C * sizeof(T)), plus the chunks * C float32 partials,
// 22.5 us at 4096 x 3072 in bf16. So (bias_gelu_bwd_kernel):
// - a warp spans 32 packs of a tile's columns (16-byte loads where C and
//   the pointers allow, else one element a lane), and each lane keeps its
//   columns' slice of b and its db partials in registers over the rows it
//   walks: nothing goes through shared memory per element;
// - the block's 8 warps walk rows 8 apart, BGB_ROWS rows at once (all
//   their loads issued before any is used), and the plan sizes the grid
//   to one wave of BGB_MINB blocks an SM, so each SM holds 96 KB of loads
//   in flight; the fewer row chunks, the fewer partials. Of the variants
//   timed on the H100 (1, 2, 3 or 4 rows at once at 2-8 blocks an SM,
//   and a cheaper erf sharing phi's exponential), 4 rows at 3 blocks was
//   the fastest in both dtypes (PERF.md, section 6);
// - at the end the block joins its warps' partials in warp order through
//   shared memory, one partial a block and column.
//
// The launch (vector width, column tiles, row chunks, rows a chunk) is
// planned in Python (ops/kernels/norm.py bg_bwd_plan); this file checks
// what it is given.
#include "common.cuh"

#define BGB_THREADS 256
#define BGB_WARPS (BGB_THREADS / 32)
// blocks an SM that the launch bounds ask for (norm.py BG_BWD_BLOCKS_PER_SM)
#define BGB_MINB 3
// rows a warp loads before it computes any of them
#define BGB_ROWS 4

template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) BgbPack {
  T v[VEC];
};

// dx of one element: z = x + b rounded to T, dx = dy * (Phi(z) + z phi(z))
template <typename T>
__device__ __forceinline__ float bgb_dx(T xv, float bz, T gv) {
  const float z = mxt_to_float(mxt_from_float<T>(mxt_to_float(xv) + bz));
  const float phi = expf(-0.5f * z * z) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.0f + erff(z * 0.7071067811865476f));
  return mxt_to_float(gv) * (cdf + z * phi);
}

// Block (tile, chunk): lane l of warp w takes columns (tile * 32 + l) *
// VEC ... + VEC - 1 of rows chunk * rows_per_chunk + w, + w + 8, ..., in
// that order into its db partials;
// part: (chunks, C) float32, the block's column sums.
template <typename T, typename TB, int VEC>
__global__ void __launch_bounds__(BGB_THREADS, BGB_MINB)
bias_gelu_bwd_kernel(const T* __restrict__ x, const TB* __restrict__ b,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ part, long long rows, int C,
                     long long rows_per_chunk) {
  __shared__ float sjoin[BGB_WARPS][32 * VEC];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c0 = (blockIdx.x * 32 + lane) * VEC;
  const long long r0 = (long long)blockIdx.y * rows_per_chunk;
  const long long r1 = min(rows, r0 + rows_per_chunk);
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  if (c0 < C) {
    float bz[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      bz[j] = mxt_to_float(mxt_from_float<T>(mxt_to_float(b[c0 + j])));
    long long row = r0 + w;
    for (; row + (BGB_ROWS - 1) * BGB_WARPS < r1;
         row += BGB_ROWS * BGB_WARPS) {
      BgbPack<T, VEC> xr[BGB_ROWS], gr[BGB_ROWS];
#pragma unroll
      for (int r = 0; r < BGB_ROWS; ++r) {
        const size_t o = (size_t)(row + r * BGB_WARPS) * C + c0;
        xr[r] = *reinterpret_cast<const BgbPack<T, VEC>*>(x + o);
        gr[r] = *reinterpret_cast<const BgbPack<T, VEC>*>(dy + o);
      }
#pragma unroll
      for (int r = 0; r < BGB_ROWS; ++r) {
        BgbPack<T, VEC> d;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float v = bgb_dx(xr[r].v[j], bz[j], gr[r].v[j]);
          d.v[j] = mxt_from_float<T>(v);
          acc[j] += v;
        }
        const size_t o = (size_t)(row + r * BGB_WARPS) * C + c0;
        *reinterpret_cast<BgbPack<T, VEC>*>(dx + o) = d;
      }
    }
    for (; row < r1; row += BGB_WARPS) {
      const size_t o = (size_t)row * C + c0;
      const BgbPack<T, VEC> xv = *reinterpret_cast<const BgbPack<T, VEC>*>(x + o);
      const BgbPack<T, VEC> gv = *reinterpret_cast<const BgbPack<T, VEC>*>(dy + o);
      BgbPack<T, VEC> d;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = bgb_dx(xv.v[j], bz[j], gv.v[j]);
        d.v[j] = mxt_from_float<T>(v);
        acc[j] += v;
      }
      *reinterpret_cast<BgbPack<T, VEC>*>(dx + o) = d;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) sjoin[w][lane * VEC + j] = acc[j];
  __syncthreads();
  // the block's partial: its warps' sums of each column in warp order
  const int tile0 = blockIdx.x * 32 * VEC;
  float* pb = part + (size_t)blockIdx.y * C;
  for (int i = threadIdx.x; i < 32 * VEC && tile0 + i < C; i += BGB_THREADS) {
    float t = sjoin[0][i];
#pragma unroll
    for (int k = 1; k < BGB_WARPS; ++k) t += sjoin[k][i];
    pb[tile0 + i] = t;
  }
}

// db[c]: the chunks' partials of column c summed in chunk order, written
// in b's dtype
template <typename TB>
__global__ void bias_gelu_bwd_colsum_kernel(const float* __restrict__ part,
                                            TB* __restrict__ db, int chunks,
                                            int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
#pragma unroll 8
  for (int p = 0; p < chunks; ++p) s += part[(size_t)p * C + c];
  db[c] = mxt_from_float<TB>(s);
}

template <typename T, typename TB, int VEC>
static int bgb_launch(const void* x, const void* b, const void* dy, void* dx,
                      void* part, void* db, long long rows, int C, int tiles,
                      int chunks, long long rows_per_chunk,
                      cudaStream_t s) {
  bias_gelu_bwd_kernel<T, TB, VEC>
      <<<dim3(tiles, chunks), BGB_THREADS, 0, s>>>(
          static_cast<const T*>(x), static_cast<const TB*>(b),
          static_cast<const T*>(dy), static_cast<T*>(dx),
          static_cast<float*>(part), rows, C, rows_per_chunk);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bias_gelu_bwd_colsum_kernel<TB><<<(C + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<TB*>(db), chunks, C);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int bgb_by_bias(int b_dtype, const void* x, const void* b,
                       const void* dy, void* dx, void* part, void* db,
                       long long rows, int C, int tiles, int chunks,
                       long long rows_per_chunk, cudaStream_t s) {
  if (b_dtype == MXT_F32)
    return bgb_launch<T, float, VEC>(x, b, dy, dx, part, db, rows, C, tiles,
                                     chunks, rows_per_chunk, s);
  if (b_dtype == MXT_BF16)
    return bgb_launch<T, __nv_bfloat16, VEC>(x, b, dy, dx, part, db, rows, C,
                                             tiles, chunks, rows_per_chunk,
                                             s);
  return (int)cudaErrorInvalidValue;
}

// x, dy, dx: (rows, C) contiguous in `dtype`; b, db: (C,) in `b_dtype`;
// part: (chunks, C) float32 scratch. The launch as bg_bwd_plan gives it:
// `vec` elements a load (1, or 4 float32 / 8 bfloat16, which needs C %
// vec == 0 and 16-byte aligned x, dy and dx), `tiles` = ceil(C / (32 *
// vec)) column tiles, `chunks` row chunks of `rows_per_chunk` rows
// (chunks * rows_per_chunk >= rows).
MXT_API int mxt_bias_gelu_bwd(const void* x, const void* b, const void* dy,
                              void* dx, void* part, void* db, long long rows,
                              int C, int dtype, int b_dtype, int vec,
                              int tiles, int chunks,
                              long long rows_per_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || C <= 0) return 0;
  const int wide = dtype == MXT_F32 ? 4 : 8;
  if ((vec != 1 && (vec != wide || C % vec || !mxt_aligned16(x) ||
                    !mxt_aligned16(dy) || !mxt_aligned16(dx))) ||
      tiles != (C + 32 * vec - 1) / (32 * vec) || chunks < 1 ||
      chunks > 65535 || rows_per_chunk < 1 ||
      (long long)chunks * rows_per_chunk < rows)
    return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32)
    return vec == 4 ? bgb_by_bias<float, 4>(b_dtype, x, b, dy, dx, part, db,
                                            rows, C, tiles, chunks,
                                            rows_per_chunk, s)
                    : bgb_by_bias<float, 1>(b_dtype, x, b, dy, dx, part, db,
                                            rows, C, tiles, chunks,
                                            rows_per_chunk, s);
  if (dtype == MXT_BF16)
    return vec == 8 ? bgb_by_bias<__nv_bfloat16, 8>(b_dtype, x, b, dy, dx,
                                                    part, db, rows, C, tiles,
                                                    chunks, rows_per_chunk, s)
                    : bgb_by_bias<__nv_bfloat16, 1>(b_dtype, x, b, dy, dx,
                                                    part, db, rows, C, tiles,
                                                    chunks, rows_per_chunk, s);
  return (int)cudaErrorInvalidValue;
}
