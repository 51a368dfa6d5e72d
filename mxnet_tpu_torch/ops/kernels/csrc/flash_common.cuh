// Device helpers of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): asynchronous copies into shared memory (cp.async),
// tile loads that zero-fill the ragged edge, the causal walk's length,
// float4 dot products, and the bfloat16 tensor-core pieces (ldmatrix
// fragments, mma.sync.m16n8k16, paired bf16 stores).
#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst; bytes past `n` (0 or 16) read as zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}
// 4 bytes from src to shared dst; `n` 0 reads zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + ROWS) of a (S, D) head at src into dst (row stride
// LD elements, DP columns), zeros past S and D: 16-byte cp.async where
// `vec` (D a multiple of 16 bytes' elements, pointers aligned), else
// plain loads
template <typename T, int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int S, int D, bool vec) {
  constexpr int E = 16 / sizeof(T);       // elements a chunk
  constexpr int CPR = DP / E;             // chunks a row
  if (vec) {
    for (int ci = threadIdx.x; ci < ROWS * CPR; ci += NT) {
      const int row = ci / CPR, d = (ci - row * CPR) * E;
      const int g = row0 + row;
      const bool in = g < S && d < D;
      cp_async16(dst + row * LD + d, in ? src + (size_t)g * D + d : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int row = i / DP, d = i - row * DP;
      const int g = row0 + row;
      dst[row * LD + d] = (g < S && d < D) ? src[(size_t)g * D + d]
                                           : mxt_from_float<T>(0.f);
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// key tiles of `bk` keys that the query rows [q0, q0 + rows) walk: all,
// or (causal) none wholly above the diagonal, which is aligned to the end
__device__ __forceinline__ int key_tiles(int q0, int rows, int bk, int Sq,
                                         int Sk, int causal) {
  const int nk = (Sk + bk - 1) / bk;
  if (!causal) return nk;
  const int kmax = min(q0 + rows, Sq) - 1 + (Sk - Sq);
  return kmax < 0 ? 0 : min(nk, kmax / bk + 1);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float f4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b for one m16n8k16 tile (bf16 operands, float32 sums)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// columns col and col + 1 (those below D) of a bf16 row; `vec`: D even
// and the row 4-byte aligned, so one store of the pair
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int col,
                                           int D, float a, float c,
                                           bool vec) {
  if (vec && col + 1 < D) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) =
        __floats2bfloat162_rn(a, c);
  } else {
    if (col < D) row[col] = __float2bfloat16_rn(a);
    if (col + 1 < D) row[col + 1] = __float2bfloat16_rn(c);
  }
}

}  // namespace
