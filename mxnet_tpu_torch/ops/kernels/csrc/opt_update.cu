// Fused optimizer update over a list of flat units in ONE launch: SGD
// (momentum 0 or not) and Adam, in place.
//
// Replaces the TPU kernel mxnet_tpu/ops/kernels/opt_update.py `_opt_kernel`
// (launched by `unit_update` once a unit). Here one launch takes a whole
// update: every parameter of a captured one-card step, every unit of a
// ZeRO-1 reduce group, every parameter of an eager `Trainer.step`. The
// rule, element for element, in the order of the TPU kernel's
// `_state_body` / `_weight_body`:
//
//   g  = clip(g * rescale, -clip, clip);  g = g + wd * w
//   sgd:      w' = w - lr * g
//   sgd mom:  m' = mom * m - lr * g;  w' = w + m'
//   adam:     m' = b1 * m + (1 - b1) * g;  v' = b2 * v + (1 - b2) * g * g
//             w' = w - lr * (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps)
//
// The arithmetic is float32 with each operation rounded on its own
// (__fmul_rn and its kin are never contracted into an FMA), so the plain
// PyTorch version, a chain of separate elementwise ops, agrees bit for bit
// on the card. As in the Pallas body's promotions, the constants `mom`,
// `b1` and `b2` that multiply a state are weakly typed Python floats, so
// they are rounded to the weight's dtype first; every product and sum is
// float32, and the outputs are rounded to the weight's dtype. b1^t is a
// float32 powf, as JAX's `b1 ** t` of an int32 t.
//
// The list: an entry is one flat unit (w, g, its states, n) with its own
// lr, wd and t in one of three forms: values in the entry (host
// scalars), one value each in device memory (a captured step's
// `DeviceHParams` view, read afresh at every replay), or per-element (n,)
// vectors (a ZeRO bucket unit). The rescale and the clip are one each for
// the launch, values or device pointers. An entry may name `low`, a
// low-precision copy of w (a float32 master's bfloat16 or float16
// weight), written from the same registers as w: the rounding of the new
// float32 value, as `low.copy_(w)` rounds it.
//
// The table of entries is the launch's own parameter (`__grid_constant__`,
// up to 32,764 bytes since CUDA 12.1): a captured graph keeps it, so no
// table lives in device memory and nothing is copied to the card. Work
// split: each entry is cut into chunks of `chunk` elements (a multiple of
// the 16-byte pack; `chunk0` is the entry's first chunk, planned on the
// host), one block a chunk, so a 64-value BatchNorm gamma and a 23 M-value
// embedding share the card in one launch and the block scheduler keeps
// every SM busy to the end. (Measured slower on one H100: a persistent
// grid walking the chunks round robin, 2 to 4 times as many blocks as
// the card keeps resident, by 1-2 %; equal contiguous parts a block, by
// 21 % at one 23 M-value entry, its blocks far apart in memory.) Loads
// and stores are 16-byte packs (4 float32, 8 bfloat16) where every
// pointer of the entry is aligned, one element at a time for the ragged
// end and for a misaligned view. Bound on the card: bytes (w, g and the
// states read once, w and the states written once; 28 B an element for
// float32 Adam).
#include "common.cuh"

#include <cuda_fp16.h>

enum { OPT_SGD = 0, OPT_SGD_MOM = 1, OPT_ADAM = 2 };
// an entry's hyperparameter form (the low two bits of `form`)
enum { OPT_HP_HOST = 0, OPT_HP_DEVICE = 1, OPT_HP_VECTOR = 2 };
// `form` bit: `low` is float16 (else bfloat16)
#define OPT_LOW_F16 4
// entries a launch (its table is the launch's parameter block)
#define OPT_CAPACITY 400
#define OPT_THREADS 256

union OptHp {
  const void* p;   // OPT_HP_DEVICE: one value; OPT_HP_VECTOR: (n,) values
  float f;         // OPT_HP_HOST: lr, wd
  int i;           // OPT_HP_HOST: t
};

// one flat unit; the layout is ops/kernels/opt_update.py's ENTRY_DTYPE
struct OptEntry {
  void* w;
  const void* g;
  void* s0;
  void* s1;
  void* low;
  OptHp lr, wd, t;
  long long n;
  int chunk0;
  int form;
};
static_assert(sizeof(OptEntry) == 80, "OptEntry is 80 bytes");

struct OptConsts {
  const float* rsp;   // the rescale and the clip in device memory, or null
  const float* clp;
  float rescale, clip, mom, b1, b2, eps, omb1, omb2;
  int n_entries, chunk;
};

struct OptTable {
  OptConsts c;
  OptEntry e[OPT_CAPACITY];
};
static_assert(sizeof(OptTable) <= 32764,
              "the table fits the launch's parameters");

template <typename T, int P>
struct alignas(sizeof(T) * P) OptPack {
  T v[P];
};

// a Python-float constant as the weight's dtype holds it
template <typename T>
__device__ __forceinline__ float opt_const(float c) {
  return mxt_to_float(mxt_from_float<T>(c));
}

// the rule on one element; c1 = 1 - b1^t and c2 = 1 - b2^t (Adam)
template <typename T, int KIND, bool CLIP>
__device__ __forceinline__ void opt_rule(const OptConsts& a, float rescale,
                                         float clip, float w, float g,
                                         float m, float v, float lr,
                                         float wd, float c1, float c2,
                                         float& nw, float& nm, float& nv) {
  g = __fmul_rn(g, rescale);
  if (CLIP) g = g < -clip ? -clip : (g > clip ? clip : g);
  g = __fadd_rn(g, __fmul_rn(wd, w));
  if (KIND == OPT_SGD) {
    nw = __fsub_rn(w, __fmul_rn(lr, g));
  } else if (KIND == OPT_SGD_MOM) {
    nm = __fsub_rn(__fmul_rn(opt_const<T>(a.mom), m), __fmul_rn(lr, g));
    nw = __fadd_rn(w, nm);
  } else {
    nm = __fadd_rn(__fmul_rn(opt_const<T>(a.b1), m), __fmul_rn(a.omb1, g));
    nv = __fadd_rn(__fmul_rn(opt_const<T>(a.b2), v),
                   __fmul_rn(__fmul_rn(a.omb2, g), g));
    const float mhat = __fdiv_rn(nm, c1);
    const float vhat = __fdiv_rn(nv, c2);
    nw = __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, mhat),
                                __fadd_rn(__fsqrt_rn(vhat), a.eps)));
  }
}

template <typename T, int KIND>
__device__ __forceinline__ void opt_bias(const OptConsts& a, int t,
                                         float& c1, float& c2) {
  if (KIND == OPT_ADAM) {
    c1 = __fsub_rn(1.f, powf(a.b1, (float)t));
    c2 = __fsub_rn(1.f, powf(a.b2, (float)t));
  }
}

// the low-precision copy of a new float32 weight
__device__ __forceinline__ void opt_store_low(void* low, long long i,
                                              bool f16, float v) {
  if (f16)
    static_cast<__half*>(low)[i] = __float2half_rn(v);
  else
    static_cast<__nv_bfloat16*>(low)[i] = __float2bfloat16_rn(v);
}

template <int P>
__device__ __forceinline__ void opt_store_low_pack(void* low, long long i,
                                                   bool f16,
                                                   const float* v) {
  if (f16) {
    OptPack<__half, P> o;
#pragma unroll
    for (int j = 0; j < P; ++j) o.v[j] = __float2half_rn(v[j]);
    *reinterpret_cast<OptPack<__half, P>*>(static_cast<__half*>(low) + i) =
        o;
  } else {
    OptPack<__nv_bfloat16, P> o;
#pragma unroll
    for (int j = 0; j < P; ++j) o.v[j] = __float2bfloat16_rn(v[j]);
    *reinterpret_cast<OptPack<__nv_bfloat16, P>*>(
        static_cast<__nv_bfloat16*>(low) + i) = o;
  }
}

// `len` elements of entry `e` from element `base`; VEC: per-element
// hyperparameters, else lr, wd, c1, c2 hold for the whole chunk
template <typename T, int KIND, bool CLIP, bool VEC>
__device__ __forceinline__ void opt_chunk(const OptEntry& e,
                                          const OptConsts& a, long long base,
                                          int len, float rescale, float clip,
                                          float lr, float wd, float c1,
                                          float c2) {
  constexpr int P = 16 / sizeof(T);
  T* __restrict__ w = static_cast<T*>(e.w) + base;
  const T* __restrict__ g = static_cast<const T*>(e.g) + base;
  T* __restrict__ s0 = KIND != OPT_SGD ? static_cast<T*>(e.s0) + base
                                       : nullptr;
  T* __restrict__ s1 = KIND == OPT_ADAM ? static_cast<T*>(e.s1) + base
                                        : nullptr;
  const float* lrv = VEC ? static_cast<const float*>(e.lr.p) + base : nullptr;
  const float* wdv = VEC ? static_cast<const float*>(e.wd.p) + base : nullptr;
  const int* tv = VEC ? static_cast<const int*>(e.t.p) + base : nullptr;
  // a low copy only of a float32 master (the host refuses others)
  void* low = sizeof(T) == 4 ? e.low : nullptr;
  const bool f16 = (e.form & OPT_LOW_F16) != 0;
  long long lo_off = base;   // low is indexed like the whole entry
  const uintptr_t addr = reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(s0) |
                         reinterpret_cast<uintptr_t>(s1);
  const bool packed =
      (addr & 15u) == 0 &&
      (low == nullptr ||
       ((reinterpret_cast<uintptr_t>(low) + 2 * lo_off) & (2 * P - 1)) == 0);
  const int np = packed ? len / P : 0;
  typedef OptPack<T, P> Pk;
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const int i = p * P;
    Pk wv = *reinterpret_cast<const Pk*>(w + i);
    const Pk gv = *reinterpret_cast<const Pk*>(g + i);
    Pk mv, vv;
    if (KIND != OPT_SGD) mv = *reinterpret_cast<const Pk*>(s0 + i);
    if (KIND == OPT_ADAM) vv = *reinterpret_cast<const Pk*>(s1 + i);
    float nws[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float elr = lr, ewd = wd, ec1 = c1, ec2 = c2;
      if (VEC) {
        elr = lrv[i + j];
        ewd = wdv[i + j];
        opt_bias<T, KIND>(a, tv[i + j], ec1, ec2);
      }
      float nm = 0.f, nv = 0.f;
      opt_rule<T, KIND, CLIP>(
          a, rescale, clip, mxt_to_float(wv.v[j]), mxt_to_float(gv.v[j]),
          KIND != OPT_SGD ? mxt_to_float(mv.v[j]) : 0.f,
          KIND == OPT_ADAM ? mxt_to_float(vv.v[j]) : 0.f, elr, ewd, ec1, ec2,
          nws[j], nm, nv);
      wv.v[j] = mxt_from_float<T>(nws[j]);
      if (KIND != OPT_SGD) mv.v[j] = mxt_from_float<T>(nm);
      if (KIND == OPT_ADAM) vv.v[j] = mxt_from_float<T>(nv);
    }
    *reinterpret_cast<Pk*>(w + i) = wv;
    if (KIND != OPT_SGD) *reinterpret_cast<Pk*>(s0 + i) = mv;
    if (KIND == OPT_ADAM) *reinterpret_cast<Pk*>(s1 + i) = vv;
    if (low) opt_store_low_pack<P>(low, lo_off + i, f16, nws);
  }
  // the ragged end past the last whole pack, or a misaligned entry
  for (int i = np * P + threadIdx.x; i < len; i += blockDim.x) {
    float elr = lr, ewd = wd, ec1 = c1, ec2 = c2;
    if (VEC) {
      elr = lrv[i];
      ewd = wdv[i];
      opt_bias<T, KIND>(a, tv[i], ec1, ec2);
    }
    float nw, nm = 0.f, nv = 0.f;
    opt_rule<T, KIND, CLIP>(
        a, rescale, clip, mxt_to_float(w[i]), mxt_to_float(g[i]),
        KIND != OPT_SGD ? mxt_to_float(s0[i]) : 0.f,
        KIND == OPT_ADAM ? mxt_to_float(s1[i]) : 0.f, elr, ewd, ec1, ec2, nw,
        nm, nv);
    w[i] = mxt_from_float<T>(nw);
    if (KIND != OPT_SGD) s0[i] = mxt_from_float<T>(nm);
    if (KIND == OPT_ADAM) s1[i] = mxt_from_float<T>(nv);
    if (low) opt_store_low(low, lo_off + i, f16, nw);
  }
}

// One block a chunk: the card's block scheduler hands the next chunk to
// the first SM with room.
template <typename T, int KIND, bool CLIP>
__global__ void __launch_bounds__(OPT_THREADS)
    opt_multi_kernel(const __grid_constant__ OptTable tab) {
  const OptConsts& a = tab.c;
  const int c = blockIdx.x;
  // the entry of chunk c: the last whose first chunk is at or before c
  int k = 0, hi = a.n_entries - 1;
  while (k < hi) {
    const int mid = (k + hi + 1) >> 1;
    if (tab.e[mid].chunk0 <= c)
      k = mid;
    else
      hi = mid - 1;
  }
  const OptEntry& e = tab.e[k];
  const long long base = (long long)(c - e.chunk0) * a.chunk;
  const long long left = e.n - base;
  const int len = left < a.chunk ? (int)left : a.chunk;
  const float rescale = a.rsp ? *a.rsp : a.rescale;
  const float clip = a.clp ? *a.clp : a.clip;
  const int form = e.form & 3;
  if (form == OPT_HP_VECTOR) {
    opt_chunk<T, KIND, CLIP, true>(e, a, base, len, rescale, clip, 0.f, 0.f,
                                   1.f, 1.f);
    return;
  }
  float lr, wd, c1 = 1.f, c2 = 1.f;
  if (form == OPT_HP_DEVICE) {
    lr = *static_cast<const float*>(e.lr.p);
    wd = *static_cast<const float*>(e.wd.p);
    opt_bias<T, KIND>(a, *static_cast<const int*>(e.t.p), c1, c2);
  } else {
    lr = e.lr.f;
    wd = e.wd.f;
    opt_bias<T, KIND>(a, e.t.i, c1, c2);
  }
  opt_chunk<T, KIND, CLIP, false>(e, a, base, len, rescale, clip, lr, wd, c1,
                                  c2);
}

template <typename T, int KIND, bool CLIP>
static int opt_launch(const OptConsts& c, const OptEntry* entries,
                      int n_chunks, cudaStream_t s) {
  OptTable tab;
  tab.c = c;
  for (int k = 0; k < c.n_entries; ++k) tab.e[k] = entries[k];
  opt_multi_kernel<T, KIND, CLIP><<<n_chunks, OPT_THREADS, 0, s>>>(tab);
  return 0;
}

template <typename T, int KIND>
static int opt_clip(int has_clip, const OptConsts& c,
                    const OptEntry* entries, int n_chunks, cudaStream_t s) {
  return has_clip ? opt_launch<T, KIND, true>(c, entries, n_chunks, s)
                  : opt_launch<T, KIND, false>(c, entries, n_chunks, s);
}

template <typename T>
static int opt_kind(int kind, int has_clip, const OptConsts& c,
                    const OptEntry* entries, int n_chunks, cudaStream_t s) {
  if (kind == OPT_SGD)
    return opt_clip<T, OPT_SGD>(has_clip, c, entries, n_chunks, s);
  if (kind == OPT_SGD_MOM)
    return opt_clip<T, OPT_SGD_MOM>(has_clip, c, entries, n_chunks, s);
  if (kind == OPT_ADAM)
    return opt_clip<T, OPT_ADAM>(has_clip, c, entries, n_chunks, s);
  return (int)cudaErrorInvalidValue;
}

// entries: `n_entries` (at most OPT_CAPACITY, ops/kernels/opt_update.py's
// CAPACITY) OptEntry records in host memory, each with n > 0 and
// `chunk0` its first chunk (entry k's chunks follow entry k-1's), in w's
// `dtype` (s0/s1 null where the kind has no such state; `low` only for a
// float32 w). rsp / clp: the rescale and the clip in device memory
// (float32), or null, and then `rescale` / `clip` hold. omb1 / omb2 are
// 1 - b1 and 1 - b2 as the host computes them (in double, then rounded to
// float32). `chunk`: elements a chunk, a multiple of 8.
MXT_API int mxt_opt_update(const void* entries, int n_entries, int n_chunks,
                           int chunk, int kind, int has_clip,
                           const void* rsp, const void* clp, float rescale,
                           float clip, float mom, float b1, float b2,
                           float eps, float omb1, float omb2, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_entries <= 0 || n_chunks <= 0) return 0;
  if (n_entries > OPT_CAPACITY || chunk <= 0 || chunk % 8 != 0 ||
      (rsp == nullptr) != (clp == nullptr))
    return (int)cudaErrorInvalidValue;
  const OptConsts c{static_cast<const float*>(rsp),
                    static_cast<const float*>(clp),
                    rescale, clip, mom, b1, b2, eps, omb1, omb2, n_entries,
                    chunk};
  const OptEntry* e = static_cast<const OptEntry*>(entries);
  int err;
  if (dtype == MXT_F32)
    err = opt_kind<float>(kind, has_clip, c, e, n_chunks, s);
  else if (dtype == MXT_BF16)
    err = opt_kind<__nv_bfloat16>(kind, has_clip, c, e, n_chunks, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  return (int)cudaGetLastError();
}
