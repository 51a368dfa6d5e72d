// Fused optimizer update over one flat unit: SGD (momentum 0 or not) and
// Adam, in place.
//
// Replaces the TPU kernel mxnet_tpu/ops/kernels/opt_update.py `_opt_kernel`
// (launched by `unit_update`). Under the ZeRO-1 sharded update each
// parameter's update is an elementwise rule over a flat 1/N shard, and a
// bucket unit fuses many small parameters into one buffer with
// per-element lr / wd / t vectors. The rule, in the order of the TPU
// kernel's `_state_body` / `_weight_body`:
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
// Bound on the card: bytes (w, g and the states read once, w and the
// states written once; 28 B an element for float32 Adam). Design: one
// grid-stride streaming pass, four elements a thread an iteration with
// 16-byte (float32) or 8-byte (bfloat16) loads when the pointers allow,
// written in place so no second buffer is touched.
//
// Hyperparameters come in one of three ways (`hp`): as host scalars in
// the launch's arguments, as per-element (n,) vectors (a ZeRO bucket
// unit), or as single values in device memory (lr, wd, t at a pointer
// each, e.g. element i of a (P,) buffer, and the rescale and the clip at
// a pointer each), which a captured CUDA graph reads afresh at every
// replay. The arithmetic is the same in all three.
#include "common.cuh"

enum { OPT_SGD = 0, OPT_SGD_MOM = 1, OPT_ADAM = 2 };

struct OptArgs {
  float lr, wd;
  int t;
  float rescale, clip, mom, b1, b2, eps, omb1, omb2;
};

template <typename T, int P>
struct alignas(sizeof(T) * P) OptPack {
  T v[P];
};

// a Python-float constant as the weight's dtype holds it
template <typename T>
__device__ __forceinline__ float opt_const(float c) {
  return mxt_to_float(mxt_from_float<T>(c));
}

template <typename T, int KIND, bool CLIP>
__device__ __forceinline__ void opt_rule(const OptArgs& a, float w, float g,
                                         float m, float v, float lr, float wd,
                                         int t, float& nw, float& nm,
                                         float& nv) {
  g = __fmul_rn(g, a.rescale);
  if (CLIP) g = g < -a.clip ? -a.clip : (g > a.clip ? a.clip : g);
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
    const float mhat = __fdiv_rn(nm, __fsub_rn(1.f, powf(a.b1, (float)t)));
    const float vhat = __fdiv_rn(nv, __fsub_rn(1.f, powf(a.b2, (float)t)));
    nw = __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, mhat),
                                __fadd_rn(__fsqrt_rn(vhat), a.eps)));
  }
}

template <typename T, int KIND, bool CLIP, bool VEC>
__device__ __forceinline__ void opt_elem(T* w, const T* g, T* s0, T* s1,
                                         const float* lrv, const float* wdv,
                                         const int* tv, long long i,
                                         const OptArgs& a) {
  float nw, nm = 0.f, nv = 0.f;
  const float m = KIND != OPT_SGD ? mxt_to_float(s0[i]) : 0.f;
  const float v = KIND == OPT_ADAM ? mxt_to_float(s1[i]) : 0.f;
  opt_rule<T, KIND, CLIP>(a, mxt_to_float(w[i]), mxt_to_float(g[i]), m, v,
                          VEC ? lrv[i] : a.lr, VEC ? wdv[i] : a.wd,
                          VEC ? tv[i] : a.t, nw, nm, nv);
  w[i] = mxt_from_float<T>(nw);
  if (KIND != OPT_SGD) s0[i] = mxt_from_float<T>(nm);
  if (KIND == OPT_ADAM) s1[i] = mxt_from_float<T>(nv);
}

template <typename T, int KIND, bool CLIP, bool VEC, int P>
__global__ void opt_update_kernel(T* __restrict__ w, const T* __restrict__ g,
                                  T* __restrict__ s0, T* __restrict__ s1,
                                  const float* __restrict__ lrv,
                                  const float* __restrict__ wdv,
                                  const int* __restrict__ tv,
                                  const float* __restrict__ rsp,
                                  const float* __restrict__ clp, long long n,
                                  OptArgs a) {
  // device scalars (hp 2): one value each at lrv, wdv, tv, rsp and clp
  if (!VEC && lrv) {
    a.lr = *lrv;
    a.wd = *wdv;
    a.t = *tv;
    a.rescale = *rsp;
    a.clip = *clp;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_packs = n / P;
  for (long long p = tid; p < n_packs; p += stride) {
    const long long i = p * P;
    typedef OptPack<T, P> Pk;
    Pk wv = *reinterpret_cast<const Pk*>(w + i);
    const Pk gv = *reinterpret_cast<const Pk*>(g + i);
    Pk mv, vv;
    if (KIND != OPT_SGD) mv = *reinterpret_cast<const Pk*>(s0 + i);
    if (KIND == OPT_ADAM) vv = *reinterpret_cast<const Pk*>(s1 + i);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float nw, nm = 0.f, nv = 0.f;
      opt_rule<T, KIND, CLIP>(
          a, mxt_to_float(wv.v[j]), mxt_to_float(gv.v[j]),
          KIND != OPT_SGD ? mxt_to_float(mv.v[j]) : 0.f,
          KIND == OPT_ADAM ? mxt_to_float(vv.v[j]) : 0.f,
          VEC ? lrv[i + j] : a.lr, VEC ? wdv[i + j] : a.wd,
          VEC ? tv[i + j] : a.t, nw, nm, nv);
      wv.v[j] = mxt_from_float<T>(nw);
      if (KIND != OPT_SGD) mv.v[j] = mxt_from_float<T>(nm);
      if (KIND == OPT_ADAM) vv.v[j] = mxt_from_float<T>(nv);
    }
    *reinterpret_cast<Pk*>(w + i) = wv;
    if (KIND != OPT_SGD) *reinterpret_cast<Pk*>(s0 + i) = mv;
    if (KIND == OPT_ADAM) *reinterpret_cast<Pk*>(s1 + i) = vv;
  }
  // the ragged tail past the last whole pack
  for (long long i = n_packs * P + tid; i < n; i += stride)
    opt_elem<T, KIND, CLIP, VEC>(w, g, s0, s1, lrv, wdv, tv, i, a);
}

static inline bool opt_aligned(const void* p, size_t bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <typename T, int KIND, bool CLIP, bool VEC>
static void opt_launch(void* w, const void* g, void* s0, void* s1,
                       const void* lrv, const void* wdv, const void* tv,
                       const void* rsp, const void* clp, long long n,
                       const OptArgs& a, cudaStream_t s) {
  const size_t pb = sizeof(T) * 4;
  const bool packed = opt_aligned(w, pb) && opt_aligned(g, pb) &&
                      opt_aligned(s0, pb) && opt_aligned(s1, pb);
  const int threads = 256;
  const long long work = packed ? n / 4 + 1 : n;
  long long blocks = (work + threads - 1) / threads;
  const long long cap = 132LL * 16;   // 16 blocks of 256 a SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
#define MXT_OPT_ARGS                                                    \
  static_cast<T*>(w), static_cast<const T*>(g), static_cast<T*>(s0),    \
      static_cast<T*>(s1), static_cast<const float*>(lrv),              \
      static_cast<const float*>(wdv), static_cast<const int*>(tv),       \
      static_cast<const float*>(rsp), static_cast<const float*>(clp), n, a
  if (packed)
    opt_update_kernel<T, KIND, CLIP, VEC, 4>
        <<<(unsigned)blocks, threads, 0, s>>>(MXT_OPT_ARGS);
  else
    opt_update_kernel<T, KIND, CLIP, VEC, 1>
        <<<(unsigned)blocks, threads, 0, s>>>(MXT_OPT_ARGS);
#undef MXT_OPT_ARGS
}

template <typename T, int KIND>
static void opt_dispatch_flags(int has_clip, int vec, void* w, const void* g,
                               void* s0, void* s1, const void* lrv,
                               const void* wdv, const void* tv,
                               const void* rsp, const void* clp, long long n,
                               const OptArgs& a, cudaStream_t s) {
#define MXT_OPT_PTRS w, g, s0, s1, lrv, wdv, tv, rsp, clp, n, a, s
  if (has_clip) {
    if (vec)
      opt_launch<T, KIND, true, true>(MXT_OPT_PTRS);
    else
      opt_launch<T, KIND, true, false>(MXT_OPT_PTRS);
  } else {
    if (vec)
      opt_launch<T, KIND, false, true>(MXT_OPT_PTRS);
    else
      opt_launch<T, KIND, false, false>(MXT_OPT_PTRS);
  }
#undef MXT_OPT_PTRS
}

template <typename T>
static int opt_dispatch(int kind, int has_clip, int vec, void* w,
                        const void* g, void* s0, void* s1, const void* lrv,
                        const void* wdv, const void* tv, const void* rsp,
                        const void* clp, long long n, const OptArgs& a,
                        cudaStream_t s) {
#define MXT_OPT_ALL \
  has_clip, vec, w, g, s0, s1, lrv, wdv, tv, rsp, clp, n, a, s
  if (kind == OPT_SGD)
    opt_dispatch_flags<T, OPT_SGD>(MXT_OPT_ALL);
  else if (kind == OPT_SGD_MOM)
    opt_dispatch_flags<T, OPT_SGD_MOM>(MXT_OPT_ALL);
  else if (kind == OPT_ADAM)
    opt_dispatch_flags<T, OPT_ADAM>(MXT_OPT_ALL);
  else
    return (int)cudaErrorInvalidValue;
#undef MXT_OPT_ALL
  return 0;
}

// w, g, s0, s1: (n,) contiguous in `dtype` (s0/s1 null where the kind has
// no such state). By `hp`: 0, lrv, wdv, tv, rsp and clp null and the
// scalars lr, wd, t, rescale and clip hold; 1, lrv, wdv (float32) and tv
// (int32) (n,) vectors, rsp and clp null and the scalars rescale and clip
// hold; 2, all five one value each in device memory (float32, but tv
// int32). omb1 / omb2 are 1 - b1 and 1 - b2 as the host computes them (in
// double, then rounded to float32).
MXT_API int mxt_opt_update(void* w, const void* g, void* s0, void* s1,
                           const void* lrv, const void* wdv, const void* tv,
                           const void* rsp, const void* clp, long long n,
                           int kind, int has_clip, int hp, float lr,
                           float wd, int t, float rescale, float clip,
                           float mom, float b1, float b2, float eps,
                           float omb1, float omb2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const bool lwt = lrv && wdv && tv, no_lwt = !lrv && !wdv && !tv;
  const bool rc = rsp && clp, no_rc = !rsp && !clp;
  const bool ok = hp == 0 ? no_lwt && no_rc
                          : hp == 1 ? lwt && no_rc : hp == 2 && lwt && rc;
  if (!ok) return (int)cudaErrorInvalidValue;
  const OptArgs a{lr, wd, t, rescale, clip, mom, b1, b2, eps, omb1, omb2};
  const int vec = hp == 1;
  int err;
  if (dtype == MXT_F32)
    err = opt_dispatch<float>(kind, has_clip, vec, w, g, s0, s1, lrv, wdv,
                              tv, rsp, clp, n, a, s);
  else if (dtype == MXT_BF16)
    err = opt_dispatch<__nv_bfloat16>(kind, has_clip, vec, w, g, s0, s1, lrv,
                                      wdv, tv, rsp, clp, n, a, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  return (int)cudaGetLastError();
}
