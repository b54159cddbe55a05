// Multi-tensor AdamW: one launch updates every (p, g, m, v) quadruple of a
// dtype bucket in place.
//
//   m' = m * beta1 + g * (1 - beta1)
//   v' = v * beta2 + (g * g) * (1 - beta2)
//   u  = (m' / bc1) / (sqrt(v' / bc2) + eps)   [+ p * weight_decay]
//   p' = p - u * lr
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_fused_adamw (:1944), the
// per-step multi-tensor claim; thunder_tpu/executors/pallasex.py
// pallas_fused_adamw_slab (:1966), the slab-persistent claim (the
// tt_fused_adamw_slab entry); and the kernel call behind both, _adamw_slab_call
// (:1917), whose body is _fused_adamw_kernel (:1872). The arithmetic is f32 in
// that kernel's (and optim.adamw_step's) exact op order, every operation
// rounded on its own (__fmul_rn and friends: no contraction into FMAs, the
// order the plain PyTorch version runs op by op); each stream is stored
// rounded to its own dtype. bc1 = 1 - beta1^step and bc2 are read from device
// memory, so the step counter never visits the host.
//
// Bound on an H100: bytes. Each element reads p, g, m, v and writes p, m, v.
// The per-step train path (llama3-8b-bench, 4 layers, one bf16 bucket of
// 1.1347 G parameters with f32 m and v): 22 B per element, 24.96 GB, 7.45 ms
// at 3.35 TB/s. The slab path at bench width (llama2-7b-bench, 8 layers, one
// bf16 bucket of 1.8812 G parameters, bf16 m slab, f32 v slab): 18 B per
// element, 33.86 GB, 10.11 ms. ~12 operations per element.
//
// Design: the TPU version packs every stream of the bucket into one
// (rows, 128) slab and unpacks it again (pallasex.py:1897-1914), two extra
// passes over every stream on this card; its slab-persistent form still packs
// p and g and unpacks p every step. Here the wrapper hands the kernel a device
// table with one row per tensor -- the four pointers, the length, and the
// index of its first chunk -- as PyTorch's own multi-tensor apply does. The
// slab entry's rows point m and v into the persistent slabs at the tensor's
// element offset (64-bit, in the optimizer's slab layout), so no stream is
// ever packed and the slabs' zero pad tail is never launched over. Both
// entries run one body, so their results are bit-identical on the same
// values. Each block takes one 4096-element chunk, finds its tensor by a
// binary search over the table, and walks the chunk with each thread on 4
// consecutive elements per step: 16-byte loads for f32 streams, 8-byte loads
// for bf16 ones. A tensor's tail of fewer than 4 elements, and every element
// of a row whose base pointers are not aligned for those loads (a slab run
// after a bucket member whose size is not a multiple of 4), take scalar loads.
//
// The numerics guard (thunder_tpu_torch/transforms/numerics_guard.py) needs a
// step's health before the update writes anything: the update is in place,
// so a non-finite step must be refused up front to leave p, m and v
// bit-identical (the reference selects old state in-graph instead,
// thunder_tpu/transforms/numerics_guard.py:317-320, and counts non-finite
// values with XLA reductions at :240-316). So the library has two more
// entries and one more argument:
//
// - tt_fused_adamw_health / tt_fused_adamw_slab_health: the health pass. The
//   same table walk and the same adamw() body, with the results rounded to
//   each stream's dtype exactly as the update stores them, but nothing is
//   stored. Each block writes three floats of a per-chunk workspace: its
//   count of non-finite g, its float32 sum of g*g, and its count of
//   non-finite p', m', v' (as stored). A one-block fold then adds the chunks
//   in a fixed order, in float64, into a 3-double accumulator the wrapper
//   zeroes once per step (several dtype buckets add into it in bucket
//   order). No float atomics anywhere, so a guarded step is bit-identical
//   from call to call. A float32 sum of huge finite g*g can overflow to inf,
//   as the reference's float32 sum does; the sentinel keeps inf out of its
//   histogram.
// - `health` on both update entries: the 5-float health word
//   (runtime/sentinel.py IDX_*). Each block reads it and returns before any
//   store when its non-finite total (grads + loss + state) is not 0.
//   nullptr keeps the ungated update exactly.
//
// Health pass bound on an H100: bytes, read-only. Per-step path at 4 layers
// of llama3-8b-bench: 12 B per element (bf16 p and g, f32 m and v), 13.62 GB,
// 4.06 ms; the slab bench bucket (bf16 m slab): 10 B per element, 18.81 GB,
// 5.62 ms.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;
constexpr long long CHUNK = THREADS * VEC * 4;   // elements per block (cudaex.ADAMW_CHUNK)
constexpr int ROW = 6;   // table row: p, g, m, v, numel, first chunk

template <typename T> struct Io;
template <> struct Io<float> {
  __device__ static void load4(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static void store4(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <typename T> struct Io16 {   // bf16 or fp16
  __device__ static void load4(const T* p, float (&x)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const T* h = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = tt::to_f(h[i]);
  }
  __device__ static void store4(T* p, const float (&x)[4]) {
    uint2 v;
    v.x = tt::pack2<T>(x[0], x[1]);
    v.y = tt::pack2<T>(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = v;
  }
};
template <> struct Io<__nv_bfloat16> : Io16<__nv_bfloat16> {};
template <> struct Io<__half> : Io16<__half> {};

struct Hyper {
  float lr, beta1, beta2, one_m_beta1, one_m_beta2, eps, weight_decay;
};

__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v, float bc1, float bc2,
                                      const Hyper& h) {
  m = __fadd_rn(__fmul_rn(m, h.beta1), __fmul_rn(g, h.one_m_beta1));
  v = __fadd_rn(__fmul_rn(v, h.beta2), __fmul_rn(__fmul_rn(g, g), h.one_m_beta2));
  const float m_hat = __fdiv_rn(m, bc1);
  const float v_hat = __fdiv_rn(v, bc2);
  float upd = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), h.eps));
  if (h.weight_decay != 0.f) upd = __fadd_rn(upd, __fmul_rn(p, h.weight_decay));
  p = __fsub_rn(p, __fmul_rn(upd, h.lr));
}

// the health pass's tally of one element: g, and the update's results as the
// update would store them
struct Tally {
  float nonfinite_g = 0.f, sumsq = 0.f, nonfinite_state = 0.f;
};

template <typename T> __device__ __forceinline__ float nonfinite_as(float x) {
  return isfinite(tt::round_as<T>(x)) ? 0.f : 1.f;
}

template <typename P, typename M, typename V>
__device__ __forceinline__ void tally(Tally& t, float g, float p, float m, float v) {
  t.nonfinite_g += isfinite(g) ? 0.f : 1.f;
  t.sumsq = __fadd_rn(t.sumsq, __fmul_rn(g, g));
  t.nonfinite_state += nonfinite_as<P>(p) + nonfinite_as<M>(m) + nonfinite_as<V>(v);
}

template <typename T> __device__ __forceinline__ bool vec_aligned(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % (VEC * sizeof(T)) == 0;
}

// element j with scalar loads and stores (HEALTH: tallied, not stored)
template <bool HEALTH, typename P, typename G, typename M, typename V>
__device__ __forceinline__ void adamw_at(P* p, const G* g, M* m, V* v, long long j, float bc1,
                                         float bc2, const Hyper& h, Tally& t) {
  float pj = tt::to_f(p[j]), mj = tt::to_f(m[j]), vj = tt::to_f(v[j]);
  const float gj = tt::to_f(g[j]);
  adamw(pj, gj, mj, vj, bc1, bc2, h);
  if constexpr (HEALTH) {
    tally<P, M, V>(t, gj, pj, mj, vj);
  } else {
    p[j] = tt::from_f<P>(pj);
    m[j] = tt::from_f<M>(mj);
    v[j] = tt::from_f<V>(vj);
  }
}

// one block's chunk of the bucket. The update (HEALTH false) stores p', m'
// and v'; with a health word it first refuses a step whose non-finite total
// is not 0. The health pass (HEALTH true) runs the same walk and arithmetic,
// stores nothing, and writes the chunk's three tallies to ws[3 * chunk].
template <bool HEALTH, typename P, typename G, typename M, typename V>
__device__ __forceinline__ void adamw_chunk(const long long* __restrict__ table, int n_tensors,
                                            const float* __restrict__ bc, const Hyper& h,
                                            const float* __restrict__ health,
                                            float* __restrict__ ws) {
  if constexpr (!HEALTH) {
    // a NaN total fails the comparison too
    if (health != nullptr && !(health[0] + health[1] + health[2] == 0.f)) return;
  }
  // the tensor whose chunks hold this block: the last row with first chunk <= blockIdx.x
  const long long c = blockIdx.x;
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid * ROW + 5] <= c) lo = mid; else hi = mid - 1;
  }
  const long long* row = table + lo * ROW;
  P* p = reinterpret_cast<P*>(row[0]);
  const G* g = reinterpret_cast<const G*>(row[1]);
  M* m = reinterpret_cast<M*>(row[2]);
  V* v = reinterpret_cast<V*>(row[3]);
  const long long n = row[4];
  const long long begin = (c - row[5]) * CHUNK;
  const long long end = min(begin + CHUNK, n);
  const float bc1 = bc[0], bc2 = bc[1];
  Tally t;

  if (!(vec_aligned(p) && vec_aligned(g) && vec_aligned(m) && vec_aligned(v))) {
    // a row whose base pointers do not take the vector loads (a slab run
    // after a bucket member whose size is not a multiple of 4): one element
    // per thread and step
    for (long long j = begin + threadIdx.x; j < end; j += THREADS)
      adamw_at<HEALTH>(p, g, m, v, j, bc1, bc2, h, t);
  } else {
    for (long long i = begin + static_cast<long long>(threadIdx.x) * VEC; i < end;
         i += THREADS * VEC) {
      if (i + VEC <= end) {
        float pf[4], gf[4], mf[4], vf[4];
        Io<P>::load4(p + i, pf);
        Io<G>::load4(g + i, gf);
        Io<M>::load4(m + i, mf);
        Io<V>::load4(v + i, vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          adamw(pf[e], gf[e], mf[e], vf[e], bc1, bc2, h);
          if constexpr (HEALTH) tally<P, M, V>(t, gf[e], pf[e], mf[e], vf[e]);
        }
        if constexpr (!HEALTH) {
          Io<P>::store4(p + i, pf);
          Io<M>::store4(m + i, mf);
          Io<V>::store4(v + i, vf);
        }
      } else {   // the tensor's tail of fewer than 4 elements
        for (long long j = i; j < end; ++j) adamw_at<HEALTH>(p, g, m, v, j, bc1, bc2, h, t);
      }
    }
  }
  if constexpr (HEALTH) {
    // fixed-order block sums (warp butterflies, then the warps in order)
    __shared__ float red[3][32];
    const float nf_g = tt::block_sum(t.nonfinite_g, red[0]);
    const float sumsq = tt::block_sum(t.sumsq, red[1]);
    const float nf_s = tt::block_sum(t.nonfinite_state, red[2]);
    if (threadIdx.x == 0) {
      ws[3 * c] = nf_g;
      ws[3 * c + 1] = sumsq;
      ws[3 * c + 2] = nf_s;
    }
  }
}

// the per-step entry's kernel and the slab entry's: one body, two names, so a
// profile tells their launches apart
template <typename P, typename G, typename M, typename V>
__global__ void __launch_bounds__(THREADS)
fused_adamw_kernel(const long long* __restrict__ table, int n_tensors,
                   const float* __restrict__ bc, Hyper h, const float* __restrict__ health) {
  adamw_chunk<false, P, G, M, V>(table, n_tensors, bc, h, health, nullptr);
}

template <typename P, typename G, typename M, typename V>
__global__ void __launch_bounds__(THREADS)
fused_adamw_slab_kernel(const long long* __restrict__ table, int n_tensors,
                        const float* __restrict__ bc, Hyper h, const float* __restrict__ health) {
  adamw_chunk<false, P, G, M, V>(table, n_tensors, bc, h, health, nullptr);
}

// the health pass of either table layout (the rows differ only in where m
// and v point)
template <typename P, typename G, typename M, typename V>
__global__ void __launch_bounds__(THREADS)
fused_adamw_health_kernel(const long long* __restrict__ table, int n_tensors,
                          const float* __restrict__ bc, Hyper h, float* __restrict__ ws) {
  adamw_chunk<true, P, G, M, V>(table, n_tensors, bc, h, nullptr, ws);
}

constexpr int FOLD_THREADS = 1024;

// acc[k] += the sum over chunks of ws[3 * chunk + k], in float64 and in a
// fixed order: each thread its strided chunks in turn, then a tree over the
// threads
__global__ void __launch_bounds__(FOLD_THREADS)
adamw_health_fold_kernel(const float* __restrict__ ws, long long n_chunks,
                         double* __restrict__ acc) {
  __shared__ double red[3][FOLD_THREADS];
  double s0 = 0.0, s1 = 0.0, s2 = 0.0;
  for (long long c = threadIdx.x; c < n_chunks; c += FOLD_THREADS) {
    s0 += ws[3 * c];
    s1 += ws[3 * c + 1];
    s2 += ws[3 * c + 2];
  }
  red[0][threadIdx.x] = s0;
  red[1][threadIdx.x] = s1;
  red[2][threadIdx.x] = s2;
  __syncthreads();
  for (int w = FOLD_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
#pragma unroll
      for (int k = 0; k < 3; ++k) red[k][threadIdx.x] += red[k][threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x < 3) acc[threadIdx.x] += red[threadIdx.x][0];
}

enum class Entry { update, slab_update, health };

// p, g, m and v each float32, bf16 or fp16: the grad's dtype is a type of its
// own (the reference's update reads g in its own dtype and computes in f32).
// `extra` is the health word (the updates; may be nullptr) or the chunk
// workspace (the health pass, which then folds it into `acc`).
int run(Entry entry, const void* table, int n_tensors, long long n_chunks, const void* bc,
        const void* extra, void* acc, const Hyper& h, int p_dtype, int g_dtype, int m_dtype,
        int v_dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (n_tensors <= 0 || n_chunks <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const long long*>(table);
  const auto* b = static_cast<const float*>(bc);
  const unsigned blocks = static_cast<unsigned>(n_chunks);
  const cudaError_t err = tt::with_dtype(p_dtype, [&](auto pt) {
    return tt::with_dtype(g_dtype, [&](auto gt) {
      return tt::with_dtype(m_dtype, [&](auto mt) {
        return tt::with_dtype(v_dtype, [&](auto vt) {
          using P = decltype(pt);
          using G = decltype(gt);
          using M = decltype(mt);
          using V = decltype(vt);
          const auto* health = static_cast<const float*>(extra);
          if (entry == Entry::slab_update)
            fused_adamw_slab_kernel<P, G, M, V><<<blocks, THREADS, 0, s>>>(t, n_tensors, b, h,
                                                                             health);
          else if (entry == Entry::update)
            fused_adamw_kernel<P, G, M, V><<<blocks, THREADS, 0, s>>>(t, n_tensors, b, h, health);
          else
            fused_adamw_health_kernel<P, G, M, V><<<blocks, THREADS, 0, s>>>(
                t, n_tensors, b, h, static_cast<float*>(const_cast<void*>(extra)));
          return cudaSuccess;
        });
      });
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  if (entry == Entry::health) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    adamw_health_fold_kernel<<<1, FOLD_THREADS, 0, s>>>(static_cast<const float*>(extra),
                                                        n_chunks, static_cast<double*>(acc));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The table's rows: (p, g, m, v, numel, first chunk), m and v pointing at
// each tensor's own moments (tt_fused_adamw, tt_fused_adamw_health) or into
// the persistent slabs at the tensor's element offset (the _slab entries).
// `health`: the 5-float health word that gates the update, or nullptr.
extern "C" int tt_fused_adamw(const void* table, int n_tensors, long long n_chunks,
                              const void* bc, const void* health, float lr, float beta1,
                              float beta2, float one_m_beta1, float one_m_beta2, float eps,
                              float weight_decay, int p_dtype, int g_dtype, int m_dtype,
                              int v_dtype, int device, void* stream) {
  const Hyper h{lr, beta1, beta2, one_m_beta1, one_m_beta2, eps, weight_decay};
  return run(Entry::update, table, n_tensors, n_chunks, bc, health, nullptr, h, p_dtype,
             g_dtype, m_dtype, v_dtype, device, stream);
}

extern "C" int tt_fused_adamw_slab(const void* table, int n_tensors, long long n_chunks,
                                   const void* bc, const void* health, float lr, float beta1,
                                   float beta2, float one_m_beta1, float one_m_beta2, float eps,
                                   float weight_decay, int p_dtype, int g_dtype, int m_dtype,
                                   int v_dtype, int device, void* stream) {
  const Hyper h{lr, beta1, beta2, one_m_beta1, one_m_beta2, eps, weight_decay};
  return run(Entry::slab_update, table, n_tensors, n_chunks, bc, health, nullptr, h, p_dtype,
             g_dtype, m_dtype, v_dtype, device, stream);
}

// The health pass: `ws` is float32 scratch of 3 * n_chunks, `acc` the three
// float64 sums (non-finite g, sum of g*g, non-finite p'/m'/v') it adds into.
extern "C" int tt_fused_adamw_health(const void* table, int n_tensors, long long n_chunks,
                                     const void* bc, void* ws, void* acc, float lr, float beta1,
                                     float beta2, float one_m_beta1, float one_m_beta2,
                                     float eps, float weight_decay, int p_dtype, int g_dtype,
                                     int m_dtype, int v_dtype, int device, void* stream) {
  const Hyper h{lr, beta1, beta2, one_m_beta1, one_m_beta2, eps, weight_decay};
  return run(Entry::health, table, n_tensors, n_chunks, bc, ws, acc, h, p_dtype, g_dtype,
             m_dtype, v_dtype, device, stream);
}

extern "C" int tt_fused_adamw_slab_health(const void* table, int n_tensors, long long n_chunks,
                                          const void* bc, void* ws, void* acc, float lr,
                                          float beta1, float beta2, float one_m_beta1,
                                          float one_m_beta2, float eps, float weight_decay,
                                          int p_dtype, int g_dtype, int m_dtype, int v_dtype,
                                          int device, void* stream) {
  const Hyper h{lr, beta1, beta2, one_m_beta1, one_m_beta2, eps, weight_decay};
  return run(Entry::health, table, n_tensors, n_chunks, bc, ws, acc, h, p_dtype, g_dtype,
             m_dtype, v_dtype, device, stream);
}
