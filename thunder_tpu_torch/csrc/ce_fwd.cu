// Fused cross-entropy forward: per-row lse = logsumexp(logits) and
// nll = lse - logits[target], with nll = 0 (and lse still written) where
// target == ignore_index.
//
// logits (N, V) f32 or bf16, contiguous; target (N,) int64; nll and lse
// (N,) f32. A target outside [0, V) that is not ignore_index gives nll NaN.
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_ce_fwd (:686), whose
// body is _ce_kernel (:671). The TPU stages a (bn, V) tile of rows in VMEM;
// a Hopper block has no room for that and needs none.
//
// Bound on an H100: bytes. Each logit is read once (N * V * 4 bytes: 2.10 GB
// at the train path's 16384 x 32000 f32, 0.626 ms at 3.35 TB/s) against ~4
// operations per logit.
//
// Design: one block of 256 threads per row and a single pass over it. Each
// thread walks the row with 16-byte loads (4 values per load) and keeps a
// running max and a running sum of exp(x - max), rescaling the sum when the
// max grows; one block reduction combines the 256 (max, sum) pairs. The
// target logit is read directly. Rows whose length or base is not a multiple
// of 4 values take scalar loads.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else if (x != -INFINITY) {   // a -inf logit adds 0 (and -inf - -inf is NaN)
    s += expf(x - m);
  }
}

template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using type = float4;
  __device__ static void unpack(const float4& v, float (&x)[4]) {
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <typename T> struct Vec4_16 {   // bf16 or fp16
  using type = uint2;
  __device__ static void unpack(const uint2& v, float (&x)[4]) {
    const T* h = reinterpret_cast<const T*>(&v);
    for (int i = 0; i < 4; ++i) x[i] = tt::to_f(h[i]);
  }
};
template <> struct Vec4<__nv_bfloat16> : Vec4_16<__nv_bfloat16> {};
template <> struct Vec4<__half> : Vec4_16<__half> {};

template <typename T>
__global__ void __launch_bounds__(THREADS)
ce_fwd_kernel(const T* __restrict__ logits, const long long* __restrict__ target,
              float* __restrict__ nll, float* __restrict__ lse, int V, long long ignore_index,
              int vec) {
  __shared__ float red_m[THREADS / 32], red_s[THREADS / 32];
  const size_t row = blockIdx.x;
  const T* x = logits + row * V;
  float m = -INFINITY, s = 0.f;
  if (vec) {
    using V4 = typename Vec4<T>::type;
    const V4* xv = reinterpret_cast<const V4*>(x);
    for (int i = threadIdx.x; i < V / 4; i += THREADS) {
      float f[4];
      Vec4<T>::unpack(xv[i], f);
#pragma unroll
      for (int j = 0; j < 4; ++j) online_add(m, s, f[j]);
    }
  } else {
    for (int i = threadIdx.x; i < V; i += THREADS) online_add(m, s, tt::to_f(x[i]));
  }
  // combine (m, s) pairs: within the warp, then across warps
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    const float mm = fmaxf(m, m2);
    s = (m == -INFINITY ? 0.f : s * expf(m - mm)) + (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mm));
    m = mm;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float M = red_m[0];
    for (int w = 1; w < THREADS / 32; ++w) M = fmaxf(M, red_m[w]);
    float Ssum = 0.f;
    for (int w = 0; w < THREADS / 32; ++w)
      if (red_m[w] != -INFINITY) Ssum += red_s[w] * expf(red_m[w] - M);
    const float l = M + logf(Ssum);
    const long long tg = target[row];
    float n = 0.f;
    if (tg != ignore_index) n = (tg >= 0 && tg < V) ? l - tt::to_f(x[tg]) : NAN;
    nll[row] = n;
    lse[row] = l;
  }
}

}  // namespace

extern "C" int tt_ce_fwd(const void* logits, const void* target, void* nll, void* lse,
                         long long N, int V, long long ignore_index, int dtype, int device,
                         void* stream) {
  cudaSetDevice(device);
  if (N > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    const auto* tg = static_cast<const long long*>(target);
    auto* n = static_cast<float*>(nll);
    auto* l = static_cast<float*>(lse);
    const unsigned blocks = static_cast<unsigned>(N);
    // 4 values per load: every row starts on a 4-value boundary when V % 4 == 0
    const int vec = reinterpret_cast<uintptr_t>(logits) % 16 == 0 && V % 4 == 0;
    const cudaError_t err = tt::with_dtype(dtype, [&](auto tag) {
      using T = decltype(tag);
      ce_fwd_kernel<T><<<blocks, THREADS, 0, s>>>(static_cast<const T*>(logits), tg, n, l, V,
                                                   ignore_index, vec);
      return cudaSuccess;
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
