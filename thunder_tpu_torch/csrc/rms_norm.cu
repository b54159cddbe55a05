// Row RMS norm: y = (x * rsqrt(mean(x^2) + eps)).to(T) * w, statistics in f32.
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_rms_norm (:738), whose
// body is _rms_kernel (:728). Rounding follows it: the normalised row is
// rounded to the storage type before the weight multiply, and the product is
// rounded again.
//
// Bound on an H100: bytes. A row of D values is read once and written once;
// the work is ~4 operations per value, far below the 295 operations per byte
// where the tensor cores would become the limit. At the decode shape (8 rows
// of 4096 bf16) the whole input is 64 KB, so one launch costs its launch
// latency, not its bytes.
//
// Two designs, chosen by the wrapper (cudaex.rms_norm_design) from the dtype
// and D alone and passed in as `design`:
//
// 1 vector (every row starts on 16 bytes, D a multiple of 16 bytes' worth of
//   values, and the row fits the registers: at most 4096 16-byte accesses).
//   The block is sized to the row, so no thread loops: a thread loads V
//   16-byte vectors of x (8 bf16/fp16 or 4 f32 values each; V = 1, 2, 4 or
//   8, the fewest that keep a row within 512 threads) and keeps them in
//   registers, so the sum of squares and the scaled output come from one
//   read of device memory. The weight is read as vectors of the same values,
//   the output written as vectors. Rows of at most 32 threads share a block
//   (256 threads) and reduce with warp shuffles alone; a longer row has a
//   block of its own and reduces with a warp shuffle plus one shared-memory
//   step. Neighbouring threads read neighbouring 16-byte vectors.
//
// 0 scalar (the rest: D off the 16-byte multiples, where row starts fall off
//   16 bytes, or rows longer than the registers hold): one 256-thread block
//   per row; threads stride the row one value at a time, and a second sweep
//   re-reads the row from L1/L2, where the first left it.
//
// Types: x in T (float32, bf16 or fp16), the weight in W. With W == T the
// output is T. A weight of another dtype (x bf16 with w float32, and the
// like) is a template parameter rather than a promotion of x: the
// reference's decomposition rounds the normalised row to x's dtype and then
// multiplies by the weight in the promoted dtype (float32 for every mixed
// pair here, torch.promote_types), so the output is float32 and the rounding
// point is the one above; promoting x first would drop it.
#include "common.cuh"

namespace {

constexpr int VEC_THREADS = 512;   // most threads a row takes in the vector design
constexpr int VEC_BLOCK = 256;     // a block of rows of at most 32 threads each

// N values of T read or written as one access of N * sizeof(T) bytes (two
// 16-byte accesses for 32: the wrapper aligns every base to 16 bytes only)
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Vec {
  T v[N];
};

template <typename T, typename W, typename O>
__global__ void __launch_bounds__(256)
rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w, O* __restrict__ out, int D,
                float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  O* orow = out + row * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = tt::to_f(xr[i]);
    ss += v * v;
  }
  const float ms = tt::block_sum(ss, red) / static_cast<float>(D);
  const float inv = 1.f / sqrtf(ms + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float y = tt::round_as<T>(tt::to_f(xr[i]) * inv);
    if (w != nullptr) y *= tt::to_f(w[i]);
    orow[i] = tt::from_f<O>(y);
  }
}

// The vector design: `tpr` threads a row (a power of two up to 32, several
// rows a block; or a multiple of 32, the whole block), `active` of them
// holding V vectors of N values each, vector v of thread j at column
// (v * active + j) * N; nv = D / N vectors a row.
template <typename T, typename W, typename O, int V>
__global__ void __launch_bounds__(VEC_THREADS)
rms_norm_kernel_vector(const T* __restrict__ x, const W* __restrict__ w, O* __restrict__ out,
                       long long n_rows, int D, int tpr, int active, float eps) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float red[VEC_THREADS / 32];
  const int j = threadIdx.x % tpr;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < n_rows && j < active;
  const int nv = D / N;
  const T* xr = x + row * D;

  float xv[V][N];
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = v * active + j;
    if (live && c < nv) {
      const Vec<T, N> a = *reinterpret_cast<const Vec<T, N>*>(xr + c * N);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        xv[v][e] = tt::to_f(a.v[e]);
        ss += xv[v][e] * xv[v][e];
      }
    }
  }
  if (tpr <= 32) {
    for (int o = tpr / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  } else {
    ss = tt::warp_sum(ss);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) ss += red[i];
  }
  if (!live) return;
  const float inv = 1.f / sqrtf(ss / static_cast<float>(D) + eps);
  O* orow = out + row * D;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = v * active + j;
    if (c >= nv) continue;
    Vec<W, N> wv{};
    if (w != nullptr) wv = *reinterpret_cast<const Vec<W, N>*>(w + c * N);
    Vec<O, N> y;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float r = tt::round_as<T>(xv[v][e] * inv);
      if (w != nullptr) r *= tt::to_f(wv.v[e]);
      y.v[e] = tt::from_f<O>(r);
    }
    *reinterpret_cast<Vec<O, N>*>(orow + c * N) = y;
  }
}

template <typename T, typename W, typename O, int V>
void launch_vector(const void* x, const void* w, void* out, long long n_rows, int D, int active,
                   float eps, cudaStream_t s) {
  int tpr = active <= 32 ? 1 : (active + 31) / 32 * 32;
  if (active <= 32)
    while (tpr < active) tpr *= 2;
  const int per_block = tpr <= 32 ? VEC_BLOCK / tpr : 1;
  const unsigned blocks = static_cast<unsigned>((n_rows + per_block - 1) / per_block);
  rms_norm_kernel_vector<T, W, O, V><<<blocks, tpr * per_block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<O*>(out), n_rows, D, tpr,
      active, eps);
}

}  // namespace

// dtype: x's; w_dtype: the weight's (x's where there is no weight); the
// output is x's dtype where they agree, float32 where they differ. design:
// 0 scalar, 1 vector, as cudaex.rms_norm_design chooses; a design the row
// does not fit is refused.
extern "C" int tt_rms_norm(const void* x, const void* w, void* out, long long n_rows, int D,
                           float eps, int dtype, int w_dtype, int design, int device,
                           void* stream) {
  cudaSetDevice(device);
  if (design != 0 && design != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tt::with_dtype(dtype, [&](auto xt) {
    return tt::with_dtype(w_dtype, [&](auto wt) {
      using T = decltype(xt);
      using W = decltype(wt);
      using O = typename std::conditional<std::is_same<T, W>::value, T, float>::type;
      if (design == 0) {
        rms_norm_kernel<T, W, O><<<static_cast<unsigned>(n_rows), 256, 0, s>>>(
            static_cast<const T*>(x), static_cast<const W*>(w), static_cast<O*>(out), D, eps);
        return cudaSuccess;
      }
      constexpr int N = 16 / sizeof(T);
      const int nv = D / N;
      if (D % N || nv <= 0 || nv > 8 * VEC_THREADS) return cudaErrorInvalidValue;
      // the fewest vectors a thread that keep the row within VEC_THREADS threads
      const int V = nv <= VEC_THREADS       ? 1
                    : nv <= 2 * VEC_THREADS ? 2
                    : nv <= 4 * VEC_THREADS ? 4
                                            : 8;
      const int active = (nv + V - 1) / V;
      switch (V) {
        case 1: launch_vector<T, W, O, 1>(x, w, out, n_rows, D, active, eps, s); break;
        case 2: launch_vector<T, W, O, 2>(x, w, out, n_rows, D, active, eps, s); break;
        case 4: launch_vector<T, W, O, 4>(x, w, out, n_rows, D, active, eps, s); break;
        default: launch_vector<T, W, O, 8>(x, w, out, n_rows, D, active, eps, s); break;
      }
      return cudaSuccess;
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
