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
// Design: one block per row, so the row's sum of squares is a block
// reduction with no second pass over device memory; the second sweep re-reads
// the row from L1/L2, where the first sweep left it. Threads stride the row,
// so neighbouring threads read neighbouring addresses.
// Types: x in T (float32, bf16 or fp16), the weight in W. With W == T the
// output is T. A weight of another dtype (x bf16 with w float32, and the
// like) is a template parameter rather than a promotion of x: the
// reference's decomposition rounds the normalised row to x's dtype and then
// multiplies by the weight in the promoted dtype (float32 for every mixed
// pair here, torch.promote_types), so the output is float32 and the rounding
// point is the one above; promoting x first would drop it.
#include "common.cuh"

namespace {

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

}  // namespace

// dtype: x's; w_dtype: the weight's (x's where there is no weight); the
// output is x's dtype where they agree, float32 where they differ
extern "C" int tt_rms_norm(const void* x, const void* w, void* out, long long n_rows, int D,
                           float eps, int dtype, int w_dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tt::with_dtype(dtype, [&](auto xt) {
    return tt::with_dtype(w_dtype, [&](auto wt) {
      using T = decltype(xt);
      using W = decltype(wt);
      using O = typename std::conditional<std::is_same<T, W>::value, T, float>::type;
      rms_norm_kernel<T, W, O><<<static_cast<unsigned>(n_rows), 256, 0, s>>>(
          static_cast<const T*>(x), static_cast<const W*>(w), static_cast<O*>(out), D, eps);
      return cudaSuccess;
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
