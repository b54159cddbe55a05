// Fused residual add + RMS norm: h = r + x (rounded to T), y = rms_norm(h, w).
// Returns both: h is the residual stream, y feeds the next projection.
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_rms_norm_residual
// (:811), whose body is _rms_res_kernel (:800). As there, h is rounded to the
// storage type before the statistics, so the result equals an add kernel
// followed by the rms_norm kernel.
//
// Bound on an H100: bytes. Two rows are read and two written; the arithmetic
// is a few operations per value. At the decode shape (8 rows of 4096 bf16)
// the launch latency dominates.
//
// Design: one block per row. The first sweep computes and stores h and the
// sum of squares; the second re-reads h (each thread reads back exactly the
// values it wrote, so no barrier is needed for them) and writes y. The
// residual stream makes one trip through device memory instead of the two an
// unfused add + norm would cost.
// Types: residual and x in T (a residual and x of two dtypes are promoted to
// one by the wrapper, as the reference's add promotes them), the weight in W,
// the output as rms_norm.cu's: T where W == T, float32 where they differ.
#include "common.cuh"

namespace {

template <typename T, typename W, typename O>
__global__ void __launch_bounds__(256)
rms_norm_residual_kernel(const T* __restrict__ r, const T* __restrict__ x,
                         const W* __restrict__ w, T* __restrict__ h, O* __restrict__ out,
                         int D, float eps) {
  __shared__ float red[32];
  const size_t off = static_cast<size_t>(blockIdx.x) * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = tt::round_as<T>(tt::to_f(r[off + i]) + tt::to_f(x[off + i]));
    h[off + i] = tt::from_f<T>(v);
    ss += v * v;
  }
  const float ms = tt::block_sum(ss, red) / static_cast<float>(D);
  const float inv = 1.f / sqrtf(ms + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float y = tt::round_as<T>(tt::to_f(h[off + i]) * inv);
    if (w != nullptr) y *= tt::to_f(w[i]);
    out[off + i] = tt::from_f<O>(y);
  }
}

}  // namespace

extern "C" int tt_rms_norm_residual(const void* r, const void* x, const void* w, void* h,
                                    void* out, long long n_rows, int D, float eps, int dtype,
                                    int w_dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tt::with_dtype(dtype, [&](auto xt) {
    return tt::with_dtype(w_dtype, [&](auto wt) {
      using T = decltype(xt);
      using W = decltype(wt);
      using O = typename std::conditional<std::is_same<T, W>::value, T, float>::type;
      rms_norm_residual_kernel<T, W, O><<<static_cast<unsigned>(n_rows), 256, 0, s>>>(
          static_cast<const T*>(r), static_cast<const T*>(x), static_cast<const W*>(w),
          static_cast<T*>(h), static_cast<O*>(out), D, eps);
      return cudaSuccess;
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
