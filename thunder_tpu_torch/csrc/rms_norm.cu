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
//   One read of the row into registers in 16-byte accesses, a block sized to
//   the row, several short rows a block: rms_row.cuh's row routine, which
//   rms_norm_residual.cu's vector design shares.
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
#include "rms_row.cuh"

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

// the vector design: rowvec::norm_row over x
template <typename T, typename W, typename O, int V>
__global__ void __launch_bounds__(rowvec::THREADS)
rms_norm_kernel_vector(const T* __restrict__ x, const W* __restrict__ w, O* __restrict__ out,
                       long long n_rows, int D, int tpr, int active, float eps) {
  __shared__ double red[rowvec::THREADS / 32];
  rowvec::norm_row<T, W, O, V, false>(nullptr, x, w, nullptr, out, n_rows, D, tpr, active, eps,
                                      red);
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
      const rowvec::Geometry g = rowvec::geometry(n_rows, D, sizeof(T));
      if (!g.fits) return cudaErrorInvalidValue;
      rowvec::with_vectors(g.V, [&](auto v) {
        rms_norm_kernel_vector<T, W, O, decltype(v)::value><<<g.blocks, g.tpr * g.per_block, 0,
                                                               s>>>(
            static_cast<const T*>(x), static_cast<const W*>(w), static_cast<O*>(out), n_rows, D,
            g.tpr, g.active, eps);
      });
      return cudaSuccess;
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
