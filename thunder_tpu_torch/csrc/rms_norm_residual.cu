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
// Two designs, chosen by the wrapper (cudaex.rms_norm_residual_design, the
// rule of rms_norm's) from the dtype and D alone and passed in as `design`:
//
// 1 vector (every row starts on 16 bytes, D a multiple of 16 bytes' worth of
//   values, and the row fits the registers: at most 4096 16-byte accesses).
//   rms_row.cuh's row routine, the one rms_norm's vector design runs: a
//   thread loads V 16-byte vectors of r and of x, forms h in registers and
//   stores it as 16-byte vectors, and the sum of squares and y come from
//   those registers. Each row of r and x is read once and each of h and y
//   written once; no sweep reads h back. The block is sized to the row;
//   short rows share a block and reduce with warp shuffles.
//
// 0 scalar (the rest: D off the 16-byte multiples, or rows longer than the
//   registers hold): one 256-thread block per row. The first sweep computes
//   and stores h and the sum of squares; the second re-reads h (each thread
//   reads back exactly the values it wrote, so no barrier is needed for
//   them) and writes y.
//
// Types: residual and x in T (a residual and x of two dtypes are promoted to
// one by the wrapper, as the reference's add promotes them), the weight in W,
// the output as rms_norm.cu's: T where W == T, float32 where they differ.
#include "rms_row.cuh"

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

// the vector design: rowvec::norm_row over h = r + x
template <typename T, typename W, typename O, int V>
__global__ void __launch_bounds__(rowvec::THREADS)
rms_norm_residual_kernel_vector(const T* __restrict__ r, const T* __restrict__ x,
                                const W* __restrict__ w, T* __restrict__ h,
                                O* __restrict__ out, long long n_rows, int D, int tpr,
                                int active, float eps) {
  __shared__ double red[rowvec::THREADS / 32];
  rowvec::norm_row<T, W, O, V, true>(r, x, w, h, out, n_rows, D, tpr, active, eps, red);
}

}  // namespace

// dtype: residual's and x's; w_dtype: the weight's (x's where there is no
// weight); design: 0 scalar, 1 vector, as cudaex.rms_norm_residual_design
// chooses; a design the row does not fit is refused.
extern "C" int tt_rms_norm_residual(const void* r, const void* x, const void* w, void* h,
                                    void* out, long long n_rows, int D, float eps, int dtype,
                                    int w_dtype, int design, int device, void* stream) {
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
        rms_norm_residual_kernel<T, W, O><<<static_cast<unsigned>(n_rows), 256, 0, s>>>(
            static_cast<const T*>(r), static_cast<const T*>(x), static_cast<const W*>(w),
            static_cast<T*>(h), static_cast<O*>(out), D, eps);
        return cudaSuccess;
      }
      const rowvec::Geometry g = rowvec::geometry(n_rows, D, sizeof(T));
      if (!g.fits) return cudaErrorInvalidValue;
      rowvec::with_vectors(g.V, [&](auto v) {
        rms_norm_residual_kernel_vector<T, W, O, decltype(v)::value>
            <<<g.blocks, g.tpr * g.per_block, 0, s>>>(
                static_cast<const T*>(r), static_cast<const T*>(x), static_cast<const W*>(w),
                static_cast<T*>(h), static_cast<O*>(out), n_rows, D, g.tpr, g.active, eps);
      });
      return cudaSuccess;
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
