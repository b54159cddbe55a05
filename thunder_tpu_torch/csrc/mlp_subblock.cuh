// What the MLP sub-block's forward and backward kernels share: the
// activations of pallasex's _ACT_IMPLS (:867) and their derivatives
// (_act_grad_f32, :981), the row pass that forms h = residual + x and the
// normed rows n, and the block tile geometries.
#pragma once

#include <math.h>

#include "gemm.cuh"

namespace tt {
namespace mlp {

enum { ACT_RELU = 0, ACT_SILU = 1, ACT_GELU = 2, ACT_GELU_TANH = 3 };

constexpr float kSqrtHalf = 0.70710678118654752f;     // 1 / sqrt(2)
constexpr float kInvSqrt2Pi = 0.39894228040143268f;   // 1 / sqrt(2 pi)
constexpr float kTanhC = 0.79788456080286536f;        // sqrt(2 / pi)

// The activation as a compile-time choice: an epilogue takes it once per
// launch (with_act), so the per-element code has no branch on it and the
// compiler can interleave neighbouring elements' math.
template <int ACT>
__device__ __forceinline__ float act_fn(float y) {
  if constexpr (ACT == ACT_RELU) {
    return fmaxf(y, 0.f);
  } else if constexpr (ACT == ACT_SILU) {
    return y * (1.f / (1.f + expf(-y)));
  } else if constexpr (ACT == ACT_GELU) {
    return 0.5f * y * (1.f + erff(y * kSqrtHalf));
  } else {
    return 0.5f * y * (1.f + tanhf(kTanhC * (y + 0.044715f * y * y * y)));
  }
}

// d act(y) / dy, the closed forms of _act_grad_f32
template <int ACT>
__device__ __forceinline__ float act_grad(float y) {
  if constexpr (ACT == ACT_RELU) {
    return y > 0.f ? 1.f : 0.f;
  } else if constexpr (ACT == ACT_SILU) {
    const float sig = 1.f / (1.f + expf(-y));
    return sig * (1.f + y * (1.f - sig));
  } else if constexpr (ACT == ACT_GELU) {
    const float cdf = 0.5f * (1.f + erff(y * kSqrtHalf));
    const float pdf = expf(-0.5f * y * y) * kInvSqrt2Pi;
    return cdf + y * pdf;
  } else {
    const float u = kTanhC * (y + 0.044715f * y * y * y);
    const float th = tanhf(u);
    const float du = kTanhC * (1.f + 3.f * 0.044715f * y * y);
    return 0.5f * (1.f + th) + 0.5f * y * (1.f - th * th) * du;
  }
}

// f(std::integral_constant<int, ACT>) for the activation code act
template <class F>
__device__ __forceinline__ void with_act(int act, F&& f) {
  switch (act) {
    case ACT_RELU: f(std::integral_constant<int, ACT_RELU>()); break;
    case ACT_SILU: f(std::integral_constant<int, ACT_SILU>()); break;
    case ACT_GELU: f(std::integral_constant<int, ACT_GELU>()); break;
    default: f(std::integral_constant<int, ACT_GELU_TANH>()); break;
  }
}

// the activation chosen at run time, for code with one value per thread
__device__ __forceinline__ float act_fn(float y, int act) {
  switch (act) {
    case ACT_RELU: return act_fn<ACT_RELU>(y);
    case ACT_SILU: return act_fn<ACT_SILU>(y);
    case ACT_GELU: return act_fn<ACT_GELU>(y);
    default: return act_fn<ACT_GELU_TANH>(y);
  }
}

// The float32 mainloop's block tile geometries, 8 warps (256 threads) each
// (the 16-bit kernels' wgmma tiles are set in each kernel's source):
//   two or three products sharing their A rows (the gate/up and
//   recompute tiles): 128 x 64, warps 4 x 2, each a 32 x 32 sub-tile;
//   one product (down projection, dn, weight gradients): 128 x 128,
//   warps 2 x 4, each a 64 x 32 sub-tile.
// Each K slab is 32 deep, 2 slabs in the ring.
constexpr int THREADS = 256;
constexpr int GROUP = 16;   // tile rows per L2 group (gemm::tile_of)
template <typename T> struct Cfg;
template <> struct Cfg<float> { static constexpr int BK = 32, STAGES = 2; };

// Row pass of row blockIdx.x: h = residual + x rounded to T (the reference's add in the
// input dtype), rr = 1 / sqrt(mean(h^2) + eps) over the f32 row, and
// n = T(T(h * rr) * w_norm): the normalised row is rounded before the weight
// multiply, as _mlp_subblock_kernel and rms_norm do.
// h_out and rr_out may be null. The body of each kernel's row pass (the
// kernels are named apart, so a profile tells forward from backward).
template <typename T>
__device__ __forceinline__ void norm_row(const T* __restrict__ residual, const T* __restrict__ x,
                                         const T* __restrict__ w, T* __restrict__ h_out,
                                         T* __restrict__ n_out, float* __restrict__ rr_out, int D,
                                         float eps) {
  __shared__ float red[32];
  const long long off = static_cast<long long>(blockIdx.x) * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float h = round_as<T>(to_f(residual[off + i]) + to_f(x[off + i]));
    if (h_out != nullptr) h_out[off + i] = from_f<T>(h);
    ss += h * h;
  }
  const float rr = 1.f / sqrtf(block_sum(ss, red) / static_cast<float>(D) + eps);
  if (rr_out != nullptr && threadIdx.x == 0) rr_out[blockIdx.x] = rr;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float h = round_as<T>(to_f(residual[off + i]) + to_f(x[off + i]));
    n_out[off + i] = from_f<T>(round_as<T>(h * rr) * to_f(w[i]));
  }
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

__host__ __device__ __forceinline__ int tiles(int n, int t) { return (n + t - 1) / t; }

}  // namespace mlp
}  // namespace tt
