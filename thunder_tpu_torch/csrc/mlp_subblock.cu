// The transformer MLP sub-block, forward:
//   h = residual + x;  n = rms_norm(h, w_norm)
//   out = h + (act(n w_gate^T) * (n w_up^T)) w_down^T
// residual, x, out (N, D); w_gate, w_up (F, D); w_down (D, F); w_norm (D,);
// all of one dtype, contiguous. h, n (N, D) and y (N, F) are scratch the
// wrapper allocates.
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_mlp_subblock (:1039),
// whose body is _mlp_subblock_kernel (:999). Rounding follows it: h in the
// input dtype; n = T(T(h * rsqrt(ms + eps)) * w_norm); ga = T(act(gate_f32)),
// u = T(up_f32), y = ga * u rounded to T; the down projection accumulated in
// f32 and rounded once before the residual add, out = T(h + T(down)).
//
// Bound on an H100: operations. At the train shape (N = 16384, D = 4096,
// F = 14336, bf16) the three products are 3 * 2 N D F = 5.77 TFLOP, 5.84 ms
// at 989 TFLOP/s; the bytes (residual, x, out and the three weights, ~0.75 GB)
// take 0.23 ms at 3.35 TB/s.
//
// Design: the TPU kernel keeps a (128, D) f32 accumulator and the row block's
// h and n in VMEM while it streams 128-wide ff blocks of the weights: 2 MB at
// D = 4096, where a block here has 227 KB of shared memory. So the interiors
// go through device memory once each (h and n: 2 N D bytes each; y: 2 N F),
// and every product runs tile by tile on chip:
//   (a) rows: one block per row writes h and n;
//   (b) gate_up: a 128 x 64 tile of n w_gate^T and of n w_up^T from the same
//       staged tile of n, two f32 accumulators, epilogue y = T(T(act(g)) T(u));
//   (c) down: a 128 x 128 tile of y w_down^T, epilogue out = T(h + T(acc)).
// The products are gemm.cuh's mainloop: a 3-deep cp.async ring of 64-deep
// slabs, ldmatrix fragments, mma.sync m16n8k16 (bf16 in, f32 accumulate),
// tiles visited 16 tile rows at a time so the blocks in flight share their
// operands in L2. No wgmma or TMA yet. float32 takes the same kernels with
// FMA products (a 2-deep ring of 32-deep slabs).
#include "mlp_subblock.cuh"

namespace {

using namespace tt;
using namespace tt::mlp;
using gemm::KMAJ;
using gemm::MNMAJ;

// (a) h and n, one block per row
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_fwd_rows(const T* __restrict__ residual, const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ h, T* __restrict__ n, int D, float eps) {
  norm_row(residual, x, w, h, n, nullptr, D, eps);
}

// (b) y = T(T(act(n w_gate^T)) * T(n w_up^T)) for a 128 x 64 tile of (N, F)
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_fwd_gate_up(const T* __restrict__ n, const T* __restrict__ wg, const T* __restrict__ wu,
                T* __restrict__ y, int N, int D, int F, int act) {
  constexpr int BM = 128, BN = 64, MT = 2, NT = 4, S = Cfg<T>::STAGES, BK = Cfg<T>::BK;
  using TA = gemm::Tile<T, KMAJ, BM, BK>;
  using TB = gemm::Tile<T, KMAJ, BN, BK>;
  constexpr int STAGE = TA::SIZE + 2 * TB::SIZE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  int tm, tn;
  gemm::tile_of<GROUP>(blockIdx.x, tiles(N, BM), tiles(F, BN), tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int warp = threadIdx.x >> 5, wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  float ag[MT][NT][4], au[MT][NT][4];
  gemm::zero(ag);
  gemm::zero(au);
  gemm::pipeline<S>(
      tiles(D, BK),
      [&](int b, int s) {
        T* st = smem + b * STAGE;
        const int k0 = s * BK;
        gemm::load_tile<T, KMAJ, BM, BK>(st, n, D, m0, N, k0, D);
        gemm::load_tile<T, KMAJ, BN, BK>(st + TA::SIZE, wg, D, n0, F, k0, D);
        gemm::load_tile<T, KMAJ, BN, BK>(st + TA::SIZE + TB::SIZE, wu, D, n0, F, k0, D);
      },
      [&](int b) {
        const T* st = smem + b * STAGE;
        gemm::mma_slab<KMAJ, KMAJ, BM, BN, BK>(ag, st, st + TA::SIZE, wm, wn);
        gemm::mma_slab<KMAJ, KMAJ, BM, BN, BK>(au, st, st + TA::SIZE + TB::SIZE, wm, wn);
      });

  gemm::for_each_pair<MT, NT>(m0 + wm, n0 + wn, N, F, [&](int mt, int nt, int h, int row, int col) {
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float ga = round_as<T>(act_fn(ag[mt][nt][2 * h + j], act));
      v[j] = ga * round_as<T>(au[mt][nt][2 * h + j]);
    }
    gemm::store_pair(y + static_cast<long long>(row) * F + col, v[0], v[1]);
  });
}

// (c) out = T(h + T(y w_down^T)) for a 128 x 128 tile of (N, D)
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_fwd_down(const T* __restrict__ y, const T* __restrict__ wd, const T* __restrict__ h,
             T* __restrict__ out, int N, int D, int F) {
  constexpr int BM = 128, BN = 128, MT = 4, NT = 4, S = Cfg<T>::STAGES, BK = Cfg<T>::BK;
  using TA = gemm::Tile<T, KMAJ, BM, BK>;
  using TB = gemm::Tile<T, KMAJ, BN, BK>;
  constexpr int STAGE = TA::SIZE + TB::SIZE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  int tm, tn;
  gemm::tile_of<GROUP>(blockIdx.x, tiles(N, BM), tiles(D, BN), tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int warp = threadIdx.x >> 5, wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  float acc[MT][NT][4];
  gemm::zero(acc);
  gemm::pipeline<S>(
      tiles(F, BK),
      [&](int b, int s) {
        T* st = smem + b * STAGE;
        gemm::load_tile<T, KMAJ, BM, BK>(st, y, F, m0, N, s * BK, F);
        gemm::load_tile<T, KMAJ, BN, BK>(st + TA::SIZE, wd, F, n0, D, s * BK, F);
      },
      [&](int b) {
        const T* st = smem + b * STAGE;
        gemm::mma_slab<KMAJ, KMAJ, BM, BN, BK>(acc, st, st + TA::SIZE, wm, wn);
      });

  gemm::for_each_pair<MT, NT>(m0 + wm, n0 + wn, N, D,
                              [&](int mt, int nt, int hh, int row, int col) {
    const long long o = static_cast<long long>(row) * D + col;
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      v[j] = to_f(h[o + j]) + round_as<T>(acc[mt][nt][2 * hh + j]);
    gemm::store_pair(out + o, v[0], v[1]);
  });
}

template <typename T>
cudaError_t run(const void* residual, const void* x, const void* w_norm, const void* w_gate,
                const void* w_up, const void* w_down, void* h, void* n, void* y, void* out,
                int N, int D, int F, int act, float eps, cudaStream_t s) {
  constexpr int S = Cfg<T>::STAGES, BK = Cfg<T>::BK;
  const int smem_gu = S * (gemm::Tile<T, KMAJ, 128, BK>::SIZE +
                           2 * gemm::Tile<T, KMAJ, 64, BK>::SIZE) * static_cast<int>(sizeof(T));
  const int smem_dn = S * 2 * gemm::Tile<T, KMAJ, 128, BK>::SIZE * static_cast<int>(sizeof(T));
  cudaError_t err = allow_smem(mlp_fwd_gate_up<T>, smem_gu);
  if (err == cudaSuccess) err = allow_smem(mlp_fwd_down<T>, smem_dn);
  if (err != cudaSuccess) return err;
  const T* hp = static_cast<const T*>(h);
  const T* np = static_cast<const T*>(n);
  mlp_fwd_rows<T><<<N, THREADS, 0, s>>>(static_cast<const T*>(residual), static_cast<const T*>(x),
                                        static_cast<const T*>(w_norm), static_cast<T*>(h),
                                        static_cast<T*>(n), D, eps);
  mlp_fwd_gate_up<T><<<tiles(N, 128) * tiles(F, 64), THREADS, smem_gu, s>>>(
      np, static_cast<const T*>(w_gate), static_cast<const T*>(w_up), static_cast<T*>(y), N, D,
      F, act);
  mlp_fwd_down<T><<<tiles(N, 128) * tiles(D, 128), THREADS, smem_dn, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(w_down), hp, static_cast<T*>(out), N, D, F);
  return cudaSuccess;
}

}  // namespace

extern "C" int tt_mlp_subblock(const void* residual, const void* x, const void* w_norm,
                               const void* w_gate, const void* w_up, const void* w_down, void* h,
                               void* n, void* y, void* out, int N, int D, int F, int act,
                               float eps, int dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == TT_BF16
          ? run<__nv_bfloat16>(residual, x, w_norm, w_gate, w_up, w_down, h, n, y, out, N, D, F,
                               act, eps, s)
          : run<float>(residual, x, w_norm, w_gate, w_up, w_down, h, n, y, out, N, D, F, act,
                       eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
