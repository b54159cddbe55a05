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
//   (b) gate_up: a tile of n w_gate^T and of n w_up^T from the same staged
//       tile of n, two f32 accumulators, epilogue y = T(T(act(g)) T(u));
//   (c) down: a tile of y w_down^T, epilogue out = T(h + T(acc)).
// The products are gemm.cuh's mainloops. bf16 and fp16: the warp-specialised,
// persistent TMA + wgmma mainloop; gate/up on 128 x 128 tiles of each of the
// two products (a 48 KB stage: n, w_gate and w_up slabs; 4 stages), down on
// 128 x 256 tiles (48 KB stages, 4 deep; 128 x 128 where the wide tiles are
// fewer than the SMs), both operands K-major. float32:
// the cp.async + FMA mainloop, 128 x 64 and 128 x 128 tiles. The epilogues
// are one function each, shared by both.
#include "mlp_subblock.cuh"

namespace {

using namespace tt;
using namespace tt::mlp;
using gemm::KMAJ;
namespace wg = tt::gemm::wg;

// (a) h and n, one block per row
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_fwd_rows(const T* __restrict__ residual, const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ h, T* __restrict__ n, int D, float eps) {
  norm_row(residual, x, w, h, n, nullptr, D, eps);
}

// the epilogues: thread-owned pairs of the tile at (row0, col0) (gemm.cuh's
// accumulator layout)
template <typename T, int MT, int NT>
__device__ __forceinline__ void gate_up_epilogue(const float (&ag)[MT][NT][4],
                                                 const float (&au)[MT][NT][4], int row0,
                                                 int col0, T* __restrict__ y, int N, int F,
                                                 int act) {
  with_act(act, [&](auto a) {
    constexpr int ACT = decltype(a)::value;
    gemm::for_each_pair<MT, NT>(row0, col0, N, F, [&](int mt, int nt, int h, int row, int col) {
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float ga = round_as<T>(act_fn<ACT>(ag[mt][nt][2 * h + j]));
        v[j] = ga * round_as<T>(au[mt][nt][2 * h + j]);
      }
      gemm::store_pair(y + static_cast<long long>(row) * F + col, v[0], v[1]);
    });
  });
}

template <typename T, int MT, int NT>
__device__ __forceinline__ void down_epilogue(const float (&acc)[MT][NT][4], int row0, int col0,
                                              const T* __restrict__ h, T* __restrict__ out,
                                              int N, int D) {
  gemm::for_each_pair<MT, NT>(row0, col0, N, D, [&](int mt, int nt, int hh, int row, int col) {
    const long long o = static_cast<long long>(row) * D + col;
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      v[j] = to_f(h[o + j]) + round_as<T>(acc[mt][nt][2 * hh + j]);
    gemm::store_pair(out + o, v[0], v[1]);
  });
}

// ---------------------------------------------------------------------------
// float32: the cp.async + FMA mainloop
// ---------------------------------------------------------------------------

// (b) y = act(n w_gate^T) * (n w_up^T) for a 128 x 64 tile of (N, F)
__global__ void __launch_bounds__(THREADS)
mlp_fwd_gate_up_f32(const float* __restrict__ n, const float* __restrict__ wg,
                    const float* __restrict__ wu, float* __restrict__ y, int N, int D, int F,
                    int act) {
  using T = float;
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
  gate_up_epilogue<T>(ag, au, m0 + wm, n0 + wn, y, N, F, act);
}

// (c) out = h + y w_down^T for a 128 x 128 tile of (N, D)
__global__ void __launch_bounds__(THREADS)
mlp_fwd_down_f32(const float* __restrict__ y, const float* __restrict__ wd,
                 const float* __restrict__ h, float* __restrict__ out, int N, int D, int F) {
  using T = float;
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
  down_epilogue<T>(acc, m0 + wm, n0 + wn, h, out, N, D);
}

// ---------------------------------------------------------------------------
// bf16 / fp16: the TMA + wgmma mainloop (gemm::wg)
// ---------------------------------------------------------------------------

constexpr int GU_BN = 128, GU_STAGES = 4;   // gate/up: 128 x 128 tiles of both products
constexpr int GU_STAGE = wg::slab_bytes<wg::BM>() + 2 * wg::slab_bytes<GU_BN>();
// down: 128 x 256 tiles (48 KB stages, 4 deep), or 128 x 128 (32 KB, 6 deep)
// where the wide tiles would not give every SM one (the 512-row prefill chunk:
// 64 wide tiles for 132 SMs)
template <int BN>
struct Down {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int STAGE = wg::slab_bytes<wg::BM>() + wg::slab_bytes<BN>();
  static constexpr int SMEM = wg::Ring<STAGES, STAGE>::BYTES;
};

// (b) for 16-bit T: n (N, D), w_gate and w_up (F, D), all K-major
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
mlp_fwd_gate_up_wg(const __grid_constant__ CUtensorMap map_n,
                   const __grid_constant__ CUtensorMap map_wg,
                   const __grid_constant__ CUtensorMap map_wu, T* __restrict__ y, int N, int D,
                   int F, int act) {
  constexpr int SA = wg::slab_bytes<wg::BM>(), SB = wg::slab_bytes<GU_BN>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_m = tiles(N, wg::BM), tiles_n = tiles(F, GU_BN);
  wg::Acc<GU_BN> ag, au;
  wg::persistent<GU_STAGES, GU_STAGE>(
      smem_raw, tiles_m * tiles_n, tiles(D, wg::BK),
      [&](int tile, int s, uint32_t st, uint32_t bar) {
        int tm, tn;
        gemm::tile_of<GROUP>(tile, tiles_m, tiles_n, tm, tn);
        const int k0 = s * wg::BK;
        wg::load_slab<KMAJ, wg::BM>(st, &map_n, bar, tm * wg::BM, k0);
        wg::load_slab<KMAJ, GU_BN>(st + SA, &map_wg, bar, tn * GU_BN, k0);
        wg::load_slab<KMAJ, GU_BN>(st + SA + SB, &map_wu, bar, tn * GU_BN, k0);
      },
      [&] {
        gemm::zero(ag);
        gemm::zero(au);
      },
      [&](uint32_t st, int c) {
        wg::mma<T, KMAJ, KMAJ, GU_BN>(ag, st, st + SA, c);
        wg::mma<T, KMAJ, KMAJ, GU_BN>(au, st, st + SA + SB, c);
      },
      [&](int tile, int c) {
        wg::fence<GU_BN>(ag);
        wg::fence<GU_BN>(au);
        int tm, tn;
        gemm::tile_of<GROUP>(tile, tiles_m, tiles_n, tm, tn);
        gate_up_epilogue<T>(ag, au, wg::row0(tm, c), tn * GU_BN, y, N, F, act);
      });
}

// (c) for 16-bit T: y (N, F), w_down (D, F), both K-major; DN_BN-wide tiles
template <typename T, int DN_BN>
__global__ void __launch_bounds__(wg::THREADS, 1)
mlp_fwd_down_wg(const __grid_constant__ CUtensorMap map_y,
                const __grid_constant__ CUtensorMap map_wd, const T* __restrict__ h,
                T* __restrict__ out, int N, int D, int F) {
  constexpr int SA = wg::slab_bytes<wg::BM>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_m = tiles(N, wg::BM), tiles_n = tiles(D, DN_BN);
  wg::Acc<DN_BN> acc;
  wg::persistent<Down<DN_BN>::STAGES, Down<DN_BN>::STAGE>(
      smem_raw, tiles_m * tiles_n, tiles(F, wg::BK),
      [&](int tile, int s, uint32_t st, uint32_t bar) {
        int tm, tn;
        gemm::tile_of<GROUP>(tile, tiles_m, tiles_n, tm, tn);
        wg::load_slab<KMAJ, wg::BM>(st, &map_y, bar, tm * wg::BM, s * wg::BK);
        wg::load_slab<KMAJ, DN_BN>(st + SA, &map_wd, bar, tn * DN_BN, s * wg::BK);
      },
      [&] { gemm::zero(acc); },
      [&](uint32_t st, int c) { wg::mma<T, KMAJ, KMAJ, DN_BN>(acc, st, st + SA, c); },
      [&](int tile, int c) {
        wg::fence<DN_BN>(acc);
        int tm, tn;
        gemm::tile_of<GROUP>(tile, tiles_m, tiles_n, tm, tn);
        down_epilogue<T>(acc, wg::row0(tm, c), tn * DN_BN, h, out, N, D);
      });
}

template <typename T, int DN_BN>
cudaError_t launch_down(const T* y, const T* w_down, const T* h, T* out, int N, int D, int F,
                        cudaStream_t s) {
  CUtensorMap my, md;
  if (!wg::op_map<T, KMAJ, wg::BM>(&my, y, N, F, F) ||
      !wg::op_map<T, KMAJ, DN_BN>(&md, w_down, D, F, F))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(mlp_fwd_down_wg<T, DN_BN>, Down<DN_BN>::SMEM);
  if (err != cudaSuccess) return err;
  const int n_tiles = tiles(N, wg::BM) * tiles(D, DN_BN);
  mlp_fwd_down_wg<T, DN_BN><<<wg::grid_for(n_tiles), wg::THREADS, Down<DN_BN>::SMEM, s>>>(
      my, md, h, out, N, D, F);
  return cudaSuccess;
}

template <typename T>
cudaError_t run_wg(const T* n, const T* w_gate, const T* w_up, const T* w_down, const T* h,
                   T* y, T* out, int N, int D, int F, int act, cudaStream_t s) {
  using gemm::wg::op_map;
  CUtensorMap mn, mg, mu;
  if (!op_map<T, KMAJ, wg::BM>(&mn, n, N, D, D) || !op_map<T, KMAJ, GU_BN>(&mg, w_gate, F, D, D) ||
      !op_map<T, KMAJ, GU_BN>(&mu, w_up, F, D, D))
    return cudaErrorInvalidValue;
  constexpr int smem_gu = wg::Ring<GU_STAGES, GU_STAGE>::BYTES;
  const cudaError_t err = allow_smem(mlp_fwd_gate_up_wg<T>, smem_gu);
  if (err != cudaSuccess) return err;
  const int t_gu = tiles(N, wg::BM) * tiles(F, GU_BN);
  mlp_fwd_gate_up_wg<T><<<wg::grid_for(t_gu), wg::THREADS, smem_gu, s>>>(mn, mg, mu, y, N, D, F,
                                                                         act);
  return tiles(N, wg::BM) * tiles(D, 256) >= wg::sm_count()
             ? launch_down<T, 256>(y, w_down, h, out, N, D, F, s)
             : launch_down<T, 128>(y, w_down, h, out, N, D, F, s);
}

cudaError_t run_f32(const float* n, const float* w_gate, const float* w_up, const float* w_down,
                    const float* h, float* y, float* out, int N, int D, int F, int act,
                    cudaStream_t s) {
  using T = float;
  constexpr int S = Cfg<T>::STAGES, BK = Cfg<T>::BK;
  const int smem_gu = S * (gemm::Tile<T, KMAJ, 128, BK>::SIZE +
                           2 * gemm::Tile<T, KMAJ, 64, BK>::SIZE) * static_cast<int>(sizeof(T));
  const int smem_dn = S * 2 * gemm::Tile<T, KMAJ, 128, BK>::SIZE * static_cast<int>(sizeof(T));
  cudaError_t err = allow_smem(mlp_fwd_gate_up_f32, smem_gu);
  if (err == cudaSuccess) err = allow_smem(mlp_fwd_down_f32, smem_dn);
  if (err != cudaSuccess) return err;
  mlp_fwd_gate_up_f32<<<tiles(N, 128) * tiles(F, 64), THREADS, smem_gu, s>>>(n, w_gate, w_up, y,
                                                                            N, D, F, act);
  mlp_fwd_down_f32<<<tiles(N, 128) * tiles(D, 128), THREADS, smem_dn, s>>>(y, w_down, h, out, N,
                                                                          D, F);
  return cudaSuccess;
}

template <typename T>
cudaError_t run(const void* residual, const void* x, const void* w_norm, const void* w_gate,
                const void* w_up, const void* w_down, void* h, void* n, void* y, void* out,
                int N, int D, int F, int act, float eps, cudaStream_t s) {
  mlp_fwd_rows<T><<<N, THREADS, 0, s>>>(static_cast<const T*>(residual), static_cast<const T*>(x),
                                        static_cast<const T*>(w_norm), static_cast<T*>(h),
                                        static_cast<T*>(n), D, eps);
  const T *np = static_cast<const T*>(n), *wg_ = static_cast<const T*>(w_gate),
          *wu_ = static_cast<const T*>(w_up), *wd_ = static_cast<const T*>(w_down),
          *hp = static_cast<const T*>(h);
  if constexpr (is_16bit<T>())
    return run_wg<T>(np, wg_, wu_, wd_, hp, static_cast<T*>(y), static_cast<T*>(out), N, D, F,
                     act, s);
  else
    return run_f32(np, wg_, wu_, wd_, hp, static_cast<T*>(y), static_cast<T*>(out), N, D, F, act,
                   s);
}

}  // namespace

// dtype: 0 float32 (the FMA mainloop), 1 bf16 or 2 fp16 (wgmma)
extern "C" int tt_mlp_subblock(const void* residual, const void* x, const void* w_norm,
                               const void* w_gate, const void* w_up, const void* w_down, void* h,
                               void* n, void* y, void* out, int N, int D, int F, int act,
                               float eps, int dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tt::with_dtype(dtype, [&](auto tag) {
    return run<decltype(tag)>(residual, x, w_norm, w_gate, w_up, w_down, h, n, y, out, N, D, F,
                              act, eps, s);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
