// The transformer MLP sub-block, backward from its saved inputs:
// (dh, dw_norm, dw_gate, dw_up, dw_down) of out = h + (act(n w_gate^T) *
// (n w_up^T)) w_down^T, h = residual + x, n = rms_norm(h, w_norm), for the
// output gradient g. dh is the gradient of both residual and x. g, residual,
// x, dh (N, D); w_gate, w_up, dw_gate, dw_up (F, D); w_down, dw_down (D, F);
// w_norm, dw_norm (D,); one dtype, contiguous. n (N, D), rr (N,) f32, dgpre,
// dup, y (N, F), dn (N, D) f32, the dw_norm partials (row blocks, D) f32 and,
// for 16-bit types, dy (N, F) f32 are scratch the wrapper allocates.
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_mlp_subblock_bwd
// (:1161), whose bodies are _mlp_subblock_bwd_dx_kernel (:1069) and
// _mlp_subblock_bwd_dw_kernel (:1118). Arithmetic follows them: the interiors
// are recomputed from the inputs; gpre, u and dy = g w_down stay f32;
// dup = T(dy act(gpre)), dgpre = T(dy u act'(gpre)), y = T(T(act(gpre)) T(u));
// dn = dgpre w_gate + dup w_up in f32; dh = T(g + rr (dn w - xhat
// mean(dn w xhat))); dw_norm = T(sum over rows of dn xhat); the weight
// gradients accumulate in f32 over every row and round once.
//
// Bound on an H100: operations. From the inputs alone the gradient needs
// eight N x D x F products (gate and up recomputed, dy, dn's two, the three
// weight gradients): 16 N D F = 15.39 TFLOP at the train shape (N = 16384,
// D = 4096, F = 14336), 15.56 ms at 989 TFLOP/s, against ~1.2 GB of inputs
// and outputs (0.37 ms). The TPU kernel does eleven: its weight pass
// recomputes gate, up and dy.
//
// Design: the TPU keeps a row block's dn (128 x D f32) in VMEM across its ff
// grid and carries the weight gradients across a sequential row grid. Blocks
// here run in no order and hold at most 227 KB, so each interior goes through
// device memory once and no product is computed twice:
//   (a) rows: n and rr = rsqrt(mean(h^2) + eps), one block per row;
//   (b) recompute: gpre = n w_gate^T, u = n w_up^T and dy = g w_down[:,
//       f-tile] for a tile of (N, F); the epilogue writes dgpre, dup and y
//       with the kernel's roundings;
//   (c) dn = dgpre w_gate + dup w_up, one product of depth 2F, written f32;
//   (d) dh: 64 rows per block, dh and the block's partial sums of
//       dn xhat; dwn_sum adds the partials in a fixed order, so dw_norm is
//       deterministic (no atomics);
//   (e) weights: dw_gate = dgpre^T n, dw_up = dup^T n, dw_down = g^T y, one
//       launch, 128 x 128 output tiles each summing over all N rows inside
//       the block (the loop takes the place of the TPU's row grid dimension).
// Every product is one of gemm.cuh's mainloops, reading each operand as
// stored or transposed, so no transposed copy is made. bf16 and fp16: the
// warp-specialised, persistent TMA + wgmma mainloop, every operand pair
// through the descriptors' transpose bits. There (b) is two launches: dy =
// g w_down first, as a product of its own on 128 x 256 tiles (A K-major, B
// MN-major) written f32 to device memory, then gpre and u on 128 x 128 tiles
// of both products (as the forward's gate/up tile), whose epilogue reads dy
// back. Three products in one tile fit only 128 x 64 tiles (a 56 KB stage),
// whose loads per operation are a third higher, and measured about 1.4x the
// two launches together (PERF.md §6); dy stays f32, so the roundings are
// the same. (c) on 128 x 256 tiles (A K-major, B MN-major), (e) on 128 x 256
// tiles with both operands MN-major (48 KB stages, 4 deep); the weight
// gradients still sum over all N rows inside the block, in a fixed order,
// so they are deterministic. float32: the cp.async + FMA mainloop, (b) in
// one three-product tile. The epilogues are one function each, shared by
// both.
// Transient memory at the train shape: dgpre, dup, y 470 MB each, dy 940 MB
// (16-bit types), dn 268 MB, n 134 MB.
#include "mlp_subblock.cuh"

namespace {

using namespace tt;
using namespace tt::mlp;
using gemm::KMAJ;
using gemm::MNMAJ;
namespace wg = tt::gemm::wg;

// The float32 three-product tile stages five operands in 32-deep slabs.
constexpr int RC_BK = 32;
constexpr int DH_ROWS = 64;   // rows per mlp_bwd_dh block (DH_ROWS in executors/cudaex.py)

// (a) n and rr, one block per row
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_rows(const T* __restrict__ residual, const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ n, float* __restrict__ rr, int D, float eps) {
  norm_row(residual, x, w, static_cast<T*>(nullptr), n, rr, D, eps);
}

// the epilogues: thread-owned pairs of the tile at (row0, col0) (gemm.cuh's
// accumulator layout)
// The recompute epilogue's arithmetic for one pair of neighbouring columns
// (gp, u, dy: the pair's f32 gpre, up and dy), stored at element o
template <typename T, int ACT>
__device__ __forceinline__ void recompute_pair(const float (&gp)[2], const float (&u)[2],
                                               float2 dy2, long long o, T* __restrict__ dgpre,
                                               T* __restrict__ dup, T* __restrict__ y) {
  float vg[2], vu[2], vy[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float dy = j ? dy2.y : dy2.x;
    const float ga = act_fn<ACT>(gp[j]);
    vu[j] = dy * ga;
    vg[j] = dy * u[j] * act_grad<ACT>(gp[j]);
    vy[j] = round_as<T>(ga) * round_as<T>(u[j]);
  }
  gemm::store_pair(dgpre + o, vg[0], vg[1]);
  gemm::store_pair(dup + o, vu[0], vu[1]);
  gemm::store_pair(y + o, vy[0], vy[1]);
}

// the float32 tile: dy is its third accumulator
template <int MT, int NT>
__device__ __forceinline__ void recompute_epilogue(const float (&agp)[MT][NT][4],
                                                   const float (&au)[MT][NT][4],
                                                   const float (&ady)[MT][NT][4], int row0,
                                                   int col0, float* __restrict__ dgpre,
                                                   float* __restrict__ dup, float* __restrict__ y,
                                                   int N, int F, int act) {
  with_act(act, [&](auto a) {
    constexpr int ACT = decltype(a)::value;
    gemm::for_each_pair<MT, NT>(row0, col0, N, F, [&](int mt, int nt, int h, int row, int col) {
      const float gp[2] = {agp[mt][nt][2 * h], agp[mt][nt][2 * h + 1]};
      const float u[2] = {au[mt][nt][2 * h], au[mt][nt][2 * h + 1]};
      recompute_pair<float, ACT>(gp, u, make_float2(ady[mt][nt][2 * h], ady[mt][nt][2 * h + 1]),
                                 static_cast<long long>(row) * F + col, dgpre, dup, y);
    });
  });
}

// the 16-bit tile (one consumer's 64 rows, MT = 1): dy read back from device
// memory, CH pairs' loads issued together ahead of their arithmetic, so the
// epilogue waits on one load latency per CH pairs rather than per pair
template <typename T, int NT>
__device__ __forceinline__ void recompute_epilogue_dy(const float (&agp)[1][NT][4],
                                                      const float (&au)[1][NT][4],
                                                      const float* __restrict__ dy, int row0,
                                                      int col0, T* __restrict__ dgpre,
                                                      T* __restrict__ dup, T* __restrict__ y,
                                                      int N, int F, int act) {
  constexpr int CH = 8;
  static_assert(NT % CH == 0, "whole chunks of pairs");
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  with_act(act, [&](auto a) {
    constexpr int ACT = decltype(a)::value;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row >= N) continue;
      const long long base = static_cast<long long>(row) * F;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += CH) {
        float2 d[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int col = col0 + (n0 + j) * 8 + 2 * t;
          d[j] = col < F ? __ldg(reinterpret_cast<const float2*>(dy + base + col))
                         : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int col = col0 + (n0 + j) * 8 + 2 * t;
          if (col >= F) continue;
          const float gp[2] = {agp[0][n0 + j][2 * h], agp[0][n0 + j][2 * h + 1]};
          const float u[2] = {au[0][n0 + j][2 * h], au[0][n0 + j][2 * h + 1]};
          recompute_pair<T, ACT>(gp, u, d[j], base + col, dgpre, dup, y);
        }
      }
    }
  });
}

template <int MT, int NT>
__device__ __forceinline__ void dn_epilogue(const float (&acc)[MT][NT][4], int row0, int col0,
                                            float* __restrict__ dn, int N, int D) {
  gemm::for_each_pair<MT, NT>(row0, col0, N, D, [&](int mt, int nt, int h, int row, int col) {
    gemm::store_pair(dn + static_cast<long long>(row) * D + col, acc[mt][nt][2 * h],
                     acc[mt][nt][2 * h + 1]);
  });
}

template <typename T, int MT, int NT>
__device__ __forceinline__ void weights_epilogue(const float (&acc)[MT][NT][4], int row0,
                                                 int col0, T* __restrict__ C, int M, int Nc) {
  gemm::for_each_pair<MT, NT>(row0, col0, M, Nc, [&](int mt, int nt, int h, int row, int col) {
    gemm::store_pair(C + static_cast<long long>(row) * Nc + col, acc[mt][nt][2 * h],
                     acc[mt][nt][2 * h + 1]);
  });
}

// ---------------------------------------------------------------------------
// float32: the cp.async + FMA mainloop
// ---------------------------------------------------------------------------

// (b) the recomputed interiors of a 128 x 64 tile of (N, F) and their
// gradients: dgpre, dup, y
__global__ void __launch_bounds__(THREADS)
mlp_bwd_recompute_f32(const float* __restrict__ n, const float* __restrict__ g,
                      const float* __restrict__ wg, const float* __restrict__ wu,
                      const float* __restrict__ wd, float* __restrict__ dgpre,
                      float* __restrict__ dup, float* __restrict__ y, int N, int D, int F,
                      int act) {
  using T = float;
  constexpr int BM = 128, BN = 64, MT = 2, NT = 4, S = Cfg<T>::STAGES, BK = RC_BK;
  using TA = gemm::Tile<T, KMAJ, BM, BK>;
  using TB = gemm::Tile<T, KMAJ, BN, BK>;
  using TD = gemm::Tile<T, MNMAJ, BN, BK>;
  constexpr int STAGE = 2 * TA::SIZE + 2 * TB::SIZE + TD::SIZE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  int tm, tn;
  gemm::tile_of<GROUP>(blockIdx.x, tiles(N, BM), tiles(F, BN), tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int warp = threadIdx.x >> 5, wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  float agp[MT][NT][4], au[MT][NT][4], ady[MT][NT][4];
  gemm::zero(agp);
  gemm::zero(au);
  gemm::zero(ady);
  gemm::pipeline<S>(
      tiles(D, BK),
      [&](int b, int s) {
        T* st = smem + b * STAGE;
        const int k0 = s * BK;
        gemm::load_tile<T, KMAJ, BM, BK>(st, n, D, m0, N, k0, D);
        gemm::load_tile<T, KMAJ, BM, BK>(st + TA::SIZE, g, D, m0, N, k0, D);
        gemm::load_tile<T, KMAJ, BN, BK>(st + 2 * TA::SIZE, wg, D, n0, F, k0, D);
        gemm::load_tile<T, KMAJ, BN, BK>(st + 2 * TA::SIZE + TB::SIZE, wu, D, n0, F, k0, D);
        // w_down (D, F) read as the (K = D, N = F) operand of g w_down
        gemm::load_tile<T, MNMAJ, BN, BK>(st + 2 * TA::SIZE + 2 * TB::SIZE, wd, F, n0, F, k0, D);
      },
      [&](int b) {
        const T* st = smem + b * STAGE;
        const T* bg = st + 2 * TA::SIZE;
        gemm::mma_slab<KMAJ, KMAJ, BM, BN, BK>(agp, st, bg, wm, wn);
        gemm::mma_slab<KMAJ, KMAJ, BM, BN, BK>(au, st, bg + TB::SIZE, wm, wn);
        gemm::mma_slab<KMAJ, MNMAJ, BM, BN, BK>(ady, st + TA::SIZE, bg + 2 * TB::SIZE, wm, wn);
      });
  recompute_epilogue(agp, au, ady, m0 + wm, n0 + wn, dgpre, dup, y, N, F, act);
}

// (c) dn = dgpre w_gate + dup w_up for a 128 x 128 tile of (N, D), f32
__global__ void __launch_bounds__(THREADS)
mlp_bwd_dn_f32(const float* __restrict__ dgpre, const float* __restrict__ dup,
               const float* __restrict__ wg, const float* __restrict__ wu,
               float* __restrict__ dn, int N, int D, int F) {
  using T = float;
  constexpr int BM = 128, BN = 128, MT = 4, NT = 4, S = Cfg<T>::STAGES, BK = Cfg<T>::BK;
  using TA = gemm::Tile<T, KMAJ, BM, BK>;
  using TB = gemm::Tile<T, MNMAJ, BN, BK>;
  constexpr int STAGE = TA::SIZE + TB::SIZE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  int tm, tn;
  gemm::tile_of<GROUP>(blockIdx.x, tiles(N, BM), tiles(D, BN), tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int warp = threadIdx.x >> 5, wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int half = tiles(F, BK);   // slabs [0, half) read (dgpre, w_gate), the rest (dup, w_up)

  float acc[MT][NT][4];
  gemm::zero(acc);
  gemm::pipeline<S>(
      2 * half,
      [&](int b, int s) {
        T* st = smem + b * STAGE;
        const bool first = s < half;
        const int k0 = (first ? s : s - half) * BK;
        gemm::load_tile<T, KMAJ, BM, BK>(st, first ? dgpre : dup, F, m0, N, k0, F);
        gemm::load_tile<T, MNMAJ, BN, BK>(st + TA::SIZE, first ? wg : wu, D, n0, D, k0, F);
      },
      [&](int b) {
        const T* st = smem + b * STAGE;
        gemm::mma_slab<KMAJ, MNMAJ, BM, BN, BK>(acc, st, st + TA::SIZE, wm, wn);
      });
  dn_epilogue(acc, m0 + wm, n0 + wn, dn, N, D);
}

// (d) dh = T(g + rr (dn w - xhat mean(dn w xhat))) for DH_ROWS rows, and the
// block's partial sums over those rows of dn xhat (xhat = h rr, f32). Each
// thread owns the columns it strides, so its share of the partials sits in
// shared memory without a race.
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_dh(const T* __restrict__ g, const T* __restrict__ residual, const T* __restrict__ x,
           const T* __restrict__ w, const float* __restrict__ rr, const float* __restrict__ dn,
           T* __restrict__ dh, float* __restrict__ dwn_part, int N, int D) {
  __shared__ float red[32];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw);
  for (int i = threadIdx.x; i < D; i += blockDim.x) part[i] = 0.f;
  const int r0 = static_cast<int>(blockIdx.x) * DH_ROWS, r_end = min(N, r0 + DH_ROWS);
  for (int row = r0; row < r_end; ++row) {
    const long long off = static_cast<long long>(row) * D;
    const float r = rr[row];
    float s = 0.f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float xhat = round_as<T>(to_f(residual[off + i]) + to_f(x[off + i])) * r;
      s += dn[off + i] * to_f(w[i]) * xhat;
    }
    const float proj = block_sum(s, red) / static_cast<float>(D);
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float xhat = round_as<T>(to_f(residual[off + i]) + to_f(x[off + i])) * r;
      const float d = dn[off + i];
      part[i] += d * xhat;
      dh[off + i] = from_f<T>(to_f(g[off + i]) + r * (d * to_f(w[i]) - xhat * proj));
    }
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    dwn_part[static_cast<long long>(blockIdx.x) * D + i] = part[i];
}

// dw_norm[d] = T(sum over row blocks of the partials), in block order
template <typename T>
__global__ void __launch_bounds__(256)
mlp_bwd_dwn_sum(const float* __restrict__ dwn_part, T* __restrict__ dwn, int blocks, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += dwn_part[static_cast<long long>(b) * D + d];
  dwn[d] = from_f<T>(s);
}

// (e) the weight gradients, blockIdx.y choosing one: C (M, Nc) = A^T B with
// A (N, M) and B (N, Nc) both stored row by row, summed over all N rows:
//   0: dw_gate = dgpre^T n;  1: dw_up = dup^T n;  2: dw_down = g^T y.
__global__ void __launch_bounds__(THREADS)
mlp_bwd_weights_f32(const float* __restrict__ dgpre, const float* __restrict__ dup,
                    const float* __restrict__ g, const float* __restrict__ n,
                    const float* __restrict__ y, float* __restrict__ dwg,
                    float* __restrict__ dwu, float* __restrict__ dwd, int N, int D, int F) {
  using T = float;
  constexpr int BM = 128, BN = 128, MT = 4, NT = 4, S = Cfg<T>::STAGES, BK = Cfg<T>::BK;
  using TA = gemm::Tile<T, MNMAJ, BM, BK>;
  using TB = gemm::Tile<T, MNMAJ, BN, BK>;
  constexpr int STAGE = TA::SIZE + TB::SIZE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int which = blockIdx.y;
  const T* A = which == 0 ? dgpre : which == 1 ? dup : g;
  const T* B = which == 2 ? y : n;
  T* C = which == 0 ? dwg : which == 1 ? dwu : dwd;
  const int M = which == 2 ? D : F, Nc = which == 2 ? F : D;

  int tm, tn;
  gemm::tile_of<GROUP>(blockIdx.x, tiles(M, BM), tiles(Nc, BN), tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int warp = threadIdx.x >> 5, wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  float acc[MT][NT][4];
  gemm::zero(acc);
  gemm::pipeline<S>(
      tiles(N, BK),
      [&](int b, int s) {
        T* st = smem + b * STAGE;
        gemm::load_tile<T, MNMAJ, BM, BK>(st, A, M, m0, M, s * BK, N);
        gemm::load_tile<T, MNMAJ, BN, BK>(st + TA::SIZE, B, Nc, n0, Nc, s * BK, N);
      },
      [&](int b) {
        const T* st = smem + b * STAGE;
        gemm::mma_slab<MNMAJ, MNMAJ, BM, BN, BK>(acc, st, st + TA::SIZE, wm, wn);
      });
  weights_epilogue<T>(acc, m0 + wm, n0 + wn, C, M, Nc);
}

// ---------------------------------------------------------------------------
// bf16 / fp16: the TMA + wgmma mainloop (gemm::wg)
// ---------------------------------------------------------------------------

constexpr int RC_BN = 128, RC_STAGES = 4;  // recompute: 128 x 128 tiles of gpre and u
constexpr int DN_BN = 256, DN_STAGES = 4;  // dy and dn: 128 x 256 tiles
constexpr int W_BN = 256, W_STAGES = 4;    // weight gradients: 128 x 256 tiles
constexpr int RC_SA = wg::slab_bytes<wg::BM>(), RC_SB = wg::slab_bytes<RC_BN>();
constexpr int RC_STAGE = RC_SA + 2 * RC_SB;
constexpr int DN_STAGE = wg::slab_bytes<wg::BM>() + wg::slab_bytes<DN_BN>();
constexpr int W_STAGE = wg::slab_bytes<wg::BM>() + wg::slab_bytes<W_BN>();

// (b) for 16-bit T, after dy: gpre = n w_gate^T and u = n w_up^T on a 128 x
// 128 tile of (N, F), n (N, D), w_gate and w_up (F, D) all K-major; the
// epilogue reads dy (N, F) f32 back
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
mlp_bwd_recompute_wg(const __grid_constant__ CUtensorMap map_n,
                     const __grid_constant__ CUtensorMap map_wg,
                     const __grid_constant__ CUtensorMap map_wu, const float* __restrict__ dy,
                     T* __restrict__ dgpre, T* __restrict__ dup, T* __restrict__ y, int N, int D,
                     int F, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_m = tiles(N, wg::BM), tiles_n = tiles(F, RC_BN);
  wg::Acc<RC_BN> agp, au;
  wg::persistent<RC_STAGES, RC_STAGE>(
      smem_raw, tiles_m * tiles_n, tiles(D, wg::BK),
      [&](int tile, int s, uint32_t st, uint32_t bar) {
        int tm, tn;
        gemm::tile_of<GROUP>(tile, tiles_m, tiles_n, tm, tn);
        const int k0 = s * wg::BK;
        wg::load_slab<KMAJ, wg::BM>(st, &map_n, bar, tm * wg::BM, k0);
        wg::load_slab<KMAJ, RC_BN>(st + RC_SA, &map_wg, bar, tn * RC_BN, k0);
        wg::load_slab<KMAJ, RC_BN>(st + RC_SA + RC_SB, &map_wu, bar, tn * RC_BN, k0);
      },
      [&] {
        gemm::zero(agp);
        gemm::zero(au);
      },
      [&](uint32_t st, int c) {
        wg::mma<T, KMAJ, KMAJ, RC_BN>(agp, st, st + RC_SA, c);
        wg::mma<T, KMAJ, KMAJ, RC_BN>(au, st, st + RC_SA + RC_SB, c);
      },
      [&](int tile, int c) {
        wg::fence<RC_BN>(agp);
        wg::fence<RC_BN>(au);
        int tm, tn;
        gemm::tile_of<GROUP>(tile, tiles_m, tiles_n, tm, tn);
        recompute_epilogue_dy<T>(agp, au, dy, wg::row0(tm, c), tn * RC_BN, dgpre, dup, y, N, F,
                                 act);
      });
}

// dy and (c) for 16-bit T: C (M, Nc) f32 = A0 B0 + A1 B1, A K-major, B
// MN-major (stored (K, Nc)), slabs [0, half) from (A0, B0) and [half,
// n_slabs) from (A1, B1):
//   dy = g w_down: A g (N, D), B w_down (D, F), one pair (half = n_slabs);
//   dn = dgpre w_gate + dup w_up: depth 2F, A (N, F), B (F, D).
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
mlp_bwd_f32_product_wg(const __grid_constant__ CUtensorMap map_a0,
                       const __grid_constant__ CUtensorMap map_a1,
                       const __grid_constant__ CUtensorMap map_b0,
                       const __grid_constant__ CUtensorMap map_b1, float* __restrict__ C, int M,
                       int Nc, int half, int n_slabs) {
  constexpr int SA = wg::slab_bytes<wg::BM>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_m = tiles(M, wg::BM), tiles_n = tiles(Nc, DN_BN);
  wg::Acc<DN_BN> acc;
  wg::persistent<DN_STAGES, DN_STAGE>(
      smem_raw, tiles_m * tiles_n, n_slabs,
      [&](int tile, int s, uint32_t st, uint32_t bar) {
        int tm, tn;
        gemm::tile_of<GROUP>(tile, tiles_m, tiles_n, tm, tn);
        const bool first = s < half;
        const int k0 = (first ? s : s - half) * wg::BK;
        wg::load_slab<KMAJ, wg::BM>(st, first ? &map_a0 : &map_a1, bar, tm * wg::BM, k0);
        wg::load_slab<MNMAJ, DN_BN>(st + SA, first ? &map_b0 : &map_b1, bar, tn * DN_BN, k0);
      },
      [&] { gemm::zero(acc); },
      [&](uint32_t st, int c) { wg::mma<T, KMAJ, MNMAJ, DN_BN>(acc, st, st + SA, c); },
      [&](int tile, int c) {
        wg::fence<DN_BN>(acc);
        int tm, tn;
        gemm::tile_of<GROUP>(tile, tiles_m, tiles_n, tm, tn);
        dn_epilogue(acc, wg::row0(tm, c), tn * DN_BN, C, M, Nc);
      });
}

// (e) for 16-bit T: the three weight gradients in one persistent launch,
// tiles [0, t01) dw_gate, [t01, 2 t01) dw_up, the rest dw_down; A and B both
// MN-major (stored (N, M) and (N, Nc)), summed over all N rows in the block
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
mlp_bwd_weights_wg(const __grid_constant__ CUtensorMap map_dg,
                   const __grid_constant__ CUtensorMap map_du,
                   const __grid_constant__ CUtensorMap map_g,
                   const __grid_constant__ CUtensorMap map_n,
                   const __grid_constant__ CUtensorMap map_y, T* __restrict__ dwg,
                   T* __restrict__ dwu, T* __restrict__ dwd, int N, int D, int F) {
  constexpr int SA = wg::slab_bytes<wg::BM>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tm01 = tiles(F, wg::BM), tn01 = tiles(D, W_BN), t01 = tm01 * tn01;
  const int tm2 = tiles(D, wg::BM), tn2 = tiles(F, W_BN);
  // the gradient of `tile`, and its tile row and column there
  const auto locate = [&](int tile, int& which, int& tm, int& tn) {
    which = tile < t01 ? 0 : tile < 2 * t01 ? 1 : 2;
    const int local = tile - which * t01;
    if (which < 2)
      gemm::tile_of<GROUP>(local, tm01, tn01, tm, tn);
    else
      gemm::tile_of<GROUP>(local, tm2, tn2, tm, tn);
  };
  wg::Acc<W_BN> acc;
  wg::persistent<W_STAGES, W_STAGE>(
      smem_raw, 2 * t01 + tm2 * tn2, tiles(N, wg::BK),
      [&](int tile, int s, uint32_t st, uint32_t bar) {
        int which, tm, tn;
        locate(tile, which, tm, tn);
        const CUtensorMap* a = which == 0 ? &map_dg : which == 1 ? &map_du : &map_g;
        const CUtensorMap* b = which == 2 ? &map_y : &map_n;
        wg::load_slab<MNMAJ, wg::BM>(st, a, bar, tm * wg::BM, s * wg::BK);
        wg::load_slab<MNMAJ, W_BN>(st + SA, b, bar, tn * W_BN, s * wg::BK);
      },
      [&] { gemm::zero(acc); },
      [&](uint32_t st, int c) { wg::mma<T, MNMAJ, MNMAJ, W_BN>(acc, st, st + SA, c); },
      [&](int tile, int c) {
        wg::fence<W_BN>(acc);
        int which, tm, tn;
        locate(tile, which, tm, tn);
        T* C = which == 0 ? dwg : which == 1 ? dwu : dwd;
        weights_epilogue<T>(acc, wg::row0(tm, c), tn * W_BN, C, which == 2 ? D : F,
                            which == 2 ? F : D);
      });
}

// the products (b), (c), (e) for 16-bit T
template <typename T>
cudaError_t products_wg(const T* G, const T* Wg, const T* Wu, const T* Wd, const T* Np, T* Dg,
                        T* Du, T* Y, float* DY, float* DN, T* dwg, T* dwu, T* dwd, int N, int D,
                        int F, int act, cudaStream_t s) {
  using gemm::wg::op_map;
  CUtensorMap mg, mwd, mn, mwg, mwu, mdg, mdu, mwg_t, mwu_t, mdg_t, mdu_t, mg_t, mn_t, my_t;
  const bool ok =
      // dy: rows of g; w_down read (K = D, N = F)
      op_map<T, KMAJ, wg::BM>(&mg, G, N, D, D) && op_map<T, MNMAJ, DN_BN>(&mwd, Wd, F, D, F) &&
      // (b): rows of n, rows of w_gate and w_up
      op_map<T, KMAJ, wg::BM>(&mn, Np, N, D, D) && op_map<T, KMAJ, RC_BN>(&mwg, Wg, F, D, D) &&
      op_map<T, KMAJ, RC_BN>(&mwu, Wu, F, D, D) &&
      // (c): rows of dgpre and dup; w_gate and w_up read (K = F, N = D)
      op_map<T, KMAJ, wg::BM>(&mdg, Dg, N, F, F) && op_map<T, KMAJ, wg::BM>(&mdu, Du, N, F, F) &&
      op_map<T, MNMAJ, DN_BN>(&mwg_t, Wg, D, F, D) &&
      op_map<T, MNMAJ, DN_BN>(&mwu_t, Wu, D, F, D) &&
      // (e): dgpre, dup, g as (K = N, M) operands; n and y as (K = N, Nc)
      op_map<T, MNMAJ, wg::BM>(&mdg_t, Dg, F, N, F) &&
      op_map<T, MNMAJ, wg::BM>(&mdu_t, Du, F, N, F) &&
      op_map<T, MNMAJ, wg::BM>(&mg_t, G, D, N, D) && op_map<T, MNMAJ, W_BN>(&mn_t, Np, D, N, D) &&
      op_map<T, MNMAJ, W_BN>(&my_t, Y, F, N, F);
  if (!ok) return cudaErrorInvalidValue;
  constexpr int smem_rc = wg::Ring<RC_STAGES, RC_STAGE>::BYTES;
  constexpr int smem_dn = wg::Ring<DN_STAGES, DN_STAGE>::BYTES;
  constexpr int smem_w = wg::Ring<W_STAGES, W_STAGE>::BYTES;
  cudaError_t err = allow_smem(mlp_bwd_recompute_wg<T>, smem_rc);
  if (err == cudaSuccess) err = allow_smem(mlp_bwd_f32_product_wg<T>, smem_dn);
  if (err == cudaSuccess) err = allow_smem(mlp_bwd_weights_wg<T>, smem_w);
  if (err != cudaSuccess) return err;
  const int t_dy = tiles(N, wg::BM) * tiles(F, DN_BN), t_rc = tiles(N, wg::BM) * tiles(F, RC_BN);
  const int t_dn = tiles(N, wg::BM) * tiles(D, DN_BN);
  const int t_w = 2 * tiles(F, wg::BM) * tiles(D, W_BN) + tiles(D, wg::BM) * tiles(F, W_BN);
  const int kd = tiles(D, wg::BK), kf = tiles(F, wg::BK);
  mlp_bwd_f32_product_wg<T><<<wg::grid_for(t_dy), wg::THREADS, smem_dn, s>>>(mg, mg, mwd, mwd, DY,
                                                                              N, F, kd, kd);
  mlp_bwd_recompute_wg<T><<<wg::grid_for(t_rc), wg::THREADS, smem_rc, s>>>(
      mn, mwg, mwu, DY, Dg, Du, Y, N, D, F, act);
  mlp_bwd_f32_product_wg<T><<<wg::grid_for(t_dn), wg::THREADS, smem_dn, s>>>(
      mdg, mdu, mwg_t, mwu_t, DN, N, D, kf, 2 * kf);
  mlp_bwd_weights_wg<T><<<wg::grid_for(t_w), wg::THREADS, smem_w, s>>>(
      mdg_t, mdu_t, mg_t, mn_t, my_t, dwg, dwu, dwd, N, D, F);
  return cudaSuccess;
}

// the products (b), (c), (e) in float32
cudaError_t products_f32(const float* G, const float* Wg, const float* Wu, const float* Wd,
                         const float* Np, float* Dg, float* Du, float* Y, float* DN, float* dwg,
                         float* dwu, float* dwd, int N, int D, int F, int act, cudaStream_t s) {
  using T = float;
  constexpr int S = Cfg<T>::STAGES, BK = Cfg<T>::BK, E = static_cast<int>(sizeof(T));
  const int smem_rc = S * E * (2 * gemm::Tile<T, KMAJ, 128, RC_BK>::SIZE +
                               2 * gemm::Tile<T, KMAJ, 64, RC_BK>::SIZE +
                               gemm::Tile<T, MNMAJ, 64, RC_BK>::SIZE);
  const int smem_dn = S * E * (gemm::Tile<T, KMAJ, 128, BK>::SIZE +
                               gemm::Tile<T, MNMAJ, 128, BK>::SIZE);
  const int smem_w = S * E * 2 * gemm::Tile<T, MNMAJ, 128, BK>::SIZE;
  cudaError_t err = allow_smem(mlp_bwd_recompute_f32, smem_rc);
  if (err == cudaSuccess) err = allow_smem(mlp_bwd_dn_f32, smem_dn);
  if (err == cudaSuccess) err = allow_smem(mlp_bwd_weights_f32, smem_w);
  if (err != cudaSuccess) return err;
  mlp_bwd_recompute_f32<<<tiles(N, 128) * tiles(F, 64), THREADS, smem_rc, s>>>(
      Np, G, Wg, Wu, Wd, Dg, Du, Y, N, D, F, act);
  mlp_bwd_dn_f32<<<tiles(N, 128) * tiles(D, 128), THREADS, smem_dn, s>>>(Dg, Du, Wg, Wu, DN, N, D,
                                                                        F);
  mlp_bwd_weights_f32<<<dim3(tiles(F, 128) * tiles(D, 128), 3), THREADS, smem_w, s>>>(
      Dg, Du, G, Np, Y, dwg, dwu, dwd, N, D, F);
  return cudaSuccess;
}
template <typename T>
cudaError_t run(const void* g, const void* residual, const void* x, const void* w_norm,
                const void* w_gate, const void* w_up, const void* w_down, void* dh, void* dwn,
                void* dwg, void* dwu, void* dwd, void* n, void* rr, void* dgpre, void* dup,
                void* y, void* dy, void* dn, void* dwn_part, int N, int D, int F, int act,
                float eps, cudaStream_t s) {
  const int smem_dh = D * static_cast<int>(sizeof(float));
  const cudaError_t err = allow_smem(mlp_bwd_dh<T>, smem_dh);
  if (err != cudaSuccess) return err;

  const T* G = static_cast<const T*>(g);
  const T* R = static_cast<const T*>(residual);
  const T* X = static_cast<const T*>(x);
  const T* Wn = static_cast<const T*>(w_norm);
  const T* Wg = static_cast<const T*>(w_gate);
  const T* Wu = static_cast<const T*>(w_up);
  const T* Wd = static_cast<const T*>(w_down);
  T* Np = static_cast<T*>(n);
  T* Dg = static_cast<T*>(dgpre);
  T* Du = static_cast<T*>(dup);
  T* Y = static_cast<T*>(y);
  float* RR = static_cast<float*>(rr);
  float* DN = static_cast<float*>(dn);
  float* P = static_cast<float*>(dwn_part);
  const int row_blocks = tiles(N, DH_ROWS);

  mlp_bwd_rows<T><<<N, THREADS, 0, s>>>(R, X, Wn, Np, RR, D, eps);
  cudaError_t e2;
  if constexpr (is_16bit<T>())
    e2 = products_wg<T>(G, Wg, Wu, Wd, Np, Dg, Du, Y, static_cast<float*>(dy), DN,
                        static_cast<T*>(dwg), static_cast<T*>(dwu), static_cast<T*>(dwd), N, D,
                        F, act, s);
  else
    e2 = products_f32(G, Wg, Wu, Wd, Np, Dg, Du, Y, DN, static_cast<T*>(dwg),
                      static_cast<T*>(dwu), static_cast<T*>(dwd), N, D, F, act, s);
  if (e2 != cudaSuccess) return e2;
  mlp_bwd_dh<T><<<row_blocks, THREADS, smem_dh, s>>>(G, R, X, Wn, RR, DN, static_cast<T*>(dh), P, N,
                                                  D);
  mlp_bwd_dwn_sum<T><<<tiles(D, 256), 256, 0, s>>>(P, static_cast<T*>(dwn), row_blocks, D);
  return cudaSuccess;
}

}  // namespace

extern "C" int tt_mlp_subblock_bwd(const void* g, const void* residual, const void* x,
                                   const void* w_norm, const void* w_gate, const void* w_up,
                                   const void* w_down, void* dh, void* dw_norm, void* dw_gate,
                                   void* dw_up, void* dw_down, void* n, void* rr, void* dgpre,
                                   void* dup, void* y, void* dy, void* dn, void* dwn_part, int N,
                                   int D, int F, int act, float eps, int dtype, int device,
                                   void* stream) {
  cudaSetDevice(device);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype != TT_F32 && dy == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tt::with_dtype(dtype, [&](auto tag) {
    return run<decltype(tag)>(g, residual, x, w_norm, w_gate, w_up, w_down, dh, dw_norm, dw_gate,
                              dw_up, dw_down, n, rr, dgpre, dup, y, dy, dn, dwn_part, N, D, F,
                              act, eps, s);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
