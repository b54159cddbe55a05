// The transformer MLP sub-block, backward from its saved inputs:
// (dh, dw_norm, dw_gate, dw_up, dw_down) of out = h + (act(n w_gate^T) *
// (n w_up^T)) w_down^T, h = residual + x, n = rms_norm(h, w_norm), for the
// output gradient g. dh is the gradient of both residual and x. g, residual,
// x, dh (N, D); w_gate, w_up, dw_gate, dw_up (F, D); w_down, dw_down (D, F);
// w_norm, dw_norm (D,); one dtype, contiguous. n (N, D), rr (N,) f32, dgpre,
// dup, y (N, F), dn (N, D) f32 and the dw_norm partials (row blocks, D) f32
// are scratch the wrapper allocates.
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
//   (b) recompute: one 128 x 64 tile of (N, F) holds three accumulators,
//       gpre = n w_gate^T, u = n w_up^T and dy = g w_down[:, f-tile]; its
//       epilogue writes dgpre, dup and y with the kernel's roundings;
//   (c) dn = dgpre w_gate + dup w_up, one product of depth 2F, written f32;
//   (d) dh: 64 rows per block, dh and the block's partial sums of
//       dn xhat; dwn_sum adds the partials in a fixed order, so dw_norm is
//       deterministic (no atomics);
//   (e) weights: dw_gate = dgpre^T n, dw_up = dup^T n, dw_down = g^T y, one
//       launch, 128 x 128 output tiles each summing over all N rows inside
//       the block (the loop takes the place of the TPU's row grid dimension).
// Every product is gemm.cuh's mainloop, reading each operand as stored or
// transposed (ldmatrix / ldmatrix.trans), so no transposed copy is made.
// Transient memory at the train shape: dgpre, dup, y 470 MB each, dn 268 MB,
// n 134 MB. No wgmma or TMA yet.
#include "mlp_subblock.cuh"

namespace {

using namespace tt;
using namespace tt::mlp;
using gemm::KMAJ;
using gemm::MNMAJ;

// The three-product tile stages five operands: 32-deep slabs keep its bf16
// ring at 106 KB, so two blocks share an SM (a 64-deep ring, 189 KB, leaves
// room for one).
constexpr int RC_BK = 32;
constexpr int DH_ROWS = 64;   // rows per mlp_bwd_dh block (DH_ROWS in executors/cudaex.py)

// (a) n and rr, one block per row
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_rows(const T* __restrict__ residual, const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ n, float* __restrict__ rr, int D, float eps) {
  norm_row(residual, x, w, static_cast<T*>(nullptr), n, rr, D, eps);
}

// (b) the recomputed interiors of a 128 x 64 tile of (N, F) and their
// gradients: dgpre, dup, y
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_recompute(const T* __restrict__ n, const T* __restrict__ g, const T* __restrict__ wg,
                  const T* __restrict__ wu, const T* __restrict__ wd, T* __restrict__ dgpre,
                  T* __restrict__ dup, T* __restrict__ y, int N, int D, int F, int act) {
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

  gemm::for_each_pair<MT, NT>(m0 + wm, n0 + wn, N, F, [&](int mt, int nt, int h, int row, int col) {
    float vg[2], vu[2], vy[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float gp = agp[mt][nt][2 * h + j], u = au[mt][nt][2 * h + j];
      const float dy = ady[mt][nt][2 * h + j];
      const float ga = act_fn(gp, act);
      vu[j] = dy * ga;
      vg[j] = dy * u * act_grad(gp, act);
      vy[j] = round_as<T>(ga) * round_as<T>(u);
    }
    const long long o = static_cast<long long>(row) * F + col;
    gemm::store_pair(dgpre + o, vg[0], vg[1]);
    gemm::store_pair(dup + o, vu[0], vu[1]);
    gemm::store_pair(y + o, vy[0], vy[1]);
  });
}

// (c) dn = dgpre w_gate + dup w_up for a 128 x 128 tile of (N, D), f32
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_dn(const T* __restrict__ dgpre, const T* __restrict__ dup, const T* __restrict__ wg,
           const T* __restrict__ wu, float* __restrict__ dn, int N, int D, int F) {
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

  gemm::for_each_pair<MT, NT>(m0 + wm, n0 + wn, N, D, [&](int mt, int nt, int h, int row, int col) {
    gemm::store_pair(dn + static_cast<long long>(row) * D + col, acc[mt][nt][2 * h],
                     acc[mt][nt][2 * h + 1]);
  });
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
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_weights(const T* __restrict__ dgpre, const T* __restrict__ dup, const T* __restrict__ g,
                const T* __restrict__ n, const T* __restrict__ y, T* __restrict__ dwg,
                T* __restrict__ dwu, T* __restrict__ dwd, int N, int D, int F) {
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

  gemm::for_each_pair<MT, NT>(m0 + wm, n0 + wn, M, Nc,
                              [&](int mt, int nt, int h, int row, int col) {
    gemm::store_pair(C + static_cast<long long>(row) * Nc + col, acc[mt][nt][2 * h],
                     acc[mt][nt][2 * h + 1]);
  });
}

template <typename T>
cudaError_t run(const void* g, const void* residual, const void* x, const void* w_norm,
                const void* w_gate, const void* w_up, const void* w_down, void* dh, void* dwn,
                void* dwg, void* dwu, void* dwd, void* n, void* rr, void* dgpre, void* dup,
                void* y, void* dn, void* dwn_part, int N, int D, int F, int act, float eps,
                cudaStream_t s) {
  constexpr int S = Cfg<T>::STAGES, BK = Cfg<T>::BK, E = static_cast<int>(sizeof(T));
  const int smem_rc = S * E * (2 * gemm::Tile<T, KMAJ, 128, RC_BK>::SIZE +
                               2 * gemm::Tile<T, KMAJ, 64, RC_BK>::SIZE +
                               gemm::Tile<T, MNMAJ, 64, RC_BK>::SIZE);
  const int smem_dn = S * E * (gemm::Tile<T, KMAJ, 128, BK>::SIZE +
                               gemm::Tile<T, MNMAJ, 128, BK>::SIZE);
  const int smem_w = S * E * 2 * gemm::Tile<T, MNMAJ, 128, BK>::SIZE;
  const int smem_dh = D * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(mlp_bwd_recompute<T>, smem_rc);
  if (err == cudaSuccess) err = allow_smem(mlp_bwd_dn<T>, smem_dn);
  if (err == cudaSuccess) err = allow_smem(mlp_bwd_weights<T>, smem_w);
  if (err == cudaSuccess) err = allow_smem(mlp_bwd_dh<T>, smem_dh);
  if (err != cudaSuccess) return err;

  const T* G = static_cast<const T*>(g);
  const T* R = static_cast<const T*>(residual);
  const T* X = static_cast<const T*>(x);
  const T* Wn = static_cast<const T*>(w_norm);
  const T* Wg = static_cast<const T*>(w_gate);
  const T* Wu = static_cast<const T*>(w_up);
  T* Np = static_cast<T*>(n);
  T* Dg = static_cast<T*>(dgpre);
  T* Du = static_cast<T*>(dup);
  T* Y = static_cast<T*>(y);
  float* RR = static_cast<float*>(rr);
  float* DN = static_cast<float*>(dn);
  float* P = static_cast<float*>(dwn_part);
  const int row_blocks = tiles(N, DH_ROWS);

  mlp_bwd_rows<T><<<N, THREADS, 0, s>>>(R, X, Wn, Np, RR, D, eps);
  mlp_bwd_recompute<T><<<tiles(N, 128) * tiles(F, 64), THREADS, smem_rc, s>>>(
      Np, G, Wg, Wu, static_cast<const T*>(w_down), Dg, Du, Y, N, D, F, act);
  mlp_bwd_dn<T><<<tiles(N, 128) * tiles(D, 128), THREADS, smem_dn, s>>>(Dg, Du, Wg, Wu, DN, N, D,
                                                                        F);
  mlp_bwd_dh<T><<<row_blocks, THREADS, smem_dh, s>>>(G, R, X, Wn, RR, DN, static_cast<T*>(dh), P, N,
                                                  D);
  mlp_bwd_dwn_sum<T><<<tiles(D, 256), 256, 0, s>>>(P, static_cast<T*>(dwn), row_blocks, D);
  mlp_bwd_weights<T><<<dim3(tiles(F, 128) * tiles(D, 128), 3), THREADS, smem_w, s>>>(
      Dg, Du, G, Np, Y, static_cast<T*>(dwg), static_cast<T*>(dwu), static_cast<T*>(dwd), N, D,
      F);
  return cudaSuccess;
}

}  // namespace

extern "C" int tt_mlp_subblock_bwd(const void* g, const void* residual, const void* x,
                                   const void* w_norm, const void* w_gate, const void* w_up,
                                   const void* w_down, void* dh, void* dw_norm, void* dw_gate,
                                   void* dw_up, void* dw_down, void* n, void* rr, void* dgpre,
                                   void* dup, void* y, void* dn, void* dwn_part, int N, int D,
                                   int F, int act, float eps, int dtype, int device,
                                   void* stream) {
  cudaSetDevice(device);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == TT_BF16
          ? run<__nv_bfloat16>(g, residual, x, w_norm, w_gate, w_up, w_down, dh, dw_norm, dw_gate,
                               dw_up, dw_down, n, rr, dgpre, dup, y, dn, dwn_part, N, D, F, act,
                               eps, s)
          : run<float>(g, residual, x, w_norm, w_gate, w_up, w_down, dh, dw_norm, dw_gate, dw_up,
                       dw_down, n, rr, dgpre, dup, y, dn, dwn_part, N, D, F, act, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
