// GEMM with an activation epilogue: C = act(A @ W^T + bias), f32 accumulation.
// A is (M, K) and W is (N, K), both K-contiguous (a "TN" product, the torch
// weight layout); C is (M, N) in the input type.
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_linear_act (:896), whose
// body is _linear_act_kernel (:875). The activations are those of _ACT_IMPLS
// (:867), here mlp::act_fn: relu, silu, gelu (erf) and gelu_tanh, applied to
// the f32 sum (bias added) before the single rounding to the output type.
//
// Bound on an H100: at the decode shape (M = 8 rows, N = 14336, K = 4096,
// bf16) bytes: the weight alone is 117 MB and each weight byte meets only
// 8 rows, so the product does ~8 operations per byte against the 295 where
// the tensor cores become the limit; the bound is ~35 us at 3.35 TB/s. At a
// 512-row prefill chunk it does ~480 operations per byte and is bound by the
// tensor cores (~61 us at 989 TFLOP/s).
//
// Two paths, chosen by the wrapper (cudaex.linear_act_path) from the dtype
// and M alone and passed in as `path`:
//
// stream (bf16 or fp16, M <= 16: decode). The weight must stream at the card's
//   memory rate, which takes ~30 KB of loads in flight per SM at all times
//   (3.35 TB/s x ~1.2 us of latency / 132 SMs). A and B are swapped: 16
//   weight rows are the A operand of mma.sync m16n8k16 and the activation
//   rows its B operand, so n = 8 is exactly the decode batch (rows 9-16
//   take a second n-tile) and no tensor-core work is padding. A block of two
//   warps owns 16 weight rows, N / 16 blocks in all (896 at N = 14336, all
//   resident at once: ~7 per SM, no tail wave); its warps split K and each
//   runs its own 4-deep ring of cp.async.cg 16-byte copies (L1 bypassed) of
//   64-column slabs of its weight rows and of the activations, which stay in
//   L2. That keeps 3 x 2 KB of weight in flight per warp, ~80 KB per SM. The
//   stage tiles are XOR-swizzled by 16-byte chunk, so the ldmatrix reads are
//   conflict-free without padding. The two warps' sums meet in shared memory
//   for the epilogue. A K that is not a multiple of 8 leaves the rows off
//   the 16-byte alignment: the slabs are then filled by scalar copies (zeros
//   past K) in place of the 16-byte cp.async. The slab tiles, fragments and
//   ring are wstream.cuh's, which the decode layer's products share.
//
// tile (every other case: prefill chunks, ragged last chunks, float32).
//   gemm.cuh's mainloops, as mlp_subblock.cu uses them, A and W both read
//   K-major: for bf16 and fp16 the persistent TMA + wgmma mainloop on 128 x
//   256 tiles (48 KB stages, 4 deep); for float32 the cp.async + FMA
//   mainloop on 128 x 128 tiles (a 2-deep ring of 32-deep slabs). Tiles are
//   visited 16 tile rows at a time so that blocks in flight share operands
//   in L2. TMA needs 16-byte row strides, so the wrapper zero-pads A and W
//   along K to a multiple of 8 (float32: 4) where K is not one.
//
// What is left for later: a TMA bulk-copy weight stream.
#include "mlp_subblock.cuh"
#include "wstream.cuh"

namespace {

using namespace tt;
using gemm::KMAJ;
using mlp::act_fn;
namespace wg = tt::gemm::wg;

// ---------------------------------------------------------------------------
// stream: M <= 16, bf16 or fp16
// ---------------------------------------------------------------------------

constexpr int SW_ROWS = 16;                 // weight rows per block (one m16 A tile)
constexpr int SW_BK = ws::BK;               // columns per slab: one 128-byte line of a row
constexpr int SW_STAGES = 4;                // ring depth per warp
constexpr int SW_WARPS = 2;                 // warps of a block, splitting K
constexpr int SW_THREADS = 32 * SW_WARPS;

template <int NT>
constexpr int stream_smem() {   // the warps' rings, then their partial sums
  return SW_WARPS * SW_STAGES * (SW_ROWS + 8 * NT) * SW_BK * 2 + SW_WARPS * SW_ROWS * 8 * NT * 4;
}

// NT n-tiles of 8 activation rows: 1 for M <= 8, 2 for M <= 16
template <typename T, int NT>
__global__ void __launch_bounds__(SW_THREADS)
linear_act_stream(const T* __restrict__ A, const T* __restrict__ W, const T* __restrict__ bias,
                  T* __restrict__ C, int M, int N, int K, int act) {
  constexpr int XR = 8 * NT;                      // activation rows of a slab
  constexpr int STAGE = (SW_ROWS + XR) * SW_BK;   // elements: weight rows, then activations
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* ring = reinterpret_cast<T*>(smem_raw) + warp * SW_STAGES * STAGE;
  float* red = reinterpret_cast<float*>(smem_raw + SW_WARPS * SW_STAGES * STAGE * 2);

  const int n0 = blockIdx.x * SW_ROWS;
  const int slabs = (K + SW_BK - 1) / SW_BK;
  const int s0 = warp * slabs / SW_WARPS;   // this warp's slabs: [s0, s0 + mine)
  const int mine = (warp + 1) * slabs / SW_WARPS - s0;

  const bool vec = K % 8 == 0;   // rows on the 16-byte alignment
  const auto load = [&](int b, int slab) {
    ws::load_slab<T, SW_ROWS + XR>(ring + b * STAGE, (s0 + slab) * SW_BK, K, vec, W,
                                   [&](int r) -> const T* {
      if (r < SW_ROWS) return n0 + r < N ? W + static_cast<long long>(n0 + r) * K : nullptr;
      return r - SW_ROWS < M ? A + static_cast<long long>(r - SW_ROWS) * K : nullptr;
    });
  };

  // acc[nt][e]: weight row g + 8 (e >> 1), activation row 8 nt + 2 t + (e & 1)
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const auto compute = [&](int b) {
    const T* st = ring + b * STAGE;
#pragma unroll
    for (int kk = 0; kk < SW_BK / 16; ++kk) {
      uint32_t a[4];
      ws::frag_a(a, st, 0, kk);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t x[2];
        ws::frag_b(x, st, SW_ROWS + 8 * nt, kk);
        mma16<T>(acc[nt], a, x[0], x[1]);
      }
    }
  };

  // the warp's own ring: SW_STAGES - 1 slabs in flight while one is multiplied
  ws::ring_start<SW_STAGES>(mine, load);
  for (int kt = 0; kt < mine; ++kt) {
    ws::ring_next<SW_STAGES>(kt, mine, load);
    compute(kt % SW_STAGES);
  }
  ws::ring_drain();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * SW_ROWS + g + 8 * (e >> 1)) * XR + 8 * nt + 2 * t + (e & 1)] = acc[nt][e];
  __syncthreads();
  for (int i = threadIdx.x; i < XR * SW_ROWS; i += SW_THREADS) {
    const int m = i / SW_ROWS, r = i % SW_ROWS, n = n0 + r;
    if (m >= M || n >= N) continue;
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < SW_WARPS; ++w) y += red[(w * SW_ROWS + r) * XR + m];
    if (bias != nullptr) y += to_f(bias[n]);
    C[static_cast<long long>(m) * N + n] = from_f<T>(act_fn(y, act));
  }
}

template <typename T, int NT>
cudaError_t launch_stream(const void* a, const void* w, const void* bias, void* out, int M, int N,
                          int K, int act, cudaStream_t s) {
  // shared memory rather than L1: ~8 blocks of the ring per SM
  const cudaError_t err = cudaFuncSetAttribute(
      linear_act_stream<T, NT>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  linear_act_stream<T, NT><<<(N + SW_ROWS - 1) / SW_ROWS, SW_THREADS, stream_smem<NT>(), s>>>(
      static_cast<const T*>(a), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), M, N, K, act);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// tile: gemm.cuh's mainloops with the bias + activation epilogue
// ---------------------------------------------------------------------------

constexpr int TL_BM = 128, TL_BN = 128;

// the epilogue: C = act(acc + bias) rounded once, thread-owned elements of
// the tile at (row0, col0) (gemm.cuh's accumulator layout)
template <typename T, int MT, int NT>
__device__ __forceinline__ void bias_act_epilogue(const float (&acc)[MT][NT][4], int row0,
                                                  int col0, const T* __restrict__ bias,
                                                  T* __restrict__ C, int M, int N, int act) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  mlp::with_act(act, [&](auto a) {
    constexpr int ACT = decltype(a)::value;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + mt * 16 + g + 8 * (e >> 1);
        if (row >= M) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = col0 + nt * 8 + 2 * t + (e & 1);
          if (col >= N) continue;
          float y = acc[mt][nt][e];
          if (bias != nullptr) y += to_f(bias[col]);
          C[static_cast<long long>(row) * N + col] = from_f<T>(mlp::act_fn<ACT>(y));
        }
      }
  });
}

// float32: the cp.async + FMA mainloop
constexpr int tile_smem_f32() {
  using C = mlp::Cfg<float>;
  return C::STAGES * (gemm::Tile<float, KMAJ, TL_BM, C::BK>::SIZE +
                      gemm::Tile<float, KMAJ, TL_BN, C::BK>::SIZE) *
         static_cast<int>(sizeof(float));
}

__global__ void __launch_bounds__(mlp::THREADS)
linear_act_tile_f32(const float* __restrict__ A, const float* __restrict__ W,
                    const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K,
                    int act) {
  using T = float;
  constexpr int MT = 4, NT = 4, S = mlp::Cfg<T>::STAGES, BK = mlp::Cfg<T>::BK;
  using TA = gemm::Tile<T, KMAJ, TL_BM, BK>;
  using TB = gemm::Tile<T, KMAJ, TL_BN, BK>;
  constexpr int STAGE = TA::SIZE + TB::SIZE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  int tm, tn;
  gemm::tile_of<mlp::GROUP>(blockIdx.x, mlp::tiles(M, TL_BM), mlp::tiles(N, TL_BN), tm, tn);
  const int m0 = tm * TL_BM, n0 = tn * TL_BN;
  const int warp = threadIdx.x >> 5, wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  float acc[MT][NT][4];
  gemm::zero(acc);
  gemm::pipeline<S>(
      mlp::tiles(K, BK),
      [&](int b, int s) {
        T* st = smem + b * STAGE;
        gemm::load_tile<T, KMAJ, TL_BM, BK>(st, A, K, m0, M, s * BK, K);
        gemm::load_tile<T, KMAJ, TL_BN, BK>(st + TA::SIZE, W, K, n0, N, s * BK, K);
      },
      [&](int b) {
        const T* st = smem + b * STAGE;
        gemm::mma_slab<KMAJ, KMAJ, TL_BM, TL_BN, BK>(acc, st, st + TA::SIZE, wm, wn);
      });
  bias_act_epilogue<T>(acc, m0 + wm, n0 + wn, bias, C, M, N, act);
}

// bf16 / fp16: the TMA + wgmma mainloop (gemm::wg) on 128 x 256 tiles
constexpr int WG_BN = 256, WG_STAGES = 4;
constexpr int WG_SA = wg::slab_bytes<wg::BM>();
constexpr int WG_STAGE = WG_SA + wg::slab_bytes<WG_BN>();

template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
linear_act_tile_wg(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w, const T* __restrict__ bias,
                   T* __restrict__ C, int M, int N, int K, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_m = mlp::tiles(M, wg::BM), tiles_n = mlp::tiles(N, WG_BN);
  wg::Acc<WG_BN> acc;
  wg::persistent<WG_STAGES, WG_STAGE>(
      smem_raw, tiles_m * tiles_n, mlp::tiles(K, wg::BK),
      [&](int tile, int s, uint32_t st, uint32_t bar) {
        int tm, tn;
        gemm::tile_of<mlp::GROUP>(tile, tiles_m, tiles_n, tm, tn);
        wg::load_slab<KMAJ, wg::BM>(st, &map_a, bar, tm * wg::BM, s * wg::BK);
        wg::load_slab<KMAJ, WG_BN>(st + WG_SA, &map_w, bar, tn * WG_BN, s * wg::BK);
      },
      [&] { gemm::zero(acc); },
      [&](uint32_t st, int c) { wg::mma<T, KMAJ, KMAJ, WG_BN>(acc, st, st + WG_SA, c); },
      [&](int tile, int c) {
        wg::fence<WG_BN>(acc);
        int tm, tn;
        gemm::tile_of<mlp::GROUP>(tile, tiles_m, tiles_n, tm, tn);
        bias_act_epilogue<T>(acc, wg::row0(tm, c), tn * WG_BN, bias, C, M, N, act);
      });
}

template <typename T>
cudaError_t launch_tile(const void* a, const void* w, const void* bias, void* out, int M, int N,
                        int K, int act, cudaStream_t s) {
  if constexpr (is_16bit<T>()) {
    CUtensorMap ma, mw;
    if (!wg::op_map<T, KMAJ, wg::BM>(&ma, a, M, K, K) ||
        !wg::op_map<T, KMAJ, WG_BN>(&mw, w, N, K, K))
      return cudaErrorInvalidValue;
    constexpr int smem = wg::Ring<WG_STAGES, WG_STAGE>::BYTES;
    const cudaError_t err = mlp::allow_smem(linear_act_tile_wg<T>, smem);
    if (err != cudaSuccess) return err;
    const int n_tiles = mlp::tiles(M, wg::BM) * mlp::tiles(N, WG_BN);
    linear_act_tile_wg<T><<<wg::grid_for(n_tiles), wg::THREADS, smem, s>>>(
        ma, mw, static_cast<const T*>(bias), static_cast<T*>(out), M, N, K, act);
  } else {
    const cudaError_t err = mlp::allow_smem(linear_act_tile_f32, tile_smem_f32());
    if (err != cudaSuccess) return err;
    linear_act_tile_f32<<<mlp::tiles(M, TL_BM) * mlp::tiles(N, TL_BN), mlp::THREADS,
                          tile_smem_f32(), s>>>(
        static_cast<const float*>(a), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K, act);
  }
  return cudaSuccess;
}

}  // namespace

// path: 0 tile, 1 stream (bf16 or fp16, M <= 16), as cudaex.linear_act_path
// chooses; a path the inputs do not fit is refused. The tile path takes K a
// multiple of 8 (16-bit) or 4 (float32), which the wrapper pads to.
extern "C" int tt_linear_act(const void* a, const void* w, const void* bias, void* out, int M,
                             int N, int K, int act, int dtype, int path, int device,
                             void* stream) {
  cudaSetDevice(device);
  if (path == 1 && (dtype == TT_F32 || M > 16)) return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0 && K % (dtype == TT_F32 ? 4 : 8)) return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0 && N > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = tt::with_dtype(dtype, [&](auto tag) {
      using T = decltype(tag);
      if constexpr (tt::is_16bit<T>()) {
        if (path == 1)
          return M <= 8 ? launch_stream<T, 1>(a, w, bias, out, M, N, K, act, s)
                        : launch_stream<T, 2>(a, w, bias, out, M, N, K, act, s);
      }
      return launch_tile<T>(a, w, bias, out, M, N, K, act, s);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
