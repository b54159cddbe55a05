// The tile-GEMM mainloops shared by the MLP sub-block kernels
// (mlp_subblock.cu, mlp_subblock_bwd.cu) and linear_act's tile path: C = A B
// tile by tile, A (M x K) and B (K x N), looping over K in BK-deep slabs.
//
// Each operand is read as stored or transposed, so that every product of the
// sub-block and its gradient reads its tensors where they lie:
//   KMAJ  - contiguous along K: A stored (M, K) row-major, B stored (N, K)
//           row-major (the torch weight layout, "x @ w.T");
//   MNMAJ - contiguous along M (for A) or N (for B): A stored (K, M)
//           ("dgpre.T @ n"), B stored (K, N) ("dgpre @ w_gate").
//
// 16-bit types (bf16, fp16): the warp-specialised TMA + wgmma mainloop of
// namespace wg below. A block of three warpgroups (384 threads) is
// persistent, about one per SM, and walks its output tiles in tile_of's
// grouped order, so the blocks in flight share operands in L2. Warpgroup 0 is
// the producer: it gives up registers (setmaxnreg 40) and one thread issues
// 2-D TMA loads of each slab's operand tiles (128-byte swizzle, 64-deep
// slabs) into a STAGES-deep ring with a full and an empty mbarrier per
// stage. Warpgroups 1 and 2 (setmaxnreg 232) each own 64 rows of the 128-row
// tile and run wgmma m64nNk16 with both operands read from shared memory and
// f32 accumulators in registers; a slab's stage is released once the wgmma
// group after it has been issued and the one reading it has completed. The
// layouts map onto the descriptor's transpose bits (KMAJ = K-major, MNMAJ =
// MN-major, which 16-bit wgmma takes for A and B alike), so no operand is
// copied transposed. TMA fills reads past M, N or K with zeros, so a ragged
// edge needs no branch in the mainloop; its global row strides must be
// multiples of 16 bytes (the wrappers require D and F to be multiples of 8,
// and pad linear_act's K to one). The barrier waits trap after ~2^31 cycles,
// so a broken ring protocol ends the launch with an error, not a hang.
//
// float32: one block of 8 warps (256 threads) per BM x BN tile, a STAGES-deep
// cp.async ring of BK-deep slabs (a tile's rows or columns past the matrix
// zero-filled by the cp.async itself, source size 0), and scalar FMAs on the
// m16n8 thread-to-element map below; wgmma in tf32 would change float32's
// numerics. A KMAJ tile sits in shared memory as [mn][k], an MNMAJ tile as
// [k][mn], each row padded by 16 bytes.
//
// The epilogues of both mainloops see one accumulator layout: element
// (mt, nt, e) of a thread is C[row][col] with
//   row = wm + 16 mt + g + 8 (e >> 1),  col = wn + 8 nt + 2 t + (e & 1),
// g = lane / 4, t = lane % 4 (the m16n8k16 D layout, common.cuh). A wgmma
// consumer's m64nN accumulator is that layout with MT = 1, NT = N / 8,
// wm = 64 c + 16 (warp in the warpgroup), wn = 0, so for_each_pair serves
// both.
#pragma once

#include "hopper.cuh"

namespace tt {
namespace gemm {

enum Layout { KMAJ = 0, MNMAJ = 1 };

template <typename T> struct Elems { static constexpr int CHUNK = 16 / sizeof(T); };

// shared-memory geometry of one ROWS x BK tile of an operand
template <typename T, int L, int ROWS, int BK>
struct Tile {
  static constexpr int LD = (L == KMAJ ? BK : ROWS) + Elems<T>::CHUNK;
  static constexpr int SIZE = (L == KMAJ ? ROWS : BK) * LD;   // elements
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of one ROWS x BK tile: rows [mn0, mn0 + ROWS) (masked at
// mn_lim) and k [k0, k0 + BK) (masked at k_lim) of an operand whose
// contiguous dimension has stride ld (in elements).
template <typename T, int L, int ROWS, int BK>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ g, long long ld, int mn0,
                                          int mn_lim, int k0, int k_lim) {
  constexpr int CH = Elems<T>::CHUNK;
  constexpr int LD = Tile<T, L, ROWS, BK>::LD;
  if (L == KMAJ) {
    constexpr int PER_ROW = BK / CH;
    for (int c = threadIdx.x; c < ROWS * PER_ROW; c += blockDim.x) {
      const int r = c / PER_ROW, kc = (c % PER_ROW) * CH;
      const bool ok = mn0 + r < mn_lim && k0 + kc < k_lim;
      const T* src = ok ? g + static_cast<long long>(mn0 + r) * ld + k0 + kc : g;
      cp_async16(s + r * LD + kc, src, ok);
    }
  } else {
    constexpr int PER_ROW = ROWS / CH;
    for (int c = threadIdx.x; c < BK * PER_ROW; c += blockDim.x) {
      const int kr = c / PER_ROW, mc = (c % PER_ROW) * CH;
      const bool ok = k0 + kr < k_lim && mn0 + mc < mn_lim;
      const T* src = ok ? g + static_cast<long long>(k0 + kr) * ld + mn0 + mc : g;
      cp_async16(s + kr * LD + mc, src, ok);
    }
  }
}

// four 8x8 16-bit matrices from shared memory, one register each (ldmatrix)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// One staged BK slab of a warp's products on the float32 mainloop: acc +=
// A_tile B_tile over the warp's (16 MT) x (8 NT) sub-tile at (wm, wn) of the
// block tile, scalar FMAs on the m16n8 thread-to-element map.
template <int LA, int LB, int BMr, int BNr, int BK, int MT, int NT>
__device__ __forceinline__ void mma_slab(float (&acc)[MT][NT][4], const float* As,
                                         const float* Bs, int wm, int wn) {
  constexpr int LDA = Tile<float, LA, BMr, BK>::LD;
  constexpr int LDB = Tile<float, LB, BNr, BK>::LD;
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float a[MT][2], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + mt * 16 + g + 8 * h;
        a[mt][h] = LA == KMAJ ? As[m * LDA + k] : As[k * LDA + m];
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = wn + nt * 8 + 2 * t + h;
        b[nt][h] = LB == KMAJ ? Bs[n * LDB + k] : Bs[k * LDB + n];
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nt][e] = fmaf(a[mt][e >> 1], b[nt][e & 1], acc[mt][nt][e]);
  }
}

// The K loop: load(buffer, slab) starts one slab's copies into ring buffer
// `buffer`; compute(buffer) runs the products on it. STAGES - 1 slabs are in
// flight while one is multiplied.
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void pipeline(int n_slabs, Load&& load, Compute&& compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slabs) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_slabs; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // slab kt has landed, and every warp is done with slab kt - 1
    const int nxt = kt + STAGES - 1;
    if (nxt < n_slabs) load(nxt % STAGES, nxt);
    cp_async_commit();
    compute(kt % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// The block's tile from a linear block index, GROUP tile rows at a time
// (column by column inside a group), so the blocks in flight share their A
// rows and B columns in L2.
template <int GROUP>
__device__ __forceinline__ void tile_of(int pid, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = GROUP * tiles_n;
  const int first = (pid / per_group) * GROUP;
  const int rows = min(tiles_m - first, GROUP);
  const int in = pid % per_group;
  tm = first + in % rows;
  tn = in / rows;
}

// Visit the thread's accumulator elements as neighbouring column pairs:
// f(mt, nt, h, row, col) for rows/cols inside (M, N); acc[mt][nt][2h],
// acc[mt][nt][2h + 1] are C[row][col], C[row][col + 1]. N is even, so a pair
// is in or out as a whole.
template <int MT, int NT, class Fn>
__device__ __forceinline__ void for_each_pair(int row0, int col0, int M, int N, Fn&& f) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + mt * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = col0 + nt * 8 + 2 * t;
        if (col < N) f(mt, nt, h, row, col);
      }
    }
}

// two neighbouring values stored to T (8 or 4 bytes, aligned: col is even)
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2<T>(a, b);
}

// ---------------------------------------------------------------------------
// The 16-bit mainloop: warp-specialised, persistent TMA + wgmma (see the top)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BM = 128;        // block tile rows: 64 per consumer warpgroup
constexpr int BK = 64;         // slab depth: one 128-byte swizzled row of 16-bit values
constexpr int BOX = 64;        // 16-bit values in one 128-byte TMA box row
constexpr int THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int BOX_BYTES = BOX * BK * 2;   // an MNMAJ box: BK rows of 128 bytes

// bytes of one operand's slab in shared memory, either layout: ROWS (M or N)
// x BK 16-bit values; a multiple of 1024, so every slab keeps the swizzle's
// alignment
template <int ROWS>
__host__ __device__ constexpr int slab_bytes() {
  return ROWS * BK * 2;
}

// Producer: the TMA loads of one operand's slab, rows [mn0, mn0 + ROWS) and k
// [k0, k0 + BK), into `dst`, completing on `bar`. KMAJ: one box of ROWS rows
// of 128 bytes; MNMAJ: ROWS / 64 boxes of BK rows of 128 bytes (op_map
// encodes the matching boxes).
template <int L, int ROWS>
__device__ __forceinline__ void load_slab(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int mn0, int k0) {
  static_assert(L == KMAJ || ROWS % BOX == 0, "an MNMAJ slab is whole 64-column boxes");
  if (L == KMAJ) {
    hopper::tma_load_2d(dst, map, bar, k0, mn0);
  } else {
#pragma unroll
    for (int b = 0; b < ROWS / BOX; ++b)
      hopper::tma_load_2d(dst + b * BOX_BYTES, map, bar, mn0 + b * BOX, k0);
  }
}

// Descriptors of the kk-th 16-deep step of a slab (hopper.cuh's layouts):
// consumer c's 64 rows of an A slab, and a whole B slab.
template <int L>
__device__ __forceinline__ uint64_t desc_a(uint32_t slab, int c, int kk) {
  return L == KMAJ ? hopper::desc_sw128(slab + c * 64 * 128 + kk * 32, 16, 1024)
                   : hopper::desc_sw128(slab + c * BOX_BYTES + kk * 16 * 128, BOX_BYTES, 1024);
}
template <int L>
__device__ __forceinline__ uint64_t desc_b(uint32_t slab, int kk) {
  return L == KMAJ ? hopper::desc_sw128(slab + kk * 32, 16, 1024)
                   : hopper::desc_sw128(slab + kk * 16 * 128, BOX_BYTES, 1024);
}

// An accumulator of a consumer warpgroup, 64 x N in the m16n8 layout above
// (MT = 1), and the flat register array wgmma writes
template <int N>
using Acc = float[1][N / 8][4];
template <int N>
__device__ __forceinline__ float (&flat(Acc<N>& acc))[N / 2] {
  return *reinterpret_cast<float(*)[N / 2]>(&acc);
}
template <int N>
__device__ __forceinline__ void fence(Acc<N>& acc) {
  hopper::fence_regs(flat<N>(acc));
}

// consumer c's thread's first row (wm) in tile row tm: its warp's 16 of the
// warpgroup's 64 rows
__device__ __forceinline__ int row0(int tm, int c) {
  return tm * BM + 64 * c + 16 * ((threadIdx.x >> 5) & 3);
}

// acc += A_slab B_slab over one BK slab, consumer c's 64 rows
template <typename T, int LA, int LB, int N>
__device__ __forceinline__ void mma(Acc<N>& acc, uint32_t a_slab, uint32_t b_slab, int c) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    hopper::wgmma_ss<T, LA, LB>(flat<N>(acc), desc_a<LA>(a_slab, c, kk), desc_b<LB>(b_slab, kk),
                                1);
}

// The ring: STAGES stages of STAGE_BYTES, then a full and an empty barrier
// per stage; BYTES is the dynamic shared memory a kernel asks for (+ 1024 for
// aligning the ring to the swizzle's period).
template <int STAGES, int STAGE_BYTES>
struct Ring {
  static_assert(STAGE_BYTES % 1024 == 0, "stages keep the 1024-byte swizzle alignment");
  static constexpr int BYTES = STAGES * STAGE_BYTES + 16 * STAGES + 1024;
  uint32_t base;
  __device__ __forceinline__ uint32_t stage(int s) const { return base + s * STAGE_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + STAGES * STAGE_BYTES + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + STAGES * STAGE_BYTES + 8 * (STAGES + s);
  }
};

// The persistent block: tiles blockIdx.x, blockIdx.x + gridDim.x, ... of
// n_tiles, each n_slabs deep.
//   load(tile, slab, stage, full)  the producer thread's TMA loads of one
//                                  slab (exactly STAGE_BYTES in all);
//   zero()                         consumer: clear the tile's accumulators;
//   mma(stage, c)                  consumer c: the slab's wgmma (not waited);
//   epilogue(tile, c)              consumer c: its 64 rows, after every wgmma
//                                  of the tile has completed (fence first).
// The stage and phase of slab `it` (counted across tiles) are it % STAGES and
// (it / STAGES) & 1 on both sides.
template <int STAGES, int STAGE_BYTES, class Load, class Zero, class Mma, class Epi>
__device__ __forceinline__ void persistent(unsigned char* smem, int n_tiles, int n_slabs,
                                           Load&& load, Zero&& zero, Mma&& mma_fn,
                                           Epi&& epilogue) {
  const Ring<STAGES, STAGE_BYTES> ring{(hopper::smem_u32(smem) + 1023u) & ~1023u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(ring.full(s), 1);
      hopper::mbar_init(ring.empty(s), 2 * 128);   // every consumer thread releases a stage
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int s = 0; s < n_slabs; ++s, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) hopper::mbar_wait(ring.empty(st), ((it / STAGES) - 1) & 1);
          hopper::mbar_expect_tx(ring.full(st), STAGE_BYTES);
          load(tile, s, ring.stage(st), ring.full(st));
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      zero();
      for (int s = 0; s < n_slabs; ++s, ++it) {
        const int st = it % STAGES;
        hopper::mbar_wait(ring.full(st), (it / STAGES) & 1);
        hopper::wgmma_fence();
        mma_fn(ring.stage(st), c);
        hopper::wgmma_commit();
        // the previous slab's products have completed: release its stage
        hopper::wgmma_wait<1>();
        if (s > 0) hopper::mbar_arrive(ring.empty((it - 1) % STAGES));
      }
      hopper::wgmma_wait<0>();
      hopper::mbar_arrive(ring.empty((it - 1) % STAGES));
      epilogue(tile, c);
    }
  }
}

// the current device's SM count
inline int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The persistent grid: one block per SM, or one per tile where there are fewer
inline int grid_for(int n_tiles) {
  const int sms = sm_count();
  return n_tiles < sms ? n_tiles : sms;
}

// The TMA map of an operand as load_slab reads it: KMAJ stored (mn, k) with
// row stride ld, boxes of 64 k x ROWS; MNMAJ stored (k, mn), boxes of 64 mn x
// BK.
template <typename T, int L, int ROWS>
bool op_map(CUtensorMap* map, const void* p, long long mn, long long k, long long ld) {
  return L == KMAJ ? hopper::map_2d<T>(map, p, k, mn, ld, BOX, ROWS)
                   : hopper::map_2d<T>(map, p, mn, k, ld, BOX, BK);
}

}  // namespace wg

}  // namespace gemm
}  // namespace tt
