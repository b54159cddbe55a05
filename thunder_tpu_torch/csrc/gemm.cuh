// The tile-GEMM mainloop shared by the MLP sub-block kernels
// (mlp_subblock.cu, mlp_subblock_bwd.cu): one block computes a BM x BN tile
// of C = A B, A (M x K) and B (K x N), looping over K in BK-deep slabs that
// a STAGES-deep cp.async ring brings into shared memory.
//
// Each operand is read as stored or transposed, so that every product of the
// sub-block and its gradient reads its tensors where they lie:
//   KMAJ  - contiguous along K: A stored (M, K) row-major, B stored (N, K)
//           row-major (the torch weight layout, "x @ w.T");
//   MNMAJ - contiguous along M (for A) or N (for B): A stored (K, M)
//           ("dgpre.T @ n"), B stored (K, N) ("dgpre @ w_gate").
// A KMAJ tile sits in shared memory as [mn][k], an MNMAJ tile as [k][mn], each
// row padded by 16 bytes so that the eight row addresses of an ldmatrix fall
// in distinct banks.
//
// bf16: each warp owns a (16 MT) x (8 NT) sub-tile and multiplies with
// mma.sync m16n8k16 (bf16 in, f32 accumulate); its fragments come from
// ldmatrix (KMAJ A, KMAJ B) or ldmatrix.trans (MNMAJ A, MNMAJ B). float32:
// the same thread-to-element map with scalar FMAs, so the epilogues are
// shared. Accumulator element (mt, nt, e) of a thread is C[row][col] with
//   row = wm + 16 mt + g + 8 (e >> 1),  col = wn + 8 nt + 2 t + (e & 1),
// g = lane / 4, t = lane % 4 (the m16n8k16 D layout, common.cuh).
//
// Edges: a tile's rows or columns past the matrix are zero-filled by the
// cp.async itself (source size 0), so a ragged M, N or K needs no branch in
// the mainloop. Loads move 16-byte chunks along the contiguous dimension,
// which must therefore be a multiple of 16 bytes' worth of elements (the
// wrappers require D and F to be multiples of 8); the other dimension is free.
#pragma once

#include "common.cuh"

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A fragment (rows [m, m+16), k [k, k+16)) of a staged A tile.
template <int L, int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* s, int m, int k) {
  const int l = threadIdx.x & 31;
  // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
  if (L == KMAJ)   // stored [m][k]
    ldsm_x4(a, s + (m + (l & 15)) * LD + k + (l >> 4) * 8);
  else             // stored [k][m]: the same four matrices, each transposed on load
    ldsm_x4_t(a, s + (k + (l >> 4) * 8 + (l & 7)) * LD + m + ((l >> 3) & 1) * 8);
}

// B fragments of two neighbouring 8-column tiles (columns [n, n+16), k [k,
// k+16)): b[0], b[1] for the first, b[2], b[3] for the second.
template <int L, int LD>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const __nv_bfloat16* s, int n, int k) {
  const int l = threadIdx.x & 31;
  // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
  if (L == KMAJ)   // stored [n][k]
    ldsm_x4(b, s + (n + (l >> 4) * 8 + (l & 7)) * LD + k + ((l >> 3) & 1) * 8);
  else             // stored [k][n]: the same four matrices, each transposed on load
    ldsm_x4_t(b, s + (k + ((l >> 3) & 1) * 8 + (l & 7)) * LD + n + (l >> 4) * 8);
}

// One staged BK slab of the warp's products: acc += A_tile B_tile over the
// warp's (16 MT) x (8 NT) sub-tile at (wm, wn) of the block tile.
template <int LA, int LB, int BMr, int BNr, int BK, int MT, int NT>
__device__ __forceinline__ void mma_slab(float (&acc)[MT][NT][4], const __nv_bfloat16* As,
                                         const __nv_bfloat16* Bs, int wm, int wn) {
  static_assert(NT % 2 == 0, "B fragments come two 8-column tiles at a time");
  constexpr int LDA = Tile<__nv_bfloat16, LA, BMr, BK>::LD;
  constexpr int LDB = Tile<__nv_bfloat16, LB, BNr, BK>::LD;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[MT][4], b[NT / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) frag_a<LA, LDA>(a[mt], As, wm + mt * 16, kk);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) frag_b<LB, LDB>(b[np], Bs, wn + np * 16, kk);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[mt][nt], a[mt], b[nt / 2][(nt & 1) * 2], b[nt / 2][(nt & 1) * 2 + 1]);
  }
}

// float32: the same slab with scalar FMAs on the same thread-to-element map.
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
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

}  // namespace gemm
}  // namespace tt
