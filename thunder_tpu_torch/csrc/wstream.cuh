// The swap-AB weight stream of the decode products: linear_act's stream path
// (linear_act.cu) and the decode layer's 16-bit products (decode_layer.cuh).
//
// At decode a product has a few activation rows (n <= 8 or 16) against a
// weight of thousands of rows, so every weight byte is read once and meets
// only those rows: the loads bound it, and the card needs ~30 KB of loads in
// flight per SM at all times (3.35 TB/s x ~1.2 us of latency / 132 SMs). The
// operands are swapped: 16 weight rows are the A operand of mma.sync
// m16n8k16 and the activation rows its B operand, so n = 8 is the decode
// batch and no tensor-core work is padding. Each warp streams its weight
// rows through its own ring of 64-column slabs, filled by 16-byte
// cp.async.cg copies (L1 bypassed) with STAGES - 1 slabs in flight while one
// is multiplied. A slab tile is [rows][64] 16-bit values, XOR-swizzled by
// 16-byte chunk so that the 8 rows of each ldmatrix phase fall in distinct
// banks without padding.
#pragma once

#include "gemm.cuh"

namespace tt {
namespace ws {

constexpr int BK = 64;   // columns per slab: one 128-byte line of a 16-bit row

// element offset of 16-byte chunk `ch` of row `r` in a [rows][BK] slab tile
__device__ __forceinline__ int swz(int r, int ch) { return r * BK + ((ch ^ (r & 7)) << 3); }

// two 8x8 16-bit matrices from shared memory (ldmatrix; lanes 0-15 address)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// Start the copies of one slab into stage tile `st`: ROWS rows, columns [k0,
// k0 + BK) of rows of length K. row(r) points at row r's first element
// (nullptr: a row of zeros); columns at or past K are zeros. `vec`: the rows
// lie on the 16-byte alignment (K % 8 == 0), so 16-byte cp.async copies
// fill the tile; otherwise scalar copies do. `any` is a valid global
// address, named by the copies that read nothing.
template <typename T, int ROWS, class Row>
__device__ __forceinline__ void load_slab(T* st, int k0, int K, bool vec, const T* any, Row&& row) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = lane; c < ROWS * 8; c += 32) {
    const int r = c >> 3, ch = c & 7, k = k0 + ch * 8;
    const T* src = row(r);
    if (vec) {
      const bool ok = src != nullptr && k < K;
      gemm::cp_async16(st + swz(r, ch), ok ? src + k : any, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        st[swz(r, ch) + e] = src != nullptr && k + e < K ? src[k + e] : from_f<T>(0.f);
    }
  }
}

// A fragment of stage rows [row0, row0 + 16) x k [16 kk, 16 kk + 16): the
// matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15)
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const T* st, int row0, int kk) {
  const int lane = threadIdx.x & 31;
  gemm::ldsm_x4(a, st + swz(row0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// B fragment of stage rows [row0, row0 + 8) (the activation rows) x the same k
template <typename T>
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const T* st, int row0, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x2(b, st + swz(row0 + (lane & 7), 2 * kk + ((lane >> 3) & 1)));
}

// B fragment of rows [0, 8) x k [k, k + 16) of a row-major tile in shared
// memory with row stride ld (ld * 2 bytes an odd multiple of 16 keeps the
// 8 rows in distinct banks)
template <typename T>
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[2], const T* tile, int ld, int k) {
  const int lane = threadIdx.x & 31;
  ldsm_x2(b, tile + (lane & 7) * ld + k + 8 * ((lane >> 3) & 1));
}

// A warp's ring over its slabs 0..n-1: ring_start before the first, then
// ring_next(i) before multiplying slab i (in buffer i % STAGES) waits for it
// to land and starts slab i + STAGES - 1, and ring_drain at the end.
// load(buffer, i) starts slab i's copies. One commit group per slab step,
// empty or not, so the wait counts stay exact.
template <int STAGES, class Load>
__device__ __forceinline__ void ring_start(int n, Load&& load) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, s);
    gemm::cp_async_commit();
  }
}

template <int STAGES, class Load>
__device__ __forceinline__ void ring_next(int i, int n, Load&& load) {
  gemm::cp_async_wait<STAGES - 2>();
  __syncwarp();   // slab i has landed for every lane; every lane is done with slab i - 1
  const int nxt = i + STAGES - 1;
  if (nxt < n) load(nxt % STAGES, nxt);
  gemm::cp_async_commit();
}

__device__ __forceinline__ void ring_drain() { gemm::cp_async_wait<0>(); }

}  // namespace ws
}  // namespace tt
