// Helpers shared by the Hopper kernels of thunder_tpu_torch: float <-> storage
// conversions, rounding through the storage type, block/warp sums, and the
// warp-level 16-bit (bf16 or fp16) tensor-core product the attention kernels
// are built from.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// dtype codes passed from the Python wrappers (executors/cudaex.py)
#define TT_F32 0
#define TT_BF16 1
#define TT_F16 2

namespace tt {

// the two 16-bit storage types the tensor-core paths take
template <typename T>
__host__ __device__ constexpr bool is_half16() {
  return std::is_same<T, __half>::value;
}
template <typename T>
__host__ __device__ constexpr bool is_16bit() {
  return std::is_same<T, __nv_bfloat16>::value || std::is_same<T, __half>::value;
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// the value a float takes once stored as T (round-to-nearest-even)
template <typename T> __device__ __forceinline__ float round_as(float v) {
  return to_f<T>(from_f<T>(v));
}

// f(T{}) for the storage type of a dtype code (host side): the dispatch of
// every entry point that takes float32, bf16 and fp16
template <class F>
cudaError_t with_dtype(int code, F&& f) {
  switch (code) {
    case TT_F32: return f(float{});
    case TT_BF16: return f(__nv_bfloat16{});
    case TT_F16: return f(__half{});
    default: return cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over the whole block; blockDim.x must be a multiple of 32.
// `red` is shared scratch of 32 floats. Every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = (threadIdx.x < nw) ? red[threadIdx.x] : 0.f;
  if (warp == 0) {
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16, bf16 or fp16 (T) in, f32 accumulate: D (16x8) += A (16x16)
// * B (16x8). Fragment layout (PTX ISA), with g = lane / 4 and t = lane % 4;
// each A/B register holds two 16-bit values, the lower column (or k) in the
// low half:
//   A: a[0] = (row g, k 2t..2t+1)   a[1] = (row g+8, k 2t..2t+1)
//      a[2] = (row g, k 2t+8..+9)   a[3] = (row g+8, k 2t+8..+9)
//   B: b0 = (k 2t..2t+1, col g)     b1 = (k 2t+8..+9, col g)
//   D: d[0], d[1] = (row g, col 2t, 2t+1)   d[2], d[3] = (row g+8, col 2t, 2t+1)
// So the D fragments of two neighbouring 8-column tiles, packed to T, are
// the A fragment of a 16-deep product over those 16 columns.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  static_assert(is_16bit<T>(), "mma16 takes bf16 or fp16");
  if constexpr (is_half16<T>())
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 16 bits of a bf16 or fp16 value
__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t bits16(__half v) { return __half_as_ushort(v); }

// two floats rounded to T and packed (lo in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return bits16(from_f<T>(lo)) | (bits16(from_f<T>(hi)) << 16);
}

// two 16-bit values from separate addresses, packed (lo in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(T lo, T hi) {
  return bits16(lo) | (bits16(hi) << 16);
}

// two neighbouring 16-bit values (4-byte aligned) as one register
template <typename T>
__device__ __forceinline__ uint32_t ld_pair(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows [r, r+16) and k [k0, k0+16) of a row-major 16-bit tile in
// shared memory with row stride ld
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile, int ld, int r, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* p = tile + (r + g) * ld + k0 + 2 * t;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// Copy rows [row0, row0 + rows) of a row-major (n_rows, HD) 16-bit matrix into
// shared memory with row stride ld, in 16-byte chunks (neighbouring threads on
// neighbouring addresses); rows at or past n_rows are zero.
template <int HD, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* __restrict__ src, int row0,
                                           int rows, int n_rows) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < rows * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * HD + col);
    *reinterpret_cast<uint4*>(dst + r * ld + col) = v;
  }
}

}  // namespace tt
