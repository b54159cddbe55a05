// The shared header of the region executor's generated kernels
// (thunder_tpu_torch/executors/regionex.py): each region of a jit program
// is one kernel generated from its members, compiled with --fmad=false and
// without fast math. It replaces no Pallas kernel: it stands for the
// fusions the reference's XLA executor (thunder_tpu/executors/xla.py
// XLAFusionExecutor, :77) hands to XLA.
//
// Bound: bytes. A region reads each input once and writes each output once
// over its iteration space; every intermediate stays in a register. Design:
// an elementwise region is one thread an element in a grid-stride loop; a
// region with row reductions (its members reduce the trailing dims of one
// row space) is one CTA a row, grid-striding over rows, one pass over the
// row a reduction level (each pass computes what it needs from the inputs)
// and a last pass for what follows the last reduction. Each member
// is computed in the compute type torch's CUDA kernel uses (float32 for the
// 16-bit types) and rounded to its dtype after each member, as the op-by-op
// chain rounds. The block reductions below combine in a fixed order (each
// thread's columns in turn, then a shuffle tree, then the warps' partials
// in warp order), so two launches on the same inputs agree bit for bit.
//
// Few long rows (the sampler's 8 rows of 128,256) split across a thread-block
// cluster of up to 8 CTAs: each CTA reduces its part of the row, then every
// CTA combines the cluster's partials from distributed shared memory in rank
// order (cluster_reduce / cluster_arg below), so the order stays fixed.
//
// Where a row's inputs that two passes read fit in shared memory, the CTA
// stages them there once a row (stage_row: 16-byte copies where the row is
// contiguous and aligned) and every pass reads them from there: the row is
// read from global memory once (design ``smem``). A sum over the kept dims
// of a row space (a norm weight's column sum) accumulates each CTA's rows
// column by column in shared memory, writes one partial a CTA, and
// finish_columns sums the partials as a fixed tree.
//
// A reduction over other dims than the trailing ones (design ``column``):
// a CTA owns a tile of kept elements, its threads along the kept index (so
// the loads coalesce where the innermost dim is kept), each column of
// threads a strided share of the reduced elements in order; tile_reduce
// combines them as a fixed tree, tile_cluster_reduce a cluster's CTAs in
// rank order where the reduced extent is split across a cluster.
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ttr {

// a value rounded to bfloat16 / float16 and held in float32
__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rnd_f16(float x) { return __half2float(__float2half_rn(x)); }

// floor division of integers, as torch's floor_divide: the quotient
// rounded toward minus infinity
template <typename T>
__device__ __forceinline__ T floor_div(T a, T b) {
  const T q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// a read of a region's input through the read-only data cache: a kernel
// never writes its inputs (its outputs are fresh tensors), so the compiler
// may move such a read above an earlier store and keep several in flight
template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldg(p); }
template <> __device__ __forceinline__ bool ld<bool>(const bool* p) {
  return __ldg(reinterpret_cast<const unsigned char*>(p)) != 0;
}
template <> __device__ __forceinline__ long ld<long>(const long* p) {
  return static_cast<long>(__ldg(reinterpret_cast<const long long*>(p)));
}

// -- reductions -------------------------------------------------------------

struct Sum {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
// integers multiply as int64 does on the card (wrapping), floats as floats
struct Prod {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a * b; }
  __device__ __forceinline__ long long operator()(long long a, long long b) const {
    return static_cast<long long>(static_cast<unsigned long long>(a) *
                                  static_cast<unsigned long long>(b));
  }
};
// torch's amax / amin: a NaN anywhere makes the result NaN
struct MaxNan {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
  }
};
struct MinNan {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
  }
};

template <typename T>
__device__ __forceinline__ T lowest();
template <> __device__ __forceinline__ float lowest<float>() { return -INFINITY; }
template <> __device__ __forceinline__ double lowest<double>() { return -INFINITY; }
template <> __device__ __forceinline__ int lowest<int>() { return -2147483647 - 1; }
template <> __device__ __forceinline__ long long lowest<long long>() {
  return -9223372036854775807LL - 1;
}
template <> __device__ __forceinline__ long lowest<long>() { return -9223372036854775807L - 1; }
template <typename T>
__device__ __forceinline__ T highest();
template <> __device__ __forceinline__ float highest<float>() { return INFINITY; }
template <> __device__ __forceinline__ double highest<double>() { return INFINITY; }
template <> __device__ __forceinline__ int highest<int>() { return 2147483647; }
template <> __device__ __forceinline__ long long highest<long long>() {
  return 9223372036854775807LL;
}
template <> __device__ __forceinline__ long highest<long>() { return 9223372036854775807L; }

template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// the CTA's values combined in a fixed order; every thread gets the result.
// ``smem`` holds 32 values of T; blockDim.x is a multiple of 32
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T identity, void* smem) {
  T* sm = reinterpret_cast<T*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_reduce(v, op);
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_reduce(lane < nw ? sm[lane] : identity, op);
    if (lane == 0) sm[0] = v;
  }
  __syncthreads();
  const T r = sm[0];
  __syncthreads();
  return r;
}

// argmax / argmin as torch's: the extreme value, a NaN counting as the
// extreme, and the lowest index among equals; index < 0 marks no value yet.
// Does (bv, bi) replace (av, ai)?
template <bool MAX, typename T>
__device__ __forceinline__ bool arg_takes(T av, long long ai, T bv, long long bi) {
  if (bi < 0) return false;
  if (ai < 0) return true;
  const bool an = av != av, bn = bv != bv;
  if (an || bn) return bn && (!an || bi < ai);
  if (bv == av) return bi < ai;
  return MAX ? bv > av : bv < av;
}

template <bool MAX, typename T>
__device__ __forceinline__ void arg_step(T& av, long long& ai, T x, long long i) {
  if (arg_takes<MAX>(av, ai, x, i)) {
    av = x;
    ai = i;
  }
}

template <bool MAX, typename T>
__device__ __forceinline__ void warp_arg(T& av, long long& ai) {
  for (int o = 16; o > 0; o >>= 1) {
    const T bv = __shfl_down_sync(0xffffffffu, av, o);
    const long long bi = __shfl_down_sync(0xffffffffu, ai, o);
    arg_step<MAX>(av, ai, bv, bi);
  }
}

// the CTA's (value, index) pairs combined in a fixed order; every thread
// gets the winner in (av, ai). ``smem`` holds 32 pairs of 16 bytes
template <bool MAX, typename T>
__device__ __forceinline__ void block_arg(T& av, long long& ai, void* smem) {
  T* sv = reinterpret_cast<T*>(smem);
  long long* si = reinterpret_cast<long long*>(static_cast<char*>(smem) + 32 * sizeof(double));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  warp_arg<MAX>(av, ai);
  if (lane == 0) {
    sv[warp] = av;
    si[warp] = ai;
  }
  __syncthreads();
  if (warp == 0) {
    av = lane < nw ? sv[lane] : T(0);
    ai = lane < nw ? si[lane] : -1LL;
    warp_arg<MAX>(av, ai);
    if (lane == 0) {
      sv[0] = av;
      si[0] = ai;
    }
  }
  __syncthreads();
  av = sv[0];
  ai = si[0];
  __syncthreads();
}

// the cluster's CTA partials ``v`` (the same in every thread of a CTA)
// combined in rank order; every thread of the cluster gets the result.
// ``slot`` is one T of this CTA's shared memory
template <typename T, typename Op>
__device__ __forceinline__ T cluster_reduce(T v, Op op, T* slot) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  cl.sync();
  T r = *cl.map_shared_rank(slot, 0);
  for (unsigned k = 1; k < cl.num_blocks(); ++k) r = op(r, *cl.map_shared_rank(slot, k));
  cl.sync();   // every CTA has read the slots before any writes its next one
  return r;
}

// the cluster's (value, index) partials combined in rank order; ``sv``,
// ``si`` one slot each of this CTA's shared memory
template <bool MAX, typename T>
__device__ __forceinline__ long long cluster_arg(T av, long long ai, T* sv, long long* si) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  if (threadIdx.x == 0) {
    *sv = av;
    *si = ai;
  }
  cl.sync();
  T bv = *cl.map_shared_rank(sv, 0);
  long long bi = *cl.map_shared_rank(si, 0);
  for (unsigned k = 1; k < cl.num_blocks(); ++k)
    arg_step<MAX>(bv, bi, *cl.map_shared_rank(sv, k), *cl.map_shared_rank(si, k));
  cl.sync();
  return bi;
}

// -- shared-memory rows -------------------------------------------------------

// n elements of a contiguous row part from src to dst by the CTA's threads:
// 16-byte copies where ``vec`` (src and dst 16-byte aligned), then the tail
template <typename T, typename I>
__device__ __forceinline__ void stage_row(T* dst, const T* src, I n, bool vec) {
  I e = 0;
  if (vec) {
    constexpr int V = 16 / sizeof(T) > 0 ? 16 / sizeof(T) : 1;
    const I nv = n / V;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (I v = threadIdx.x; v < nv; v += blockDim.x) d[v] = __ldg(s + v);
    e = nv * V;
  }
  for (I k = e + threadIdx.x; k < n; k += blockDim.x) dst[k] = ld(src + k);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// an accumulator's value as the output's storage type: rounded once
template <typename O, typename A>
__device__ __forceinline__ O store_as(A v) { return static_cast<O>(v); }
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half store_as<__half, float>(float v) {
  return __float2half_rn(v);
}

// -- column tiles -------------------------------------------------------------

// a (blockDim.x, blockDim.y) tile's values combined down each column of
// threads as a fixed tree (blockDim.y a power of two); every thread gets its
// column's total. ``sm`` holds blockDim.x * blockDim.y values of T
template <typename T, typename Op>
__device__ __forceinline__ T tile_reduce(T v, Op op, T* sm) {
  const int x = threadIdx.x, y = threadIdx.y, tx = blockDim.x;
  sm[y * tx + x] = v;
  __syncthreads();
  for (int s = blockDim.y / 2; s > 0; s >>= 1) {
    if (y < s) sm[y * tx + x] = op(sm[y * tx + x], sm[(y + s) * tx + x]);
    __syncthreads();
  }
  const T r = sm[x];
  __syncthreads();
  return r;
}

// the cluster's tile totals (column x's in sm[x] of every CTA) combined in
// rank order
template <typename T, typename Op>
__device__ __forceinline__ T tile_cluster_reduce(Op op, T* sm) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  cl.sync();
  T r = *cl.map_shared_rank(sm + threadIdx.x, 0);
  for (unsigned k = 1; k < cl.num_blocks(); ++k)
    r = op(r, *cl.map_shared_rank(sm + threadIdx.x, k));
  cl.sync();
  return r;
}

// the sum of part[p0 * R], ..., part[(p1 - 1) * R] as a fixed tree (a binary
// counter: each term merges with the equal-sized subtrees before it, then the
// subtrees left fold from the newest)
template <typename A>
__device__ __forceinline__ A tree_sum(const A* part, long long p0, long long p1, long long R) {
  A st[48];
  int lv[48];
  int top = 0;
  for (long long p = p0; p < p1; ++p) {
    A v = part[p * R];
    int l = 0;
    while (top > 0 && lv[top - 1] == l) {
      v = st[--top] + v;
      ++l;
    }
    st[top] = v;
    lv[top++] = l;
  }
  if (top == 0) return A(0);
  A r = st[top - 1];
  for (int k = top - 2; k >= 0; --k) r = st[k] + r;
  return r;
}

// the column sums' partials, P rows of R, summed column by column: a CTA of
// (FINISH_X, FINISH_Y) threads a tile of FINISH_X columns, each of its
// FINISH_Y lanes a tree over its block of ceil(P / FINISH_Y) partials, the
// lanes then a tree (tile_reduce); rounded once to the output's type
constexpr int FINISH_X = 8;
constexpr int FINISH_Y = 32;
template <typename A, typename O>
__global__ void __launch_bounds__(FINISH_X * FINISH_Y) finish_columns(const A* part, long long P,
                                                                     long long R, O* out) {
  __shared__ A sm[FINISH_X * FINISH_Y];
  const long long c = static_cast<long long>(blockIdx.x) * FINISH_X + threadIdx.x;
  const long long q = (P + FINISH_Y - 1) / FINISH_Y;
  const long long p0 = threadIdx.y * q < P ? threadIdx.y * q : P;
  const long long p1 = p0 + q < P ? p0 + q : P;
  const A v = c < R ? tree_sum(part + (c < R ? c : 0), p0, p1, R) : A(0);
  const A t = tile_reduce(v, Sum(), sm);
  if (threadIdx.y == 0 && c < R) out[c] = store_as<O>(t);
}

}  // namespace ttr
