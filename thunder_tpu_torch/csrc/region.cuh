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
// row a reduction level (each pass recomputes what it needs from the
// inputs) and a last pass for what follows the last reduction. Each member
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

// -- reductions -------------------------------------------------------------

struct Sum {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
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

}  // namespace ttr
