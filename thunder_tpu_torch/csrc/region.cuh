// The shared header of the region executor's generated kernels
// (thunder_tpu_torch/executors/regionex.py): each region of a jit program
// is one kernel generated from its elementwise members, compiled with
// --fmad=false and without fast math. It replaces no Pallas kernel: it
// stands for the fusions the reference's XLA executor
// (thunder_tpu/executors/xla.py XLAFusionExecutor, :77) hands to XLA.
//
// Bound: bytes. A region reads each input once and writes each output once
// over its iteration space; every intermediate stays in a register. Design:
// one thread an element in a grid-stride loop, each member computed in the
// compute type torch's CUDA kernel uses (float32 for the 16-bit types) and
// rounded to its dtype after each member, as the op-by-op chain rounds.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ttr {

// a value rounded to bfloat16 / float16 and held in float32
__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rnd_f16(float x) { return __half2float(__float2half_rn(x)); }

}  // namespace ttr
