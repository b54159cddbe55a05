// Flash-attention forward: out = softmax(q k^T * scale [causal]) v and the row
// logsumexp lse, the flash-attention forward contract.
//
// q (BH, T, hd), k and v (BH, S, hd), contiguous, the same batch*heads; out
// (BH, T, hd) in q's type, lse (BH, T) f32. Causal masking is top-left
// aligned: row r attends columns c <= r (ops.tril_mask(T, S, 0)).
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_sdpa_fwd (:214), whose
// bodies are _sdpa_kernel (:98) and _sdpa_kernel_causal_resident (:173).
// Arithmetic follows them: scores and the online-softmax state (running max
// m, sum l, accumulator) in f32; P is rounded to the input type before the PV
// product (:139), while l sums the unrounded f32 P; rows whose l is 0 divide
// by 1 (lsafe, :147); lse = m + log(lsafe).
//
// Bound on an H100: operations. At the train path's shape (8, 32, 2048, 128)
// bf16 causal the two products need 4 * BH * T * S * hd / 2 = 275 GFLOP,
// 0.278 ms at 989 TFLOP/s, against 0.16 ms for its 537 MB of bytes.
//
// Design (first version, right before fast): the TPU walks kv tiles as a
// sequential grid dimension (or keeps all of Q/K/V resident in VMEM); Hopper
// has neither, so one block of 4 warps owns a 64-row q tile of one batch*head
// and loops over 64-row kv tiles inside the block. Each warp owns 16 q rows.
// Q, K and V tiles are staged in shared memory with 16-byte loads; QK^T and PV
// run on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), and
// the online-softmax state and the accumulator stay in registers, laid out as
// mma fragments, so the S fragments turn into the PV product's A operand
// without a trip through shared memory. Causal: the kv loop stops at the
// diagonal (the resident TPU variant's triangle skip), and q tiles are
// scheduled heaviest first. Loads and products do not overlap yet (no
// cp.async/TMA ring) and the products are mma.sync rather than wgmma: that is
// the later work. float32 inputs take a plain FMA kernel, one thread per q row.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;    // q rows per block (16 per warp)
constexpr int BKV = 64;   // kv rows per tile
constexpr int THREADS = 128;

template <int HD>
__global__ void __launch_bounds__(THREADS)
sdpa_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
             float* __restrict__ lse, int T, int S, float scale, int causal) {
  constexpr int LD = HD + 8;   // bf16 row stride in shared memory (conflict-free fragments)
  constexpr int NT = HD / 8;   // 8-column tiles of the accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BKV * LD;

  const int n_qt = (T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);   // heaviest first
  const size_t bh = blockIdx.x / n_qt;
  const int q0 = qt * BQ;
  const __nv_bfloat16* qb = q + bh * T * HD;
  const __nv_bfloat16* kb = k + bh * S * HD;
  const __nv_bfloat16* vb = v + bh * S * HD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;                  // the warp's first row in the tile
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};

  tt::stage_rows<HD>(Qs, LD, qb, q0, BQ, T);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();   // every warp is done with the previous K/V tile
    tt::stage_rows<HD>(Ks, LD, kb, kv0, BKV, S);
    tt::stage_rows<HD>(Vs, LD, vb, kv0, BKV, S);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 columns
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      tt::load_a(a, Qs, LD, wr, kk);
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const __nv_bfloat16* kp = Ks + (j * 8 + g) * LD + kk + 2 * t;
        tt::mma_bf16(s[j], a, tt::ld_pair(kp), tt::ld_pair(kp + 8));
      }
    }

    // scale, mask, online softmax; a row's 64 columns live in the 4 threads of a quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (col >= S || (causal && col > row[e >> 1])) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;   // a row masked so far stays at p = 0
      alpha[r] = expf(m[r] - base[r]);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - base[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V, P rounded to bf16; V is (kv, d) row-major, read down a column
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = tt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = tt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = tt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = tt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* c = vp + n * 8;
        tt::mma_bf16(acc[n], a, tt::pack_bf16(c[0], c[LD]),
                     tt::pack_bf16(c[8 * LD], c[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    const float lsafe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = out + (bh * T + row[r]) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          tt::pack_bf16(acc[n][2 * r] / lsafe, acc[n][2 * r + 1] / lsafe);
    if (t == 0) lse[bh * T + row[r]] = m[r] + logf(lsafe);
  }
}

// float32: one thread per q row, the online softmax over every allowed key.
__global__ void __launch_bounds__(64)
sdpa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
             int T, int S, int hd, float scale, int causal) {
  const int n_qt = (T + 63) / 64;
  const size_t bh = blockIdx.x / n_qt;
  const int r = (blockIdx.x % n_qt) * 64 + threadIdx.x;
  if (r >= T) return;
  const float* qr = q + (bh * T + r) * hd;
  const float* kb = k + bh * S * hd;
  const float* vb = v + bh * S * hd;
  float acc[128];
  for (int d = 0; d < hd; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int end = causal ? min(S, r + 1) : S;
  for (int c = 0; c < end; ++c) {
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s += qr[d] * kb[static_cast<size_t>(c) * hd + d];
    s *= scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
    for (int d = 0; d < hd; ++d) acc[d] = acc[d] * alpha + p * vb[static_cast<size_t>(c) * hd + d];
    m = m_new;
  }
  const float lsafe = l == 0.f ? 1.f : l;
  for (int d = 0; d < hd; ++d) out[(bh * T + r) * hd + d] = acc[d] / lsafe;
  lse[bh * T + r] = m + logf(lsafe);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                       int T, int S, float scale, int causal, cudaStream_t s) {
  const int smem = (BQ + 2 * BKV) * (HD + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(sdpa_fwd_mma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(BH) * ((T + BQ - 1) / BQ);
  sdpa_fwd_mma<HD><<<blocks, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), T, S, scale, causal);
  return cudaSuccess;
}

}  // namespace

extern "C" int tt_sdpa_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                           int BH, int T, int S, int hd, float scale, int causal, int dtype,
                           int device, void* stream) {
  cudaSetDevice(device);
  if (BH > 0 && T > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    if (dtype == TT_BF16) {
      switch (hd) {
        case 16: err = launch_mma<16>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        case 32: err = launch_mma<32>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        case 48: err = launch_mma<48>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        case 64: err = launch_mma<64>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        case 80: err = launch_mma<80>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        case 96: err = launch_mma<96>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        case 112: err = launch_mma<112>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        case 128: err = launch_mma<128>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
    } else {
      const unsigned blocks = static_cast<unsigned>(BH) * ((T + 63) / 64);
      sdpa_fwd_f32<<<blocks, 64, 0, s>>>(static_cast<const float*>(q),
                                         static_cast<const float*>(k),
                                         static_cast<const float*>(v), static_cast<float*>(out),
                                         static_cast<float*>(lse), T, S, hd, scale, causal);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
