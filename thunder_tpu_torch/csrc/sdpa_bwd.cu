// Flash-attention backward: (dq, dk, dv) from (dO, q, k, v, out, lse), with
// delta = rowsum(dO * O); the probabilities are recomputed from q, k and lse
// and never stored.
//
// g = dO, q and out (BH, T, hd); k, v (BH, S, hd); lse (BH, T) f32; all
// contiguous. dq, dk, dv in the inputs' type; delta is f32 scratch (BH, T).
// Causal masking is top-left aligned (row r attends columns c <= r).
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_sdpa_bwd (:537), whose
// bodies are the dq/dkv pair (_sdpa_dq_kernel :302, _sdpa_dkv_kernel :344,
// their resident-K/V causal variants :454 and :489) and the combined causal
// kernel (:388). Arithmetic follows them: S and P = exp(S - lse) in f32;
// dV += P^T dO with P rounded to the input type; dS = P * (dP - delta) * scale
// rounded to the input type before dQ += dS K and dK += dS^T Q; f32
// accumulators, one rounding of each gradient.
//
// Bound on an H100: operations. At the train path's shape (8, 32, 2048, 128)
// bf16 causal the five products (S, dP and the three gradients) need
// 10 * BH * T * S * hd / 2 = 687 GFLOP, 0.695 ms at 989 TFLOP/s, against
// 0.24 ms for the bytes (six (BH, T, hd) tensors read or written, three more
// written).
//
// Design (first version, right before fast): the TPU's dq/dkv split, with its
// sequential grid turned into loops inside a block, and no atomics, so the
// gradients are deterministic. Three kernels:
//   1. delta = rowsum(dO * O) in f32, one warp per row;
//   2. dK/dV: one block of 4 warps per (batch*head, 64-row kv tile) keeps its
//      K/V tile in shared memory and loops over 32-row q tiles from the
//      diagonal onwards (causal) or over all of them; each warp owns 16 kv
//      rows and keeps their dK/dV accumulators in registers;
//   3. dQ: one block per (batch*head, 64-row q tile) loops over 64-row kv
//      tiles up to the diagonal, the dQ accumulator in registers.
// All products are mma.sync m16n8k16 (bf16 or fp16 in, f32 accumulate; head
// dims multiples of 16 up to 256, a head dim off the multiples zero-padded
// by the wrapper, cudaex.sdpa_bwd) on operands
// staged in shared memory with 16-byte loads; the S/P/dS fragments become the
// next product's A operand in registers. S and dP are computed twice (once
// per kernel), as in the TPU's split. No load pipelining and no wgmma yet.
// float32 inputs take plain FMA kernels, one thread per row (head dims up to
// 256).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BKV = 64;   // kv rows per dK/dV block, per dQ-kernel tile
constexpr int BQD = 32;   // q rows per tile of the dK/dV kernel's loop
constexpr int BQ = 64;    // q rows per dQ block

template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ g, const T* __restrict__ o, float* __restrict__ delta,
             long long rows, int hd) {
  const long long r = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc += tt::to_f(g[r * hd + d]) * tt::to_f(o[r * hd + d]);
  acc = tt::warp_sum(acc);
  if (lane == 0) delta[r] = acc;
}

template <typename E, int HD>
__global__ void __launch_bounds__(THREADS)
sdpa_dkv_mma(const E* __restrict__ dO, const E* __restrict__ q,
             const E* __restrict__ k, const E* __restrict__ v,
             const float* __restrict__ lse, const float* __restrict__ delta,
             E* __restrict__ dk, E* __restrict__ dv, int T, int S,
             float scale, int causal) {
  constexpr int LD = HD + 8;
  constexpr int NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Ks = reinterpret_cast<E*>(smem_raw);
  E* Vs = Ks + BKV * LD;
  E* Qs = Vs + BKV * LD;
  E* Gs = Qs + BQD * LD;
  float* lse_s = reinterpret_cast<float*>(Gs + BQD * LD);
  float* delta_s = lse_s + BQD;

  const int n_kt = (S + BKV - 1) / BKV;
  const int kt = static_cast<int>(blockIdx.x % n_kt);   // causal: low tiles carry the most rows
  const size_t bh = blockIdx.x / n_kt;
  const int kv0 = kt * BKV;
  const E* qb = q + bh * T * HD;
  const E* gb = dO + bh * T * HD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int kvrow[2] = {kv0 + wr + g, kv0 + wr + g + 8};

  tt::stage_rows<HD>(Ks, LD, k + bh * S * HD, kv0, BKV, S);
  tt::stage_rows<HD>(Vs, LD, v + bh * S * HD, kv0, BKV, S);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int q_begin = causal ? (kv0 / BQD) * BQD : 0;
  for (int q0 = q_begin; q0 < T; q0 += BQD) {
    __syncthreads();   // every warp is done with the previous Q/dO tile
    tt::stage_rows<HD>(Qs, LD, qb, q0, BQD, T);
    tt::stage_rows<HD>(Gs, LD, gb, q0, BQD, T);
    if (threadIdx.x < BQD) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < T ? lse[bh * T + r] : 0.f;
      delta_s[threadIdx.x] = r < T ? delta[bh * T + r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 kv rows x 32 q columns
    float st[BQD / 8][4], dpt[BQD / 8][4];
#pragma unroll
    for (int j = 0; j < BQD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t ak[4], av[4];
      tt::load_a(ak, Ks, LD, wr, kk);
      tt::load_a(av, Vs, LD, wr, kk);
#pragma unroll
      for (int j = 0; j < BQD / 8; ++j) {
        const E* qp = Qs + (j * 8 + g) * LD + kk + 2 * t;
        const E* gp = Gs + (j * 8 + g) * LD + kk + 2 * t;
        tt::mma16<E>(st[j], ak, tt::ld_pair(qp), tt::ld_pair(qp + 8));
        tt::mma16<E>(dpt[j], av, tt::ld_pair(gp), tt::ld_pair(gp + 8));
      }
    }

    // P^T = exp(S^T * scale - lse), dS^T = P^T * (dP^T - delta) * scale
#pragma unroll
    for (int j = 0; j < BQD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);   // q row within the tile
        const int qr = q0 + qc, kr = kvrow[e >> 1];
        float p = 0.f;
        if (qr < T && kr < S && !(causal && kr > qr))
          p = expf(st[j][e] * scale - lse_s[qc]);
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - delta_s[qc]) * scale;
      }

    // dV += P^T dO and dK += dS^T Q; dO and Q are (q, d) row-major, read down a column
#pragma unroll
    for (int kk = 0; kk < BQD / 16; ++kk) {
      uint32_t ap[4], as[4];
      ap[0] = tt::pack2<E>(st[2 * kk][0], st[2 * kk][1]);
      ap[1] = tt::pack2<E>(st[2 * kk][2], st[2 * kk][3]);
      ap[2] = tt::pack2<E>(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      ap[3] = tt::pack2<E>(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      as[0] = tt::pack2<E>(dpt[2 * kk][0], dpt[2 * kk][1]);
      as[1] = tt::pack2<E>(dpt[2 * kk][2], dpt[2 * kk][3]);
      as[2] = tt::pack2<E>(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      as[3] = tt::pack2<E>(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
      const int r = (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const E* gc = Gs + r + n * 8;
        const E* qc = Qs + r + n * 8;
        tt::mma16<E>(dv_acc[n], ap, tt::pack2<E>(gc[0], gc[LD]),
                     tt::pack2<E>(gc[8 * LD], gc[9 * LD]));
        tt::mma16<E>(dk_acc[n], as, tt::pack2<E>(qc[0], qc[LD]),
                     tt::pack2<E>(qc[8 * LD], qc[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kvrow[r] >= S) continue;
    const size_t off = (bh * S + kvrow[r]) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * t) =
          tt::pack2<E>(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * t) =
          tt::pack2<E>(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <typename E, int HD>
__global__ void __launch_bounds__(THREADS)
sdpa_dq_mma(const E* __restrict__ dO, const E* __restrict__ q,
            const E* __restrict__ k, const E* __restrict__ v,
            const float* __restrict__ lse, const float* __restrict__ delta,
            E* __restrict__ dq, int T, int S, float scale, int causal) {
  constexpr int LD = HD + 8;
  constexpr int NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* Qs = reinterpret_cast<E*>(smem_raw);
  E* Gs = Qs + BQ * LD;
  E* Ks = Gs + BQ * LD;
  E* Vs = Ks + BKV * LD;

  const int n_qt = (T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);   // heaviest first
  const size_t bh = blockIdx.x / n_qt;
  const int q0 = qt * BQ;
  const E* kb = k + bh * S * HD;
  const E* vb = v + bh * S * HD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = row[r] < T ? lse[bh * T + row[r]] : 0.f;
    delta_r[r] = row[r] < T ? delta[bh * T + row[r]] : 0.f;
  }

  tt::stage_rows<HD>(Qs, LD, q + bh * T * HD, q0, BQ, T);
  tt::stage_rows<HD>(Gs, LD, dO + bh * T * HD, q0, BQ, T);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();
    tt::stage_rows<HD>(Ks, LD, kb, kv0, BKV, S);
    tt::stage_rows<HD>(Vs, LD, vb, kv0, BKV, S);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 kv columns
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t aq[4], ag[4];
      tt::load_a(aq, Qs, LD, wr, kk);
      tt::load_a(ag, Gs, LD, wr, kk);
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const E* kp = Ks + (j * 8 + g) * LD + kk + 2 * t;
        const E* vp = Vs + (j * 8 + g) * LD + kk + 2 * t;
        tt::mma16<E>(s[j], aq, tt::ld_pair(kp), tt::ld_pair(kp + 8));
        tt::mma16<E>(dp[j], ag, tt::ld_pair(vp), tt::ld_pair(vp + 8));
      }
    }

#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        float p = 0.f;
        if (row[r] < T && col < S && !(causal && col > row[r]))
          p = expf(s[j][e] * scale - lse_r[r]);
        s[j][e] = p * (dp[j][e] - delta_r[r]) * scale;   // dS
      }

    // dQ += dS K; K is (kv, d) row-major, read down a column
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = tt::pack2<E>(s[2 * kk][0], s[2 * kk][1]);
      a[1] = tt::pack2<E>(s[2 * kk][2], s[2 * kk][3]);
      a[2] = tt::pack2<E>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = tt::pack2<E>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const E* kp = Ks + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const E* c = kp + n * 8;
        tt::mma16<E>(acc[n], a, tt::pack2<E>(c[0], c[LD]),
                     tt::pack2<E>(c[8 * LD], c[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    E* o = dq + (bh * T + row[r]) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8 + 2 * t) =
          tt::pack2<E>(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// float32: dQ one thread per q row, dK/dV one thread per kv row.
__global__ void __launch_bounds__(64)
sdpa_dq_f32(const float* __restrict__ dO, const float* __restrict__ q,
            const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int T, int S, int hd, float scale, int causal) {
  const int n_t = (T + 63) / 64;
  const size_t bh = blockIdx.x / n_t;
  const int r = (blockIdx.x % n_t) * 64 + threadIdx.x;
  if (r >= T) return;
  const float* qr = q + (bh * T + r) * hd;
  const float* gr = dO + (bh * T + r) * hd;
  const float* kb = k + bh * S * hd;
  const float* vb = v + bh * S * hd;
  const float lr = lse[bh * T + r], dr = delta[bh * T + r];
  float acc[256];
  for (int d = 0; d < hd; ++d) acc[d] = 0.f;
  const int end = causal ? min(S, r + 1) : S;
  for (int c = 0; c < end; ++c) {
    const float* kc = kb + static_cast<size_t>(c) * hd;
    const float* vc = vb + static_cast<size_t>(c) * hd;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < hd; ++d) {
      s += qr[d] * kc[d];
      dp += gr[d] * vc[d];
    }
    const float p = expf(s * scale - lr);
    const float ds = p * (dp - dr) * scale;
    for (int d = 0; d < hd; ++d) acc[d] += ds * kc[d];
  }
  for (int d = 0; d < hd; ++d) dq[(bh * T + r) * hd + d] = acc[d];
}

__global__ void __launch_bounds__(64)
sdpa_dkv_f32(const float* __restrict__ dO, const float* __restrict__ q,
             const float* __restrict__ k, const float* __restrict__ v,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int T, int S, int hd, float scale,
             int causal) {
  const int n_t = (S + 63) / 64;
  const size_t bh = blockIdx.x / n_t;
  const int c = (blockIdx.x % n_t) * 64 + threadIdx.x;
  if (c >= S) return;
  const float* kc = k + (bh * S + c) * hd;
  const float* vc = v + (bh * S + c) * hd;
  float ak[256], av[256];
  for (int d = 0; d < hd; ++d) ak[d] = av[d] = 0.f;
  for (int r = causal ? c : 0; r < T; ++r) {
    const float* qr = q + (bh * T + r) * hd;
    const float* gr = dO + (bh * T + r) * hd;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < hd; ++d) {
      s += qr[d] * kc[d];
      dp += gr[d] * vc[d];
    }
    const float p = expf(s * scale - lse[bh * T + r]);
    const float ds = p * (dp - delta[bh * T + r]) * scale;
    for (int d = 0; d < hd; ++d) {
      av[d] += p * gr[d];
      ak[d] += ds * qr[d];
    }
  }
  for (int d = 0; d < hd; ++d) {
    dk[(bh * S + c) * hd + d] = ak[d];
    dv[(bh * S + c) * hd + d] = av[d];
  }
}

template <typename E, int HD>
cudaError_t launch_mma(const void* g, const void* q, const void* k, const void* v,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int BH,
                       int T, int S, float scale, int causal, cudaStream_t s) {
  constexpr int LDB = (HD + 8) * static_cast<int>(sizeof(E));
  const int smem_kv = 2 * BKV * LDB + 2 * BQD * LDB + 2 * BQD * static_cast<int>(sizeof(float));
  const int smem_q = 2 * BQ * LDB + 2 * BKV * LDB;
  cudaError_t err = cudaFuncSetAttribute(sdpa_dkv_mma<E, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sdpa_dq_mma<E, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q);
  if (err != cudaSuccess) return err;
  const unsigned kv_blocks = static_cast<unsigned>(BH) * ((S + BKV - 1) / BKV);
  sdpa_dkv_mma<E, HD><<<kv_blocks, THREADS, smem_kv, s>>>(
      static_cast<const E*>(g), static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), lse, delta, static_cast<E*>(dk), static_cast<E*>(dv), T, S,
      scale, causal);
  const unsigned q_blocks = static_cast<unsigned>(BH) * ((T + BQ - 1) / BQ);
  sdpa_dq_mma<E, HD><<<q_blocks, THREADS, smem_q, s>>>(
      static_cast<const E*>(g), static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), lse, delta, static_cast<E*>(dq), T, S, scale, causal);
  return cudaSuccess;
}

// delta, then the dK/dV and dQ kernels in E (bf16 or fp16) at head dim hd, a
// multiple of 16 up to 256
template <typename E>
cudaError_t launch16(const void* g, const void* q, const void* k, const void* v, const void* out,
                     const float* lse, float* delta, void* dq, void* dk, void* dv, int BH, int T,
                     int S, int hd, float scale, int causal, cudaStream_t s) {
  const long long rows = static_cast<long long>(BH) * T;
  delta_kernel<E><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const E*>(g), static_cast<const E*>(out), delta, rows, hd);
  switch (hd) {
#define TT_SDPA_BWD_CASE(H) \
  case H: return launch_mma<E, H>(g, q, k, v, lse, delta, dq, dk, dv, BH, T, S, scale, causal, s);
    TT_SDPA_BWD_CASE(16) TT_SDPA_BWD_CASE(32) TT_SDPA_BWD_CASE(48) TT_SDPA_BWD_CASE(64)
    TT_SDPA_BWD_CASE(80) TT_SDPA_BWD_CASE(96) TT_SDPA_BWD_CASE(112) TT_SDPA_BWD_CASE(128)
    TT_SDPA_BWD_CASE(144) TT_SDPA_BWD_CASE(160) TT_SDPA_BWD_CASE(176) TT_SDPA_BWD_CASE(192)
    TT_SDPA_BWD_CASE(208) TT_SDPA_BWD_CASE(224) TT_SDPA_BWD_CASE(240) TT_SDPA_BWD_CASE(256)
#undef TT_SDPA_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tt_sdpa_bwd(const void* g, const void* q, const void* k, const void* v,
                           const void* out, const void* lse, void* dq, void* dk, void* dv,
                           void* delta, int BH, int T, int S, int hd, float scale, int causal,
                           int dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (hd <= 0 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (BH <= 0 || T <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(BH) * T;
  const unsigned delta_blocks = static_cast<unsigned>((rows + 7) / 8);
  const float* L = static_cast<const float*>(lse);
  float* Dl = static_cast<float*>(delta);
  cudaError_t err = cudaSuccess;
  if (dtype == TT_BF16 || dtype == TT_F16) {
    err = dtype == TT_BF16
              ? launch16<__nv_bfloat16>(g, q, k, v, out, L, Dl, dq, dk, dv, BH, T, S, hd, scale,
                                        causal, s)
              : launch16<__half>(g, q, k, v, out, L, Dl, dq, dk, dv, BH, T, S, hd, scale, causal,
                                 s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    const float* G = static_cast<const float*>(g);
    const float* Q = static_cast<const float*>(q);
    const float* K = static_cast<const float*>(k);
    const float* V = static_cast<const float*>(v);
    delta_kernel<float><<<delta_blocks, 256, 0, s>>>(G, static_cast<const float*>(out), Dl, rows,
                                                     hd);
    const unsigned kv_blocks = static_cast<unsigned>(BH) * ((S + 63) / 64);
    sdpa_dkv_f32<<<kv_blocks, 64, 0, s>>>(G, Q, K, V, L, Dl, static_cast<float*>(dk),
                                          static_cast<float*>(dv), T, S, hd, scale, causal);
    const unsigned q_blocks = static_cast<unsigned>(BH) * ((T + 63) / 64);
    sdpa_dq_f32<<<q_blocks, 64, 0, s>>>(G, Q, K, V, L, Dl, static_cast<float*>(dq), T, S, hd,
                                        scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}
