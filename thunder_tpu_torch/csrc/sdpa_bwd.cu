// Flash-attention backward: (dq, dk, dv) from (dO, q, k, v, out, lse), with
// delta = rowsum(dO * O); the probabilities are recomputed from q, k and lse
// and never stored.
//
// g = dO, q and out (BH, T, hd); k, v (BH, S, hd); lse (BH, T) f32; all
// contiguous. dq, dk, dv in the inputs' type; delta is f32 scratch of
// 2 * BH * Tp values, Tp = T rounded up to 128 (the fma and mma designs use
// its first BH * T).
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
// written). That is the row's bound. The designs below keep the TPU's
// dq/dkv split, so they compute S and dP twice: 7 products, 962 GFLOP, a
// floor of 0.973 ms at the same rate.
//
// Deterministic: no atomics. Each gradient row is written once, in f32
// rounded to the input type, by the one block that owns it; a block loops
// over the other side's tiles where the TPU's grid was sequential.
//
// Three designs, chosen by the wrapper (cudaex.sdpa_bwd_design) from the
// dtype and the head dim alone and passed in as `design`:
//
// 2 wgmma (bf16 or fp16, hd 64 and 128: llama3-8b's and the TPU checker's
//   head dims). Three launches:
//   1. prep: delta = rowsum(dO * O) in f32 with 16-byte loads (HD / 8
//      threads a row), written with lse * log2(e) into a (BH, Tp) scratch
//      whose rows are padded to Tp = T rounded up to 128: delta 0 and lse
//      +inf there, so a q row past T gets P = exp2(s - inf) = 0 with no mask;
//   2. dK/dV: one block of three warpgroups per (batch*head, 64-row kv
//      tile). Warpgroup 0 is the producer (setmaxnreg 24): one thread
//      streams 64-row (Q, dO) tiles by TMA, with the step's lse and delta as
//      256-byte bulk copies on the same full barrier, through a 4-stage ring
//      with full/empty mbarriers. The two consumer warpgroups (setmaxnreg
//      240) share the 64 kv rows and split the work by gradient, so that
//      each holds one 64 x hd f32 accumulator (hd / 2 registers a thread),
//      one 64 x 64 score tile and its K or V rows as A fragments, read once
//      from device memory: warpgroup 1 computes S^T = K Q^T (wgmma
//      m64n64k16, A from registers, Q K-major from 128-byte-swizzled shared
//      memory), P^T = exp2(S^T * scale * log2(e) - lse * log2(e)) in f32 on
//      the special-function unit, hands P^T to warpgroup 2 through shared
//      memory (float4 per thread, a named barrier per ring stage), and runs
//      dV += P^T dO with P^T rounded to the input type as A and dO read
//      MN-major as stored (the transpose bit; the forward's O += P V);
//      warpgroup 2 computes dP^T = V dO^T the same way, dS^T = P^T * (dP^T -
//      delta) * scale rounded to the input type, and dK += dS^T Q. Causal:
//      the q loop starts at the diagonal and the mask is applied only on
//      steps that cross it or the ragged end S; a kv tile that no q row
//      reaches (causal, kv0 >= T) stores zeros;
//   3. dQ: one block per (batch*head, 128-row q tile), heaviest first: Q
//      and dO resident, 64-row (K, V) tiles streamed through the ring; per
//      consumer warpgroup (64 q rows) S = Q K^T and dP = dO V^T (wgmma_ss,
//      two commit groups, so that P is computed while dP runs), dS in
//      registers, dQ += dS K (wgmma_rs, K MN-major); the kv loop stops at
//      the diagonal.
//   Both walk the grid eight heads at a time, tiles in order within them,
//   so that the blocks in flight share their streamed operands in L2. The
//   TMA maps are 3-D over (hd, rows, BH), so a tile past a head's rows is
//   zero-filled and never reads the next head's. Shared memory at hd 128:
//   dK/dV 4 x (Q + dO 32 KB + P 16 KB); dQ Q + dO 64 KB + 4 x (K + V) 32 KB;
//   one block per SM. Why the dK/dV split: the first version held dK and
//   dV in one warpgroup (128 kv rows a block), ~250 live registers a
//   thread, more than ptxas allocated to the consumers: it spilled them and
//   serialised the wgmma (its C7512 warning). What is left for later: one
//   pass that computes S and dP once (5 products) with an ordered,
//   deterministic dQ reduction across kv blocks, FA3's ping-pong of the
//   softmax with the products inside a warpgroup, and a persistent grid.
//
// 1 mma (bf16 or fp16, other head dims: multiples of 16 up to 256, the first
//   version; a head dim off the multiples of 16 is zero-padded by the
//   wrapper, cudaex.sdpa_bwd). Three kernels:
//   1. delta = rowsum(dO * O) in f32, one warp per row;
//   2. dK/dV: one block of 4 warps per (batch*head, 64-row kv tile) keeps its
//      K/V tile in shared memory and loops over 32-row q tiles from the
//      diagonal onwards (causal) or over all of them; each warp owns 16 kv
//      rows and keeps their dK/dV accumulators in registers;
//   3. dQ: one block per (batch*head, 64-row q tile) loops over 64-row kv
//      tiles up to the diagonal, the dQ accumulator in registers.
//   All products are mma.sync m16n8k16 on operands staged in shared memory
//   with 16-byte loads; the S/P/dS fragments become the next product's A
//   operand in registers. Loads and products do not overlap.
//
// 0 fma (float32, head dims up to 256): plain FMA kernels, one thread per
//   row.
#include <math.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// The wgmma design, on the Hopper primitives of hopper.cuh.
// ---------------------------------------------------------------------------

using namespace tt::hopper;

constexpr int WG_THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int WG_STAGES = 4;        // ring depth
constexpr int WG_PAD = 128;         // the prep scratch's rows are padded to a multiple of this
constexpr int BOX_COLS = 64;        // 16-bit columns of one 128-byte-swizzled TMA box
constexpr int BOX_ROW = 128;        // bytes of one box row
constexpr float kLog2e = 1.4426950408889634f;
constexpr int DKV_ROWS = 64;        // kv rows a dK/dV block owns (both consumers)
constexpr int DKV_STEP = 64;        // q rows of its streamed steps
constexpr int DQ_ROWS = 128;        // q rows a dQ block owns, 64 per consumer
constexpr int DQ_STEP = 64;         // kv rows of its streamed steps

// The thread's role: -1 for the producer warpgroup, else its consumer
// warpgroup (0 or 1). Read from lane 0 so that the compiler sees one value
// for the whole warp.
__device__ __forceinline__ int role() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0) - 1;
}

// Byte offsets of the dK/dV block's shared memory (1024-aligned tiles): per
// ring stage the Q and dO tiles of DKV_STEP rows, P^T (64 x DKV_STEP f32)
// and the step's lse and delta; K and V live in registers
template <int HD>
struct DkvLayout {
  static constexpr int STEP_BOX = DKV_STEP * BOX_ROW;   // one 64-column box of a tile
  static constexpr int TILE = DKV_STEP * HD * 2;
  static constexpr int SA = 0;                          // + stage * TILE: Q
  static constexpr int SB = SA + WG_STAGES * TILE;      // + stage * TILE: dO
  static constexpr int P_STAGE = DKV_ROWS * DKV_STEP * 4;
  static constexpr int P = SB + WG_STAGES * TILE;       // + stage * P_STAGE
  static constexpr int ROWS = P + WG_STAGES * P_STAGE;  // + stage * 8 DKV_STEP: lse, delta
  static constexpr int BAR = ROWS + WG_STAGES * 8 * DKV_STEP;   // full[], empty[]
  static constexpr int BYTES = BAR + 8 * 2 * WG_STAGES + 1024;  // + alignment slack
};

// Byte offsets of the dQ block's shared memory: the resident Q and dO tiles
// of DQ_ROWS rows, and per ring stage the K and V tiles of DQ_STEP rows
template <int HD>
struct DqLayout {
  static constexpr int RES_BOX = DQ_ROWS * BOX_ROW;     // one 64-column box of Q or dO
  static constexpr int STEP_BOX = DQ_STEP * BOX_ROW;    // one 64-column box of K or V
  static constexpr int RES = DQ_ROWS * HD * 2;
  static constexpr int TILE = DQ_STEP * HD * 2;
  static constexpr int A = 0, B = RES;                  // Q, dO
  static constexpr int SA = 2 * RES;                    // + stage * TILE: K
  static constexpr int SB = SA + WG_STAGES * TILE;      // + stage * TILE: V
  static constexpr int BAR = SB + WG_STAGES * TILE;     // res_full, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * WG_STAGES) + 1024;   // + alignment slack
};

// delta = rowsum(dO * O) and lse * log2(e) into the padded scratch, HD / 8
// threads a row with 16-byte loads; rows [T, Tp) get delta 0 and lse +inf.
// The grid covers BH * Tp rows exactly (Tp a multiple of 128), so every
// group of HD / 8 threads is whole for its shuffles.
template <typename TE, int HD>
__global__ void __launch_bounds__(256)
delta_kernel_padded(const TE* __restrict__ g, const TE* __restrict__ o,
                    const float* __restrict__ lse, float* __restrict__ delta_p,
                    float* __restrict__ lse2_p, int T, int Tp) {
  constexpr int TPR = HD / 8;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long r = idx / TPR;
  const int sub = static_cast<int>(idx % TPR);
  const long long bh = r / Tp;
  const int t = static_cast<int>(r % Tp);
  float acc = 0.f;
  if (t < T) {
    const size_t off = (static_cast<size_t>(bh) * T + t) * HD + sub * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(g + off);
    const uint4 b = *reinterpret_cast<const uint4*>(o + off);
    const TE* av = reinterpret_cast<const TE*>(&a);
    const TE* bv = reinterpret_cast<const TE*>(&b);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += tt::to_f(av[e]) * tt::to_f(bv[e]);
  }
#pragma unroll
  for (int w = TPR / 2; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (sub == 0) {
    delta_p[r] = acc;
    lse2_p[r] = t < T ? lse[bh * T + t] * kLog2e : INFINITY;
  }
}

// `a` hidden from the compiler at this point: a descriptor built from it is
// computed where it is used, between two wgmma issues, rather than all of
// them ahead of the loop and held in registers
__device__ __forceinline__ uint32_t opaque(uint32_t a) {
  asm volatile("" : "+r"(a));
  return a;
}

// the K-major descriptor of 16-deep k step kk of a tile's rows starting at
// `rows` (boxes of box_bytes), and the MN-major one of k rows [16 kk, 16 kk +
// 16) of a tile of box_bytes boxes
__device__ __forceinline__ uint64_t kmajor(uint32_t rows, int kk, int box_bytes) {
  return desc_sw128(opaque(rows) + (kk / 4) * box_bytes + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk, int box_bytes) {
  return desc_sw128(opaque(tile) + kk * 16 * BOX_ROW, box_bytes, 1024);
}

// Issue D (64 x N) = A B^T over HD (16-deep steps), both operands K-major in
// shared memory: the first-stage products S = Q K^T, S^T = K Q^T and so on.
// The caller fences, commits and waits.
template <typename TE, int HD, int N>
__device__ __forceinline__ void ss_product(float (&d)[N], uint32_t a_rows, int a_box,
                                           uint32_t b_rows, int b_box) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<TE, 0, 0>(d, kmajor(a_rows, kk, a_box), kmajor(b_rows, kk, b_box), kk > 0);
}

// Issue D (64 x HD) += A B over K (16-deep steps): A the fragments in
// registers, B a K x HD tile read MN-major as stored: the second-stage
// products. The caller fences, commits and waits.
template <typename TE, int K, int N>
__device__ __forceinline__ void rs_product(float (&d)[N], const uint32_t (&a)[K / 16][4],
                                           uint32_t b_tile, int b_box) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) wgmma_rs<TE, 1>(d, a[kk], mnmajor(b_tile, kk, b_box));
}

// Issue D (64 x N) = A B^T over HD with A in registers (fragments of the
// warpgroup's 64 rows) and B's N rows K-major in shared memory. wgmma_rs
// accumulates, so D is zeroed first. The caller fences, commits and waits.
template <typename TE, int HD, int N>
__device__ __forceinline__ void rs_first(float (&d)[N], const uint32_t (&a)[HD / 16][4],
                                         uint32_t b_rows, int b_box) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs<TE, 0>(d, a[kk], kmajor(b_rows, kk, b_box));
}

// an f32 accumulator rounded to TE: two neighbouring 8-column groups of it
// are the A fragment of one 16-deep step of the next product
template <typename TE, int N>
__device__ __forceinline__ void frags(const float (&x)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = tt::pack2<TE>(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// f32 accumulator rows [row0, row0 + 8) of a warpgroup's 64, rounded to TE,
// into rows of a (rows, HD) matrix; rows at or past n_rows are not stored
template <typename TE, int HD>
__device__ __forceinline__ void store_rows(TE* __restrict__ dst, const float (&acc)[HD / 2],
                                           int row0, int n_rows, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n_rows) continue;
    TE* p = dst + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + n * 8 + 2 * t) =
          tt::pack2<TE>(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
  }
}

// The (batch*head, tile) of block `blk` when BH heads of n_t tiles each are
// walked HEAD_GROUP heads at a time, tiles in order within a group: the
// blocks in flight together then share a few heads' streamed operands in
// L2 instead of reading each from device memory on their own
constexpr int HEAD_GROUP = 8;

__device__ __forceinline__ void grouped_tile(int blk, int BH, int n_t, int& bh, int& tile) {
  const int group = blk / (HEAD_GROUP * n_t);
  const int heads = min(HEAD_GROUP, BH - group * HEAD_GROUP);
  const int rem = blk - group * HEAD_GROUP * n_t;
  tile = rem / heads;
  bh = group * HEAD_GROUP + rem % heads;
}

// 2^x by the special-function unit (ex2.approx.ftz: about 2 ulp, 2^-inf =
// 0); exp2f's accurate path was the dK/dV kernel's largest elementwise cost
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// named barriers 1 + s: P of ring stage s written (warpgroup 0 arrives,
// warpgroup 1 waits)
__device__ __forceinline__ void p_ready_arrive(int s) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + s) : "memory");
}
__device__ __forceinline__ void p_ready_wait(int s) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + s) : "memory");
}

// dK/dV: the block's 64 kv rows of K and V held in registers as A fragments
// of the first-stage products, (Q, dO, lse, delta) streamed in DKV_STEP-row
// q steps. Warpgroup 0: S^T = K Q^T, P^T (to shared memory for warpgroup 1),
// dV += P^T dO. Warpgroup 1: dP^T = V dO^T, dS^T from P^T, dK += dS^T Q.
template <typename TE, int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
sdpa_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
               const TE* __restrict__ k, const TE* __restrict__ v,
               const float* __restrict__ lse2_p, const float* __restrict__ delta_p,
               TE* __restrict__ dk, TE* __restrict__ dv, int BH, int T, int S, int Tp,
               float scale, float scale_log2, int causal) {
  static_assert(HD == 64 || HD == 128, "the wgmma design takes head dims 64 and 128");
  constexpr int Q = DKV_STEP;
  constexpr int NA = Q / 2;   // a thread's values of a 64 x Q accumulator
  using L = DkvLayout<HD>;
  constexpr int BOXES = HD / BOX_COLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + L::BAR;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (WG_STAGES + s); };

  int bh, kt;   // low kv tiles first within a head group: under causal the heaviest
  grouped_tile(static_cast<int>(blockIdx.x), BH, (S + DKV_ROWS - 1) / DKV_ROWS, bh, kt);
  const int kv0 = kt * DKV_ROWS;
  const int q_begin = causal ? kv0 : 0;   // a multiple of Q: the first step holds the diagonal
  const int n_q = T > q_begin ? (T - q_begin + Q - 1) / Q : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int c = role();
  if (c < 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      for (int j = 0; j < n_q; ++j) {
        const int s = j % WG_STAGES;
        const int q0 = q_begin + j * Q;
        if (j >= WG_STAGES) mbar_wait(empty(s), ((j / WG_STAGES) - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::TILE + 8 * Q);
        for (int b = 0; b < BOXES; ++b) {
          tma_load_3d(base + L::SA + s * L::TILE + b * L::STEP_BOX, &tq, full(s),
                      b * BOX_COLS, q0, bh);
          tma_load_3d(base + L::SB + s * L::TILE + b * L::STEP_BOX, &tg, full(s),
                      b * BOX_COLS, q0, bh);
        }
        const size_t row = static_cast<size_t>(bh) * Tp + q0;
        bulk_load(base + L::ROWS + s * 8 * Q, lse2_p + row, 4 * Q, full(s));
        bulk_load(base + L::ROWS + s * 8 * Q + 4 * Q, delta_p + row, 4 * Q, full(s));
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    const int row0 = kv0 + 16 * warp + g;   // the thread's kv rows: row0, row0 + 8
    // the first-stage product's A: K (warpgroup 0) or V (warpgroup 1) rows
    // row0 and row0 + 8, k columns 2t, 2t + 1 (+ 8) of each 16-deep step, as
    // stored; rows past S are zeros. Read once: the rows do not change
    // across the q loop, and from registers the product reads only B from
    // shared memory
    uint32_t ka[HD / 16][4];
    {
      const TE* src = (c == 0 ? k : v) + static_cast<size_t>(bh) * S * HD;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + 8 * (e & 1);
          ka[kk][e] = r < S ? tt::ld_pair(src + static_cast<size_t>(r) * HD + 16 * kk + 2 * t +
                                          8 * (e >> 1))
                            : 0u;
        }
    }
    // warpgroup 0 reads Q in its first product and dO in its second;
    // warpgroup 1 the other way round
    const int first = c == 0 ? L::SA : L::SB, second = c == 0 ? L::SB : L::SA;

    float acc[HD / 2];   // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    for (int j = 0; j < n_q; ++j) {
      const int s = j % WG_STAGES;
      const int q0 = q_begin + j * Q;
      mbar_wait(full(s), (j / WG_STAGES) & 1);
      const float* rows_s = reinterpret_cast<const float*>(smem + L::ROWS + s * 8 * Q);

      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1): 64 kv rows x Q
      float x[NA];
      rs_first<TE, HD>(x, ka, base + first + s * L::TILE, L::STEP_BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      // element i = 4 m + e of the accumulator: kv row row0 + 8 (e >> 1), q
      // column q0 + 8 m + 2 t + (e & 1). P^T travels as f32 through shared
      // memory, thread by thread: float4 m of thread tid at pv[128 m + tid]
      float4* pv = reinterpret_cast<float4*>(smem + L::P + s * L::P_STAGE) + tid;
      if (c == 0) {
        // P^T = exp2(S^T scale log2 e - lse log2 e), zero where masked (the
        // step crosses the diagonal or the ragged end S)
        const bool edge = (causal && q0 < kv0 + DKV_ROWS - 1) || kv0 + DKV_ROWS > S;
#pragma unroll
        for (int m = 0; m < NA / 4; ++m) {
          const float2 l2 = *reinterpret_cast<const float2*>(rows_s + 8 * m + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * m + e;
            float p = ex2(x[i] * scale_log2 - ((e & 1) ? l2.y : l2.x));
            const int kr = row0 + 8 * (e >> 1), qc = q0 + 8 * m + 2 * t + (e & 1);
            if (edge && (kr >= S || (causal && kr > qc))) p = 0.f;
            x[i] = p;
          }
          pv[128 * m] = make_float4(x[4 * m], x[4 * m + 1], x[4 * m + 2], x[4 * m + 3]);
        }
        p_ready_arrive(s);
      } else {
        // dS^T = P^T (dP^T - delta) scale
        p_ready_wait(s);
#pragma unroll
        for (int m = 0; m < NA / 4; ++m) {
          const float2 d2 = *reinterpret_cast<const float2*>(rows_s + Q + 8 * m + 2 * t);
          const float4 p = pv[128 * m];
          x[4 * m] = p.x * (x[4 * m] - d2.x) * scale;
          x[4 * m + 1] = p.y * (x[4 * m + 1] - d2.y) * scale;
          x[4 * m + 2] = p.z * (x[4 * m + 2] - d2.x) * scale;
          x[4 * m + 3] = p.w * (x[4 * m + 3] - d2.y) * scale;
        }
      }

      // dV += P^T dO or dK += dS^T Q: x rounded to TE as A, the tile MN-major
      uint32_t a[Q / 16][4];
      frags<TE>(x, a);
      fence_regs(acc);
      wgmma_fence();
      rs_product<TE, Q>(acc, a, base + second + s * L::TILE, L::STEP_BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }

    store_rows<TE, HD>((c == 0 ? dv : dk) + static_cast<size_t>(bh) * S * HD, acc, row0, S, t);
  }
}

// dQ: Q and dO resident (128 q rows), (K, V) streamed in DQ_STEP-row kv steps
template <typename TE, int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
sdpa_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
              const float* __restrict__ lse2_p, const float* __restrict__ delta_p,
              TE* __restrict__ dq, int BH, int T, int S, int Tp, float scale, float scale_log2,
              int causal) {
  static_assert(HD == 64 || HD == 128, "the wgmma design takes head dims 64 and 128");
  constexpr int K = DQ_STEP;
  constexpr int NA = K / 2;
  using L = DqLayout<HD>;
  constexpr int BOXES = HD / BOX_COLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t res_full = base + L::BAR;
  const auto full = [&](int s) { return res_full + 8 * (1 + s); };
  const auto empty = [&](int s) { return res_full + 8 * (1 + WG_STAGES + s); };

  const int n_qt = (T + DQ_ROWS - 1) / DQ_ROWS;
  int bh, qt;   // high q tiles first within a head group: under causal the heaviest
  grouped_tile(static_cast<int>(blockIdx.x), BH, n_qt, bh, qt);
  qt = n_qt - 1 - qt;
  const int q0 = qt * DQ_ROWS;
  const int kv_end = causal ? min(S, q0 + DQ_ROWS) : S;
  const int n_kv = (kv_end + K - 1) / K;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int c = role();
  if (c < 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(res_full, 2 * L::RES);
      for (int b = 0; b < BOXES; ++b) {
        tma_load_3d(base + L::A + b * L::RES_BOX, &tq, res_full, b * BOX_COLS, q0, bh);
        tma_load_3d(base + L::B + b * L::RES_BOX, &tg, res_full, b * BOX_COLS, q0, bh);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % WG_STAGES;
        if (j >= WG_STAGES) mbar_wait(empty(s), ((j / WG_STAGES) - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::TILE);
        for (int b = 0; b < BOXES; ++b) {
          tma_load_3d(base + L::SA + s * L::TILE + b * L::STEP_BOX, &tk, full(s),
                      b * BOX_COLS, j * K, bh);
          tma_load_3d(base + L::SB + s * L::TILE + b * L::STEP_BOX, &tv, full(s),
                      b * BOX_COLS, j * K, bh);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    const int qc0 = q0 + 64 * c;                  // the warpgroup's first q row
    const int row0 = qc0 + 16 * warp + g;         // the thread's q rows: row0, row0 + 8
    const uint32_t q_rows = base + L::A + 64 * c * BOX_ROW;
    const uint32_t g_rows = base + L::B + 64 * c * BOX_ROW;
    // the padded scratch holds every row below q0 + 128 <= Tp
    float lse2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = lse2_p[static_cast<size_t>(bh) * Tp + row0 + 8 * r];
      delta[r] = delta_p[static_cast<size_t>(bh) * Tp + row0 + 8 * r];
    }

    float dq_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;

    mbar_wait(res_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % WG_STAGES;
      const int kv0 = j * K;
      mbar_wait(full(s), (j / WG_STAGES) & 1);
      if (causal && kv0 > qc0 + 63) {   // past the diagonal of every row of the warpgroup
        mbar_arrive(empty(s));
        continue;
      }
      const uint32_t k_tile = base + L::SA + s * L::TILE, v_tile = base + L::SB + s * L::TILE;

      // S = Q K^T and dP = dO V^T: 64 q rows x K kv columns each, f32, as
      // two groups, so that P is computed while dP runs
      float sc[NA], dp[NA];
      wgmma_fence();
      ss_product<TE, HD>(sc, q_rows, L::RES_BOX, k_tile, L::STEP_BOX);
      wgmma_commit();
      ss_product<TE, HD>(dp, g_rows, L::RES_BOX, v_tile, L::STEP_BOX);
      wgmma_commit();

      // element i: q row row0 + 8 ((i >> 1) & 1), kv column kv0 + 8 (i >> 2) + 2 t + (i & 1);
      // P = exp2(S scale log2 e - lse log2 e), zero where masked (the tile
      // crosses the diagonal or the ragged end S); dS = P (dP - delta) scale
      const bool edge = (causal && kv0 + K - 1 > qc0) || kv0 + K > S;
      wgmma_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int r = (i >> 1) & 1;
        const int cl = kv0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const float p = ex2(sc[i] * scale_log2 - lse2[r]);
        sc[i] = edge && (cl >= S || (causal && cl > row0 + 8 * r)) ? 0.f : p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < NA; ++i) dp[i] = sc[i] * (dp[i] - delta[(i >> 1) & 1]) * scale;
      uint32_t da[K / 16][4];
      frags<TE>(dp, da);

      // dQ += dS K, K MN-major as stored
      fence_regs(dq_acc);
      wgmma_fence();
      rs_product<TE, K>(dq_acc, da, k_tile, L::STEP_BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      mbar_arrive(empty(s));
    }

    store_rows<TE, HD>(dq + static_cast<size_t>(bh) * T * HD, dq_acc, row0, T, t);
  }
}

// prep, dK/dV and dQ in TE (bf16 or fp16) at head dim HD (64 or 128)
template <typename TE, int HD>
cudaError_t launch_wgmma(const void* g, const void* q, const void* k, const void* v,
                         const void* out, const float* lse, float* scratch, void* dq, void* dk,
                         void* dv, int BH, int T, int S, float scale, int causal, cudaStream_t s) {
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  // Q and dO in DKV_STEP-row boxes (streamed in dK/dV) and DQ_ROWS-row ones
  // (resident in dQ); K and V in DQ_STEP-row boxes (streamed in dQ)
  CUtensorMap q_step, g_step, q_res, g_res, k_step, v_step;
  if (!map_heads<TE>(&q_step, q, BH, T, HD, DKV_STEP) ||
      !map_heads<TE>(&g_step, g, BH, T, HD, DKV_STEP) ||
      !map_heads<TE>(&q_res, q, BH, T, HD, DQ_ROWS) ||
      !map_heads<TE>(&g_res, g, BH, T, HD, DQ_ROWS) ||
      !map_heads<TE>(&k_step, k, BH, S, HD, DQ_STEP) ||
      !map_heads<TE>(&v_step, v, BH, S, HD, DQ_STEP))
    return cudaErrorInvalidValue;
  constexpr int smem_kv = DkvLayout<HD>::BYTES;
  constexpr int smem_q = DqLayout<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(sdpa_dkv_wgmma<TE, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sdpa_dq_wgmma<TE, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  const int Tp = (T + WG_PAD - 1) / WG_PAD * WG_PAD;
  float* delta_p = scratch;
  float* lse2_p = scratch + static_cast<size_t>(BH) * Tp;
  const long long prep_threads = static_cast<long long>(BH) * Tp * (HD / 8);
  delta_kernel_padded<TE, HD><<<static_cast<unsigned>(prep_threads / 256), 256, 0, s>>>(
      static_cast<const TE*>(g), static_cast<const TE*>(out), lse, delta_p, lse2_p, T, Tp);
  const float scale_log2 = scale * kLog2e;
  const unsigned kv_blocks = static_cast<unsigned>(BH) * ((S + DKV_ROWS - 1) / DKV_ROWS);
  sdpa_dkv_wgmma<TE, HD><<<kv_blocks, WG_THREADS, smem_kv, s>>>(
      q_step, g_step, static_cast<const TE*>(k), static_cast<const TE*>(v), lse2_p, delta_p,
      static_cast<TE*>(dk), static_cast<TE*>(dv), BH, T, S, Tp, scale, scale_log2, causal);
  const unsigned q_blocks = static_cast<unsigned>(BH) * ((T + DQ_ROWS - 1) / DQ_ROWS);
  sdpa_dq_wgmma<TE, HD><<<q_blocks, WG_THREADS, smem_q, s>>>(
      q_res, g_res, k_step, v_step, lse2_p, delta_p, static_cast<TE*>(dq), BH, T, S, Tp, scale,
      scale_log2, causal);
  return cudaSuccess;
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

// the 16-bit designs at head dim hd (a multiple of 16 up to 256): wgmma
// (hd 64 or 128), or delta then the mma.sync dK/dV and dQ kernels
template <typename E>
cudaError_t launch16(int design, const void* g, const void* q, const void* k, const void* v,
                     const void* out, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int BH, int T, int S, int hd, float scale, int causal,
                     cudaStream_t s) {
  if (design == 2)
    return hd == 128 ? launch_wgmma<E, 128>(g, q, k, v, out, lse, delta, dq, dk, dv, BH, T, S,
                                            scale, causal, s)
                     : launch_wgmma<E, 64>(g, q, k, v, out, lse, delta, dq, dk, dv, BH, T, S,
                                           scale, causal, s);
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

// design: 0 fma (float32), 1 mma (bf16 or fp16), 2 wgmma (bf16 or fp16, hd 64
// or 128), as cudaex.sdpa_bwd_design chooses; a design the inputs do not fit
// is refused. Head dims: multiples of 16 up to 256 (16-bit), up to 256 (f32).
// delta: f32 scratch of 2 * BH * Tp values, Tp = T rounded up to 128.
extern "C" int tt_sdpa_bwd(const void* g, const void* q, const void* k, const void* v,
                           const void* out, const void* lse, void* dq, void* dk, void* dv,
                           void* delta, int BH, int T, int S, int hd, float scale, int causal,
                           int dtype, int design, int device, void* stream) {
  cudaSetDevice(device);
  if ((design == 0) != (dtype == TT_F32) ||
      (design != 0 && ((design == 2) != (hd == 64 || hd == 128) || hd % 16)) || hd > 256 ||
      hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH <= 0 || T <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(BH) * T;
  const unsigned delta_blocks = static_cast<unsigned>((rows + 7) / 8);
  const float* L = static_cast<const float*>(lse);
  float* Dl = static_cast<float*>(delta);
  cudaError_t err = cudaSuccess;
  if (dtype == TT_BF16 || dtype == TT_F16) {
    err = dtype == TT_BF16
              ? launch16<__nv_bfloat16>(design, g, q, k, v, out, L, Dl, dq, dk, dv, BH, T, S,
                                        hd, scale, causal, s)
              : launch16<__half>(design, g, q, k, v, out, L, Dl, dq, dk, dv, BH, T, S, hd, scale,
                                 causal, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {    const float* G = static_cast<const float*>(g);
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
